"""Serving-path UNet-1D over S stacked networks (counterpart of
``vla_touch_tpu/models/controllers/unet1d_serve.py``).

The v and s nets of the stochastic interpolant share the architecture and
the input, so their weights are stacked on a leading S axis once
(:func:`stack_unets`, cast to the inference dtype) and every layer runs
for both nets in one call: the 12 conditional residual blocks through
kernel K2 (:func:`ops.unet_kernels.resblock_fused`), the glue (step MLP,
stride-2 down conv, transposed-conv upsampling, final head) as batched
matmuls.

Stacked layouts (leading S): Linear ``kernel`` (S, in, out) and ``bias``;
Conv ``kernel`` (S, k, Cin, F); the transposed conv as the equivalent
correlation kernel (S, 4, Cin, F) over the zero-dilated input; residual
blocks as documented in :mod:`ops.unet_kernels`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from vla_touch_tpu_torch.models.controllers.unet1d import ConditionalUnet1D
from vla_touch_tpu_torch.ops import unet_kernels as UK
from vla_touch_tpu_torch.ops.pos_embed import sinusoidal_pos_emb


def _conv_kernel(w):
    """torch Conv1d weight (F, Cin, k) -> (k, Cin, F)."""
    return w.permute(2, 1, 0)


def _convt_kernel(w):
    """torch ConvTranspose1d weight (Cin, F, k) -> the (k, Cin, F) kernel
    that cross-correlates the zero-dilated, (k-1-p)-padded input (the
    spatially flipped weight)."""
    return w.flip(-1).permute(2, 0, 1)


def _resblock_leaves(blk) -> dict:
    out = {"w0": _conv_kernel(blk.block0.conv.weight), "b0": blk.block0.conv.bias,
           "g0w": blk.block0.gn.weight, "g0b": blk.block0.gn.bias,
           "fw": blk.cond_encoder.weight.T, "fb": blk.cond_encoder.bias,
           "w1": _conv_kernel(blk.block1.conv.weight), "b1": blk.block1.conv.bias,
           "g1w": blk.block1.gn.weight, "g1b": blk.block1.gn.bias}
    if hasattr(blk, "residual_conv"):
        out["wr"] = blk.residual_conv.weight[:, :, 0].T
        out["br"] = blk.residual_conv.bias
    return out


def _leaves(net: ConditionalUnet1D) -> dict:
    tree = {"step_fc1": {"kernel": net.step_fc1.weight.T, "bias": net.step_fc1.bias},
            "step_fc2": {"kernel": net.step_fc2.weight.T, "bias": net.step_fc2.bias}}
    for name, mod in net.named_children():
        if name.endswith(("_res0", "_res1")) or name in ("mid0", "mid1"):
            tree[name] = _resblock_leaves(mod)
        elif name.endswith("_down") or name == "final_conv":
            tree[name] = {"kernel": _conv_kernel(mod.weight), "bias": mod.bias}
        elif name.endswith("_up"):
            tree[name] = {"kernel": _convt_kernel(mod.weight), "bias": mod.bias}
    fb = net.final_block
    tree["final_block"] = {"kernel": _conv_kernel(fb.conv.weight),
                           "bias": fb.conv.bias, "gw": fb.gn.weight, "gb": fb.gn.bias}
    return tree


@torch.no_grad()
def stack_unets(nets: Sequence[ConditionalUnet1D], dtype=torch.bfloat16) -> dict:
    """Stack same-architecture nets into the serving layout, contiguous,
    in ``dtype``.  Done once per set of weights, not per SDE step."""
    trees = [_leaves(n) for n in nets]

    def stack(*leaves):
        return torch.stack([l.to(dtype) for l in leaves]).contiguous()

    return {name: {k: stack(*(t[name][k] for t in trees)) for k in trees[0][name]}
            for name in trees[0]}


def _dense_s(p, x):
    """x (S, B, I) @ kernel (S, I, O) + bias (S, O)."""
    return torch.baddbmm(p["bias"][:, None, :], x, p["kernel"])


def _conv_transpose_s(p, x, stride: int = 2, padding: int = 1):
    """torch ConvTranspose1d semantics as a correlation over the
    zero-dilated input.  x (S, B, T, Ci) -> (S, B, (T-1)*stride - 2p + k, F)."""
    S, B, T, Ci = x.shape
    k = p["kernel"].shape[1]
    xd = x.new_zeros((S, B, (T - 1) * stride + 1, Ci))
    xd[:, :, ::stride] = x
    return UK.conv1d_taps(xd, p["kernel"], p["bias"], padding=k - 1 - padding)


def unet_forward_stacked(params: dict, sample, timestep, global_cond, *,
                         down_dims=(256, 512, 512), n_groups: int = 8,
                         diffusion_step_embed_dim: int = 256):
    """params: :func:`stack_unets` output; sample (B, T, D); timestep (B,);
    global_cond (B, G).  Returns (S, B, T, D) in the params' dtype."""
    dtype = params["step_fc1"]["kernel"].dtype
    S = params["step_fc1"]["kernel"].shape[0]
    B, T, D = sample.shape
    t_emb = sinusoidal_pos_emb(timestep, diffusion_step_embed_dim, dtype=dtype)
    t_emb = t_emb[None].expand(S, -1, -1)
    t_emb = _dense_s(params["step_fc2"], UK.mish(_dense_s(params["step_fc1"], t_emb)))
    cond = torch.cat([t_emb, global_cond.to(dtype)[None].expand(S, -1, -1)],
                     dim=-1).contiguous()

    def block(name, x):
        return UK.resblock_fused(x.contiguous(), cond, params[name],
                                 n_groups=n_groups)

    levels = len(down_dims)
    x = sample.to(dtype)[None].expand(S, B, T, D)
    skips = []
    for i in range(levels):
        x = block(f"down{i}_res1", block(f"down{i}_res0", x))
        skips.append(x)
        if i < levels - 1:
            p = params[f"down{i}_down"]
            x = UK.conv1d_taps(x, p["kernel"], p["bias"], stride=2, padding=1)
    x = block("mid1", block("mid0", x))
    for i in range(levels - 1):
        x = torch.cat([x, skips.pop()], dim=-1)
        x = block(f"up{i}_res1", block(f"up{i}_res0", x))
        x = _conv_transpose_s(params[f"up{i}_up"], x)
    fb = params["final_block"]
    k = fb["kernel"].shape[1]
    x = UK.conv1d_taps(x, fb["kernel"], fb["bias"], padding=k // 2)
    x = UK.mish(UK.group_norm(x.float(), fb["gw"].float(), fb["gb"].float(),
                              n_groups, 1e-5)).to(dtype)
    p = params["final_conv"]
    return UK.conv1d_taps(x, p["kernel"], p["bias"])
