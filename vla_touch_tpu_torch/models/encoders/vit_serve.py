"""Serving twin of the ViT towers, SigLIP and DinoV2, with an int8 tier
(counterpart of ``vla_touch_tpu/models/encoders/vit_serve.py``).

:func:`quantize_vit_params` turns the port's :class:`SiglipVisionEncoder` or
:class:`DinoV2Encoder` into a :class:`ViTServe`:

- each block's query/key/value linears fused into one (3D, D) ``qkv``
  linear (the per-channel int8 scales concatenate exactly, so the math is
  that of three);
- ``weights='int8'``: every block linear (qkv, output, fc1, fc2) an int8
  :class:`ops.quant.QLinear`, dynamic per-token int8 activations, except
  the last ``keep_bf16_last`` blocks; ``weights='bf16'``: the same linears
  as bf16 weights with a float32 bias;
- the patch embedding, positional table, norms and layer scales kept in
  float32 (its linears are :class:`ops.quant.QLinear` or
  :class:`ops.quant.BF16Linear` leaves).

:func:`vit_encode_serve` is its forward.  The patch embedding is one
(N, p*p*3) x (p*p*3, D) product over (h, w, c)-ordered patches; each
LayerNorm runs in float32 with ``rsqrt`` and rounds to bf16.  Attention goes
through K1 (:func:`ops.attention.dot_product_attention`) on strided views of
the fused projection.  The int8 linears go through
``ops/quant_matmul.py::qdense_kernel_a8w8``: K6 at M <= 512, the plain
``qdense`` above, where every SigLIP call of a tick falls (M = 3 x 729 or
6 x 729), as the JAX package leaves them to XLA.

Unlike the JAX tree, a :class:`ViTServe` is a serving module whatever
``keep_bf16_last`` is: with every block kept bf16 it is the bf16 tier, never
the flax-equivalent module.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from vla_touch_tpu_torch.models.encoders.vit import (DinoV2Encoder, SiglipVisionEncoder,
                                                     ViTConfig, interpolate_pos_embed)
from vla_touch_tpu_torch.ops import attention as A
from vla_touch_tpu_torch.ops import quant as Q
from vla_touch_tpu_torch.ops import quant_matmul as QM
from vla_touch_tpu_torch.ops.nn import gelu_erf, gelu_tanh, quick_gelu


class ServeBlock(nn.Module):
    """One transformer block of the twin: ``norm1``, ``qkv``, ``output``,
    ``norm2``, ``fc1``, ``fc2`` and, for DinoV2, ``layerscale1/2``."""

    def __init__(self, norm1, qkv, output, norm2, fc1, fc2, layerscale=None):
        super().__init__()
        self.norm1, self.qkv, self.output = norm1, qkv, output
        self.norm2, self.fc1, self.fc2 = norm2, fc1, fc2
        if layerscale is not None:
            self.register_buffer("layerscale1", layerscale[0])
            self.register_buffer("layerscale2", layerscale[1])


class ViTServe(nn.Module):
    """The serving twin of a ViT tower (``cfg``: its :class:`ViTConfig`).
    ``pooled``: DinoV2's CLS token (B, D) instead of every token."""

    def __init__(self, cfg: ViTConfig, patch_weight, patch_bias, pos_embed, cls_token,
                 pre_norm, blocks, final_norm, pooled: bool):
        super().__init__()
        self.cfg = cfg
        self.pooled = pooled
        self.register_buffer("patch_weight", patch_weight)
        self.register_buffer("patch_bias", patch_bias)
        self.register_buffer("pos_embed", pos_embed)
        self.register_buffer("cls_token", cls_token)
        self.pre_norm = pre_norm
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm

    def forward(self, pixels, dtype=torch.bfloat16):
        tokens = vit_encode_serve(self, pixels, dtype=dtype)
        return tokens[:, 0] if self.pooled else tokens


def is_vit_serve_tree(vision) -> bool:
    """True for a serving twin (:func:`quantize_vit_params` or
    ``utils/from_flax.py::vit_serve``), whatever its tiers."""
    return isinstance(vision, ViTServe)


def _f32(t):
    return None if t is None else t.detach().float().clone()


def _layernorm_f32(ln: nn.LayerNorm) -> nn.LayerNorm:
    """A float32 copy of a LayerNorm (the twin applies it itself,
    :func:`_layernorm`)."""
    return copy.deepcopy(ln).float()


@torch.no_grad()
def _serve_linear(weight, bias, tier: str):
    """(N, K) weight and bias -> the twin's int8 or bf16 linear."""
    if tier == "int8":
        lin = nn.Linear(weight.shape[1], weight.shape[0], bias=bias is not None,
                        device=weight.device)
        lin.weight.copy_(weight.float())
        if bias is not None:
            lin.bias.copy_(bias.float())
        return Q.quantize_linear(lin)
    return Q.BF16Linear(weight.detach().to(torch.bfloat16).contiguous(), _f32(bias))


@torch.no_grad()
def quantize_vit_params(vision: nn.Module, weights: str = "int8",
                        keep_bf16_last: int = 0) -> ViTServe:
    """The serving twin of the port's ``SiglipVisionEncoder`` or
    ``DinoV2Encoder`` (any dtype, on its device): ``weights`` 'int8' or
    'bf16'; with 'int8', the last ``keep_bf16_last`` blocks stay bf16
    (their quantization error lands on the output tokens unmixed)."""
    if weights not in ("int8", "bf16"):
        raise ValueError(f"weights {weights!r}")
    if not isinstance(vision, (SiglipVisionEncoder, DinoV2Encoder)):
        raise TypeError(f"not a ViT tower: {type(vision).__name__}")
    vit = vision.vit
    cfg = vit.cfg
    n = len(vit.blocks)
    cut = n - keep_bf16_last if weights == "int8" else 0
    blocks = []
    for i, blk in enumerate(vit.blocks):
        tier = "int8" if i < cut else "bf16"
        a = blk.attention
        qkv_w = torch.cat([a.query.weight, a.key.weight, a.value.weight], dim=0)
        qkv_b = torch.cat([a.query.bias, a.key.bias, a.value.bias], dim=0)
        ls = ((_f32(blk.layerscale1), _f32(blk.layerscale2)) if cfg.use_layerscale
              else None)
        blocks.append(ServeBlock(
            _layernorm_f32(blk.norm1), _serve_linear(qkv_w, qkv_b, tier),
            _serve_linear(a.output.weight, a.output.bias, tier), _layernorm_f32(blk.norm2),
            _serve_linear(blk.fc1.weight, blk.fc1.bias, tier),
            _serve_linear(blk.fc2.weight, blk.fc2.bias, tier), ls))
    pe = vit.patch_embed
    return ViTServe(
        cfg, _f32(pe.weight), _f32(pe.bias), _f32(vit.pos_embed),
        _f32(vit.cls_token) if cfg.use_cls_token else None,
        _layernorm_f32(vit.pre_norm) if cfg.use_pre_norm else None, blocks,
        _layernorm_f32(vit.final_norm), pooled=isinstance(vision, DinoV2Encoder),
    ).eval().requires_grad_(False)


# ---- the serving forward --------------------------------------------------------

def _lin(x, leaf, dtype):
    """A twin linear on x (..., K): int8 a8w8 (bf16 out, as K6 gives, then
    ``dtype``) or bf16 x bf16 with float32 accumulation and bias."""
    if isinstance(leaf, Q.QLinear):
        return QM.qdense_kernel_a8w8(x, leaf).to(dtype)
    return Q.dense_f32acc(x.to(dtype), leaf.weight.to(dtype), leaf.bias).to(dtype)


def _layernorm(x, ln: nn.LayerNorm):
    """float32 statistics, ``(x - mu) * rsqrt(var + eps)``, scale and bias in
    float32, bf16 out."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + ln.eps)
    return (y * ln.weight + ln.bias).to(torch.bfloat16)


def _block(x, blk: ServeBlock, cfg: ViTConfig, dtype):
    B, N, D = x.shape
    h = _layernorm(x, blk.norm1)
    qkv = _lin(h, blk.qkv, dtype).reshape(B, N, 3, cfg.num_heads, D // cfg.num_heads)
    o = A.dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    h = _lin(o.reshape(B, N, D), blk.output, dtype)
    if cfg.use_layerscale:
        h = h * blk.layerscale1.to(dtype)
    x = x + h
    h = _lin(_layernorm(x, blk.norm2), blk.fc1, dtype)
    if cfg.quick_gelu:
        h = quick_gelu(h)
    elif cfg.gelu_tanh:
        h = gelu_tanh(h)
    else:
        h = gelu_erf(h)
    h = _lin(h, blk.fc2, dtype)
    if cfg.use_layerscale:
        h = h * blk.layerscale2.to(dtype)
    return x + h


def vit_encode_serve(twin: ViTServe, pixels, dtype=torch.bfloat16):
    """The twin's forward: ``pixels`` (B, H, W, 3) normalised, channels-last
    -> post-final-LayerNorm tokens (B, N(+cls), D) in ``dtype``."""
    cfg = twin.cfg
    B, H, W, _ = pixels.shape
    p = cfg.patch_size
    grid = (H - p) // p + 1
    crop = pixels[:, : grid * p, : grid * p].to(dtype)
    patches = crop.reshape(B, grid, p, grid, p, 3).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(B, grid * grid, p * p * 3)
    x = Q.dense_f32acc(patches, twin.patch_weight.to(dtype), twin.patch_bias).to(dtype)
    if cfg.use_cls_token:
        x = torch.cat([twin.cls_token.to(dtype).expand(B, 1, -1), x], dim=1)
    pos = interpolate_pos_embed(twin.pos_embed, grid, cfg.image_size // p, cfg.use_cls_token)
    x = x + pos.to(dtype)
    if cfg.use_pre_norm:
        x = _layernorm(x, twin.pre_norm)
    for blk in twin.blocks:
        x = _block(x, blk, cfg, dtype)
    return _layernorm(x, twin.final_norm).to(dtype)
