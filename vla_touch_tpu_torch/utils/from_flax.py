"""Flax parameter trees (as numpy arrays) -> the port's state dicts.

The port's modules reuse the flax names, so a tree converts by flattening
its path (the RDT and ViT ``block{i}`` become ``blocks.{i}``) plus one
layout rule per leaf kind:

- ``Dense`` kernel (in, out)            -> ``weight`` (out, in);
- ``Conv`` kernel (k, Cin, F)            -> Conv1d ``weight`` (F, Cin, k), and the
  flax wrapper's inner ``conv`` level disappears;
- ``ConvTranspose`` kernel (k, Cin, F)   -> ConvTranspose1d ``weight`` (Cin, F, k),
  spatially FLIPPED: flax correlates the dilated input with its kernel as
  stored, torch's transposed conv scatters with it;
- patch ``Conv`` kernel HWIO (p, p, C, D) -> Linear ``weight`` (D, p*p*C) over
  the (ky, kx, c)-ordered patch;
- LayerNorm ``scale`` -> ``weight``; every other leaf as is.

Everything runs on numpy, so a tree can come from a checkpoint file as well
as from the JAX package.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def to_state_dict(tree: dict, lists: tuple = ()) -> dict:
    """Generic flax tree -> {torch name: numpy array}.  ``lists`` names the
    flax module prefixes that the port holds in an ``nn.ModuleList``
    (``("block",)``: ``block3`` -> ``blocks.3``)."""
    out = {}
    for path, arr in _flatten(tree):
        *mods, leaf = path
        for name in lists:
            mods = [re.sub(rf"^{name}(\d+)$", rf"{name}s.\1", m) for m in mods]
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 3:
                if mods and mods[-1] == "conv":
                    mods = mods[:-1]
                if mods and mods[-1].endswith("_up"):
                    arr = arr[::-1].transpose(1, 2, 0)
                else:
                    arr = arr.transpose(2, 1, 0)
            elif arr.ndim == 4:
                arr = arr.reshape(-1, arr.shape[-1]).T
            leaf = "weight"
        elif leaf == "bias" and mods and mods[-1] == "conv":
            mods = mods[:-1]
        elif leaf == "scale":
            leaf = "weight"
        out[".".join(mods + [leaf])] = np.ascontiguousarray(arr)
    return out


def load_into(module: torch.nn.Module, state: dict) -> torch.nn.Module:
    """Copy a converted state dict into ``module`` (strict: every parameter
    must be present and no extra key may remain), casting to each
    parameter's dtype and device."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing[:8]}, "
                       f"unexpected {extra[:8]}")
    with torch.no_grad():
        for name, t in own.items():
            src = torch.from_numpy(np.array(state[name], np.float32))
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(t.shape)}")
            t.copy_(src.to(t.dtype))
    return module


def rdt_runner(params: dict) -> dict:
    """RDT runner tree (``model`` + three adaptors)."""
    return to_state_dict(params, lists=("block",))


def vit(params: dict) -> dict:
    """DinoV2 / SigLIP encoder tree (``vit`` subtree inside)."""
    return to_state_dict(params, lists=("block",))


def unet1d(params: dict) -> dict:
    """One ``ConditionalUnet1D`` tree."""
    return to_state_dict(params)


def bridge_controller(params: dict, ema_shadow: dict) -> dict:
    """Deployable BRIDGeR state: the observation encoder from ``params``
    and the b/v/s UNets from the EMA shadow (``{"b_net", "v_net",
    "s_net"}``).  The auxiliary force decoder (training only) is dropped."""
    enc = {k: v for k, v in params.items() if k.startswith("se_fc")}
    return to_state_dict({**enc, "si": ema_shadow})


def _port_path(path) -> list:
    out = []
    for p in path:
        m = re.match(r"^block(\d+)$", p)
        out += ["blocks", m.group(1)] if m else [p]
    return out


def quant_rdt_runner(qparams: dict, cfg, device=None):
    """A JAX quantized runner tree (``quant_serve.quantize_rdt_params``:
    ``w_i8``/``scale`` and ``w4_pack``/``scale4`` leaves, bf16 ``kv``
    kernels, float embedders, norms and positional tables) -> the port's
    ``QuantRDTRunner`` for ``cfg`` (an ``RDTModelConfig``), on ``device``
    (``None`` means CUDA, as for every entry point of the port).

    Integer codes and scales are taken as they are, only re-laid out for
    the kernels: ``w_i8`` (K, N) -> (N, K), ``w4_pack`` (K/2, N) -> (N, K/2)
    (the plane packing is kept: byte j of row n holds rows j and K/2 + j);
    ``scale4`` stays (G, N)."""
    from vla_touch_tpu_torch.models.rdt.quant_serve import BF16Linear, QuantRDTRunner
    from vla_touch_tpu_torch.models.rdt.runner import RDTRunnerModule
    from vla_touch_tpu_torch.ops.quant import QLinear, QLinearW4
    from vla_touch_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    with torch.device("meta"):
        module = RDTRunnerModule(cfg)
    module = module.to_empty(device=device)

    def f32(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    def leaf(node, path):
        bias = f32(node["bias"]) if "bias" in node else None
        if "w_i8" in node:
            w = torch.from_numpy(np.ascontiguousarray(np.asarray(node["w_i8"]).T))
            return QLinear(w.to(device), f32(node["scale"]), bias)
        if "w4_pack" in node:
            w = torch.from_numpy(np.ascontiguousarray(np.asarray(node["w4_pack"]).T))
            return QLinearW4(w.to(device), f32(node["scale4"]), bias)
        if path[-2:] == ("cross_attn", "kv"):
            return BF16Linear(f32(np.asarray(node["kernel"], np.float32).T).to(torch.bfloat16)
                              .contiguous(), bias)
        return None

    def rec(node, path):
        """Install the quantized leaves; return the rest of the tree."""
        rest = {}
        for k, v in node.items():
            if not isinstance(v, dict):
                rest[k] = v
                continue
            q = leaf(v, path + (k,))
            if q is None:
                sub = rec(v, path + (k,))
                if sub:
                    rest[k] = sub
                continue
            *parent, name = _port_path(path + (k,))
            setattr(module.get_submodule(".".join(parent)), name, q)
        return rest

    state = to_state_dict(rec(qparams, ()), lists=("block",))
    own = dict(module.named_parameters())
    if set(own) != set(state):
        raise KeyError(f"quantized tree mismatch: missing {sorted(set(own) - set(state))[:8]},"
                       f" unexpected {sorted(set(state) - set(own))[:8]}")
    with torch.no_grad():
        for name, p in own.items():
            src = f32(state[name])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(p.shape)}")
            p.copy_(src)
    return QuantRDTRunner(cfg, module.model, module.lang_adaptor, module.img_adaptor,
                          module.state_adaptor).eval().requires_grad_(False)
