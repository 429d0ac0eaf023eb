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
