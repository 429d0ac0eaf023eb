"""Seeded random initialisation of the port's modules, made on the device.

The weights of a full-size model (RDT-1B: 1.2 B parameters) are created
directly on the target device from a ``torch.Generator`` seed, so
``chip_smoke.py`` needs neither checkpoints nor the JAX package.  Rules:
matrices and conv kernels ~ N(0, 1/fan_in) (lecun-normal, as flax's
default), biases 0, 1-D norm weights, layer scales and scalars 1; modules with an
``init_special_(generator)`` method then set their own parameters
(positional tables, zero-initialised heads).
"""

from __future__ import annotations

import torch
from torch import nn

from vla_touch_tpu_torch.utils.device import resolve_device


@torch.no_grad()
def init_module_(module: nn.Module, seed: int) -> nn.Module:
    params = list(module.named_parameters())
    gen = torch.Generator(device=params[0][1].device).manual_seed(seed)
    for name, p in params:
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            p.zero_()
        elif p.dim() <= 1:
            p.fill_(1.0)
        else:
            fan_in = p.numel() // p.shape[0]
            p.normal_(0.0, fan_in ** -0.5, generator=gen)
    for sub in module.modules():
        if hasattr(sub, "init_special_"):
            sub.init_special_(gen)
    return module


def build_module(factory, seed: int, device=None, dtype=torch.float32) -> nn.Module:
    """``factory()`` built without allocating, then materialised on
    ``device`` (default CUDA) in ``dtype`` and filled from ``seed``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        module = factory()
    module = module.to_empty(device=dev).to(dtype)
    init_module_(module, seed)
    return module.eval().requires_grad_(False)
