"""Weights made from the seed on the device, in the published checkpoints'
layout, and handed to the program through its own loaders.

:func:`make` fills one flat buffer per call with a single normal draw from
a ``torch.Generator`` on the device and views it as the checkpoint's named
tensors, each scaled to its kind: matrices N(0, 1/fan_in), biases N(0,
0.02^2), norm weights 1 + N(0, 0.1^2), positional tables N(0, 0.02^2).
Nothing is zero, the final projection included.

The program's loaders (``utils/torch_port.py``: ``rdt_runner``,
``siglip_from_hf``; ``utils/from_flax.py``) convert numpy state dicts.  The
weights never leave the device: :func:`loader_map` runs those loaders once
over stand-ins (one element per tensor, holding its index; and the tensors
whose layout they change at full size, holding element indices), which
gives each of the program's parameters its checkpoint tensor and the
element order it takes.  :func:`load_port` then fills the program's module
from the device tensors by that map.
"""

from __future__ import annotations

import numpy as np
import torch


def _kind(name: str, shape) -> str:
    if len(shape) >= 2 and not name.endswith("pos_embed") and "position_embedding" not in name:
        return "matrix"
    if name.endswith("bias"):
        return "bias"
    if len(shape) == 1:
        return "norm"
    return "table"


@torch.no_grad()
def make(shapes: dict, seed: int, device, dtype) -> dict:
    """{name: tensor} views of one buffer drawn from ``seed``."""
    sizes = [int(np.prod(s)) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(sum(sizes), dtype=dtype, device=device)
    flat.normal_(0.0, 1.0, generator=gen)
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        t = flat[at:at + n].view(shape)
        at += n
        kind = _kind(name, shape)
        if kind == "matrix":
            t.mul_(float(np.prod(shape[1:])) ** -0.5)
        elif kind == "norm":
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(0.02)
        out[name] = t
    return out


def _stand_ins(shapes: dict, full: str = None) -> dict:
    out = {}
    for i, (name, shape) in enumerate(shapes.items()):
        if name == full:
            out[name] = np.arange(int(np.prod(shape)), dtype=np.float64).reshape(shape)
        else:
            out[name] = np.full((1,) * len(shape), float(i))
    return out


def loader_map(convert, shapes: dict, port_shapes: dict) -> dict:
    """{program name: (checkpoint name, element order or None)}.
    ``convert(state_dict) -> {program name: numpy array}`` is the program's
    loader chain; ``port_shapes`` the program module's parameter shapes."""
    names = list(shapes)
    got = convert(_stand_ins(shapes))
    if set(got) != set(port_shapes):
        raise KeyError(f"loader gives {sorted(set(got) ^ set(port_shapes))[:8]} unmatched")
    out = {}
    for pname, arr in got.items():
        src = names[int(np.asarray(arr).reshape(-1)[0])]
        order = None
        if list(shapes[src]) != list(port_shapes[pname]):
            full = np.asarray(convert(_stand_ins(shapes, full=src))[pname])
            if list(full.shape) != list(port_shapes[pname]):
                raise ValueError(f"{pname}: loader gives {full.shape}, module holds "
                                 f"{port_shapes[pname]}")
            order = full.reshape(-1).astype(np.int64)
        out[pname] = (src, order)
    return out


def port_tensor(hf: dict, entry, shape):
    src, order = entry
    t = hf[src]
    if order is None:
        return t.reshape(shape)
    idx = torch.as_tensor(order, device=t.device)
    return t.reshape(-1)[idx].reshape(shape)


@torch.no_grad()
def load_port(module: torch.nn.Module, hf: dict, mapping: dict) -> torch.nn.Module:
    """Copy the device tensors into ``module`` (materialised, on the
    device) by ``mapping``; every parameter must be covered."""
    own = module.state_dict()
    if set(own) != set(mapping):
        raise KeyError(f"module and map differ: {sorted(set(own) ^ set(mapping))[:8]}")
    for name, t in own.items():
        t.copy_(port_tensor(hf, mapping[name], t.shape))
    return module


# ---- the program's modules and loaders ----------------------------------------------


def rdt_module(rcfg, hf: dict, device, dtype):
    """The program's ``RDTRunnerModule`` on ``device`` in ``dtype``, filled
    from ``hf`` through ``torch_port.rdt_runner``."""
    from vla_touch_tpu_torch.models.rdt.runner import RDTRunnerModule
    from vla_touch_tpu_torch.utils import from_flax as FF
    from vla_touch_tpu_torch.utils import torch_port as TP

    with torch.device("meta"):
        module = RDTRunnerModule(rcfg.model)
    depths = tuple(getattr(module, n).depth
                   for n in ("lang_adaptor", "img_adaptor", "state_adaptor"))
    port_shapes = {k: list(v.shape) for k, v in module.state_dict().items()}
    shapes = {k: list(v.shape) for k, v in hf.items()}
    mapping = loader_map(lambda sd: FF.rdt_runner(TP.rdt_runner(
        sd, depth=rcfg.model.depth, adaptor_depths=depths)), shapes, port_shapes)
    module = module.to_empty(device=device).to(dtype)
    return load_port(module, hf, mapping).eval().requires_grad_(False), mapping


def siglip_module(vcfg, hf: dict, device, dtype):
    """The program's ``SiglipVisionEncoder`` filled through
    ``torch_port.siglip_from_hf``."""
    from vla_touch_tpu_torch.models.encoders.vit import SiglipVisionEncoder
    from vla_touch_tpu_torch.utils import from_flax as FF
    from vla_touch_tpu_torch.utils import torch_port as TP

    with torch.device("meta"):
        module = SiglipVisionEncoder(vcfg)
    port_shapes = {k: list(v.shape) for k, v in module.state_dict().items()}
    shapes = {k: list(v.shape) for k, v in hf.items()}
    mapping = loader_map(lambda sd: FF.vit(TP.siglip_from_hf(sd, vcfg.num_layers)),
                         shapes, port_shapes)
    module = module.to_empty(device=device).to(dtype)
    return load_port(module, hf, mapping).eval().requires_grad_(False), mapping
