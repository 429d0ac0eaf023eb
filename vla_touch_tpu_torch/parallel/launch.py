"""Process-group launch glue (counterpart of
``vla_touch_tpu/parallel/launch.py``).

One process per GPU.  :func:`initialize` starts ``torch.distributed`` where
a coordinator is given or a launcher set the environment (``torchrun``'s
``MASTER_ADDR`` / ``RANK`` / ``WORLD_SIZE``); without either it does
nothing, so every single-process path runs as before.  The backend is NCCL
on ``cuda:<local rank>``; Gloo is used when the caller asks for the CPU
(``device="cpu"``), or names it (``backend="gloo"``: two ranks sharing one
card, which NCCL refuses).

A coordinator is ``host:port`` (a TCP store; rank 0 listens there), or an
``init_method`` URL as ``torch.distributed`` takes it (``tcp://...``,
``file:///path``: a file store, which needs no port).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# A rank that hangs fails the run after this long instead of stalling it.
TIMEOUT_S = 900

_LOCAL = {"device": None}


def _launcher_env() -> bool:
    return all(k in os.environ for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))


def _init_method(coordinator_address: Optional[str]) -> str:
    if coordinator_address is None:
        return "env://"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               local_rank: Optional[int] = None, backend: Optional[str] = None) -> bool:
    """Start the default process group; True when distributed mode is on.

    ``num_processes`` / ``process_id`` default to ``WORLD_SIZE`` / ``RANK``.
    ``device``: "cpu" (Gloo), a CUDA device, or None: ``cuda:<local
    rank>``, the local rank from ``local_rank``, else ``LOCAL_RANK``, else
    the rank modulo the visible cards."""
    if dist.is_available() and dist.is_initialized():
        return True
    if coordinator_address is None and not _launcher_env():
        return False
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    elif device is not None:
        dev = torch.device(device)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run the "
                               "process group on the CPU (Gloo)")
        if local_rank is None or local_rank < 0:
            local_rank = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local_rank)
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _LOCAL["device"] = dev
    return True


def shutdown() -> None:
    """Destroy the default process group, if any."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _LOCAL["device"] = None


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def local_device(default=None) -> torch.device:
    """The device :func:`initialize` chose, else ``default`` resolved as the
    single-process entry points do (None: CUDA)."""
    if _LOCAL["device"] is not None:
        return _LOCAL["device"]
    from vla_touch_tpu_torch.utils.device import resolve_device

    return resolve_device(default)


def host_local_batch(mesh, batch, spec=("data",), device=None):
    """This rank's rows of a global batch, on its device.

    ``batch``: a tensor, array or dict of them, each the GLOBAL batch; the
    axis that ``spec`` names "data" (the first by default; ``(None,
    "data")`` for (accumulation, rows, ...) leaves) is split into
    ``n_data`` equal parts in rank-major order, so the global batch is the
    concatenation of the ranks' parts.  Every rank of one data index (the
    ``model`` ranks) gets the same rows."""
    from vla_touch_tpu_torch.parallel import mesh as mesh_lib

    n_data, _ = mesh_lib.mesh_sizes(mesh)
    d = mesh_lib.data_index(mesh)
    axis = list(spec).index(mesh_lib.DATA_AXIS)
    dev = local_device(device)

    def place(x):
        t = torch.as_tensor(x)
        part = t.shape[axis] // n_data
        if part * n_data != t.shape[axis]:
            raise ValueError(f"batch axis {axis} of {tuple(t.shape)} does not split into "
                             f"{n_data} data ranks")
        return t.narrow(axis, d * part, part).to(dev)

    if isinstance(batch, dict):
        return {k: place(v) for k, v in batch.items()}
    return place(batch)
