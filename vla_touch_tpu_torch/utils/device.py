"""Device resolution for the port's entry points."""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA.  Asking for CUDA where it is absent raises: the
    port never falls back to the CPU unless the caller passes ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: the kernels'
    split plans fill them."""
    return torch.cuda.get_device_properties(index).multi_processor_count
