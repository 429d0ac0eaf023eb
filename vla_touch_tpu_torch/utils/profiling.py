"""Per-stage latency metrics (counterpart of
``vla_touch_tpu/utils/profiling.py``).

- :func:`stage`: a context manager that records wall-clock spans into a
  process-wide registry; given tensors in ``block_on`` it synchronises
  their CUDA device at the span's end, so the span covers the device work
  the stage queued, not only its launches;
- :func:`record`: add a span measured elsewhere;
- :func:`stage_stats` / :func:`reset_stages`: count, mean, p50 and p95 per
  stage, in ms;
- :func:`trace`: ``torch.profiler`` around a block, written as a Chrome
  trace into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np

_SPANS: dict = defaultdict(list)


def _synchronise(block_on) -> None:
    import torch

    items = block_on if isinstance(block_on, (list, tuple)) else [block_on]
    for dev in {t.device for t in items if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def stage(name: str, block_on=None):
    """Record one span.  ``block_on``: a tensor or a list of tensors whose
    CUDA devices are synchronised at the span's end.  It is read at exit,
    so a list the block fills counts."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if block_on is not None:
            _synchronise(block_on)
        _SPANS[name].append(time.perf_counter() - t0)


def record(name: str, seconds: float) -> None:
    _SPANS[name].append(seconds)


def stage_stats(reset: bool = False) -> dict:
    out = {}
    for name, vals in _SPANS.items():
        a = np.asarray(vals)
        out[name] = {
            "count": int(a.size),
            "mean_ms": float(a.mean() * 1e3),
            "p50_ms": float(np.percentile(a, 50) * 1e3),
            "p95_ms": float(np.percentile(a, 95) * 1e3),
        }
    if reset:
        reset_stages()
    return out


def reset_stages() -> None:
    _SPANS.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (the CPU, and CUDA where it is
    available); the trace is written to ``log_dir/trace.json`` for
    ``chrome://tracing`` or Perfetto."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
