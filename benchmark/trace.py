"""Device trace of a traced run: ``torch.profiler`` over whole units of work
(batches or steps), reduced to what the per-layer metrics read.

- ``busy_s``: the union of the device's activity intervals (kernels,
  copies, sets): copies issued ``non_blocking`` may overlap kernels, so
  durations are not summed;
- ``window_s``: the profiled span's host wall time;
- ``kernels``: device seconds and calls by kernel name;
- ``device_ops``: the 10 names with the most device time;
- ``idle_gaps``: the device's idle time grouped by the CUDA runtime call
  that spans each gap's midpoint (``host`` where none does: the host is in
  Python or in an operator's own work), the 10 largest.

The profiler's raw events are read (``kineto_results.events()``): building
its event tree costs seconds of host time on a step of a large model.
"""

from __future__ import annotations

import heapq
import time

import torch


class Tracer:
    """Profiles from :meth:`start` to :meth:`stop`; both may be called from
    any one thread, once each."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.summary = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        # the device's activity and the CUDA runtime's calls only: recording
        # every host op as well slowed a finetuning step about twofold
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    @property
    def done(self) -> bool:
        return self.t1 is not None

    def reduce(self) -> dict:
        if self.summary is None:
            self.summary = summarize(self.prof.profiler.kineto_results.events(),
                                     self.t1 - self.t0)
        return self.summary


def union_s(intervals) -> tuple:
    """(covered seconds, merged intervals) of (start_ns, end_ns) pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged) / 1e9, merged


def summarize(events, window_s: float, top: int = 10) -> dict:
    from torch.autograd import DeviceType

    dev, host, kernels = [], [], {}
    for e in events:
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            dev.append((s, s + d))
            sec, n = kernels.get(e.name(), (0.0, 0))
            kernels[e.name()] = (sec + d / 1e9, n + 1)
        elif d > 0:
            host.append((s, s + d, e.name()))
    if not dev:
        raise RuntimeError("the profiler saw no device activity: device time not measured")
    busy, merged = union_s(dev)
    host.sort()
    gaps, live, i = {}, [], 0
    # each gap (in time order) goes to the innermost host event spanning its
    # midpoint: of those started by then, the latest-starting one that has
    # not ended; ended ones leave the heap from its top
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) // 2
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(live, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while live and live[0][1] < mid:
            heapq.heappop(live)
        key = live[0][2] if live else "host"
        gaps[key] = gaps.get(key, 0.0) + (b - a) / 1e9
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {"busy_s": busy, "window_s": window_s, "kernels": kernels,
            "device_ops": [[n[:120], s] for n, (s, _) in ranked[:top]],
            "idle_gaps": [[n[:120], s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]}


def kernel_s(summary: dict, *patterns) -> tuple:
    """(device seconds, calls) of the kernels whose name holds any pattern."""
    sec = n = 0
    for name, (s, c) in summary["kernels"].items():
        if any(p in name for p in patterns):
            sec += s
            n += c
    return sec, n
