"""What every cell shares: finding a cell's files by name, the process's
set-up clock, the device line, the check that nothing of JAX was loaded,
the per-layer readers, and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<mix>.json``, whose ``kind`` names its driver,
``drivers/<kind>.py``).  Per-layer metrics are ``metrics/<name>.py``, each
with ``read(ctx) -> number or None``, read in the cells that their entry
lists under ``workloads``; ``limits/<cell>.json`` holds the limits that
decide ``correct``.  Adding any of these is adding files.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no run may load: JAX, its libraries, and the
# JAX package the program was ported from
BANNED = ("jax", "jaxlib", "flax", "optax", "vla_touch_tpu")


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return read_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str) -> dict:
    """The cell's workload entry, configuration, traffic, limits and the
    metrics it reports (end to end, per layer)."""
    bench = spec()
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    limits = os.path.join(HERE, "limits", f"{name}.json")
    return {"name": name, "workload": work,
            "config": read_json(os.path.join(ROOT, conf["file"])),
            "traffic": read_json(os.path.join(HERE, "traffic", f"{work['traffic']}.json")),
            "limits": read_json(limits) if os.path.exists(limits) else None,
            "end_to_end": e2e, "per_layer": per_layer}


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def reader(metric: str):
    """``metrics/<metric>.py`` (the name may hold dots)."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec_ = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def read_per_layer(metrics: list, ctx: dict) -> dict:
    """Each reader's number; a reader that finds nothing returns None and
    its metric is left out."""
    out = {}
    for m in metrics:
        v = reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time), or
    since this module was imported where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def banned_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`BANNED`, compared as a whole word."""
    modules = sys.modules if modules is None else modules
    return sorted(n for n in list(modules) if n.split(".", 1)[0] in BANNED)


def cache_dirs() -> dict:
    """Fixed build and kernel-cache directories inside the checkout (the
    program builds its kernels into ``build/kernels`` beside itself)."""
    b = os.path.join(ROOT, "build")
    return {"TORCH_EXTENSIONS_DIR": os.path.join(b, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(b, "triton"),
            "CUDA_CACHE_PATH": os.path.join(b, "cuda_cache")}


def device_info(count: int, memory_peak: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(memory_peak)}


@dataclasses.dataclass
class Check:
    """The numbers compared for ``correct``, each beside its limit (a
    number passes when it is at most its limit)."""

    numbers: dict
    limits: dict

    @property
    def correct(self) -> bool:
        return all(k in self.numbers and self.numbers[k] <= v
                   for k, v in self.limits.items())

    def lines(self) -> list:
        return [f"{k} {self.numbers.get(k)!r} limit {v!r}" for k, v in self.limits.items()]

    def as_json(self) -> dict:
        return {k: {"value": self.numbers.get(k), "limit": v} for k, v in self.limits.items()}
