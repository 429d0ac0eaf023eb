#!/usr/bin/env python3
"""Run one cell of the benchmark of ``vla_touch_tpu_torch`` once.

    python3 benchmark/run.py --workload rdt1b.serve8 --seed 7 --seconds 30 --trace 0

From the root of a checkout that holds the program.  Prints one JSON line
as the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device`` and, traced, ``breakdown``; then
``check``, every number compared beside its limit, which are also the last
lines of standard error.  Exits with 2 and prints no result where CUDA or
the cell's cards are missing, and with 3 where a module of JAX or of the
JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness as HN  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(code: int, msg: str):
    print(msg, file=sys.stderr, flush=True)
    sys.exit(code)


def result_line(cell: dict, out: dict, trace: bool, device: dict) -> tuple:
    """The result's line (and the check) from a driver's outcome."""
    limits = (cell["limits"] or {}).get("limits", {})
    check = HN.Check({k: v for k, v in out["numbers"].items() if not k.startswith("_")}, limits)
    correct = bool(limits) and check.correct and out["failed"] == 0
    if trace:
        metrics = HN.read_per_layer(cell["per_layer"], out["ctx"])
    else:
        metrics = {}
        for m in cell["end_to_end"]:
            v = out["e2e"].get(m["name"])
            if v is None or not math.isfinite(v):
                correct = False
                continue
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    tr = out["ctx"].get("trace")
    if trace and tr is not None:
        line["device"]["busy_s"] = tr["busy_s"]
        line["device"]["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    line["check"] = check.as_json()
    return line, check


def main(argv=None) -> int:
    args = parse(argv)
    for k, v in HN.cache_dirs().items():
        os.environ[k] = v
        os.makedirs(v, exist_ok=True)
    import torch

    cell = HN.cell(args.workload)
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(2, f"{args.workload} needs {chips} CUDA device(s); "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
    out = HN.driver(cell["traffic"]["kind"]).run(cell, args.seed, args.seconds,
                                                 bool(args.trace), device="cuda")
    banned = HN.banned_modules()
    if banned:
        fail(3, "modules of JAX or of the JAX package were loaded: " + ", ".join(banned))
    line, check = result_line(cell, out, bool(args.trace),
                              HN.device_info(chips, out["memory_peak"]))
    extra = {k: v for k, v in out["numbers"].items() if k.startswith("_")}
    if extra or out["errors"]:
        print(json.dumps({"detail": extra, "errors": out["errors"]}), file=sys.stderr)
    for s in check.lines():
        print(s, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
