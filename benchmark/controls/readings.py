#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, in one process:
the program's numbers on many seeds (sound runs, a short window at the
cell's own load) and the controls' on a few.

    python3 benchmark/controls/readings.py --workload rdt1b.serve8 \\
        --seeds 11 12 13 --control-seeds 91 92 93 --seconds 5

Serving cells: the control is the reference in fp8 put in the program's
place (its chunks judged instead of the served ones, after a window at the
cell's own load).  Finetuning cells: the
reference in fp8 put in the program's place, and the fault "half of the
batch left out" (the reference over half of each micro-batch's rows); a
step that leaves its state unchanged reads 1 by construction.  One JSON
line per reading; the last line sums them up.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness as HN  # noqa: E402


def numbers(out: dict) -> dict:
    return {k: v for k, v in out["numbers"].items() if isinstance(v, (int, float))}


def serve_readings(cell, seeds, control_seeds, seconds, device):
    from benchmark.drivers import serve

    rows = []
    for kind, some, control in (("program", seeds, None), ("fp8", control_seeds, "fp8")):
        for s in some:
            out = serve.run(cell, s, seconds, False, device, control=control)
            rows.append({"seed": s, "kind": kind, **numbers(out),
                         "attempted": out["attempted"], "failed": out["failed"]})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def train_readings(cell, seeds, control_seeds, seconds, device):
    import torch

    from benchmark import traffic as TR
    from benchmark.drivers import common as C
    from benchmark.drivers import train

    rows = []
    for s in seeds:
        out = train.run(cell, s, seconds, False, device)
        rows.append({"seed": s, "kind": "program", **out["numbers"]})
        print(json.dumps(rows[-1]), flush=True)
    config, traffic = cell["config"], cell["traffic"]
    recipe = traffic["recipe"]
    mb = recipe["batch_size"]
    n = mb * recipe["grad_accum"]
    half = [i for i in range(n) if i % mb < mb // 2]
    for s in control_seeds:
        from vla_touch_tpu_torch.data.consumer import collate

        batches = TR.train_batches(traffic, config, s, collate)[:traffic["checked_steps"]]
        ref = train.reference_run(config, traffic, s, batches, n, mb, device)
        C.free(device)
        for kind, m, kw in (("fp8", mb, dict(precision="fp8")),
                            ("half_batch", mb // 2, dict(rows=torch.tensor(half)))):
            got = train.reference_run(config, traffic, s, batches, n, m, device, **kw)
            rows.append({"seed": s, "kind": kind, **train.compare(got, ref)})
            print(json.dumps(rows[-1]), flush=True)
            C.free(device)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description="readings for the limits of correct")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for k, v in HN.cache_dirs().items():
        os.environ[k] = v
    cell = HN.cell(args.workload)
    kind = cell["traffic"]["kind"]
    fn = serve_readings if kind == "serve" else train_readings
    rows = fn(cell, args.seeds, args.control_seeds, args.seconds, args.device)
    summary = {}
    for r in rows:
        for k, v in r.items():
            if k in ("seed", "kind") or not isinstance(v, (int, float)):
                continue
            key = f"{r['kind']}:{k}"
            lo, hi = summary.get(key, (float("inf"), float("-inf")))
            summary[key] = (min(lo, v), max(hi, v))
    print(json.dumps({"summary": summary, "banned": HN.banned_modules()}), flush=True)


if __name__ == "__main__":
    main()
