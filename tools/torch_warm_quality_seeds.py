#!/usr/bin/env python3
"""The warm-replan quality check (``eval/warm_quality.py``) over several
seeds: how often its four asserts pass, and with what margins.

    python3 tools/torch_warm_quality_seeds.py [--device cuda|cpu]
        [--dtype bfloat16|float32] [--draws host|device]
        [--attention kernel|plain] [seed ...]

``--draws host`` (the check's own) takes every draw from host generators,
so the card and the CPU run one stream; ``--draws device`` takes the
weights, the loss's draws and the solver's noise from the card's
generators.  ``--attention plain`` runs the attention's plain version on
the card in place of K1 (``chip_smoke.plain_kernels``).  On CUDA the
kernels are built first and TF32 is off, as in ``chip_smoke.py``.  Prints
one JSON line per seed (the results, ``passed``, and the first failing
assert) and a last line with the count that passed (~25-40 s a seed on an
H100, 1-4 min on 8 CPU cores in float32).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--draws", default="host", choices=("host", "device"))
    ap.add_argument("--attention", default="kernel", choices=("kernel", "plain"))
    ap.add_argument("seeds", nargs="*", type=int, default=[0])
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, ROOT)
    from vla_touch_tpu_torch.eval import warm_quality as WQ

    plain = contextlib.nullcontext
    if args.device == "cuda":
        import chip_smoke as CS
        from vla_touch_tpu_torch.csrc import build

        build.build_all()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = CS.gpu_line()
        if args.attention == "plain":
            plain = CS.plain_kernels
    else:
        card = "cpu"
    passed = 0
    for seed in args.seeds:
        with plain():
            r = WQ.run(device=args.device, dtype=args.dtype, seed=seed, draws=args.draws)
        try:
            WQ.check(r)
            failed = None
        except AssertionError as e:
            failed = str(e)
        passed += failed is None
        print(json.dumps(dict(seed=seed, device=card, dtype=args.dtype, draws=args.draws,
                              attention=args.attention, passed=failed is None,
                              failed_assert=failed, cold_over_signal=r["cold_mse"] /
                              r["signal_power"], **r)), flush=True)
    print(json.dumps(dict(passed=passed, runs=len(args.seeds), device=card, dtype=args.dtype,
                          draws=args.draws, attention=args.attention)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
