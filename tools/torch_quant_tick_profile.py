#!/usr/bin/env python3
"""Time and profile the full-width quantized tick (a): int8 weights and the
int8 condition cache, through ``policy_step``.

    python3 /path/to/tools/torch_quant_tick_profile.py [--ticks N]

Run it from the root of a checkout: it imports that checkout's
``vla_touch_tpu_torch``, and the code that runs the tick (``build_tick``,
``run_tick``, ``profile_tick``) from the ``chip_smoke.py`` beside this
script's own ``tools/``, so two trees of the package can be compared on one
card under the same tick code.  It builds the kernels, builds the seeded tick,
quantizes its RDT-1B runner, warms up with two ticks, times N ticks on the
host clock (each ends in a synchronise), then profiles one more, and prints
one JSON line: p50 and each tick's ms, and the profile (device busy ms,
idle share, host synchronise calls, host to device copies, per-kernel
groups).  Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location("tick_code",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    from vla_touch_tpu_torch.csrc import build
    from vla_touch_tpu_torch.models.rdt import quant_serve as QS

    if not torch.cuda.is_available():
        print("torch_quant_tick_profile: CUDA is not available", file=sys.stderr)
        return 1
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = CS.build_tick(seed=0)
    kw = dict(rdt=QS.quantize_rdt_params(t["model"].rdt, "int8"), kv_cache="int8")
    for _ in range(2):
        CS.run_tick(t, **kw)
    ticks = []
    for _ in range(args.ticks):
        t0 = time.perf_counter()
        CS.run_tick(t, **kw)
        ticks.append(1e3 * (time.perf_counter() - t0))
    prof = CS.profile_tick(t, **kw)
    print(json.dumps(dict(package=os.path.dirname(build.CSRC), gpu=CS.gpu_line(),
                          p50_ms=float(np.median(ticks)), ticks_ms=ticks, profile=prof)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
