#!/usr/bin/env python3
"""Fault controls for the K2 gates of ``chip_smoke.py``: plant a known fault
in a throwaway copy of the K2 source and read what each gate sees.

    python3 tools/torch_k2_fault_control.py [fault ...]

For each entry of ``FAULTS`` named (``none`` is the sound kernel; default:
all) the script copies ``vla_touch_tpu_torch/`` and ``chip_smoke.py`` into
a temporary directory, edits ``csrc/resblock.cu`` there, and in a child
process that imports the copy:

1. runs K2 against its plain version at the 12 block shapes of a UNet pass
   (``chip_smoke.K2_SHAPES``) and prints, per shape, the max abs error as a
   share of ``K2_TOL`` (above 1: the gate misses), twice (a race may show
   in one call only);
2. runs the full-width cold tick with that kernel and again through the
   plain versions, and prints the refined-action correlation beside
   chip_smoke's gate;
3. runs chip_smoke's checked tick (every kernel call against its plain
   version on the same operands) and prints the worst K2 call: its share of
   ``K2_TICK_TOL`` x max|plain| and, as ``group_share``, of the
   per-channel measure (``K2_GROUP_TOL``).

The checkout itself is never edited.  Needs one NVIDIA GPU.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: (text in csrc/resblock.cu, its replacement)
FAULTS = {
    "none": None,
    # every product's last reduction split never summed
    "drop_one_reduction_split": (
        "for (int z = 1; z < splits; ++z) v += __ldcg(p + z * stride);",
        "for (int z = 1; z < splits - 1; ++z) v += __ldcg(p + z * stride);"),
    # the GroupNorm mean taken from the first split's partials alone (one
    # block's share of the reduction), the normalization applied to the sum
    "gn_stats_from_one_split": (
        "    hv[e] = v;\n    sum += v;",
        "    hv[e] = v;\n    sum += __ldcg(p) + bf(bias + (size_t)s * C + c);"),
    # conv1's items read its operand without the grid barrier that waits
    # for the norm items to have written it
    "missing_grid_barrier": (
        "  grid.sync();\n  product_phase<NM>(a, a.jobs + 3, 1, smem);",
        "  product_phase<NM>(a, a.jobs + 3, 1, smem);"),
    # GroupNorm0 reads conv0's partials without the grid barrier that waits
    # for every block to have written them (a race with a short window)
    "missing_first_grid_barrier": (
        "  grid.sync();\n  norm0_phase(a, smem);", "  norm0_phase(a, smem);"),
    # the FiLM scale and bias never applied
    "film_ignored": (
        "a.h[((size_t)sb * T + t) * C + c] = __float2bfloat16(ex[2 * n + e] * y + ex[3 * n + e]);",
        "a.h[((size_t)sb * T + t) * C + c] = __float2bfloat16(y);"),
}


def child(fault: str) -> None:
    import numpy as np
    import torch

    import chip_smoke as CS
    from vla_touch_tpu_torch.csrc import build
    from vla_touch_tpu_torch.ops import unet_kernels as UK

    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    S, B, G, K = CS.K2_S, 1, CS.K2_G, CS.K2_K
    for name, T, Cin, C in CS.K2_SHAPES:
        x = torch.randn((S, B, T, Cin), generator=gen, device="cuda").to(torch.bfloat16)
        cond = torch.randn((S, B, G), generator=gen, device="cuda").to(torch.bfloat16)
        p = CS.k2_params(gen, S, Cin, C, G, K)
        want = UK.resblock_ref(x, cond, p)
        shares = []
        for _ in range(2):
            got = UK.resblock_fused(x, cond, p)
            torch.cuda.synchronize()
            shares.append(float((got.float() - want).abs().max()) / CS.K2_TOL)
        verdict = "pass" if all(np.isfinite(v) and v <= 1 for v in shares) else "MISS"
        print(f"{fault}: K2 {name}: err {shares[0]:.3f} / {shares[1]:.3f} x tol: {verdict}",
              flush=True)
    t = CS.build_tick(seed=0)
    out = CS.run_tick(t)
    with CS.plain_kernels():
        out_p = CS.run_tick(t)
    c_ref = CS.action_corr(t, out["refined"], out_p["refined"])
    finite = bool(np.all(np.isfinite(out["refined"])))
    print(f"{fault}: tick refined corr {c_ref:.6f} finite {finite}; gate: refined > "
          f"{CS.REFINED_CORR_MIN}", flush=True)
    chk = CS.checked_tick(t)
    print(f"{fault}: checked tick (gate: share <= 1) K2 " + json.dumps(chk["K2"]), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    rc = 0
    for fault in sys.argv[1:] or FAULTS:
        edit = FAULTS[fault]
        tmp = tempfile.mkdtemp(prefix=f"k2_{fault}_")
        try:
            shutil.copytree(os.path.join(ROOT, "vla_touch_tpu_torch"),
                            os.path.join(tmp, "vla_touch_tpu_torch"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp)
            if edit is not None:
                src = os.path.join(tmp, "vla_touch_tpu_torch", "csrc", "resblock.cu")
                text = open(src).read()
                if text.count(edit[0]) != 1:
                    raise RuntimeError(f"{fault}: the text to replace is not in the "
                                       f"source exactly once")
                with open(src, "w") as f:
                    f.write(text.replace(edit[0], edit[1]))
            env = dict(os.environ, PYTHONPATH=tmp)
            r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", fault],
                               cwd=tmp, env=env)
            rc = rc or r.returncode
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
