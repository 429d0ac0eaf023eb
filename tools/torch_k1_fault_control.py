#!/usr/bin/env python3
"""Fault controls for the K1 gates of ``chip_smoke.py``: plant a known fault
in a throwaway copy of the K1 source and read what each gate sees.

    python3 tools/torch_k1_fault_control.py [fault ...]

For each entry of ``FAULTS`` named (``none`` is the sound kernel; default:
all) the script copies ``vla_touch_tpu_torch/`` and ``chip_smoke.py`` into
a temporary directory, edits ``csrc/flash_attention.cu`` there, and in a
child process that imports the copy:

1. runs chip_smoke's K1 check at every tick shape and at its check-only
   split-boundary shapes and prints, per shape, the max abs error as a
   share of its tolerance (above 1: the gate misses);
2. runs the full-width cold tick with that kernel and again through the
   plain versions, and prints the stage correlations beside chip_smoke's
   gates;
3. runs chip_smoke's checked tick (every kernel call against its plain
   version on the same operands) and prints the worst call per kernel.

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

# name: (text in csrc/flash_attention.cu, its replacement)
FAULTS = {
    "none": None,
    # the last KV tile, partial at every tick shape but the 64-key language
    # one, is never read
    "drop_last_kv_tile": ("const int n_tiles = (a.Lkv + BK - 1) / BK;",
                          "const int n_tiles = a.Lkv / BK;"),
    # the key mask is ignored (only the RDT language cross-attention has one)
    "ignore_mask": ("return mb == nullptr || __ldg(mb + j) != 0;", "return 1;"),
    # one whole 64-key tile, the second of the middle split (of the only
    # split where there is one), never used
    "drop_full_kv_tile": ("if (!active) continue;",
                          "if (!active || (split == a.n_splits / 2 && t == t0 + 1)) continue;"),
    # the combine leaves out the last split
    "combine_skips_last_split": ("const int n_used = S;", "const int n_used = S - 1;"),
    # the combine sums the splits without rescaling by 2^(m_s - m*)
    "combine_no_rescale": ("const float w = exp2f(a.part_m[i] - m_star);",
                           "const float w = 1.f;"),
}


def child(fault: str) -> None:
    import numpy as np
    import torch

    import chip_smoke as CS
    from vla_touch_tpu_torch.csrc import build
    from vla_touch_tpu_torch.ops import flash_attention as FA

    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    for name, B, Lq, Lkv, H, D, layout, mask_kind, _ in CS.K1_SHAPES:
        q, k, v = CS.k1_operands(gen, B, Lq, Lkv, H, D, layout)
        mask = CS.k1_mask(B, Lq, Lkv, H, mask_kind)
        got = FA.flash_attention(q, k, v, kv_mask=mask).float()
        want = FA.attention_plain(q, k, v, kv_mask=mask).float()
        torch.cuda.synchronize()
        share = float((got - want).abs().max()) / (CS.K1_TOL * float(want.abs().max()))
        try:
            CS.k1_check(name, q, k, v, mask)
            verdict = "pass"
        except AssertionError as e:
            verdict = f"MISS ({e})"
        print(f"{fault}: K1 {name}: err {share:.3f} x tol: {verdict}", flush=True)
    t = CS.build_tick(seed=0)
    out = CS.run_tick(t)
    tok = CS.siglip_tokens(t)
    with CS.plain_kernels():
        out_p = CS.run_tick(t)
        tok_p = CS.siglip_tokens(t)
    corrs = dict(siglip=CS.corr(tok, tok_p),
                 chunk=CS.action_corr(t, out["actions"], out_p["actions"]),
                 dinov2=CS.corr(out["dino"], out_p["dino"]),
                 refined=CS.action_corr(t, out["refined"], out_p["refined"]))
    finite = all(bool(np.all(np.isfinite(out[key]))) for key in ("actions", "refined"))
    print(f"{fault}: tick corr " + json.dumps(corrs) + f" finite {finite}; gates: tokens > "
          f"{CS.TOKEN_CORR_MIN}, chunk > {CS.CHUNK_CORR_MIN}, refined > "
          f"{CS.REFINED_CORR_MIN}", flush=True)
    print(f"{fault}: checked tick (gate: share <= 1) " + json.dumps(CS.checked_tick(t)),
          flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    rc = 0
    for fault in sys.argv[1:] or FAULTS:
        edit = FAULTS[fault]
        tmp = tempfile.mkdtemp(prefix=f"k1_{fault}_")
        try:
            shutil.copytree(os.path.join(ROOT, "vla_touch_tpu_torch"),
                            os.path.join(tmp, "vla_touch_tpu_torch"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp)
            if edit is not None:
                src = os.path.join(tmp, "vla_touch_tpu_torch", "csrc", "flash_attention.cu")
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
