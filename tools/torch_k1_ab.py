#!/usr/bin/env python3
"""K1 on one card: this tree's kernel against an earlier ``flash_attention.cu``,
its split plans, and the exact GELU's cost.

    python3 tools/torch_k1_ab.py --parent build/parent/flash_attention.cu

``--parent`` names an earlier K1 source with the one-launch C entry
``flash_attention_bf16(q, k, v, mask, out, B, Lq, Lkv, H, D, 9 strides,
m_sb, scale, stream)`` (e.g. ``git show <commit>:vla_touch_tpu_torch/csrc/
flash_attention.cu``, written under the ignored ``build/``).  It is built
with the same nvcc flags beside this tree's kernels.  The script prints one
JSON line per part:

1. ``plans``: this tree's K1 under several plans (rows per CTA, splits,
   tiles per split) at the RDT image cross-attention and at the long-query
   shapes (64- and 128-row q tiles), device time by CUDA-graph replay;
2. ``shapes``: parent and this tree's K1 in turns (parent, new, new,
   parent) at the six tick shapes (``chip_smoke.K1_SHAPES`` with calls and
   the planner's CLIP shape), each checked against the plain version, and
   the per-tick sums;
3. ``ticks``: the full-width bf16 tick (``chip_smoke.run_tick``) with the
   parent's K1 and with this tree's, in turns: p50 of 5 ticks, and one
   profiled tick each (device busy ms, idle share, K1 groups);
4. ``gelu``: ``ops/nn.py::gelu_erf`` against ``F.gelu`` at the tick's two
   exact-GELU sites (``GELU_SITES``: DinoV2-small's MLP, 2 x 730 x 1536
   bf16, 12 calls per tick; BRIDGeR's observation encoder, 1 x 256
   float32, 2 calls): device ms per call, host ms per eager call, kernel
   launches per call, and what ``gelu_erf`` adds per tick.

Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build_parent(src: str):
    from vla_touch_tpu_torch.csrc import build

    text = open(src, "rb").read()
    digest = hashlib.sha256(text + " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:16]
    path = build.BUILD_DIR / f"parent_flash_attention.{digest}.so"
    if not path.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(path), src], check=True)
    lib = ctypes.CDLL(str(path))
    lib.vtt_error_string.argtypes = [_I]
    lib.vtt_error_string.restype = ctypes.c_char_p
    f = lib.flash_attention_bf16
    f.argtypes = [_P] * 5 + [_I] * 5 + [_L] * 10 + [ctypes.c_float, _P]
    f.restype = _I

    def parent_attention(q, k, v, kv_mask=None, scale=None):
        """The parent's K1 behind the wrapper's interface."""
        import torch

        from vla_touch_tpu_torch.ops import flash_attention as FA

        B, Lq, H, D = q.shape
        Lkv = k.shape[1]
        mask_ptr, m_sb = FA.mask_arg("parent K1", kv_mask, B, Lkv, q.device)
        out = torch.empty((B, Lq, H, D), dtype=torch.bfloat16, device=q.device)
        scale = D ** -0.5 if scale is None else float(scale)
        err = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(), B, Lq,
                Lkv, H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], m_sb, scale,
                torch.cuda.current_stream(q.device).cuda_stream)
        build.check(lib, err, "parent flash_attention")
        parent_attention.launches += 1
        return out

    parent_attention.launches = 0
    return parent_attention


def operand_sets(CS, gen, B, Lq, Lkv, H, D, layout):
    n_sets = max(1, min(8, -(-2 * CS.L2_BYTES // (2 * 2 * B * Lkv * H * D))))
    return [CS.k1_operands(gen, B, Lq, Lkv, H, D, layout) for _ in range(n_sets)]


def timed(CS, fn, sets, mask):
    it = [0]

    def run():
        it[0] = (it[0] + 1) % len(sets)
        fn(*sets[it[0]], kv_mask=mask)

    return CS.graph_time_ms(run)


def plans_part(CS, gen):
    from vla_touch_tpu_torch.ops import flash_attention as FA

    out = []

    def plan_set(rows, n_tiles, splits):
        """(rows, splits, tiles per split) for each split count asked."""
        return sorted({(rows, -(-n_tiles // -(-n_tiles // s)), -(-n_tiles // s))
                       for s in splits})

    cases = [("rdt_image_cross", 1, 67, 4374, 32, 64, "cross",
              plan_set(80, 69, (9, 12, 14, 18, 23, 35)))]
    for name, B, Lq, Lkv, H, D, layout, *_ in CS.K1_SHAPES[:2] + CS.K1_CLIP_SHAPES:
        n_tiles = -(-Lkv // FA.BK)
        cases.append((name, B, Lq, Lkv, H, D, layout,
                      plan_set(64, n_tiles, (1, 2, 3, 4, 6)) + plan_set(128, n_tiles, (1, 2, 3, 6))))
    for name, B, Lq, Lkv, H, D, layout, plans in cases:
        sets = operand_sets(CS, gen, B, Lq, Lkv, H, D, layout)
        default = FA.card_plan(B, Lq, Lkv, H, D)
        for plan in plans:
            fn = lambda q, k, v, kv_mask=None, plan=plan: FA._launch(  # noqa: E731
                q, k, v, kv_mask, None, lambda *_: plan)
            want = FA.attention_plain(*sets[0]).float()
            err = float((fn(*sets[0]).float() - want).abs().max())
            ok = err <= CS.K1_TOL * float(want.abs().max())
            out.append(dict(shape=name, plan=plan, default=plan == default, ok=ok,
                            ms=timed(CS, fn, sets, None)))
    return out


def shapes_part(CS, gen, parent):
    from vla_touch_tpu_torch.ops import flash_attention as FA

    rows, tot = [], {"parent": [0.0, 0.0], "new": [0.0, 0.0]}
    for name, B, Lq, Lkv, H, D, layout, mask_kind, calls in CS.K1_SHAPES + CS.K1_CLIP_SHAPES:
        if not calls:
            continue
        sets = operand_sets(CS, gen, B, Lq, Lkv, H, D, layout)
        mask = CS.k1_mask(B, Lq, Lkv, H, mask_kind)
        for fn in (parent, FA.flash_attention):
            CS.hold(f"K1 {name}", fn(*sets[0], kv_mask=mask),
                    FA.attention_plain(*sets[0], kv_mask=mask).float(), CS.K1_TOL, mask)
        ms = {"parent": [], "new": []}
        for who in ("parent", "new", "new", "parent"):
            ms[who].append(timed(CS, parent if who == "parent" else FA.flash_attention,
                                 sets, mask))
        rows.append(dict(shape=name, calls=calls, parent_ms=ms["parent"], new_ms=ms["new"]))
        for who in ms:
            for i in range(2):
                tot[who][i] += calls * ms[who][i]
    return rows, tot


def ticks_part(CS, parent):
    import numpy as np

    t = CS.build_tick(seed=0)
    CS.run_tick(t)
    res = {"parent": [], "new": []}
    for who in ("parent", "new", "new", "parent"):
        ctx = CS.swapped(K1=parent) if who == "parent" else CS.swapped()
        with ctx:
            CS.run_tick(t)
            ticks = []
            for _ in range(5):
                t0 = time.perf_counter()
                CS.run_tick(t)
                ticks.append(1e3 * (time.perf_counter() - t0))
            prof = CS.profile_tick(t)
        res[who].append(dict(p50_ms=float(np.median(ticks)), busy_ms=prof["device_busy_ms"],
                             idle_share=prof["idle_share"],
                             k1_ms=prof["groups_ms"]["K1 flash_fwd_kernel"],
                             k1_combine_ms=prof["groups_ms"]["K1 flash_combine_kernel"],
                             other_ms=prof["groups_ms"]["other"]))
    return res


# (site, shape, dtype name, calls per tick) of the tick's exact GELUs:
# DinoV2-small's MLP activation and BRIDGeR's observation encoder (two GELUs
# at the hidden width, once per refine)
GELU_SITES = (("dinov2_mlp", (2, 730, 1536), "bfloat16", 12),
              ("bridger_se", (1, 256), "float32", 2))


def gelu_part(CS, gen):
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vla_touch_tpu_torch.ops.nn import gelu_erf

    res = {}
    for site, shape, dtype, calls in GELU_SITES:
        x = torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dtype))
        row = dict(shape=list(shape), dtype=dtype, calls=calls)
        for name, fn in (("gelu_erf", gelu_erf), ("F.gelu", F.gelu)):
            dev = CS.graph_time_ms(lambda: fn(x))
            for _ in range(3):
                fn(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn(x)
            host = 1e3 * (time.perf_counter() - t0) / 20
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(x)
                torch.cuda.synchronize()
            launches = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
            row[name] = dict(device_ms=dev, host_ms_per_call=host, launches=launches)
        new, old = row["gelu_erf"], row["F.gelu"]
        row["added_per_tick"] = dict(
            device_ms=calls * (new["device_ms"] - old["device_ms"]),
            host_ms=calls * (new["host_ms_per_call"] - old["host_ms_per_call"]),
            launches=calls * (new["launches"] - old["launches"]))
        res[site] = row
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--parts", default="plans,shapes,ticks,gelu")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_k1_ab: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from vla_touch_tpu_torch.csrc import build

    build.build_all()
    parent = build_parent(args.parent)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    gpu = CS.gpu_line()
    parts = args.parts.split(",")
    if "plans" in parts:
        print(json.dumps(dict(gpu=gpu, plans=plans_part(CS, gen))), flush=True)
    if "shapes" in parts:
        rows, tot = shapes_part(CS, gen, parent)
        print(json.dumps(dict(gpu=gpu, shapes=rows, per_tick_ms=tot)), flush=True)
    if "ticks" in parts:
        print(json.dumps(dict(gpu=gpu, ticks=ticks_part(CS, parent))), flush=True)
    if "gelu" in parts:
        print(json.dumps(dict(gpu=gpu, gelu=gelu_part(CS, gen))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
