#!/usr/bin/env python3
"""K6 (a8w8), K5 (w8a16), K7 (a8w8, large M), K8 (w4a8), K9/K10 (the w4
megakernels) and K2 (the UNet-1D residual block) on one card: this tree's
kernels against an earlier tree's, in turns.

    python3 tools/torch_quant_ab.py --parent-dir build/parent \
        [--parts k6,k5,k7,k8,k8variants,k8cross,k8plans,k2,ttft,plans,phases,mk,tick,decode]

``--parent-dir`` holds an earlier tree's ``a8w8_matmul.cu``,
``w4a8_matmul.cu``, ``int8_mma.cuh``, ``w4_swiglu.cu``, ``w4_postattn.cu``,
``w4_swiglu.cuh``, ``w4_group.cuh``, ``resblock.cu``, ``w8a16_matmul.cu``
and ``a8w8_matmul_large.cu`` (e.g. ``git show
<commit>:vla_touch_tpu_torch/csrc/<file>``, written under the ignored
``build/``), with the C entries of that tree: ``a8w8_matmul(x, x_f32, x_sm,
w, scale, bias, xq, rs, out, M, N, K, mt, wn, splits, stream)``, ``w4a8_matmul(x, x_f32,
x_sm, w4_pack, scale4, bias, xq, rs, out, M, N, K, G, mt, splits, stream)``
(or, in a tree whose K8 has only the warp loop, without ``mt, splits``:
the binding follows the declaration in the parent's source),
``w8a16_matmul(x, w, scale, bias, out, M, N, K, stream)``,
``a8w8_matmul_large(x, x_f32, x_sm, w, scale, bias, xq, rs, out, M, N, K,
stream)``,
``resblock_bf16(x, cond, w0, b0, g0w, g0b, fw, fb, w1, b1, g1w, g1b, wr, br,
h0, film, h1, res, out, S, B, T, Cin, C, G, K, n_groups, eps, stream)`` (three
launches over four float32 scratch tensors), and ``w4_swiglu_mlp`` /
``w4_postattn_fused`` as this tree's (the argument lists of their wrappers
in ``ops/w4_fused.py``).  They are built with the same nvcc flags beside
this tree's kernels.  Device times are CUDA-graph replays
(``chip_smoke.graph_time_ms``), each version timed in turns (parent, new,
new, parent).  One JSON line per part:

1. ``k6``: every K6 shape of the tick (``chip_smoke.QMM_SHAPES``) and of
   the planner's int8 request (``K6_LLM_SHAPES``), both versions bit-exact
   against the plain version, the time of each, this tree's plan, and the
   quantize launch alone (identical in both trees), so that the parent's
   GEMM launch is its time less the quantize; sums per tick;
2. ``k8``: K8 at every shape of the tick (``chip_smoke.QMM_SHAPES``) and of
   the planner's prompt passes (the ``K8_LLM_SHAPES`` rows at M = 72 and
   442), both versions against the plain version and timed, this tree's
   plan; sums per tick and per prompt pass;
3. ``k8variants``: this tree's K8 tile body and its cut variants
   (``K8_VARIANTS``: no fold, ring or compute alone, I2F, half the folds,
   other stage widths and depths) at ``K8_VARIANT_SHAPES``, for timing;
   ``k8cross``: this tree's K8 under the warp loop and under tile plans
   at the prompt-pass products for M from 72 to 442 (``K8_CROSS_MS``);
   ``k8plans``: this tree's K8 under the warp loop and each tile plan at the
   tick's two main shapes and the 72- and 442-token prompt passes' widest
   and deepest products, against the plain version and timed;
4. ``k2``: K2 at the 12 block shapes of a UNet pass (``chip_smoke.
   K2_SHAPES``), both versions against the plain version (max abs error,
   ``K2_TOL``) and timed on rotating weight sets, this tree's plan, and
   this tree's K2 cut before phase 1 and after phases 1-3 (``K2_CUTS``,
   copies that return there), with its barriers alone
   (``K2_BARRIERS_ONLY``) and its variants (``K2_VARIANTS``); sums per tick
   (x 10 SDE steps);
5. ``ttft``: the full-width planner (``chip_smoke.build_planner``), the
   time to first token of the 24-token ask and of a 430-token prompt on the
   fused tree with MEGAKERNELS (host clock, median of 3), with the parent's
   K8 and with this tree's, in turns, and one profiled 430-token prompt
   pass each (K8's device ms);
6. ``plans``: this tree's K6 under other plans (mt, wn, splits) at the
   tick's two main shapes and the planner's down and o projections;
7. ``phases``: this tree's K6 at one K chunk beside its quantize launch
   (what a call costs beside its data) and this tree's K10 cut after each
   phase (a copy that returns there, built under ``build/``);
8. ``mk``: K9 at M = 1, 8, 24 and K10 at M = 1, 8 at Qwen2.5-7B width,
   both versions against the plain version (``chip_smoke.mk_check``) and
   timed; the parent's K10 cut after each of its phases (a variant that
   returns there), which times the phases, and its grid;
9. ``tick``: quantized tick (a) with the parent's K6, this tree's, and this
   tree's built without the programmatic dependent launch (a copy whose
   GEMM waits for the whole quantize launch, ``NO_PDL``), in turns: the
   profiled device busy ms as the sum of kernel durations and as the union
   of kernel spans, the union of the quantize and GEMM spans, the idle
   share and the kernel groups;
10. ``decode``: the full-width planner, a 16-token greedy decode of the
   24-token ask on the fused tree with MEGAKERNELS, ms per token (host
   clock, median of 3) with the parent's K9/K10 and with this tree's, in
   turns, and one profiled decode each;
11. ``k5``: K5 at every ``chip_smoke.K5_SHAPES`` row, both versions
   against the plain version and timed (this tree's also built without the
   cluster barrier begun at its start), this tree's plan, ``F.linear`` on
   bf16 weights; sums per tick (870 shadow calls);
12. ``k7``: K7 at every ``chip_smoke.K7_SHAPES`` row, both versions' bf16
   outputs unlike the plain version's, timed (this tree's also built
   without the programmatic dependent launch), this tree's tile, the
   quantize launch alone (a copy of this tree's ``a8w8_matmul_large.cu``
   with an extra C entry; both trees run the same quantize launch) and
   ``torch._int_mm``: each GEMM is its time less the quantize; sums per
   (f) chunk (16 calls).

Needs one NVIDIA GPU.  No module of the package imports this script.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PARENT_FILES = ("a8w8_matmul.cu", "w4a8_matmul.cu", "int8_mma.cuh", "w4_swiglu.cu",
                "w4_postattn.cu", "w4_swiglu.cuh", "w4_group.cuh", "resblock.cu",
                "w8a16_matmul.cu", "a8w8_matmul_large.cu")

# the parent's K10 cut after phase 1 (o), 2 (norm, gate|up) and 3 (the
# activation's codes): text in the parent's w4_postattn.cu and its stand-in
K10_CUTS = {
    "o": ("  grid.sync();\n  // h's codes", "  return;\n  grid.sync();\n  // h's codes"),
    "gate_up": ("a.act, a.amax, red_g, red_u);\n  grid.sync();",
                "a.act, a.amax, red_g, red_u);\n  return;\n  grid.sync();"),
    "act_codes": ("quantize_act_phase(a.act, a.amax, M, a.F, a.aq);\n  grid.sync();",
                  "quantize_act_phase(a.act, a.amax, M, a.F, a.aq);\n  return;\n  grid.sync();"),
}
# appended to the parent's K10: the grid megakernel_grid gives it
K10_GRID_ENTRY = """
extern "C" int parent_postattn_grid(int M, int K, int* grid) {
  const int MT = megakernel_mt(M);
  const void* fn =
      MT == 1 ? (const void*)w4_postattn_kernel<1> : (const void*)w4_postattn_kernel<2>;
  return (int)megakernel_grid(fn, megakernel_smem(MT, K), grid);
}
"""


def build_lib(src_dir: str, name: str, text: str | None = None, tag: str = "") -> ctypes.CDLL:
    """Build ``src_dir/<name>.cu`` (or ``text`` as that file, beside it)
    into the kernels' build directory; the library."""
    from vla_touch_tpu_torch.csrc import build

    src = os.path.join(src_dir, f"{name}.cu")
    if text is not None:
        src = os.path.join(src_dir, f"{name}{tag}.cu")
        with open(src, "w") as f:
            f.write(text)
    blob = open(src, "rb").read() + b"".join(
        open(os.path.join(src_dir, h), "rb").read() for h in PARENT_FILES if h.endswith(".cuh"))
    digest = hashlib.sha256(blob + " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:16]
    path = build.BUILD_DIR / f"parent_{name}{tag}.{digest}.so"
    if not path.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(path), src], check=True)
    lib = ctypes.CDLL(str(path))
    lib.vtt_error_string.argtypes = [_I]
    lib.vtt_error_string.restype = ctypes.c_char_p
    return lib


def k8_entry_takes_plan(source: str) -> bool:
    """Whether a ``w4a8_matmul.cu``'s C entry takes K8's plan (``mt``,
    ``splits`` after ``G``, as a K8 with a tile body does) or ends at ``G,
    stream`` (a K8 with only the warp loop), read off the entry's
    declaration in ``source``."""
    m = re.search(r'extern "C" int w4a8_matmul\(([^)]*)\)', source)
    if m is None:
        raise ValueError("the source declares no w4a8_matmul C entry")
    names = [a.split()[-1].lstrip("*") for a in m.group(1).split(",")]
    if names[-3:] == ["mt", "splits", "stream"]:
        return True
    if names[-2:] == ["G", "stream"]:
        return False
    raise ValueError(f"w4a8_matmul takes ({m.group(1)}): neither known signature")


def parent_k8(lib, source: str):
    """The parent's K8 behind the wrapper's interface.  ``source``: the
    parent's ``w4a8_matmul.cu``, whose entry's signature decides the
    binding: with a plan (``mt``, ``splits``) it runs under this tree's
    ``k8_plan``, as the parent K6 runs under ``k6_plan``."""
    import torch

    from vla_touch_tpu_torch.csrc import build
    from vla_touch_tpu_torch.ops import quant_matmul as QM
    from vla_touch_tpu_torch.utils.device import sm_count

    takes_plan = k8_entry_takes_plan(source)
    f = lib.w4a8_matmul
    f.argtypes = [_P, _I, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I] + (
        [_I, _I] if takes_plan else []) + [_P]
    f.restype = _I

    def w4a8(x, w4_pack, scale4, bias=None):
        *lead, K = x.shape
        x2 = x.reshape(-1, K)
        M, N, G = x2.shape[0], w4_pack.shape[0], scale4.shape[0]
        out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
        xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
        rs = torch.empty((M,), dtype=torch.float32, device=x.device)
        plan = QM.k8_plan(M, N, K, G, sm_count(x.device.index)) if takes_plan else ()
        err = f(x2.data_ptr(), int(x2.dtype == torch.float32), x2.stride(0), w4_pack.data_ptr(),
                scale4.data_ptr(), None if bias is None else bias.data_ptr(), xq.data_ptr(),
                rs.data_ptr(), out.data_ptr(), M, N, K, G, *plan,
                torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, err, "parent w4a8_matmul")
        w4a8.launches += 1
        return out.reshape(*lead, N)

    w4a8.launches = 0
    w4a8.takes_plan = takes_plan
    return w4a8


def parent_k5(lib):
    """The parent's K5 (``w8a16_matmul(x, w, scale, bias, out, M, N, K,
    stream)``, bf16 x contiguous) behind the wrapper's interface."""
    import torch

    from vla_touch_tpu_torch.csrc import build

    f = lib.w8a16_matmul
    f.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
    f.restype = _I

    def w8a16(x, w_i8, scale, bias=None):
        *lead, K = x.shape
        x2 = x.reshape(-1, K).to(torch.bfloat16).contiguous()
        M, N = x2.shape[0], w_i8.shape[0]
        out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
        err = f(x2.data_ptr(), w_i8.data_ptr(), scale.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(), M, N, K,
                torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, err, "parent w8a16_matmul")
        return out.reshape(*lead, N)

    return w8a16


def parent_k7(lib):
    """The parent's K7 (``a8w8_matmul_large(x, x_f32, x_sm, w, scale, bias,
    xq, rs, out, M, N, K, stream)``) behind the wrapper's interface."""
    import torch

    from vla_touch_tpu_torch.csrc import build

    f = lib.a8w8_matmul_large
    f.argtypes = [_P, _I, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
    f.restype = _I

    def large(x, w_i8, scale, bias=None):
        *lead, K = x.shape
        x2 = x.reshape(-1, K)
        M, N = x2.shape[0], w_i8.shape[0]
        out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
        xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
        rs = torch.empty((M,), dtype=torch.float32, device=x.device)
        err = f(x2.data_ptr(), int(x2.dtype == torch.float32), x2.stride(0), w_i8.data_ptr(),
                scale.data_ptr(), None if bias is None else bias.data_ptr(), xq.data_ptr(),
                rs.data_ptr(), out.data_ptr(), M, N, K,
                torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, err, "parent a8w8_matmul_large")
        return out.reshape(*lead, N)

    return large


# appended to a copy of this tree's a8w8_matmul.cu: the quantize launch alone
QUANTIZE_ENTRY = """
extern "C" int a8w8_quantize(const void* x, int x_f32, long long x_sm, void* xq, void* rs,
                             int M, int K, void* stream) {
  return (int)quantize_rows(x, x_f32, x_sm, M, K, (int8_t*)xq, (float*)rs,
                            (cudaStream_t)stream);
}
"""
# this tree's K6 without the programmatic dependent launch: the GEMM starts
# only when the quantize launch has ended
NO_PDL = [("quantize_rows<true>(", "quantize_rows<false>("),
          ("programmaticStreamSerializationAllowed = 1;",
           "programmaticStreamSerializationAllowed = 0;")]


def quantize_only(source: str = "a8w8_matmul"):
    """This tree's quantize launch alone (the one K6's, or with ``source``
    ``a8w8_matmul_large`` K7's, trees both run), from a copy of
    ``csrc/<source>.cu`` with an extra C entry."""
    import torch

    from vla_touch_tpu_torch.csrc import build

    lib = build_cut(source, [], "quantize", QUANTIZE_ENTRY)
    f = lib.a8w8_quantize
    f.argtypes = [_P, _I, _L, _P, _P, _I, _I, _P]
    f.restype = _I

    def run(x, xq, rs):
        err = f(x.data_ptr(), int(x.dtype == torch.float32), x.stride(0), xq.data_ptr(),
                rs.data_ptr(), x.shape[0], x.shape[1],
                torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, err, "a8w8_quantize")

    return run


def k6_of(lib, tree: str = "cut"):
    """K6 of a library built from an a8w8_matmul.cu whose entry takes a
    plan (a cut copy of this tree's, or ``tree`` "parent": an earlier
    tree's) behind the wrapper's interface, under ``k6_plan``'s plan."""
    import torch

    from vla_touch_tpu_torch.csrc import build
    from vla_touch_tpu_torch.ops import quant_matmul as QM
    from vla_touch_tpu_torch.utils.device import sm_count

    f = lib.a8w8_matmul
    f.argtypes = [_P, _I, _L, _P, _P, _P, _P, _P, _P] + [_I] * 6 + [_P]
    f.restype = _I

    def a8w8(x, w_i8, scale, bias=None):
        *lead, K = x.shape
        x2 = x.reshape(-1, K)
        M, N = x2.shape[0], w_i8.shape[0]
        out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
        xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
        rs = torch.empty((M,), dtype=torch.float32, device=x.device)
        err = f(x2.data_ptr(), int(x2.dtype == torch.float32), x2.stride(0), w_i8.data_ptr(),
                scale.data_ptr(), None if bias is None else bias.data_ptr(), xq.data_ptr(),
                rs.data_ptr(), out.data_ptr(), M, N, K, *QM.k6_plan(M, N, K, sm_count(0)),
                torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, err, f"{tree} a8w8_matmul")
        a8w8.launches += 1
        return out.reshape(*lead, N)

    a8w8.launches = 0
    return a8w8


def mk_wrappers(lib9, lib10, tree: str = "parent"):
    """K9 and K10 of libraries built from ``tree``'s sources (both trees'
    C entries take the same arguments) behind the wrappers' interfaces (the
    shapes the megakernels take; the tool calls them only there).  Returns
    (K9, K10 of a library, a maker of K10 for another library of the same
    tree)."""
    import torch

    from vla_touch_tpu_torch.csrc import build
    from vla_touch_tpu_torch.ops import w4_fused as W4F

    if lib9 is not None:
        f9 = lib9.w4_swiglu_mlp
        f9.argtypes = [_P] * 11 + [_I] * 6 + [_P]
        f9.restype = _I

    def k9(x, gu, down):
        *lead, K = x.shape
        x2 = x.reshape(-1, K).to(torch.bfloat16).contiguous()
        M, F, N, dev = x2.shape[0], gu.w4_pack.shape[0] // 2, down.w4_pack.shape[0], x.device
        gw, gs, gb = W4F._leaf_args("K9", gu, dev)
        dw, ds, db = W4F._leaf_args("K9", down, dev)
        act = torch.empty((M, F), dtype=torch.bfloat16, device=dev)
        aq = torch.empty((M, F), dtype=torch.int8, device=dev)
        amax = torch.empty((M,), dtype=torch.int32, device=dev)
        out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
        err = f9(x2.data_ptr(), gw, gs, gb, dw, ds, db, act.data_ptr(), aq.data_ptr(),
                 amax.data_ptr(), out.data_ptr(), M, K, F, N, gu.scale4.shape[0],
                 down.scale4.shape[0], torch.cuda.current_stream(dev).cuda_stream)
        build.check(lib9, err, f"{tree} w4_swiglu_mlp")
        k9.launches += 1
        return out.reshape(*lead, N)

    def k10_with(lib):
        f = lib.w4_postattn_fused
        f.argtypes = [_P] * 17 + [_I] * 7 + [ctypes.c_float, _P]
        f.restype = _I

        def k10(x, att, o, gu, down, norm_w, eps=1e-6):
            *lead, Ka = att.shape
            D = x.shape[-1]
            xr = x.reshape(-1, D).to(torch.bfloat16).contiguous()
            ar = att.reshape(-1, Ka).to(torch.bfloat16).contiguous()
            M, F, dev = xr.shape[0], gu.w4_pack.shape[0] // 2, x.device
            ow, os_, ob = W4F._leaf_args("K10", o, dev)
            gw, gs, gb = W4F._leaf_args("K10", gu, dev)
            dw, ds, db = W4F._leaf_args("K10", down, dev)
            x2 = torch.empty((M, D), dtype=torch.bfloat16, device=dev)
            act = torch.empty((M, F), dtype=torch.bfloat16, device=dev)
            aq = torch.empty((M, F), dtype=torch.int8, device=dev)
            amax = torch.empty((M,), dtype=torch.int32, device=dev)
            out = torch.empty((M, D), dtype=torch.bfloat16, device=dev)
            err = f(xr.data_ptr(), ar.data_ptr(), ow, os_, ob, norm_w.data_ptr(), gw, gs, gb,
                    dw, ds, db, x2.data_ptr(), act.data_ptr(), aq.data_ptr(), amax.data_ptr(),
                    out.data_ptr(), M, Ka, D, F, o.scale4.shape[0], gu.scale4.shape[0],
                    down.scale4.shape[0], float(eps), torch.cuda.current_stream(dev).cuda_stream)
            build.check(lib, err, f"{tree} w4_postattn_fused")
            k10.launches += 1
            return out.reshape(*lead, D)

        k10.launches = 0
        return k10

    k9.launches = 0
    return k9, k10_with(lib10), k10_with


def weight_sets(CS, gen, wts):
    """Distinct int8 weight sets, >= 2x the L2 cache in all, as
    ``chip_smoke.check_qmm`` times them."""
    import torch

    wbytes = wts[0].numel() + 4 * wts[1].numel()
    n_sets = max(1, min(64, -(-2 * CS.L2_BYTES // wbytes)))
    return [tuple(torch.randint(-127, 128, w.shape, generator=gen, device="cuda",
                                dtype=torch.int8) if w.dtype == torch.int8 else w.clone()
                  for w in wts) for _ in range(n_sets)]


def timed_sets(CS, fn, x, sets):
    it = [0]

    def run():
        it[0] = (it[0] + 1) % len(sets)
        fn(x, *sets[it[0]])

    return CS.graph_time_ms(run)


def k6_part(CS, gen, parent):
    import torch

    from vla_touch_tpu_torch.ops import quant_matmul as QM

    quant = quantize_only()
    rows, tot = [], {"parent": [0.0, 0.0], "new": [0.0, 0.0], "quantize": 0.0}
    for where, shapes in (("tick", CS.QMM_SHAPES), ("planner", CS.K6_LLM_SHAPES)):
        for M, K, N, calls in shapes:
            x, wts, _, _, _ = CS.qmm_check(gen, "K6", M, K, N)
            want = QM.a8w8_plain(x, *wts, out_dtype=torch.float32).to(torch.bfloat16)
            unlike = int((parent(x, *wts) != want).sum())
            sets = weight_sets(CS, gen, wts)
            ms = {"parent": [], "new": []}
            for who in ("parent", "new", "new", "parent"):
                ms[who].append(timed_sets(CS, parent if who == "parent" else QM.a8w8_matmul,
                                          x, sets))
            xq = torch.empty((M, K), dtype=torch.int8, device="cuda")
            rs = torch.empty((M,), dtype=torch.float32, device="cuda")
            q_ms = CS.graph_time_ms(lambda: quant(x, xq, rs))
            rows.append(dict(where=where, M=M, K=K, N=N, calls=calls,
                             plan=CS.k6_card_plan(M, K, N), parent_unlike=unlike,
                             parent_ms=ms["parent"], new_ms=ms["new"], quantize_ms=q_ms,
                             parent_gemm_ms=[p - q_ms for p in ms["parent"]]))
            if where == "tick":
                for who in ("parent", "new"):
                    for i in range(2):
                        tot[who][i] += calls * ms[who][i]
                tot["quantize"] += calls * q_ms
    return rows, tot


def library_ms(CS, kernel, x, sets):
    """``chip_smoke.qmm_library``'s yardstick of K5 or K7 on rotating sets."""
    lib = CS.qmm_library(kernel, x, sets)
    it = [0]

    def run():
        it[0] = (it[0] + 1) % len(sets)
        lib(it[0])

    return CS.graph_time_ms(run)


# K5 without the cluster barrier its split CTAs begin at the start and
# wait on before their first store into a peer (a variant for timing only:
# it stores into peers that may not have started)
K5_NO_START_BARRIER = [("  if (a.splits > 1) cluster_arrive_relaxed();\n", ""),
                       ("  if (S > 1) cluster_wait();                        "
                        "// every peer has started\n", "")]


def k5_of(lib):
    """K5 of a library built from a cut copy of this tree's
    w8a16_matmul.cu behind the wrapper's interface, under k5_card_plan's
    plan."""
    import torch

    from vla_touch_tpu_torch.csrc import build
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    f = lib.w8a16_matmul
    f.argtypes = [_P, _P, _P, _P, _P] + [_I] * 6 + [_P]
    f.restype = _I

    def w8a16(x, w_i8, scale, bias=None):
        M, K = x.shape
        N = w_i8.shape[0]
        out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
        err = f(x.data_ptr(), w_i8.data_ptr(), scale.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(), M, N, K,
                *QM.k5_card_plan(M, N, K, x.device),
                torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, err, "cut w8a16_matmul")
        return out

    return w8a16


def k5_part(CS, gen, parent):
    """K5 at every chip_smoke.K5_SHAPES row: both versions against the plain
    version (max abs error as a share of QMM_TOL x max|plain|), timed in
    turns on rotating weight sets with this tree's built without the
    cluster barrier begun at its start (``K5_NO_START_BARRIER``), this
    tree's plan, ``F.linear`` on bf16 weights; sums per tick (the 870
    shadow calls)."""
    import torch

    from vla_touch_tpu_torch.ops import quant_matmul as QM

    no_barrier = k5_of(build_cut("w8a16_matmul", K5_NO_START_BARRIER, "no_start_barrier"))
    rows = []
    tot = {"parent": [0.0, 0.0], "new": [0.0, 0.0], "no_start_barrier": [0.0, 0.0],
           "F.linear": 0.0}
    for M, K, N, calls in CS.K5_SHAPES:
        x, wts, err, tol, _ = CS.qmm_check(gen, "K5", M, K, N)
        want = QM.w8a16_plain(x, *wts, out_dtype=torch.float32)
        perr = float((parent(x, *wts).float() - want).abs().max())
        sets = weight_sets(CS, gen, wts)
        ms = {"parent": [], "new": [], "no_start_barrier": []}
        fns = {"parent": parent, "new": QM.w8a16_matmul, "no_start_barrier": no_barrier}
        for who in ("parent", "new", "no_start_barrier", "no_start_barrier", "new", "parent"):
            ms[who].append(timed_sets(CS, fns[who], x, sets))
        lib = library_ms(CS, "K5", x, sets)
        del sets
        rows.append(dict(M=M, K=K, N=N, calls=calls, plan=CS.card_plan("K5", M, K, N, wts[1]),
                         new_share=err / tol, parent_share=perr / tol, parent_ms=ms["parent"],
                         new_ms=ms["new"], no_start_barrier_ms=ms["no_start_barrier"],
                         f_linear_ms=lib))
        for who in ("parent", "new", "no_start_barrier"):
            for i in range(2):
                tot[who][i] += calls * ms[who][i]
        tot["F.linear"] += calls * lib
    return rows, tot


def k7_of(lib):
    """K7 of a library built from a cut copy of this tree's
    a8w8_matmul_large.cu behind the wrapper's interface."""
    import torch

    from vla_touch_tpu_torch.csrc import build

    f = lib.a8w8_matmul_large
    f.argtypes = [_P, _I, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
    f.restype = _I

    def large(x, w_i8, scale, bias=None):
        M, K = x.shape
        N = w_i8.shape[0]
        out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
        xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
        rs = torch.empty((M,), dtype=torch.float32, device=x.device)
        err = f(x.data_ptr(), int(x.dtype == torch.float32), x.stride(0), w_i8.data_ptr(),
                scale.data_ptr(), None if bias is None else bias.data_ptr(), xq.data_ptr(),
                rs.data_ptr(), out.data_ptr(), M, N, K,
                torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, err, "cut a8w8_matmul_large")
        return out

    return large


def k7_part(CS, gen, parent):
    """K7 at every chip_smoke.K7_SHAPES row: both versions' bf16 outputs
    unlike the plain version's (must be 0), timed in turns on rotating
    weight sets with this tree's built without the programmatic dependent
    launch (``NO_PDL``); the quantize launch alone (the
    one both trees run, ``quantize_only``), so that each GEMM is its time
    less the quantize, beside ``torch._int_mm`` (the GEMM alone); sums per
    (f) chunk (16 calls)."""
    import torch

    from vla_touch_tpu_torch.ops import quant_matmul as QM

    quant = quantize_only("a8w8_matmul_large")
    no_pdl = k7_of(build_cut("a8w8_matmul_large", NO_PDL, "no_pdl"))
    rows = []
    tot = {"parent": [0.0, 0.0], "new": [0.0, 0.0], "no_pdl": [0.0, 0.0], "quantize": 0.0,
           "int_mm": 0.0}
    for M, K, N, calls in CS.K7_SHAPES:
        x, wts, _, _, unlike = CS.qmm_check(gen, "K7", M, K, N)
        want = QM.a8w8_large_plain(x, *wts, out_dtype=torch.float32).to(torch.bfloat16)
        punlike = int((parent(x, *wts) != want).sum())
        sets = weight_sets(CS, gen, wts)
        ms = {"parent": [], "new": [], "no_pdl": []}
        fns = {"parent": parent, "new": QM.a8w8_matmul_large, "no_pdl": no_pdl}
        for who in ("parent", "new", "no_pdl", "no_pdl", "new", "parent"):
            ms[who].append(timed_sets(CS, fns[who], x, sets))
        xq = torch.empty((M, K), dtype=torch.int8, device="cuda")
        rs = torch.empty((M,), dtype=torch.float32, device="cuda")
        q_ms = CS.graph_time_ms(lambda: quant(x, xq, rs))
        lib = library_ms(CS, "K7", x, sets)
        del sets
        rows.append(dict(M=M, K=K, N=N, calls=calls, tile=CS.card_plan("K7", M, K, N, wts[1]),
                         new_unlike=unlike, parent_unlike=punlike, parent_ms=ms["parent"],
                         new_ms=ms["new"], no_pdl_ms=ms["no_pdl"], quantize_ms=q_ms,
                         int_mm_ms=lib,
                         new_gemm_ms=[t - q_ms for t in ms["new"]],
                         parent_gemm_ms=[t - q_ms for t in ms["parent"]]))
        for who in ("parent", "new", "no_pdl"):
            for i in range(2):
                tot[who][i] += calls * ms[who][i]
        tot["quantize"] += calls * q_ms
        tot["int_mm"] += calls * lib
    return rows, tot


def k8_part(CS, gen, parent):
    import torch

    from vla_touch_tpu_torch.ops import quant_matmul as QM

    prompt = [r for r in CS.K8_LLM_SHAPES if r[0] in CS.K8_PROMPT_MS]
    rows = []
    tot = {"tick": {"parent": [0.0, 0.0], "new": [0.0, 0.0]}}
    tot.update({f"prompt_{M}": {"parent": [0.0, 0.0], "new": [0.0, 0.0]}
                for M in CS.K8_PROMPT_MS})
    for where, shapes in (("tick", CS.QMM_SHAPES), ("prompt", prompt)):
        for M, K, N, calls in shapes:
            x, wts, err, tol, _ = CS.qmm_check(gen, "K8", M, K, N)
            want = QM.w4a8_plain(x, *wts, out_dtype=torch.float32)
            perr = float((parent(x, *wts).float() - want).abs().max())
            sets = weight_sets(CS, gen, wts)
            ms = {"parent": [], "new": []}
            for who in ("parent", "new", "new", "parent"):
                ms[who].append(timed_sets(CS, parent if who == "parent" else QM.w4a8_matmul,
                                          x, sets))
            del sets
            rows.append(dict(where=where, M=M, K=K, N=N, calls=calls, tol=tol, new_err=err,
                             parent_err=perr, plan=CS.k8_card_plan(M, K, N, wts[1].shape[0]),
                             parent_ms=ms["parent"], new_ms=ms["new"]))
            key = "tick" if where == "tick" else f"prompt_{M}"
            for who in ("parent", "new"):
                for i in range(2):
                    tot[key][who][i] += calls * ms[who][i]
    return rows, tot


# (M, K, N) the k8plans part times every tile plan at
K8_PLAN_SHAPES = ((67, 2048, 2048), (67, 2048, 6144), (72, 3584, 37888), (72, 18944, 3584),
                  (442, 3584, 37888), (442, 18944, 3584))


# (M, (K, N) ...) of the k8cross part: the planner's prompt-pass products
# at prompt lengths between the tick's and the 442-token pass
K8_CROSS_MS = (72, 96, 128, 192, 256, 320, 442)
K8_CROSS_KN = ((3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584))
K8_CROSS_PLANS = ((0, 1), (2, 1), (2, 2), (2, 4))


def k8_cross_part(CS, gen):
    """This tree's K8 under the warp loop (plan (0, 1)) and the tile body
    (mt 2, 1, 2 and 4 splits) at the prompt-pass products for M in
    K8_CROSS_MS: where the tile body overtakes the warp loop."""
    import torch

    from vla_touch_tpu_torch.ops import quant_matmul as QM

    out = []
    for M in K8_CROSS_MS:
        for K, N in K8_CROSS_KN:
            x, wts, _, tol, _ = CS.qmm_check(gen, "K8", M, K, N)
            want = QM.w4a8_plain(x, *wts, out_dtype=torch.float32)
            sets = weight_sets(CS, gen, wts)
            row = dict(M=M, K=K, N=N, default=CS.k8_card_plan(M, K, N, wts[1].shape[0]),
                       tol=tol, ms={}, err={})
            for plan in K8_CROSS_PLANS:
                fn = lambda x, *w, plan=plan: QM._w4a8_launch(x, *w, plan)  # noqa: E731
                row["err"][str(plan)] = float((fn(x, *wts).float() - want).abs().max())
                row["ms"][str(plan)] = timed_sets(CS, fn, x, sets)
            out.append(row)
            del sets
    return out


def k8_plans_part(CS, gen):
    import torch

    from vla_touch_tpu_torch.ops import quant_matmul as QM

    out = []
    for M, K, N in K8_PLAN_SHAPES:
        x, wts, _, tol, _ = CS.qmm_check(gen, "K8", M, K, N)
        want = QM.w4a8_plain(x, *wts, out_dtype=torch.float32)
        sets = weight_sets(CS, gen, wts)
        G = wts[1].shape[0]
        default = CS.k8_card_plan(M, K, N, G)
        for plan in ((0, 1),) + tuple((QM.K8_TILE_MT, s) for s in (1, 2, 4, 8)):
            fn = lambda x, *w, plan=plan: QM._w4a8_launch(x, *w, plan)  # noqa: E731
            err = float((fn(x, *wts).float() - want).abs().max())
            out.append(dict(M=M, K=K, N=N, plan=plan, default=plan == default, err=err,
                            tol=tol, ms=timed_sets(CS, fn, x, sets)))
        del sets
    return out


# this tree's K2 cut before phase 1 (the launch alone) and after phases 1,
# 2 and 3: text in resblock.cu and its stand-in
K2_CUTS = {
    "launch": ("  product_phase<NM>(a, a.jobs, a.n1, smem);",
               "  return;\n  product_phase<NM>(a, a.jobs, a.n1, smem);"),
    "products0": ("  grid.sync();\n  norm0_phase(a, smem);",
                  "  return;\n  grid.sync();\n  norm0_phase(a, smem);"),
    "norm0": ("  grid.sync();\n  product_phase<NM>(a, a.jobs + 3, 1, smem);",
              "  return;\n  grid.sync();\n  product_phase<NM>(a, a.jobs + 3, 1, smem);"),
    "conv1": ("  grid.sync();\n  out_phase(a, smem);",
              "  return;\n  grid.sync();\n  out_phase(a, smem);"),
}
# this tree's K2 with no phase but its grid barriers (a list of cuts)
K2_BARRIERS_ONLY = [
    ("  product_phase<NM>(a, a.jobs, a.n1, smem);              // conv0, film, residual\n", ""),
    ("  norm0_phase(a, smem);                                  // GN0, Mish, FiLM -> h\n", ""),
    ("  product_phase<NM>(a, a.jobs + 3, 1, smem);             // conv1\n", ""),
    ("  out_phase(a, smem);                                    // GN1, Mish, + residual\n", ""),
]


# variants of this tree's K2 (lists of cuts of resblock.cu): a 5-slot ring,
# which puts all of a 4-slot item's weights in flight at once; and, for
# timing only, its input staging without loads and its steps without mma
K2_VARIANTS = {
    "stages_5": [("constexpr int STAGES = 4;", "constexpr int STAGES = 5;")],
    # for timing only: no load in the input staging (zeros), no mma
    "no_a_loads": [("v = jb.src == SRC_H ? ld_bf16_l2(p) : bf(p);", "v = 0.f * (float)(size_t)p;")],
    "no_mma": [("        mma_bf16(acc[m], af, bfr);",
                "        acc[m][0] += __uint_as_float(af[0] ^ bfr[0]);")],
}


def k2_with(lib):
    """K2 of a library built from a resblock.cu with this tree's C interface
    (a cut copy of this tree's, or the parent's since one cooperative
    launch) behind the wrapper's interface, under k2_plan's plan."""
    import torch

    from vla_touch_tpu_torch.csrc import build
    from vla_touch_tpu_torch.ops import unet_kernels as UK

    f = lib.resblock_bf16
    f.argtypes = [_P] * 15 + [ctypes.c_longlong, _P] + [_I] * 8 + [ctypes.c_float] \
        + [_I] * 4 + [_P]
    f.restype = _I

    def k2(x, cond, p, *, n_groups=8, eps=1e-5):
        S, B, T, Cin = x.shape
        k, C, G = p["w0"].shape[1], p["w0"].shape[-1], cond.shape[-1]
        has_res = "wr" in p
        plan = UK.k2_plan(Cin, C, G, k, S, UK._ctas(0, T, Cin, C, G, k, n_groups), has_res)
        nbytes = UK.k2_scratch_bytes(S, B, T, C, plan)
        scratch = torch.empty((nbytes,), dtype=torch.uint8, device=x.device)
        out = torch.empty((S, B, T, C), dtype=torch.bfloat16, device=x.device)
        err = f(x.data_ptr(), cond.data_ptr(), *(p[n].data_ptr() for n in (
                    "w0", "b0", "g0w", "g0b", "fw", "fb", "w1", "b1", "g1w", "g1b")),
                p["wr"].data_ptr() if has_res else None, p["br"].data_ptr() if has_res else None,
                scratch.data_ptr(), nbytes, out.data_ptr(), S, B, T, Cin, C, G, k, n_groups,
                float(eps), plan["conv0"], plan["film"], plan.get("res", 1), plan["conv1"],
                torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, err, "cut resblock_bf16")
        return out

    return k2


# variants of this tree's K8 tile body (lists of cuts of w4a8_matmul.cu),
# for timing only (most compute something else): no fold of the int32 sets
# (ptxas may then drop the dead mma), no k-step (the ring's streaming
# alone), no load (the compute alone), I2F in the fold, half the folds,
# and deeper or wider ring stages
K8_VARIANTS = {
    "no_fold": [("      if (kb + 32 == kg) {", "      if (false) {")],
    "ring_only": [("      if (kb >= kb1) break;                         // the split's last stage ends early",
                   "      break;")],
    # the k-steps and folds on whatever the ring holds, no load issued
    "compute_only": [("  auto load = [&](int s, int q, int p) {\n",
                      "  auto load = [&](int s, int q, int p) {\n    return;\n")],
    # the fold's int32 -> float by I2F (the SMALL = false path) everywhere
    "fold_i2f": [("  const bool small = K / G <= 256;", "  const bool small = false;")],
    # every other fold skipped (the fold's cost per unit, by difference)
    "half_folds": [("      if (kb + 32 == kg) {", "      if (kb + 32 == kg && (kg / gs) % 2) {"),
                   ("        kg += gs;\n      }", "      }\n      if (kb + 32 == kg) kg += gs;")],
    # the ring's x codes loaded for the first stages only (half the ring's
    # bytes; later stages compute on stale codes)
    "ring_weights_only": [("    for (int i = p; i < 2 * BM * PR; i += TB_PRODUCERS) {",
                           "    for (int i = p; s < TB_STAGES && i < 2 * BM * PR; "
                           "i += TB_PRODUCERS) {")],
    # every stage loads the split's first stage again (its bytes stay in L2)
    "ring_hot": [("    const int kb = kb0 + s * TB_KC;\n    unsigned char* slot",
                  "    const int kb = kb0 + 0 * s;\n    unsigned char* slot")],
    # other stage widths and ring depths
    "kc_64": [("constexpr int TB_KC = 128;", "constexpr int TB_KC = 64;")],
    "kc_64_stages_8": [("constexpr int TB_KC = 128;", "constexpr int TB_KC = 64;"),
                       ("constexpr int TB_STAGES = 4;", "constexpr int TB_STAGES = 8;")],
    "kc_128_stages_3": [("constexpr int TB_STAGES = 4;", "constexpr int TB_STAGES = 3;")],
    "kc_192_stages_3": [("constexpr int TB_KC = 128;", "constexpr int TB_KC = 192;"),
                        ("constexpr int TB_STAGES = 4;", "constexpr int TB_STAGES = 3;")],
}
K8_VARIANT_SHAPES = ((128, 3584, 3584), (442, 3584, 4608), (442, 3584, 3584),
                     (442, 3584, 37888), (442, 18944, 3584))


def k8_variants_part(CS, gen):
    """This tree's K8 and each K8_VARIANTS copy (same plan, k8_plan's) at
    K8_VARIANT_SHAPES: what the fold, the k-steps and the ring's depth and
    width cost.  The variants' outputs are not checked (two compute
    nothing)."""
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    libs = {name: k8_with(build_cut("w4a8_matmul", cuts, name))
            for name, cuts in K8_VARIANTS.items()}
    out = []
    for M, K, N in K8_VARIANT_SHAPES:
        x, wts, _, _, _ = CS.qmm_check(gen, "K8", M, K, N)
        sets = weight_sets(CS, gen, wts)
        row = dict(M=M, K=K, N=N, plan=CS.k8_card_plan(M, K, N, wts[1].shape[0]),
                   ms=timed_sets(CS, QM.w4a8_matmul, x, sets))
        row.update({name: timed_sets(CS, fn, x, sets) for name, fn in libs.items()})
        out.append(row)
        del sets
    return out


def k8_with(lib):
    """K8 of a library built from this tree's w4a8_matmul.cu (a cut copy)
    behind the wrapper's interface, under k8_plan's plan."""
    import torch

    from vla_touch_tpu_torch.csrc import build
    from vla_touch_tpu_torch.ops import quant_matmul as QM
    from vla_touch_tpu_torch.utils.device import sm_count

    f = lib.w4a8_matmul
    f.argtypes = [_P, _I, _L, _P, _P, _P, _P, _P, _P] + [_I] * 6 + [_P]
    f.restype = _I

    def w4a8(x, w4_pack, scale4, bias=None):
        M, K = x.shape
        N, G = w4_pack.shape[0], scale4.shape[0]
        out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
        xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
        rs = torch.empty((M,), dtype=torch.float32, device=x.device)
        err = f(x.data_ptr(), int(x.dtype == torch.float32), x.stride(0), w4_pack.data_ptr(),
                scale4.data_ptr(), None if bias is None else bias.data_ptr(), xq.data_ptr(),
                rs.data_ptr(), out.data_ptr(), M, N, K, G, *QM.k8_plan(M, N, K, G, sm_count(0)),
                torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, err, "cut w4a8_matmul")
        return out

    return w4a8


def k2_part(CS, gen, parent):
    import numpy as np
    import torch

    from vla_touch_tpu_torch.ops import unet_kernels as UK

    S, B, G, K = CS.K2_S, 1, CS.K2_G, CS.K2_K
    rows, tot = [], {"parent": [0.0, 0.0], "new": [0.0, 0.0]}
    cuts = {name: k2_with(build_cut("resblock", [cut], name)) for name, cut in K2_CUTS.items()}
    cuts["barriers"] = k2_with(build_cut("resblock", K2_BARRIERS_ONLY, "barriers"))
    cuts.update({name: k2_with(build_cut("resblock", v, name)) for name, v in K2_VARIANTS.items()})
    for name, T, Cin, C in CS.K2_SHAPES:
        x = torch.randn((S, B, T, Cin), generator=gen, device="cuda").to(torch.bfloat16)
        cond = torch.randn((S, B, G), generator=gen, device="cuda").to(torch.bfloat16)
        sets = [CS.k2_params(gen, S, Cin, C, G, K) for _ in range(4)]
        want = UK.resblock_ref(x, cond, sets[0])
        errs = {who: float((fn(x, cond, sets[0]).float() - want).abs().max())
                for who, fn in (("parent", parent), ("new", UK.resblock_fused))}
        it = [0]

        def run(fn):
            it[0] = (it[0] + 1) % len(sets)
            fn(x, cond, sets[it[0]])

        ms = {"parent": [], "new": []}
        for who in ("parent", "new", "new", "parent"):
            fn = parent if who == "parent" else UK.resblock_fused
            ms[who].append(CS.graph_time_ms(lambda: run(fn)))
        cut_ms = {cut: CS.graph_time_ms(lambda: run(fn)) for cut, fn in cuts.items()}
        ok = all(np.isfinite(e) and e <= CS.K2_TOL for e in errs.values())
        rows.append(dict(shape=name, T=T, Cin=Cin, C=C, err=errs, tol=CS.K2_TOL, ok=ok,
                         parent_ms=ms["parent"], new_ms=ms["new"], new_cut_ms=cut_ms,
                         plan=UK.k2_plan(Cin, C, G, K, S, UK._ctas(0, T, Cin, C, G, K, 8),
                                         Cin != C),
                         bound_ms=max(CS.k2_bound_ms(S, B, T, Cin, C, G, K))))
        for who in ("parent", "new"):
            for i in range(2):
                tot[who][i] += CS.K2_STEPS * ms[who][i]
    return rows, tot


def ttft_part(CS, parent):
    import numpy as np
    import torch

    from vla_touch_tpu_torch.planning import llm as L
    from vla_touch_tpu_torch.planning import run_llm as RL

    P = CS.build_planner(seed=0)
    cfg = P["cfg"]
    L.MEGAKERNELS = True
    iface = RL.make_llm_interface(cfg, P["fused"], max_new_tokens=1)
    eos = iface.tokenizer.EOS
    prompts = {"ask": iface.embed_text(CS.ASK_QUERY)[None],
               "long": iface.embed_text("x" * 430)[None]}

    def first(prompt):
        return L.greedy_generate(cfg, P["fused"], prompt, max_new_tokens=1, eos_id=eos)

    def wall(prompt):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first(prompt)
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(ts))

    res = {"parent": [], "new": [], "prompt_tokens": int(prompts["long"].shape[1])}
    for who in ("parent", "new", "new", "parent"):
        with CS.swapped(K8=parent) if who == "parent" else CS.swapped():
            first(prompts["long"])
            row = {f"ttft_ms_{k}": wall(p) for k, p in prompts.items()}
            prof = span_profile(lambda: first(prompts["long"]))
            row.update(busy_ms=prof["busy_sum_ms"], k8_ms=prof["K8"]["sum_ms"],
                       k8_calls=prof["K8"]["calls"], quantize_ms=prof["quantize"]["sum_ms"])
        res[who].append(row)
    return res


# (M, K, N, plans) the plans part times
K6_PLAN_SHAPES = (
    (67, 2048, 2048, [(5, 2, s) for s in (1, 2, 4, 8)] + [(5, 4, s) for s in (1, 2, 4, 8)]),
    (67, 2048, 6144, [(5, 2, 1), (5, 2, 2), (5, 4, 1), (5, 4, 2), (5, 4, 3)]),
    (1, 18944, 3584, [(1, 2, s) for s in (1, 2, 4)] + [(1, 4, s) for s in (2, 4, 8)]),
    (1, 3584, 3584, [(1, 2, s) for s in (1, 2, 4)] + [(1, 4, s) for s in (2, 4, 8)]),
    (1, 3584, 152064, [(1, 2, 1), (1, 4, 1)]),
)


def plans_part(CS, gen):
    import torch

    from vla_touch_tpu_torch.ops import quant_matmul as QM

    out = []
    for M, K, N, plans in K6_PLAN_SHAPES:
        x, wts, _, _, _ = CS.qmm_check(gen, "K6", M, K, N)
        want = QM.a8w8_plain(x, *wts, out_dtype=torch.float32).to(torch.bfloat16)
        sets = weight_sets(CS, gen, wts)
        default = CS.k6_card_plan(M, K, N)
        for plan in plans:
            fn = lambda x, *w, plan=plan: QM._a8w8_launch(x, *w, plan)  # noqa: E731
            unlike = int((fn(x, *wts) != want).sum())
            out.append(dict(M=M, K=K, N=N, plan=plan, default=plan == default,
                            unlike=unlike, ms=timed_sets(CS, fn, x, sets)))
    return out


def build_cut(name: str, cuts, tag: str, extra: str = "") -> ctypes.CDLL:
    """This tree's ``csrc/<name>.cu`` with each (text, replacement) of
    ``cuts`` applied and ``extra`` appended, in a copy of it under the build
    directory."""
    from vla_touch_tpu_torch.csrc import build

    text = (build.CSRC / f"{name}.cu").read_text()
    for old, new in cuts:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}.cu: a cut's text is not in it once")
        text = text.replace(old, new)
    text += extra
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"cut_{name}_{tag}.cu"
    src.write_text(text)
    blob = text.encode() + b"".join(p.read_bytes() for p in sorted(build.CSRC.glob("*.cuh")))
    digest = hashlib.sha256(blob + " ".join(build.NVCC_FLAGS).encode()).hexdigest()[:16]
    path = build.BUILD_DIR / f"cut_{name}_{tag}.{digest}.so"
    if not path.exists():
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                        str(path), str(src)], check=True)
    lib = ctypes.CDLL(str(path))
    lib.vtt_error_string.argtypes = [_I]
    lib.vtt_error_string.restype = ctypes.c_char_p
    return lib


# (M, K, N, plans) of this tree's K6 in the phases part: the tick's main
# shape, and one K chunk ((67, 64, 2048), (1, 64, 2048)), which times what a
# call costs beside its data
K6_FLOOR_SHAPES = (
    (67, 2048, 2048, [(5, 2, 1), (5, 2, 2)]),
    (67, 64, 2048, [(5, 2, 1), (5, 4, 1)]),
    (1, 64, 2048, [(1, 2, 1)]),
)


def phases_part(CS, gen):
    """This tree's K6 at K6_FLOOR_SHAPES (and at one chunk its default plan
    without the programmatic dependent launch, ``NO_PDL``) beside its
    quantize launch alone; this tree's K10 at M = 1 and 8 whole and cut
    after each phase (``K10_CUTS``)."""
    import torch

    from vla_touch_tpu_torch.ops import quant_matmul as QM
    from vla_touch_tpu_torch.ops import w4_fused as W4F

    out = []
    quant = quantize_only()
    no_pdl = k6_of(build_cut("a8w8_matmul", NO_PDL, "no_pdl"))
    for M, K, N, plans in K6_FLOOR_SHAPES:
        x, wts, _, _, _ = CS.qmm_check(gen, "K6", M, K, N)
        sets = weight_sets(CS, gen, wts)
        for plan in plans:
            run = lambda x, *w, plan=plan: QM._a8w8_launch(x, *w, plan)  # noqa: E731
            out.append(dict(kernel="K6", M=M, K=K, N=N, plan=plan,
                            ms=timed_sets(CS, run, x, sets)))
        if K == 64:
            out.append(dict(kernel="K6 NO_PDL", M=M, K=K, N=N, plan=CS.k6_card_plan(M, K, N),
                            ms=timed_sets(CS, no_pdl, x, sets)))
        xq = torch.empty((M, K), dtype=torch.int8, device="cuda")
        rs = torch.empty((M,), dtype=torch.float32, device="cuda")
        out.append(dict(kernel="quantize", M=M, K=K,
                        ms=CS.graph_time_ms(lambda: quant(x, xq, rs))))
    leaves = CS.mk_leaves(gen)
    cuts = {name: mk_wrappers(None, build_cut("w4_postattn", [cut], name), "new")[1]
            for name, cut in K10_CUTS.items()}
    for M in CS.K10_MS:
        ops = CS.mk_operands(gen, "K10", M, leaves)
        out.append(dict(kernel="K10", M=M, ms=CS.graph_time_ms(lambda: W4F.w4_postattn_fused(*ops)),
                        cut_ms={name: CS.graph_time_ms(lambda: c(*ops))
                                for name, c in cuts.items()}))
    return out


def mk_part(CS, gen, pk9, pk10, k10_with, parent_dir):
    from vla_touch_tpu_torch.ops import w4_fused as W4F

    leaves = CS.mk_leaves(gen)
    rows = []
    with open(os.path.join(parent_dir, "w4_postattn.cu")) as f:
        base = f.read() + K10_GRID_ENTRY
    probe_lib = build_lib(parent_dir, "w4_postattn", base, "_probe")
    cuts = {}
    for name, (text, repl) in K10_CUTS.items():
        if base.count(text) != 1:
            raise RuntimeError(f"K10 cut {name}: text not in the parent's w4_postattn.cu once")
        cuts[name] = k10_with(build_lib(parent_dir, "w4_postattn", base.replace(text, repl),
                                        f"_cut_{name}"))
    for kernel, Ms in (("K9", CS.K9_MS), ("K10", CS.K10_MS)):
        new = W4F.w4_swiglu_mlp if kernel == "K9" else W4F.w4_postattn_fused
        old = pk9 if kernel == "K9" else pk10
        for M in Ms:
            ops = CS.mk_operands(gen, kernel, M, leaves)
            errs = {}
            with CS.swapped(**{kernel: old}):
                errs["parent"] = CS.mk_check(kernel, ops)
            errs["new"] = CS.mk_check(kernel, ops)
            ms = {"parent": [], "new": []}
            for who in ("parent", "new", "new", "parent"):
                ms[who].append(CS.graph_time_ms(lambda: (old if who == "parent" else new)(*ops)))
            row = dict(kernel=kernel, M=M, err_tol=errs, parent_ms=ms["parent"],
                       new_ms=ms["new"], bound_ms=max(CS.mk_bound_ms(kernel, M)))
            if kernel == "K10":
                row["parent_cut_ms"] = {name: CS.graph_time_ms(lambda: fn(*ops))
                                        for name, fn in cuts.items()}
                grid = _I(0)
                gf = probe_lib.parent_postattn_grid
                gf.argtypes = [_I, _I, ctypes.POINTER(_I)]
                gf(M, CS.QWEN_D, ctypes.byref(grid))
                row["parent_grid"] = grid.value
            rows.append(row)
    return rows


def span_profile(run) -> dict:
    """``run()`` under ``torch.profiler``: device busy ms as the sum of
    kernel durations and as the union of their spans (a programmatic
    dependent launch starts before its predecessor ends, so the two
    differ), and per group of ``SPAN_GROUPS`` the summed durations and the
    union of the group's spans."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]

    def union_ms(ivs):
        total, end = 0.0, float("-inf")
        for a, b in sorted(ivs):
            if b <= end:
                continue
            total += b - max(a, end)
            end = b
        return total / 1e3

    out = dict(busy_sum_ms=sum(b - a for _, a, b in spans) / 1e3,
               busy_union_ms=union_ms([(a, b) for _, a, b in spans]))
    for group, pats in SPAN_GROUPS.items():
        ivs = [(a, b) for n, a, b in spans if any(p in n for p in pats)]
        out[group] = dict(calls=len(ivs), sum_ms=sum(b - a for a, b in ivs) / 1e3,
                          union_ms=union_ms(ivs))
    return out


SPAN_GROUPS = {"K6 gemm": ("a8w8_gemm_kernel",), "quantize": ("quantize_rows_kernel",),
               "K8": ("w4a8_",),
               "K6 gemm + quantize": ("a8w8_gemm_kernel", "quantize_rows_kernel")}


def tick_part(CS, parent):
    from vla_touch_tpu_torch.models.rdt import quant_serve as QS

    t = CS.build_tick(seed=0)
    kw = dict(rdt=QS.quantize_rdt_params(t["model"].rdt, "int8"), kv_cache="int8")
    CS.run_tick(t, **kw)
    no_pdl = k6_of(build_cut("a8w8_matmul", NO_PDL, "no_pdl"))
    k6 = {"parent": parent, "no_pdl": no_pdl}
    res = {"parent": [], "new": [], "no_pdl": []}
    for who in ("parent", "new", "no_pdl", "no_pdl", "new", "parent"):
        with CS.swapped(K6=k6[who]) if who in k6 else CS.swapped():
            CS.run_tick(t, **kw)
            prof = CS.profile_tick(t, **kw)
            spans = span_profile(lambda: CS.run_tick(t, **kw))
        res[who].append(dict(busy_ms=prof["device_busy_ms"], idle_share=prof["idle_share"],
                             groups_ms=prof["groups_ms"], spans=spans))
    return res


def decode_part(CS, pk9, pk10, tokens=16):
    import numpy as np
    import torch

    from vla_touch_tpu_torch.planning import llm as L
    from vla_touch_tpu_torch.planning import run_llm as RL

    P = CS.build_planner(seed=0)
    cfg = P["cfg"]
    L.MEGAKERNELS = True
    iface = RL.make_llm_interface(cfg, P["fused"], max_new_tokens=tokens)
    ask = iface.embed_text(CS.ASK_QUERY)[None]
    eos = iface.tokenizer.EOS

    def run(n):
        return L.greedy_generate(cfg, P["fused"], ask, max_new_tokens=n, eos_id=eos)

    def wall(n):
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(n)
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(ts))

    res = {"parent": [], "new": []}
    for who in ("parent", "new", "new", "parent"):
        with CS.swapped(K9=pk9, K10=pk10) if who == "parent" else CS.swapped():
            run(tokens)
            first, full = wall(1), wall(tokens)
            prof = CS.profile_run(lambda: run(tokens))
        res[who].append(dict(ms_per_token=(full - first) / (tokens - 1), first_ms=first,
                             busy_ms=prof["device_busy_ms"], idle_share=prof["idle_share"],
                             groups_ms=prof["groups_ms"]))
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent-dir", required=True)
    ap.add_argument("--parts",
                    default="k6,k5,k7,k8,k8variants,k8cross,k8plans,k2,ttft,plans,phases,mk,"
                            "tick,decode")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_quant_ab: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from vla_touch_tpu_torch.csrc import build

    build.build_all()
    parent_dir = os.path.abspath(args.parent_dir)
    k6 = k6_of(build_lib(parent_dir, "a8w8_matmul"), "parent")
    k8 = parent_k8(build_lib(parent_dir, "w4a8_matmul"),
                   open(os.path.join(parent_dir, "w4a8_matmul.cu")).read())
    pk9, pk10, k10_with = mk_wrappers(build_lib(parent_dir, "w4_swiglu"),
                                      build_lib(parent_dir, "w4_postattn"))
    k2 = k2_with(build_lib(parent_dir, "resblock"))
    k5 = parent_k5(build_lib(parent_dir, "w8a16_matmul"))
    k7 = parent_k7(build_lib(parent_dir, "a8w8_matmul_large"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    gpu = CS.gpu_line()
    parts = args.parts.split(",")
    if "k6" in parts:
        rows, tot = k6_part(CS, gen, k6)
        print(json.dumps(dict(gpu=gpu, k6=rows, per_tick_ms=tot)), flush=True)
    if "k5" in parts:
        rows, tot = k5_part(CS, gen, k5)
        print(json.dumps(dict(gpu=gpu, k5=rows, per_tick_ms=tot)), flush=True)
    if "k7" in parts:
        rows, tot = k7_part(CS, gen, k7)
        print(json.dumps(dict(gpu=gpu, k7=rows, per_f_chunk_ms=tot)), flush=True)
    if "k8" in parts:
        rows, tot = k8_part(CS, gen, k8)
        print(json.dumps(dict(gpu=gpu, k8=rows, sums_ms=tot)), flush=True)
    if "k8variants" in parts:
        print(json.dumps(dict(gpu=gpu, k8variants=k8_variants_part(CS, gen))), flush=True)
    if "k8cross" in parts:
        print(json.dumps(dict(gpu=gpu, k8cross=k8_cross_part(CS, gen))), flush=True)
    if "k8plans" in parts:
        print(json.dumps(dict(gpu=gpu, k8plans=k8_plans_part(CS, gen))), flush=True)
    if "k2" in parts:
        rows, tot = k2_part(CS, gen, k2)
        print(json.dumps(dict(gpu=gpu, k2=rows, per_tick_ms=tot)), flush=True)
    if "ttft" in parts:
        print(json.dumps(dict(gpu=gpu, ttft=ttft_part(CS, k8))), flush=True)
    if "plans" in parts:
        print(json.dumps(dict(gpu=gpu, plans=plans_part(CS, gen))), flush=True)
    if "phases" in parts:
        print(json.dumps(dict(gpu=gpu, phases=phases_part(CS, gen))), flush=True)
    if "mk" in parts:
        print(json.dumps(dict(gpu=gpu, mk=mk_part(CS, gen, pk9, pk10, k10_with, parent_dir))),
              flush=True)
    if "tick" in parts:
        print(json.dumps(dict(gpu=gpu, tick=tick_part(CS, k6))), flush=True)
    if "decode" in parts:
        print(json.dumps(dict(gpu=gpu, decode=decode_part(CS, pk9, pk10))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
