#!/usr/bin/env python3
"""K6 (a8w8), K8 (w4a8) and K9/K10 (the w4 megakernels) on one card: this
tree's kernels against an earlier tree's, in turns.

    python3 tools/torch_quant_ab.py --parent-dir build/parent \
        [--parts k6,k8,plans,phases,mk,tick,decode]

``--parent-dir`` holds an earlier tree's ``a8w8_matmul.cu``,
``w4a8_matmul.cu``, ``int8_mma.cuh``, ``w4_swiglu.cu``, ``w4_postattn.cu``,
``w4_swiglu.cuh`` and ``w4_group.cuh`` (e.g. ``git show
<commit>:vla_touch_tpu_torch/csrc/<file>``, written under the ignored
``build/``), with the C entries of that tree: ``a8w8_matmul(x, x_f32, x_sm,
w, scale, bias, xq, rs, out, M, N, K, stream)``, ``w4a8_matmul`` as this
tree's, and ``w4_swiglu_mlp`` / ``w4_postattn_fused`` as this tree's (the
argument lists of their wrappers in ``ops/w4_fused.py``).  They are built
with the same nvcc flags beside this tree's kernels.  Device times are
CUDA-graph replays (``chip_smoke.graph_time_ms``), each version timed in
turns (parent, new, new, parent).  One JSON line per part:

1. ``k6``: every K6 shape of the tick (``chip_smoke.QMM_SHAPES``) and of
   the planner's int8 request (``K6_LLM_SHAPES``), both versions bit-exact
   against the plain version, the time of each, this tree's plan, and the
   quantize launch alone (identical in both trees), so that the parent's
   GEMM launch is its time less the quantize; sums per tick;
2. ``k8``: K8 at every shape of the tick (``chip_smoke.QMM_SHAPES``),
   both versions against the plain version and timed; sums per tick;
3. ``plans``: this tree's K6 under other plans (mt, wn, splits) at the
   tick's two main shapes and the planner's down and o projections;
4. ``phases``: this tree's K6 at one K chunk beside its quantize launch
   (what a call costs beside its data) and this tree's K10 cut after each
   phase (a copy that returns there, built under ``build/``);
5. ``mk``: K9 at M = 1, 8, 24 and K10 at M = 1, 8 at Qwen2.5-7B width,
   both versions against the plain version (``chip_smoke.mk_check``) and
   timed; the parent's K10 cut after each of its phases (a variant that
   returns there), which times the phases, and its grid;
6. ``tick``: quantized tick (a) with the parent's K6, this tree's, and this
   tree's built without the programmatic dependent launch (a copy whose
   GEMM waits for the whole quantize launch, ``NO_PDL``), in turns: the
   profiled device busy ms as the sum of kernel durations and as the union
   of kernel spans, the union of the quantize and GEMM spans, the idle
   share and the kernel groups;
7. ``decode``: the full-width planner (``chip_smoke.build_planner``), a
   16-token greedy decode of the 24-token ask on the fused tree with
   MEGAKERNELS, ms per token (host clock, median of 3) with the parent's
   K9/K10 and with this tree's, in turns, and one profiled decode each.

Needs one NVIDIA GPU.  No module of the package imports this script.
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
PARENT_FILES = ("a8w8_matmul.cu", "w4a8_matmul.cu", "int8_mma.cuh", "w4_swiglu.cu",
                "w4_postattn.cu", "w4_swiglu.cuh", "w4_group.cuh")

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


def parent_k6(lib):
    """The parent's K6 behind the wrapper's interface."""
    import torch

    from vla_touch_tpu_torch.csrc import build

    f = lib.a8w8_matmul
    f.argtypes = [_P, _I, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
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
                rs.data_ptr(), out.data_ptr(), M, N, K,
                torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, err, "parent a8w8_matmul")
        a8w8.launches += 1
        return out.reshape(*lead, N)

    a8w8.launches = 0
    return a8w8


def parent_k8(lib):
    """The parent's K8 behind the wrapper's interface."""
    import torch

    from vla_touch_tpu_torch.csrc import build

    f = lib.w4a8_matmul
    f.argtypes = [_P, _I, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    f.restype = _I

    def w4a8(x, w4_pack, scale4, bias=None):
        *lead, K = x.shape
        x2 = x.reshape(-1, K)
        M, N, G = x2.shape[0], w4_pack.shape[0], scale4.shape[0]
        out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
        xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
        rs = torch.empty((M,), dtype=torch.float32, device=x.device)
        err = f(x2.data_ptr(), int(x2.dtype == torch.float32), x2.stride(0), w4_pack.data_ptr(),
                scale4.data_ptr(), None if bias is None else bias.data_ptr(), xq.data_ptr(),
                rs.data_ptr(), out.data_ptr(), M, N, K, G,
                torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, err, "parent w4a8_matmul")
        w4a8.launches += 1
        return out.reshape(*lead, N)

    w4a8.launches = 0
    return w4a8


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


def quantize_only():
    """This tree's quantize launch alone (the one both trees run)."""
    import torch

    from vla_touch_tpu_torch.csrc import build

    lib = build_cut("a8w8_matmul", [], "quantize", QUANTIZE_ENTRY)
    f = lib.a8w8_quantize
    f.argtypes = [_P, _I, _L, _P, _P, _I, _I, _P]
    f.restype = _I

    def run(x, xq, rs):
        err = f(x.data_ptr(), int(x.dtype == torch.float32), x.stride(0), xq.data_ptr(),
                rs.data_ptr(), x.shape[0], x.shape[1],
                torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, err, "a8w8_quantize")

    return run


def k6_of(lib):
    """K6 of a library built from this tree's a8w8_matmul.cu (a cut copy)
    behind the wrapper's interface, under ``k6_plan``'s plan."""
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
        build.check(lib, err, "cut a8w8_matmul")
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


def k8_part(CS, gen, parent):
    import torch

    from vla_touch_tpu_torch.ops import quant_matmul as QM

    rows, tot = [], {"parent": [0.0, 0.0], "new": [0.0, 0.0]}
    for M, K, N, calls in CS.QMM_SHAPES:
        x, wts, err, tol, _ = CS.qmm_check(gen, "K8", M, K, N)
        want = QM.w4a8_plain(x, *wts, out_dtype=torch.float32)
        perr = float((parent(x, *wts).float() - want).abs().max())
        sets = weight_sets(CS, gen, wts)
        ms = {"parent": [], "new": []}
        for who in ("parent", "new", "new", "parent"):
            ms[who].append(timed_sets(CS, parent if who == "parent" else QM.w4a8_matmul,
                                      x, sets))
        rows.append(dict(M=M, K=K, N=N, calls=calls, tol=tol, new_err=err, parent_err=perr,
                         parent_ms=ms["parent"], new_ms=ms["new"]))
        for who in ("parent", "new"):
            for i in range(2):
                tot[who][i] += calls * ms[who][i]
    return rows, tot


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
    ap.add_argument("--parts", default="k6,k8,plans,phases,mk,tick,decode")
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
    k6 = parent_k6(build_lib(parent_dir, "a8w8_matmul"))
    k8 = parent_k8(build_lib(parent_dir, "w4a8_matmul"))
    pk9, pk10, k10_with = mk_wrappers(build_lib(parent_dir, "w4_swiglu"),
                                      build_lib(parent_dir, "w4_postattn"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    gpu = CS.gpu_line()
    parts = args.parts.split(",")
    if "k6" in parts:
        rows, tot = k6_part(CS, gen, k6)
        print(json.dumps(dict(gpu=gpu, k6=rows, per_tick_ms=tot)), flush=True)
    if "k8" in parts:
        rows, tot = k8_part(CS, gen, k8)
        print(json.dumps(dict(gpu=gpu, k8=rows, per_tick_ms=tot)), flush=True)
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
