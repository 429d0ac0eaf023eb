#!/usr/bin/env python3
"""Fault controls for the K3-K10 gates of ``chip_smoke.py``:
plant a known fault in a throwaway copy of a kernel source and read what
each gate sees.

    python3 tools/torch_quant_fault_control.py [fault ...]

For each entry of ``FAULTS`` (``none`` is the sound kernels; default: all)
the script copies ``vla_touch_tpu_torch/`` and ``chip_smoke.py`` into a
temporary directory, edits the named ``csrc/*.cu`` there, and in a child
process that imports the copy:

1. runs chip_smoke's correctness check of the faulted kernel(s) at every
   shape of the quantized tick (K5: and of the planner's int8 request; K8:
   and of the planner's 72- and 442-token prompt passes; K7:
   the 4374-token condition products; K9/K10: of the planner, at
   Qwen2.5-7B width) and prints, per shape, the max abs error against its
   tolerance, or the miss, and for K5-K8 how many bf16 outputs differ
   from the plain version's rounded to bf16;
2. runs the full-width quantized tick in the configuration(s) that use the
   kernel, with the kernels and through the plain versions, and prints the
   chunk (and refined-action) correlations beside chip_smoke's gates, and
   the chunk's correlation with the bf16 tick's (K5 and K7 are on no main
   path, so these cannot see their faults);
3. runs chip_smoke's checked tick there (every kernel call against its
   plain version on the same operands; in (a) and (f) with K5 and K7
   shadowed on the tick's operands) and prints the worst call per kernel
   against its tolerance (share <= 1 passes; for K2 and K3/K4 also
   ``group_share``, the per-channel or per (row, head) measure);
4. for K8 and K9/K10, builds the full-width planner and prints the ask
   request's teacher-forced logits corr against the plain versions and a
   checked 4-token decode, beside chip_smoke's gates; for K8 also every
   planner request checked at 4 tokens (K8's tile body runs in the
   442-token prompt pass); for K6, the int8 request checked at 2 tokens.

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

# name: (source, text in it, its replacement, kernels to check, configurations);
# a fault of several edits gives a tuple of (source, text, replacement) as its
# source and None for the text and replacement
FAULTS = {
    "none": (None, None, None, ("K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10"),
             ("a", "b", "e", "f")),
    # K5: the weight scale never applied in the first column tile
    "k5_scale_ignored_on_one_tile": (
        "w8a16_matmul.cu", "y[c] = __fmul_rn(f[c], s_scale[col + c]);",
        "y[c] = blockIdx.x == 0 ? f[c] : __fmul_rn(f[c], s_scale[col + c]);", ("K5",), ("f",)),
    # K5: the last split's partial left out of every cluster sum (no effect
    # where the plan does not split)
    "k5_skip_one_split": (
        "w8a16_matmul.cu", "for (int w = 1; w < S; ++w) accumulate(v, recv[w * slice + i]);",
        "for (int w = 1; w < S - 1; ++w) accumulate(v, recv[w * slice + i]);", ("K5",), ("f",)),
    # K7: the last 128-byte K stage never multiplied
    "k7_drop_last_k_chunk": ("a8w8_matmul_large.cu", "const int nkb = a.K / BK;",
                             "const int nkb = a.K / BK - 1;", ("K7",), ("f",)),
    # K7: rows scaled by qdense's amax / 127 where a8w8_matmul_large's
    # amax * (1/127) belongs (one ulp apart for some amax)
    "k7_row_scale_div_127": ("a8w8_matmul_large.cu", "/*rs_recip=*/1", "/*rs_recip=*/0",
                             ("K7",), ("f",)),
    # K7: the fourth k32 wgmma of every stage reads the third's bytes (a
    # wrong descriptor advance: K bytes 96..127 of each stage skipped, 64..95
    # counted twice)
    "k7_skip_one_k32": (
        "a8w8_matmul_large.cu",
        "for (int k = 0; k < BK / 32; ++k) wgmma_m64n256k32_s8(acc, da + 2 * k, db + 2 * k);",
        "for (int k = 0; k < BK / 32; ++k) "
        "wgmma_m64n256k32_s8(acc, da + 2 * (k == 3 ? 2 : k), db + 2 * (k == 3 ? 2 : k));",
        ("K7",), ("f",)),
    # K7: each slot released to the producer as soon as its wgmma group is
    # issued, before the consumers have read it (a race: TMA may refill the
    # slot under the tensor cores)
    "k7_early_empty_arrive": (
        (("a8w8_matmul_large.cu",
          "      wgmma_commit();\n      wgmma_wait<1>();",
          "      wgmma_commit();\n      if (lane == 0) mbar_arrive(&empty[s]);\n"
          "      wgmma_wait<1>();"),
         ("a8w8_matmul_large.cu",
          "      if (kb > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);\n", ""),
         ("a8w8_matmul_large.cu",
          "    fence_regs(acc);\n    if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);\n",
          "    fence_regs(acc);\n")),
        None, None, ("K7",), ("f",)),
    # K7: the 22-row tail tile's rows past M stored too (its output mask
    # gone: 106 rows written past the end of the (M, N) output, which
    # chip_smoke's per-shape check sees in its guard rows)
    "k7_tail_unmasked": ("a8w8_matmul_large.cu", "      if (m < a.M)\n",
                         "      if (true)\n", ("K7",), ("f",)),
    # K6: the last 64-wide K chunk of every row is never multiplied (the
    # last split stops one chunk short)
    "k6_drop_last_k_chunk": ("a8w8_matmul.cu", "const int kend = min(K, c1 * KC);",
                             "const int kend = min(K, c1 * KC) - "
                             "(blockIdx.z == a.splits - 1 ? KC : 0);", ("K6",), ("a",)),
    # K6: one split's int32 partial never added to the tile (the last in
    # rank order; at two splits each CTA takes only its own; no effect
    # where the plan does not split)
    "k6_skip_one_k_split": ("a8w8_matmul.cu", "v[u] = rank_sum(cluster, red, e, S);",
                            "v[u] = rank_sum(cluster, red, e, S > 1 ? S - 1 : S);",
                            ("K6",), ("a",)),
    # K6: a CTA reads its peers' partials without the cluster barrier that
    # waits for them to be written (K6 keeps no counter or workspace
    # between calls: the race is the state fault its design can have)
    "k6_no_cluster_wait": ("a8w8_matmul.cu",
                           "  cluster.sync();\n  const int S = a.splits;",
                           "  const int S = a.splits;", ("K6",), ("a",)),
    # K8 (both bodies) and K9/K10, whose products share the nibble
    # unpacking (w4_group.cuh): the two nibble planes swapped (rows j and
    # K/2 + j exchanged), in the warp loop's form and the tile body's x16 form
    "k8_swap_nibble_planes": (
        (("w4_group.cuh",
          "return sext_nibbles(v & 0x0F0F0F0Fu);\n}\n"
          "__device__ __forceinline__ int high_nibbles(unsigned v) {\n"
          "  return sext_nibbles((v >> 4) & 0x0F0F0F0Fu);",
          "return sext_nibbles((v >> 4) & 0x0F0F0F0Fu);\n}\n"
          "__device__ __forceinline__ int high_nibbles(unsigned v) {\n"
          "  return sext_nibbles(v & 0x0F0F0F0Fu);"),
         ("w4_group.cuh",
          "return (int)((v << 4) & 0xF0F0F0F0u);\n}\n"
          "__device__ __forceinline__ int high_nibbles_x16(unsigned v) {\n"
          "  return (int)(v & 0xF0F0F0F0u);",
          "return (int)(v & 0xF0F0F0F0u);\n}\n"
          "__device__ __forceinline__ int high_nibbles_x16(unsigned v) {\n"
          "  return (int)((v << 4) & 0xF0F0F0F0u);")),
        None, None, ("K8", "K9", "K10"), ("e",)),
    # K8 (both bodies; K9/K10 too): the nibble's sign not extended: taken as
    # 0..15 by the warp loop; the tile body's x16 form, which has no room for
    # 16 * 15, drops the sign bit instead
    "k8_no_sign_extension": (
        (("w4_group.cuh", "return (int)__vsub4(v ^ 0x08080808u, 0x08080808u);",
          "return (int)v;"),
         ("w4_group.cuh", "return (int)((v << 4) & 0xF0F0F0F0u);",
          "return (int)((v << 4) & 0x70707070u);"),
         ("w4_group.cuh", "return (int)(v & 0xF0F0F0F0u);", "return (int)(v & 0x70707070u);")),
        None, None, ("K8",), ("e",)),
    # K8's tile body: the last unit of every split never summed (a split of
    # one unit sums nothing)
    "k8_drop_last_unit_of_split": (
        "w4a8_matmul.cu", "const int u1 = split_unit(blockIdx.z + 1, HG, a.splits);",
        "const int u1 = split_unit(blockIdx.z + 1, HG, a.splits) - 1;", ("K8",), ("e",)),
    # K8's tile body: the high plane's group sums never folded in with
    # their scale4
    "k8_skip_high_plane_fold": (
        "w4a8_matmul.cu",
        "              acc = fmaf(acc_to_float<SMALL>(acc_hi[i][j][r]), r & 1 ? s_hi.y : s_hi.x, "
        "acc);\n",
        "", ("K8",), ("e",)),
    # K3/K4: the V channel scale never applied (in place and in the combine)
    "q8_no_v_scale": ("flash_attention_q8.cu", "return acc / fmaxf(l, 1e-30f) * vs;",
                      "return acc / fmaxf(l, 1e-30f);", ("K3", "K4"), ("a", "b")),
    # K3/K4: the last KV tile (partial at the 4374-key image shape) never read
    "q8_drop_last_kv_tile": ("flash_attention_q8.cu",
                             "const int n_tiles = (a.Lkv + BK - 1) / BK;",
                             "const int n_tiles = a.Lkv / BK;", ("K3", "K4"), ("a", "b")),
    # K3/K4: one whole 64-key tile, the second of the middle split, never
    # used (1.5 % of the 4374 image keys; no effect on a one-split call)
    "q8_drop_full_kv_tile": ("flash_attention_q8.cu", "if (nr <= 0) continue;",
                             "if (nr <= 0 || (split == a.n_splits / 2 && t == t0 + 1)) continue;",
                             ("K3", "K4"), ("a", "b")),
    # K3/K4: the combine leaves out the last split
    "q8_combine_skips_last_split": ("flash_attention_q8.cu", "const int n_used = S;",
                                    "const int n_used = S - 1;", ("K3", "K4"), ("a", "b")),
    # K3/K4: the combine sums the splits without rescaling by e^(m_s - m*)
    "q8_combine_no_rescale": ("flash_attention_q8.cu",
                              "const float w = __expf(a.part_m[i] - m_star);",
                              "const float w = 1.f;", ("K3", "K4"), ("a", "b")),
    # K9: down reads the activation codes without waiting for every block
    # to have written them (the grid barrier after the requantization gone)
    "k9_skip_act_requant_barrier": (
        "w4_swiglu.cu", "  quantize_act_phase(a.act, a.amax, a.M, a.F, a.aq);\n  grid.sync();\n",
        "  quantize_act_phase(a.act, a.amax, a.M, a.F, a.aq);\n", ("K9",), ()),
    # K10: the RMSNorm's weight never applied
    "k10_norm_weight_ignored": (
        "w4_postattn.cu", "h[q] = bf16_round(__fmul_rn(__fmul_rn(f[q], r), wv[q]));",
        "h[q] = bf16_round(__fmul_rn(f[q], r));", ("K10",), ()),
    # K10: the last 16 output columns of down never written
    "k10_drop_last_down_tile": (
        "w4_postattn.cu", "a.out[e] = __float2bfloat16(__fadd_rn(res, bf16_round(y)));",
        "if (n < D - W4_BN) a.out[e] = __float2bfloat16(__fadd_rn(res, bf16_round(y)));",
        ("K10",), ()),
}


def planner_gates(fault: str, kernels) -> None:
    """The full-width planner.  K8-K10: the ask request (K8 and K9 in the
    prompt pass, K10 and K8 in every decode step): teacher-forced logits
    corr against the plain versions, and a checked 4-token decode; K8: every
    request checked at 4 tokens as chip_smoke checks them.  K6: the int8
    request, checked at 2 tokens as chip_smoke checks it."""
    import chip_smoke as CS
    from vla_touch_tpu_torch.planning import llm as L
    from vla_touch_tpu_torch.planning import run_llm as RL

    P = CS.build_planner(seed=0)
    cfg = P["cfg"]
    if "K6" in kernels:
        i8 = RL.make_llm_interface(cfg, P["i8"], max_new_tokens=2)
        chk = CS.checked_run(lambda: i8.generate_fn(i8.embed_text(CS.ASK_QUERY)))
        print(f"{fault}: planner int8 checked request (gate: share <= 1, unlike 0) "
              + json.dumps({k: v for k, v in chk.items() if v["calls"]}), flush=True)
    if "K8" in kernels:
        # every request at 4 tokens, as chip_smoke checks them: the
        # describe and guess prompt passes (72 and 442 tokens) run K8's
        # warp loop and tile body
        chk = CS.checked_run(lambda: CS.planner_requests(P, T=4))
        print(f"{fault}: planner checked requests (gate: share <= 1) "
              + json.dumps({k: v for k, v in chk.items() if v["calls"]}), flush=True)
    if not {"K8", "K9", "K10"} & set(kernels):
        return
    L.MEGAKERNELS = True
    iface = RL.make_llm_interface(cfg, P["fused"], max_new_tokens=CS.PLAN_TOKENS)
    with CS.recording_generate() as calls:
        iface.generate_fn(iface.embed_text(CS.ASK_QUERY))
    c, agree, first, median = CS.teacher_forced(P, calls[0])
    print(f"{fault}: planner ask: teacher-forced logits per-step corr min {c:.6f} (gate > "
          f"{CS.LOGITS_CORR_MIN}), first step {first:.6f}, median {median:.6f}; token "
          f"agreement {agree:.3f}", flush=True)
    ask = iface.embed_text(CS.ASK_QUERY)[None]
    chk = CS.checked_run(lambda: L.greedy_generate(cfg, P["fused"], ask, max_new_tokens=4,
                                                   eos_id=iface.tokenizer.EOS))
    print(f"{fault}: planner checked decode (gate: share <= 1) "
          + json.dumps({k: v for k, v in chk.items() if v["calls"]}), flush=True)


def child(fault: str) -> None:
    import numpy as np
    import torch

    import chip_smoke as CS
    from vla_touch_tpu_torch.csrc import build

    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, _, _, kernels, configs = FAULTS[fault]
    gen = torch.Generator(device="cuda").manual_seed(1234)
    leaves = None
    qmm_shapes = {"K5": CS.K5_SHAPES, "K6": CS.QMM_SHAPES, "K7": CS.K7_SHAPES,
                  "K8": CS.QMM_SHAPES + [r for r in CS.K8_LLM_SHAPES
                                         if r[0] in CS.K8_PROMPT_MS]}
    for kernel in kernels:
        if kernel in qmm_shapes:
            cases = [(f"M{M} K{K} N{N}", (M, K, N)) for M, K, N, _ in qmm_shapes[kernel]]
        elif kernel in ("K9", "K10"):
            leaves = leaves or CS.mk_leaves(gen)
            cases = [(f"M{M}", M) for M in (CS.K9_MS if kernel == "K9" else CS.K10_MS)]
        else:
            cases = [(name, shape) for name, *shape, _ in CS.Q8_SHAPES]
        for name, shape in cases:
            try:
                if kernel in ("K9", "K10"):
                    err, tol = CS.mk_check(kernel, CS.mk_operands(gen, kernel, shape, leaves))
                elif kernel in qmm_shapes:
                    _, _, err, tol, n_diff = CS.qmm_check(gen, kernel, *shape)
                    M, _, N = shape
                    name += f" (bf16 outputs unlike the plain version's: {n_diff} of {M * N})"
                else:
                    B, Lq, Lkv, H, D, mask_kind = shape
                    ops = CS.q8_operands(gen, B, Lq, Lkv, H, D, kernel == "K4")
                    err, tol = CS.q8_check(kernel, ops, CS.q8_mask(B, Lq, Lkv, H, mask_kind))
                print(f"{fault}: {kernel} {name}: pass, err {err:.3e} tol {tol:.3e}",
                      flush=True)
            except AssertionError as e:
                print(f"{fault}: {kernel} {name}: {e}: MISS", flush=True)
    del leaves
    if {"K6", "K8", "K9", "K10"} & set(kernels):
        planner_gates(fault, kernels)
    if not configs:
        return
    t = CS.build_tick(seed=0)
    bf16 = CS.run_tick(t, refine=False)["actions"]
    runners = CS.quant_runners(t["model"].rdt)
    table = {name: (runner, kv, refine, shadows)
             for name, runner, kv, refine, _, shadows in CS.QUANT_CONFIGS}
    for c in configs:
        runner, kv, refine, shadows = table[c]
        kw = dict(rdt=runners[runner], kv_cache=kv, refine=refine)
        out = CS.run_tick(t, **kw)
        with CS.plain_kernels():
            out_p = CS.run_tick(t, **kw)
        corrs = dict(chunk=CS.action_corr(t, out["actions"], out_p["actions"]),
                     chunk_vs_bf16=CS.action_corr(t, out["actions"], bf16))
        if kw["refine"]:
            corrs["refined"] = CS.action_corr(t, out["refined"], out_p["refined"])
        finite = bool(np.all(np.isfinite(out["actions"])))
        print(f"{fault}: config ({c}) runner={runner} kv_cache={kv}: corr "
              + json.dumps(corrs) + f" finite {finite}; gates: chunk > {CS.CHUNK_CORR_MIN}, "
              f"refined > {CS.REFINED_CORR_MIN}, int8 chunk vs bf16 > "
              f"{CS.INT8_CHUNK_CORR_MIN}", flush=True)
        chk = CS.checked_tick(t, shadow=bool(shadows), **kw)
        print(f"{fault}: config ({c}) checked tick (gate: share <= 1) "
              + json.dumps({k: v for k, v in chk.items() if v["calls"]}), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    picked = sys.argv[1:] or list(FAULTS)
    rc = 0
    for fault in picked:
        src, text, repl, _, _ = FAULTS[fault]
        tmp = tempfile.mkdtemp(prefix=f"quant_{fault}_")
        try:
            shutil.copytree(os.path.join(ROOT, "vla_touch_tpu_torch"),
                            os.path.join(tmp, "vla_touch_tpu_torch"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp)
            edits = src if isinstance(src, tuple) else ((src, text, repl),) if src else ()
            for src, text, repl in edits:
                path = os.path.join(tmp, "vla_touch_tpu_torch", "csrc", src)
                code = open(path).read()
                if code.count(text) != 1:
                    raise RuntimeError(f"{fault}: the text to replace is not in {src} "
                                       f"exactly once")
                with open(path, "w") as f:
                    f.write(code.replace(text, repl))
            env = dict(os.environ, PYTHONPATH=tmp)
            r = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", fault],
                               cwd=tmp, env=env)
            rc = rc or r.returncode
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
