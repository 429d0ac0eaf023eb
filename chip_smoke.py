#!/usr/bin/env python3
"""Drive the PyTorch port's cold control tick on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from ``vla_touch_tpu_torch/csrc``
   (one nvcc per source, in parallel) and prints the card's name and power
   limit.
2. Holds each kernel against its plain PyTorch version on the card at every
   shape the tick gives it (K1 flash attention: SigLIP, DinoV2 and the three
   RDT-1B attentions, plus a ragged and a fully masked language mask, with
   q/k/v laid out as the modules pass them; K2 fused residual block: the
   12 BRIDGeR block shapes) and times kernel,
   plain version, a library yardstick (SDPA for K1) and the bound.  Kernel,
   plain and library times are device times (calls captured in a CUDA
   graph and replayed); the eager back-to-back loop, which the host's
   per-call work bounds at batch 1, is printed beside them.  The
   ``kernels`` line sums each time over the calls of one tick.
3. Runs the full-width cold tick with seeded random weights — SigLIP-so400m
   on 6 frames -> RDT-1B 5-step chunk -> DinoV2-small pair + GelSight marker
   force -> BRIDGeR 10-step refine — through the entry points a user calls,
   with the launch counts zeroed just before and read just after; then the
   same tick through the plain versions, and the stage correlations; then
   a checked tick, in which every K1 and K2 call is held to its plain
   version on the tick's own operands; then the tick's p50, and its stage
   times from ticks that synchronise after each stage.
   One more tick runs under ``torch.profiler``: the device's busy time,
   its idle share and the kernels with the most time.
4. Prints one ``kernels`` JSON line, the ``nvidia-smi`` line, and as the
   last line ``{"ok": true, "device": {...}}``.

Exits non-zero, without a result line, when CUDA is absent, when the port
package is not beside this script, or when any phase fails.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (data sheet)
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor cores
L2_BYTES = 50 * 1024 * 1024

# K1's max abs error is held to K1_TOL x max|plain| at each shape, since the
# outputs' scale runs from ~0.13 (4374 keys) to ~2 (64 keys).  The
# kernel's output and its p in p.v are bf16 (2^-8 relative): a sound kernel
# reads 2e-3..6e-3 of the max, one KV tile dropped or the mask ignored
# 0.17..0.82 (tools/torch_k1_fault_control.py).
K1_TOL = 2e-2
# K2 at the block shapes, on N(0, 1) inputs: bf16 output of O(1..5)
# activations vs the f32 plain version, max abs error.
K2_TOL = 3e-2
# K2 on the tick's own operands (checked_tick), whose scale the random-weight
# chunk sets (outputs reach the hundreds): max abs error <= K2_TICK_TOL x
# max|plain|, as K1's.
K2_TICK_TOL = 2e-2
# Kernel tick vs plain tick.  SigLIP tokens and DinoV2 features read
# 0.99993-0.99995 sound and 0.9991-0.9993 with K1's last KV tile dropped.
# At random weights the chunk and refined actions barely depend on the
# conditions: they read 0.99998-0.99999 sound and with either K1 fault, so
# these two gates catch only faults outside K1; checked_tick holds every
# kernel call of the tick to its plain version (tools/torch_k1_fault_control.py).
TOKEN_CORR_MIN = 0.9998
CHUNK_CORR_MIN = 0.9995
REFINED_CORR_MIN = 0.9995


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of one ``fn()`` call over ``reps`` back-to-back
    calls, CUDA events around the whole run."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one ``fn()`` call: ``calls`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events.  Unlike
    :func:`cuda_time_ms` this leaves out the host's per-call work (Python
    wrapper, checks, allocation, launch), which at batch 1 is slower than
    the small kernels themselves."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (calls * replays)
    del graph
    return ms


def corr(a, b) -> float:
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.corrcoef(a, b)[0, 1])


@contextlib.contextmanager
def plain_kernels():
    """Route both wrappers to their plain versions (comparison runs only)."""
    from vla_touch_tpu_torch.ops import flash_attention as FA
    from vla_touch_tpu_torch.ops import unet_kernels as UK

    orig = FA.flash_attention, UK.resblock_fused
    FA.flash_attention = FA.attention_plain

    def ref(x, cond, p, *, n_groups=8, eps=1e-5):
        return UK.resblock_ref(x, cond, p, n_groups=n_groups, eps=eps).to(x.dtype)

    UK.resblock_fused = ref
    try:
        yield
    finally:
        FA.flash_attention, UK.resblock_fused = orig


def checked_tick(t) -> dict:
    """One tick in which every K1 and K2 call also runs its plain version on
    the same operands: the main path's own data, strides and masks.  Per
    kernel: the calls, and the call whose max abs error takes the largest
    share of its tolerance, rel_tol x max|plain| (K1_TOL, K2_TICK_TOL)."""
    from vla_touch_tpu_torch.ops import flash_attention as FA
    from vla_touch_tpu_torch.ops import unet_kernels as UK

    seen = {"K1": dict(calls=0, share=0.0), "K2": dict(calls=0, share=0.0)}

    def note(kernel, got, want, rel_tol):
        err = float((got.float() - want).abs().max())
        scale = float(want.abs().max())
        s = seen[kernel]
        s["calls"] += 1
        share = err / (rel_tol * scale) if np.isfinite(err) and scale > 0 else (
            0.0 if err == 0.0 else float("inf"))
        if share >= s["share"]:
            s.update(share=share, err=err, max_plain=scale, tol=rel_tol * scale)

    k1, k2 = FA.flash_attention, UK.resblock_fused

    def k1_checked(q, k, v, kv_mask=None, scale=None):
        got = k1(q, k, v, kv_mask=kv_mask, scale=scale)
        note("K1", got, FA.attention_plain(q, k, v, kv_mask=kv_mask, scale=scale).float(),
             K1_TOL)
        return got

    def k2_checked(x, cond, p, *, n_groups=8, eps=1e-5):
        got = k2(x, cond, p, n_groups=n_groups, eps=eps)
        note("K2", got, UK.resblock_ref(x, cond, p, n_groups=n_groups, eps=eps),
             K2_TICK_TOL)
        return got

    # each wrapper bumps the count of the function its module name holds,
    # so the stand-ins carry counts of their own and the kernels' stay as
    # the main path left them
    k1_checked.launches = k2_checked.launches = 0
    FA.flash_attention, UK.resblock_fused = k1_checked, k2_checked
    try:
        run_tick(t)
    finally:
        FA.flash_attention, UK.resblock_fused = k1, k2
    return seen


# ---- K1 ----------------------------------------------------------------------

# (name, B, Lq, Lkv, H, D, layout, mask kind, calls per tick).  The layout
# is that of the operands on the main path: "vit" separate q/k/v
# projections, all contiguous (models/encoders/vit.py); "self" the fused
# qkv projection of ops/nn.py's SelfAttention (q, k normed copies, v a
# strided view); "cross" a q projection and the fused kv projection of
# CrossAttention / CrossAttentionSized (k a normed copy, v a strided view).
K1_SHAPES = [
    ("siglip_self", 6, 729, 729, 16, 72, "vit", None, 27),
    ("dinov2_self", 2, 730, 730, 6, 64, "vit", None, 12),
    ("rdt_self", 1, 67, 67, 32, 64, "self", None, 140),
    ("rdt_image_cross", 1, 67, 4374, 32, 64, "cross", None, 70),
    ("rdt_lang_cross", 1, 67, 64, 32, 64, "cross", "ragged", 70),
    ("rdt_lang_cross_empty_row", 2, 67, 64, 32, 64, "cross", "empty", 0),
]


def k1_operands(gen, B, Lq, Lkv, H, D, layout):
    """One bf16 (q, k, v) on the card, laid out as ``layout`` says."""
    import torch

    def mk(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    if layout == "vit":
        return mk(B, Lq, H, D), mk(B, Lkv, H, D), mk(B, Lkv, H, D)
    if layout == "self":
        assert Lq == Lkv
        qkv = mk(B, Lq, 3, H, D)
        return qkv[:, :, 0].contiguous(), qkv[:, :, 1].contiguous(), qkv[:, :, 2]
    kv = mk(B, Lkv, 2, H, D)
    return mk(B, Lq, H, D), kv[:, :, 0].contiguous(), kv[:, :, 1]


def k1_mask(B, Lkv, kind):
    """None, or a (B, Lkv) mask: row 0 keeps 50 keys ("ragged"), and row 1
    keeps none as well ("empty")."""
    import torch

    if kind is None:
        return None
    mask = torch.ones((B, Lkv), dtype=torch.bool, device="cuda")
    mask[0, 50:] = False
    if kind == "empty":
        mask[1, :] = False
    return mask


def k1_check(name, q, k, v, mask):
    """K1 against its plain version on the same operands; returns (max abs
    error, tolerance) and raises on a miss."""
    import torch

    from vla_touch_tpu_torch.ops import flash_attention as FA

    got = FA.flash_attention(q, k, v, kv_mask=mask)
    want = FA.attention_plain(q, k, v, kv_mask=mask).float()
    torch.cuda.synchronize()
    err = float((got.float() - want).abs().max())
    tol = K1_TOL * float(want.abs().max())
    if not np.isfinite(err) or err > tol:
        raise AssertionError(f"K1 {name}: max abs err {err} > {tol} "
                             f"({K1_TOL} x max|plain|)")
    empty = mask is not None and not bool(mask.any(dim=1).all())
    if empty and float(got[~mask.any(dim=1)].float().abs().max()) != 0.0:
        raise AssertionError(f"K1 {name}: fully masked rows must be 0")
    return err, tol


def k1_bound_ms(B, Lq, Lkv, H, D, masked):
    """(bytes ms, operations ms): q, k, v, mask read once, out written once;
    the two matmuls' 4 B H Lq Lkv D operations at the bf16 peak."""
    nbytes = 2 * (2 * B * Lq * H * D + 2 * B * Lkv * H * D) + (B * Lkv if masked else 0)
    flops = 4.0 * B * H * Lq * Lkv * D
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / BF16_FLOPS


def check_k1(gen):
    import torch.nn.functional as F

    from vla_touch_tpu_torch.ops import flash_attention as FA

    rows = []
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, err=0.0,
               bytes_ms=0.0, ops_ms=0.0)
    for name, B, Lq, Lkv, H, D, layout, mask_kind, calls in K1_SHAPES:
        # enough distinct operand sets that a timing loop misses the L2 cache
        n_sets = max(1, min(8, -(-2 * L2_BYTES // (2 * 2 * B * Lkv * H * D))))
        sets = [k1_operands(gen, B, Lq, Lkv, H, D, layout) for _ in range(n_sets)]
        mask = k1_mask(B, Lkv, mask_kind)
        err, tol = k1_check(name, *sets[0], mask)
        tot["err"] = max(tot["err"], err)
        where = f"K1 {name:26s} B{B} Lq{Lq} Lkv{Lkv} H{H} D{D} {layout:5s}"
        if calls == 0:
            log(f"{where}: err {err:.3e} (tol {tol:.3e}), fully masked rows 0; "
                f"check only")
            continue
        it = [0]

        def nxt():
            it[0] = (it[0] + 1) % n_sets
            return sets[it[0]]

        def run_kernel():
            FA.flash_attention(*nxt(), kv_mask=mask)

        def run_plain():
            FA.attention_plain(*nxt(), kv_mask=mask)

        sdpa_mask = None if mask is None else mask[:, None, None, :]

        def run_library():
            qq, kk, vv = nxt()
            F.scaled_dot_product_attention(qq.transpose(1, 2), kk.transpose(1, 2),
                                           vv.transpose(1, 2), attn_mask=sdpa_mask)

        ms = graph_time_ms(run_kernel)
        eager_ms = cuda_time_ms(run_kernel)
        plain_ms = graph_time_ms(run_plain, calls=5)
        lib_ms = graph_time_ms(run_library)
        b_ms, o_ms = k1_bound_ms(B, Lq, Lkv, H, D, mask is not None)
        bound = max(b_ms, o_ms)
        rows.append(dict(shape=name, B=B, Lq=Lq, Lkv=Lkv, H=H, D=D, layout=layout,
                         calls=calls, max_abs_err=err, tol=tol, ms=ms, eager_ms=eager_ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound))
        log(f"{where}: err {err:.3e} "
            f"(tol {tol:.3e}) kernel {ms:.4f} ms (eager loop {eager_ms:.4f}) "
            f"plain {plain_ms:.4f} ms sdpa {lib_ms:.4f} ms bound {bound:.4f} ms "
            f"x{calls}/tick")
        tot["ms"] += calls * ms
        tot["plain_ms"] += calls * plain_ms
        tot["library_ms"] += calls * lib_ms
        tot["bound_ms"] += calls * bound
        tot["bytes_ms"] += calls * b_ms
        tot["ops_ms"] += calls * o_ms
    return rows, tot


# ---- K2 ----------------------------------------------------------------------

# (name, T, Cin, C) of the 12 blocks of one BRIDGeR UNet pass, S = 2, B = 1
K2_SHAPES = [
    ("down0_res0", 16, 10, 256), ("down0_res1", 16, 256, 256),
    ("down1_res0", 8, 256, 512), ("down1_res1", 8, 512, 512),
    ("down2_res0", 4, 512, 512), ("down2_res1", 4, 512, 512),
    ("mid0", 4, 512, 512), ("mid1", 4, 512, 512),
    ("up0_res0", 4, 1024, 512), ("up0_res1", 4, 512, 512),
    ("up1_res0", 8, 1024, 256), ("up1_res1", 8, 256, 256),
]
K2_G, K2_K, K2_S, K2_STEPS = 512, 5, 2, 10


def k2_params(gen, S, Cin, C, G, K):
    import torch

    def w(*shape, scale):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)

    p = {"w0": w(S, K, Cin, C, scale=(K * Cin) ** -0.5), "b0": w(S, C, scale=0.1),
         "g0w": 1 + w(S, C, scale=0.1), "g0b": w(S, C, scale=0.1),
         "fw": w(S, G, 2 * C, scale=G ** -0.5), "fb": w(S, 2 * C, scale=0.1),
         "w1": w(S, K, C, C, scale=(K * C) ** -0.5), "b1": w(S, C, scale=0.1),
         "g1w": 1 + w(S, C, scale=0.1), "g1b": w(S, C, scale=0.1)}
    if Cin != C:
        p["wr"] = w(S, Cin, C, scale=Cin ** -0.5)
        p["br"] = w(S, C, scale=0.1)
    return p


def k2_bound_ms(S, B, T, Cin, C, G, K):
    """(bytes ms, operations ms): every weight, x, cond read once, out
    written once; the conv, residual and FiLM multiply-adds at the bf16
    peak."""
    params = S * (K * Cin * C + K * C * C + G * 2 * C + 2 * C + 6 * C
                  + ((Cin * C + C) if Cin != C else 0))
    nbytes = 2 * (params + S * B * T * Cin + S * B * G + S * B * T * C)
    flops = 2.0 * S * B * (T * (K * Cin * C + K * C * C + (Cin * C if Cin != C else 0))
                           + G * 2 * C)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / BF16_FLOPS


def check_k2(gen):
    import torch

    from vla_touch_tpu_torch.ops import unet_kernels as UK

    rows = []
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, bytes_ms=0.0, ops_ms=0.0)
    S, B, G, K = K2_S, 1, K2_G, K2_K
    for name, T, Cin, C in K2_SHAPES:
        x = torch.randn((S, B, T, Cin), generator=gen, device="cuda").to(torch.bfloat16)
        cond = torch.randn((S, B, G), generator=gen, device="cuda").to(torch.bfloat16)
        # the block's weights per tick are streamed once per SDE step; keep
        # enough copies that the timing loop misses the L2 cache
        sets = [k2_params(gen, S, Cin, C, G, K) for _ in range(4)]
        got = UK.resblock_fused(x, cond, sets[0])
        want = UK.resblock_ref(x, cond, sets[0])
        torch.cuda.synchronize()
        err = float((got.float() - want).abs().max())
        max_plain = float(want.abs().max())
        if not np.isfinite(err) or err > K2_TOL:
            raise AssertionError(f"K2 {name}: max abs err {err} > {K2_TOL}")
        it = [0]

        def nxt():
            it[0] = (it[0] + 1) % len(sets)
            return sets[it[0]]

        ms = graph_time_ms(lambda: UK.resblock_fused(x, cond, nxt()))
        eager_ms = cuda_time_ms(lambda: UK.resblock_fused(x, cond, nxt()))
        plain_ms = graph_time_ms(
            lambda: UK.resblock_ref(x, cond, nxt()).to(torch.bfloat16))
        b_ms, o_ms = k2_bound_ms(S, B, T, Cin, C, G, K)
        bound = max(b_ms, o_ms)
        rows.append(dict(shape=name, T=T, Cin=Cin, C=C, calls=K2_STEPS,
                         max_abs_err=err, max_plain=max_plain, ms=ms, eager_ms=eager_ms,
                         plain_ms=plain_ms, bound_ms=bound))
        log(f"K2 {name:11s} S{S} B{B} T{T:2d} Cin{Cin:5d} C{C}: err {err:.3e} "
            f"(tol {K2_TOL}, max|plain| {max_plain:.2f}) kernel {ms:.4f} ms "
            f"(eager loop {eager_ms:.4f}) "
            f"plain {plain_ms:.4f} ms bound {bound:.4f} ms x{K2_STEPS}/tick")
        tot["ms"] += K2_STEPS * ms
        tot["plain_ms"] += K2_STEPS * plain_ms
        tot["bound_ms"] += K2_STEPS * bound
        tot["bytes_ms"] += K2_STEPS * b_ms
        tot["ops_ms"] += K2_STEPS * o_ms
        tot["err"] = max(tot["err"], err)
    return rows, tot


def bound_by(tot) -> str:
    return "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"


# ---- the cold tick -------------------------------------------------------------

def build_tick(seed: int = 0):
    """Full-width models with seeded random weights and one tick's inputs."""
    import torch

    from vla_touch_tpu_torch.config import BridgeControllerConfig
    from vla_touch_tpu_torch.models.controllers import bridge as BR
    from vla_touch_tpu_torch.models.encoders.vit import (DINOV2_SMALL, DinoV2Encoder,
                                                         init_vit)
    from vla_touch_tpu_torch.ops import marker_tracking as MT
    from vla_touch_tpu_torch.runtime import policy as P

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pcfg = P.franka_eef_policy_config()
    model = P.create_model(pcfg, seed=seed, cache_frames=False)
    # the zero-initialised final projection would make every chunk 0
    fc2 = model.rdt.model.final_ffn.fc2.weight
    fc2.copy_((torch.randn(fc2.shape, generator=gen, device=dev) * 0.02).to(fc2.dtype))
    dino = init_vit(DinoV2Encoder, DINOV2_SMALL, seed=seed + 3, device=dev)
    bcfg = BridgeControllerConfig(inference_dtype="bfloat16", horizon=16)
    bridge = BR.init_bridge_controller(bcfg, seed=seed + 1, device=dev)
    stacked = BR.stacked_vs(bridge)            # once per set of weights
    stats = {"vla_mins": np.zeros(10, np.float32), "vla_maxs": np.ones(10, np.float32),
             "action_mins": np.zeros(10, np.float32),
             "action_maxs": np.ones(10, np.float32)}
    S = pcfg.image_size
    m = pcfg.rdt.model
    text_mask = np.zeros((1, 64), bool)
    text_mask[0, :50] = True                    # a ragged language mask
    gel0 = torch.as_tensor(rng.integers(0, 256, (240, 320)).astype(np.float32), device=dev)
    inp = dict(
        frames=[rng.integers(0, 256, (S, S, 3)).astype(np.uint8) for _ in range(6)],
        proprio=rng.normal(size=(10,)).astype(np.float32),
        text=rng.normal(size=(1, 64, m.lang_token_dim)).astype(np.float32),
        text_mask=text_mask,
        init_noise=torch.randn((1, m.horizon, m.output_dim), generator=gen, device=dev),
        dino_frames=torch.as_tensor(rng.integers(0, 256, (2, 384, 384, 3)).astype(np.uint8),
                                    device=dev),
        gel=torch.as_tensor(rng.integers(0, 256, (240, 320)).astype(np.float32), device=dev),
        baseline=MT.calibrate(gel0),            # once per episode
        state10=torch.as_tensor(rng.normal(size=(1, 10)).astype(np.float32), device=dev),
        noise_seq=torch.randn((bcfg.interpolant.diffusion_steps, 1, bcfg.horizon, 10),
                              generator=gen, device=dev))
    return dict(pcfg=pcfg, model=model, dino=dino, bcfg=bcfg, bridge=bridge,
                stacked=stacked, stats=stats, inp=inp)


def run_tick(t, stage_ms=None) -> dict:
    """One cold control tick through the user entry points.

    With a ``stage_ms`` dict, every stage ends in a synchronise and its host
    ms is appended to ``stage_ms[stage]``; SigLIP's end inside ``step`` is
    marked by a forward hook on the vision tower."""
    import torch

    from vla_touch_tpu_torch.models.controllers import bridge as BR
    from vla_touch_tpu_torch.ops import marker_tracking as MT
    from vla_touch_tpu_torch.utils.image import imagenet_normalize

    marks = []

    def mark(stage):
        if stage_ms is not None:
            torch.cuda.synchronize()
            marks.append((stage, time.perf_counter()))

    inp = t["inp"]
    hook = None
    if stage_ms is not None:
        hook = t["model"].vision.register_forward_hook(
            lambda *_: mark("siglip_6_frames"))
    mark("start")
    try:
        actions = t["model"].step(inp["proprio"], inp["frames"], inp["text"],
                                  inp["text_mask"], init_noise=inp["init_noise"])
    finally:
        if hook is not None:
            hook.remove()
    mark("rdt_chunk_5_steps")
    with torch.inference_mode():
        feats = t["dino"](imagenet_normalize(inp["dino_frames"]).to(torch.bfloat16)).float()
    mark("dinov2_pair")
    force = MT.estimate_force(inp["gel"], inp["baseline"])["force"]
    mark("marker_force")
    vla10 = torch.as_tensor(actions[:, : t["bcfg"].horizon], device="cuda")
    refined = BR.bridge_predict(t["bcfg"], t["bridge"], t["stats"], inp["state10"], vla10,
                                feats[:1], feats[1:], force[None], stacked=t["stacked"],
                                noise_seq=inp["noise_seq"])
    mark("bridger_refine_10_steps")
    torch.cuda.synchronize()
    for (_, t0), (stage, t1) in zip(marks, marks[1:]):
        stage_ms.setdefault(stage, []).append(1e3 * (t1 - t0))
    return dict(actions=actions, dino=feats.cpu().numpy(), force=force.cpu().numpy(),
                refined=refined.cpu().numpy())


def siglip_tokens(t):
    import torch

    from vla_touch_tpu_torch.runtime import policy as P

    frames = torch.as_tensor(np.stack(t["inp"]["frames"])[None], device="cuda")
    mask = torch.ones((1, 6), dtype=torch.bool, device="cuda")
    return P.encode_frames(t["pcfg"], t["model"].vision, frames, mask).float().cpu().numpy()


def profile_tick(t, top: int = 12) -> dict:
    """One tick under ``torch.profiler``: the device's busy time (kernel
    durations summed; one stream, so they do not overlap), its idle share
    of the tick's host wall time, and the kernels with the most device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_tick(t)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    if busy == 0.0:
        raise AssertionError("the profiler saw no CUDA kernel: device time not measured")
    groups = {"K1 flash_fwd_kernel": 0.0, "K2 resblock_*": 0.0, "other": 0.0}
    for name, (ms, _) in by_name.items():
        key = ("K1 flash_fwd_kernel" if "flash_fwd_kernel" in name else
               "K2 resblock_*" if "resblock_" in name else "other")
        groups[key] += ms
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(wall_ms=wall_ms, device_busy_ms=busy, idle_share=1.0 - busy / wall_ms,
                groups_ms=groups,
                top=[dict(name=n[:90], ms=ms, calls=c) for n, (ms, c) in ranked])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from vla_touch_tpu_torch.csrc import build
    from vla_touch_tpu_torch.ops import flash_attention as FA
    from vla_touch_tpu_torch.ops import unet_kernels as UK

    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    build.build_all(verbose=True)
    log(f"build: {time.perf_counter() - t0:.1f} s")
    card = gpu_line()
    log(f"gpu: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gen = torch.Generator(device="cuda").manual_seed(1234)
    k1_rows, k1 = check_k1(gen)
    k2_rows, k2 = check_k2(gen)

    t = build_tick(seed=0)
    run_tick(t)                                  # warm-up (allocator, cuBLAS)
    FA.flash_attention.launches = 0
    UK.resblock_fused.launches = 0
    out = run_tick(t)
    n1, n2 = FA.flash_attention.launches, UK.resblock_fused.launches
    log(f"main path launches: K1 {n1} (need >= 319), K2 {n2} (need 120)")
    if n1 < 319 or n2 != 120:
        raise AssertionError(f"main path launches K1 {n1}, K2 {n2}")
    shapes = {"actions": (1, 64, 10), "dino": (2, 384), "force": (3,), "refined": (1, 16, 10)}
    for key, shape in shapes.items():
        if out[key].shape != shape or not np.all(np.isfinite(out[key])):
            raise AssertionError(f"{key}: shape {out[key].shape}, finite "
                                 f"{np.all(np.isfinite(out[key]))}")
    if float(np.abs(out["actions"]).max()) == 0.0:
        raise AssertionError("actions are all zero")

    tok_k = siglip_tokens(t)
    with plain_kernels():
        tok_p = siglip_tokens(t)
        out_p = run_tick(t)
    c_tok = corr(tok_k, tok_p)
    c_chunk = corr(out["actions"], out_p["actions"])
    c_dino = corr(out["dino"], out_p["dino"])
    c_ref = corr(out["refined"], out_p["refined"])
    log(f"kernel vs plain tick: siglip token corr {c_tok:.6f} (min {TOKEN_CORR_MIN}), "
        f"chunk corr {c_chunk:.6f} (min {CHUNK_CORR_MIN}), dinov2 corr {c_dino:.6f} "
        f"(min {TOKEN_CORR_MIN}), refined corr {c_ref:.6f} (min {REFINED_CORR_MIN})")
    if not (c_tok > TOKEN_CORR_MIN and c_dino > TOKEN_CORR_MIN
            and c_chunk > CHUNK_CORR_MIN and c_ref > REFINED_CORR_MIN):
        raise AssertionError("kernel tick disagrees with the plain tick")
    chk = checked_tick(t)
    log("one tick's kernel calls, each against its plain version on the same "
        "operands (worst call): " + json.dumps(chk))
    for kernel, need in (("K1", n1), ("K2", n2)):
        if chk[kernel]["calls"] != need or not chk[kernel]["share"] <= 1.0:
            raise AssertionError(f"{kernel} on the tick's own operands: {chk[kernel]}")

    ticks = []
    for _ in range(5):
        t1 = time.perf_counter()
        run_tick(t)
        ticks.append(1e3 * (time.perf_counter() - t1))
    with plain_kernels():
        plain_ticks = []
        for _ in range(3):
            t1 = time.perf_counter()
            run_tick(t)
            plain_ticks.append(1e3 * (time.perf_counter() - t1))
    stages = {}
    for _ in range(5):
        run_tick(t, stage_ms=stages)
    log(f"cold tick p50 {np.median(ticks):.2f} ms (ticks {[round(x, 2) for x in ticks]}); "
        f"plain-version tick p50 {np.median(plain_ticks):.2f} ms")
    log("stage p50 ms (ticks with a synchronise after each stage): " + json.dumps(
        {k: round(float(np.median(v)), 3) for k, v in stages.items()}))
    log("tick profile: " + json.dumps(profile_tick(t)))
    log("k1 shapes: " + json.dumps(k1_rows))
    log("k2 shapes: " + json.dumps(k2_rows))

    kernels = [
        dict(name="flash_attention", route="cuda",
             source="vla_touch_tpu_torch/csrc/flash_attention.cu",
             replaces="vla_touch_tpu/ops/pallas_attention.py:126",
             launches=n1, max_abs_err=k1["err"], ms=k1["ms"], plain_ms=k1["plain_ms"],
             bound_ms=k1["bound_ms"], bound_by=bound_by(k1), library_ms=k1["library_ms"]),
        dict(name="resblock_fused", route="cuda",
             source="vla_touch_tpu_torch/csrc/resblock.cu",
             replaces="vla_touch_tpu/ops/pallas_unet.py:203",
             launches=n2, max_abs_err=k2["err"], ms=k2["ms"], plain_ms=k2["plain_ms"],
             bound_ms=k2["bound_ms"], bound_by=bound_by(k2), library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
