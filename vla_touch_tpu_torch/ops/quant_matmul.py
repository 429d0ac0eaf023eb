"""K6 (a8w8) and K8 (w4a8): the wrappers of ``csrc/a8w8_matmul.cu`` and
``csrc/w4a8_matmul.cu``, and the dispatchers of the serving path
(counterpart of the serving part of ``vla_touch_tpu/ops/pallas_matmul.py``);
K7 (a8w8, large M) and K5 (w8a16): the wrappers of
``csrc/a8w8_matmul_large.cu`` and ``csrc/w8a16_matmul.cu``, reached only
through their own entries (:func:`a8w8_matmul_large`, :func:`w8a16_matmul`
and :func:`qdense_kernel_w8a16`), since no module of the JAX package
dispatches ``a8w8_matmul_large`` or ``w8a16_matmul`` either.

:func:`a8w8_matmul` and :func:`w4a8_matmul` launch their CUDA kernel on
CUDA tensors and compute their plain versions (``ops/quant.py::qdense`` /
``qdense_w4``) on CPU tensors; ``.launches`` counts wrapper calls that
launched the kernel (each is two CUDA launches: the per-token quantization
of x, then the product).  Both write bf16, the serving path's only output
type; the plain versions also take ``out_dtype``.

:func:`qdense_kernel_a8w8` and :func:`qdense_kernel_w4` mirror the routing
of ``qdense_pallas_a8w8`` / ``qdense_pallas_w4`` (``pallas_matmul.py:
989-1031``), bf16 out: M > 512 (the once-per-chunk condition precompute,
which the JAX package leaves to XLA) goes to the plain ``qdense`` /
``qdense_w4``, and so does an int4 leaf whose N is not a multiple of 128 or
whose group size is not a multiple of 32; everything else goes to the
kernel of the leaf's layout, int8 -> K6, grouped int4 -> K8.

On a CUDA tensor that requires grad, under autograd, every wrapper raises
(``csrc/build.py::refuse_grad``): K8's autograd route is
:class:`W4A8MatmulFn`, which :func:`qdense_kernel_w4` takes under grad;
K5-K7 have none, as their JAX kernels have no differentiation rule.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from vla_touch_tpu_torch.csrc import build
from vla_touch_tpu_torch.ops import quant as Q
from vla_touch_tpu_torch.utils.device import sm_count

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


class _Int8Leaf(NamedTuple):
    w_i8: torch.Tensor
    scale: torch.Tensor
    bias: Optional[torch.Tensor]


class _Int4Leaf(NamedTuple):
    w4_pack: torch.Tensor
    scale4: torch.Tensor
    bias: Optional[torch.Tensor]


def a8w8_plain(x, w_i8, scale, bias=None, out_dtype=torch.bfloat16):
    """The plain version of K6 (``ops/quant.py::qdense``)."""
    return Q.qdense(x, _Int8Leaf(w_i8, scale, bias), out_dtype=out_dtype)


def w4a8_plain(x, w4_pack, scale4, bias=None, out_dtype=torch.bfloat16):
    """The plain version of K8 (``ops/quant.py::qdense_w4`` below M = 513;
    the kernel has no large-M branch)."""
    *lead, K = x.shape
    if x.reshape(-1, K).shape[0] > 512:
        raise ValueError("w4a8_plain: the kernel's function is defined for M <= 512")
    return Q.qdense_w4(x, _Int4Leaf(w4_pack, scale4, bias), out_dtype=out_dtype)


def a8w8_large_plain(x, w_i8, scale, bias=None, out_dtype=torch.bfloat16):
    """The plain version of K7: what ``pallas_matmul.py::a8w8_matmul_large``
    computes (:257-260 and ``_i8mm_kernel``).  Not quite ``qdense``: x is
    quantized from float32 as given, and a row scales by ``amax * (1/127)``
    where ``qdense`` divides by 127 (one ulp apart for some amax); the
    int32 sum is exact (``Q.int_matmul``), the rest float32 in the kernel's
    order, ``(acc * rs) * scale + bias``."""
    *lead, K = x.shape
    x_i8, amax = Q.quantize_rows(x.reshape(-1, K))
    y = Q.int_matmul(x_i8, w_i8).float() * (amax * (1.0 / 127.0)) * scale
    if bias is not None:
        y = y + bias
    return y.to(out_dtype).reshape(*lead, -1)


def w8a16_plain(x, w_i8, scale, bias=None, out_dtype=torch.bfloat16):
    """The plain version of K5 (``pallas_matmul.py::_w8a16_kernel``): x
    rounded to bf16, the int8 weights as they are, a float32 product of
    those exact values (not ``Q.dense_f32acc``, which rounds the product to
    bf16 on the card), then ``acc * scale + bias`` in float32."""
    *lead, K = x.shape
    y = x.reshape(-1, K).to(torch.bfloat16).float() @ w_i8.float().t()
    y = y * scale
    if bias is not None:
        y = y + bias
    return y.to(out_dtype).reshape(*lead, -1)


def _check_x(name, x, K):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: x must be bfloat16 or float32, got {x.dtype}")
    x2 = x.reshape(-1, K)
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    return x2


def _check_vec(name, what, t, n, device):
    if t.dtype != torch.float32 or t.shape != (n,) or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(f"{name}: {what} must be a contiguous float32 ({n},) on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_w_i8(name, w_i8, K, device):
    if w_i8.dtype != torch.int8 or w_i8.dim() != 2 or w_i8.shape[1] != K \
            or not w_i8.is_contiguous() or w_i8.device != device or w_i8.data_ptr() % 16:
        raise ValueError(f"{name}: w_i8 must be a contiguous, 16-byte aligned int8 (N, {K}) "
                         f"on {device}, got {w_i8.dtype} {tuple(w_i8.shape)} on {w_i8.device}")


# K6's plan: a CTA owns 32 * wn columns (wn warps across them), up to
# K6_MAX_MT 16-row tiles and one of `splits` ranges of 64-wide K chunks; the
# splits of a tile form one thread-block cluster, at most K6_MAX_SPLITS, and
# at most K6_TALL_SPLITS where a CTA holds three or more row tiles (its 150
# KB+ of shared memory make larger clusters slow to place on an H100)
K6_CHUNK = 64
K6_MAX_MT = 5
K6_MAX_SPLITS = 8
K6_TALL_SPLITS = 2
K6_MIN_CHUNKS = 4
K6_WN = 2


def k6_split_chunks(nc: int, splits: int, z: int) -> tuple:
    """[first, end) 64-wide K chunks of split ``z`` of ``nc`` chunks: the
    splits differ by at most one chunk (the kernel's ``split_chunk``)."""
    return z * nc // splits, (z + 1) * nc // splits


def k6_plan(M: int, N: int, K: int, n_sms: int) -> tuple:
    """(16-row tiles per CTA, warps across 32-column blocks, K splits) of a
    K6 call on ``n_sms`` SMs.  The tiles (column tiles x row blocks) split K
    into as many ranges as one CTA per SM holds, so that a call whose tiles
    leave SMs idle fills them, but at least K6_MIN_CHUNKS 64-wide chunks per
    split and no more splits than the cluster cap of its row tiles allows.
    Warps across columns: 4 (128-column tiles) where those give one or two
    CTAs per SM without a split (the planner's widest products: two such
    CTAs share an SM at one or two row tiles), else K6_WN."""
    mt = min(K6_MAX_MT, -(-M // 16))
    wide = k6_tiles(M, N, (mt, 4, 1))
    wn = 4 if n_sms <= wide <= 2 * n_sms else K6_WN
    tiles = k6_tiles(M, N, (mt, wn, 1))
    nc = -(-K // K6_CHUNK)
    cap = K6_TALL_SPLITS if mt >= 3 else K6_MAX_SPLITS
    return mt, wn, fill_splits(tiles, nc, n_sms, K6_MIN_CHUNKS, cap)


def fill_splits(tiles: int, nc: int, ctas: int, min_chunks: int, cap: int) -> int:
    """K splits of a split-K plan (K6, K5): as many as ``ctas`` CTAs at
    once hold over ``tiles`` output tiles, so that tiles that leave SMs
    idle fill them, but at least ``min_chunks`` of the ``nc`` 64-wide
    chunks per split and at most ``cap`` (the tile's cluster); at least 1."""
    return max(1, min(ctas // tiles, nc // min_chunks, cap))


def k6_tiles(M: int, N: int, plan: tuple) -> int:
    """Output tiles (column tiles x row blocks) of a K6 plan."""
    mt, wn, _ = plan
    return -(-M // (16 * mt)) * -(-N // (32 * wn))


def a8w8_matmul(x, w_i8, scale, bias=None):
    """x (..., K) bf16/f32 . int8 W -> (..., N) bf16.  ``w_i8`` (N, K) int8
    contiguous and 16-byte aligned with K % 16 == 0, ``scale`` (N,) and
    ``bias`` (N,) float32.
    CUDA: the K6 kernel under :func:`k6_plan`; CPU: :func:`a8w8_plain`;
    anything else raises."""
    if x.device.type == "cpu":
        return a8w8_plain(x, w_i8, scale, bias)
    return _a8w8_launch(x, w_i8, scale, bias, None)


def _a8w8_launch(x, w_i8, scale, bias, plan):
    """Check the operands and launch K6 on CUDA tensors under ``plan`` (mt,
    wn, splits), or :func:`k6_plan`'s when None (the tools and tests time
    and check other plans)."""
    if x.device.type != "cuda":
        raise ValueError(f"a8w8_matmul: unsupported device {x.device}")
    build.refuse_grad("a8w8_matmul", None, x, scale, bias)
    *lead, K = x.shape
    _check_w_i8("a8w8_matmul", w_i8, K, x.device)
    if K % 16:
        raise ValueError(f"a8w8_matmul: K = {K} must be a multiple of 16")
    N = w_i8.shape[0]
    _check_vec("a8w8_matmul", "scale", scale, N, x.device)
    if bias is not None:
        _check_vec("a8w8_matmul", "bias", bias, N, x.device)
    x2 = _check_x("a8w8_matmul", x, K)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0 or N == 0:
        return out.reshape(*lead, N)
    plan = plan or k6_plan(M, N, K, sm_count(x.device.index))
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    rs = torch.empty((M,), dtype=torch.float32, device=x.device)
    lib, f = build.entry("a8w8_matmul", [_P, _I, _L, _P, _P, _P, _P, _P, _P] + [_I] * 6 + [_P])
    err = f(x2.data_ptr(), int(x2.dtype == torch.float32), x2.stride(0), w_i8.data_ptr(),
            scale.data_ptr(), None if bias is None else bias.data_ptr(), xq.data_ptr(),
            rs.data_ptr(), out.data_ptr(), M, N, K, *plan,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "a8w8_matmul")
    a8w8_matmul.launches += 1
    return out.reshape(*lead, N)


a8w8_matmul.launches = 0


# K8's plan.  Up to K8_WARP_MAX_M rows, the warp loop (mt 0): a CTA owns 16
# columns and all the rows (at most five 16-row tiles), so each weight byte
# is read once; measured faster there than the tile body on an H100
# (tools/torch_quant_ab.py, PERF.md).  Above, the tile body (mt
# K8_TILE_MT, 16-row tiles per warp): a CTA owns 64 rows by K8_BN columns
# and one of `splits` ranges of units (pairs of groups, one per nibble
# plane), the splits of a tile one thread-block cluster of at most
# K8_MAX_SPLITS.
K8_WARP_MAX_M = 80
K8_TILE_MT = 2
K8_BN = 128
K8_MAX_SPLITS = 8


def k8_split_units(units: int, splits: int, z: int) -> tuple:
    """[first, end) units of split ``z`` of ``units``: the splits differ by
    at most one unit (the kernel's ``split_unit``)."""
    return z * units // splits, (z + 1) * units // splits


def k8_plan(M: int, N: int, K: int, G: int, n_sms: int) -> tuple:
    """(mt, splits) of a K8 call on ``n_sms`` SMs: (0, 1), the warp loop,
    up to K8_WARP_MAX_M rows; else the tile body (K8_TILE_MT), its G/2
    units split so that the tiles (one CTA an SM) fill the card: tiles that
    leave SMs idle take as many splits as fit in one wave; tiles of one to
    one and a half waves take 2 (at most three waves of half-size CTAs in
    place of two ragged ones); more tiles none; at most K8_MAX_SPLITS and
    one unit a split."""
    if M <= K8_WARP_MAX_M:
        return 0, 1
    tiles = k8_tiles(M, N)
    splits = n_sms // tiles if tiles <= n_sms else 2 if 2 * tiles <= 3 * n_sms else 1
    return K8_TILE_MT, max(1, min(splits, G // 2, K8_MAX_SPLITS))


def k8_tiles(M: int, N: int) -> int:
    """CTA tiles (row blocks x column tiles) of K8's tile body."""
    return -(-M // (32 * K8_TILE_MT)) * -(-N // K8_BN)


# K7's tile: 128 rows (two consumer warpgroups of 64) by 256 columns
K7_BM = 128
K7_BN = 256


def k7_tiles(M: int, N: int) -> int:
    """Output tiles (row tiles x column tiles) of K7; the kernel's
    persistent grid of min(tiles, SMs) CTAs walks them row tiles fastest,
    CTA c taking tiles c, c + grid, ..."""
    return -(-M // K7_BM) * (N // K7_BN)


# K5's plan: K6's split-K skeleton with bf16 x.  A CTA owns 32 * wn columns
# (wn in K5_WNS: 128 or 256, so that x's K slice is read N / (32 wn) times),
# up to K5_MAX_MT 16-row tiles (two CTAs per SM at one or two) and one of
# `splits` ranges of 64-wide K chunks, the splits of a tile one cluster.
K5_MAX_MT = 5
K5_WNS = (4, 8)
K5_MIN_CHUNKS = 2


def k5_plan(M: int, N: int, K: int, n_sms: int, active=None) -> tuple:
    """(16-row tiles per CTA, warps across 32-column blocks, K splits) of a
    K5 call on ``n_sms`` SMs.  ``active(mt, wn, splits)``: how many
    clusters of ``splits`` CTAs the card holds at once (on the card
    :func:`k5_card_plan` asks CUDA's occupancy calculator; None: every CTA
    the SMs hold, two per SM at one or two row tiles, in full clusters).
    For each width, from the most splits that fill those CTAs
    (:func:`fill_splits`: at least K5_MIN_CHUNKS chunks a split, a cluster
    of at most K6_MAX_SPLITS) down to one, the plan whose busiest SM
    streams the fewest bytes wins: waves of clusters x the CTAs an SM
    hosts in a wave x a split's chunks x (weight columns + x rows, an x
    row's two bytes a chunk read from L2 counted as one), ties to the
    narrower width and more splits."""
    mt = min(K5_MAX_MT, -(-M // 16))
    nc = K // K6_CHUNK
    ctas = n_sms * (2 if mt <= 2 else 1)
    active = active or (lambda mt, wn, splits: ctas // splits)
    best = None
    for wn in K5_WNS:
        tiles = k5_tiles(M, N, (mt, wn, 1))
        for splits in range(fill_splits(tiles, nc, ctas, K5_MIN_CHUNKS, K6_MAX_SPLITS), 0, -1):
            wave = min(tiles, max(1, active(mt, wn, splits)))     # clusters at once
            cost = (-(-tiles // wave) * -(-wave * splits // n_sms) * -(-nc // splits)
                    * (min(N, 32 * wn) + min(M, 16 * mt)))
            if best is None or cost < best[0]:
                best = cost, (mt, wn, splits)
    return best[1]


def k5_card_plan(M: int, N: int, K: int, device) -> tuple:
    """:func:`k5_plan` on CUDA device ``device`` (an index or a
    torch.device): its SMs, and the clusters each plan places at once."""
    index = torch.device("cuda", device).index if isinstance(device, int) else device.index
    index = torch.cuda.current_device() if index is None else index
    return k5_plan(M, N, K, sm_count(index),
                   active=lambda mt, wn, splits: _k5_active_clusters(index, mt, wn, splits))


@functools.cache
def _k5_active_clusters(index: int, mt: int, wn: int, splits: int) -> int:
    """Clusters of plan (mt, wn, splits) that device ``index`` holds at
    once (``csrc/w8a16_matmul.cu::w8a16_active_clusters``)."""
    lib, f = build.entry("w8a16_matmul", [_I, _I, _I, ctypes.POINTER(ctypes.c_int)],
                         "w8a16_active_clusters")
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        build.check(lib, f(mt, wn, splits, ctypes.byref(n)), "w8a16_active_clusters")
    return n.value


def k5_tiles(M: int, N: int, plan: tuple) -> int:
    """Output tiles (column tiles x row blocks) of a K5 plan."""
    mt, wn, _ = plan
    return -(-M // (16 * mt)) * -(-N // (32 * wn))


def w4a8_matmul(x, w4_pack, scale4, bias=None):
    """x (..., K) bf16/f32 . grouped-int4 W -> (..., N) bf16, M <= 512.
    ``w4_pack`` (N, K/2) int8 contiguous and 16-byte aligned, plane-packed,
    K % 32 == 0 (and N % 4 == 0 where the tile body runs); ``scale4`` (G,
    N) float32, G even, group size K/G a multiple of 32; ``bias`` (N,)
    float32.  CUDA: the K8 kernel under :func:`k8_plan`; CPU:
    :func:`w4a8_plain`; anything else raises."""
    if x.device.type == "cpu":
        return w4a8_plain(x, w4_pack, scale4, bias)
    return _w4a8_launch(x, w4_pack, scale4, bias, None)


def _w4a8_launch(x, w4_pack, scale4, bias, plan):
    """Check the operands and launch K8 on CUDA tensors under ``plan`` (mt,
    splits): (0, 1) the warp loop, (K8_TILE_MT, splits) the tile body, or
    :func:`k8_plan`'s when None (the tools and tests time and check other
    plans)."""
    if x.device.type != "cuda":
        raise ValueError(f"w4a8_matmul: unsupported device {x.device}")
    build.refuse_grad("w4a8_matmul", "ops.quant_matmul.W4A8MatmulFn (qdense_kernel_w4 takes "
                      "it under grad)", x, scale4, bias)
    *lead, K = x.shape
    if w4_pack.dtype != torch.int8 or w4_pack.dim() != 2 or 2 * w4_pack.shape[1] != K \
            or not w4_pack.is_contiguous() or w4_pack.device != x.device \
            or w4_pack.data_ptr() % 16:
        raise ValueError(f"w4a8_matmul: w4_pack must be a contiguous, 16-byte aligned int8 "
                         f"(N, {K // 2}) on {x.device}, got {w4_pack.dtype} "
                         f"{tuple(w4_pack.shape)}")
    N = w4_pack.shape[0]
    if scale4.dtype != torch.float32 or scale4.dim() != 2 or scale4.shape[1] != N \
            or not scale4.is_contiguous() or scale4.device != x.device:
        raise ValueError(f"w4a8_matmul: scale4 must be a contiguous float32 (G, {N})")
    G = scale4.shape[0]
    if K % 32 or G % 2 or K % G or (K // G) % 32:
        raise ValueError(f"w4a8_matmul: K = {K}, G = {G}: needs K % 32 == 0, G even "
                         f"and a group size that is a multiple of 32")
    if bias is not None:
        _check_vec("w4a8_matmul", "bias", bias, N, x.device)
    x2 = _check_x("w4a8_matmul", x, K)
    M = x2.shape[0]
    if M > 512:
        raise ValueError(f"w4a8_matmul: M = {M}: the kernel serves M <= 512")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0 or N == 0:
        return out.reshape(*lead, N)
    plan = plan or k8_plan(M, N, K, G, sm_count(x.device.index))
    if plan[0] and N % 4:
        raise ValueError(f"w4a8_matmul: N = {N}: the tile body needs N % 4 == 0")
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    rs = torch.empty((M,), dtype=torch.float32, device=x.device)
    lib, f = build.entry("w4a8_matmul", [_P, _I, _L, _P, _P, _P, _P, _P, _P] + [_I] * 6 + [_P])
    err = f(x2.data_ptr(), int(x2.dtype == torch.float32), x2.stride(0),
            w4_pack.data_ptr(), scale4.data_ptr(),
            None if bias is None else bias.data_ptr(), xq.data_ptr(), rs.data_ptr(),
            out.data_ptr(), M, N, K, G, *plan,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "w4a8_matmul")
    w4a8_matmul.launches += 1
    return out.reshape(*lead, N)


w4a8_matmul.launches = 0


class W4A8MatmulFn(torch.autograd.Function):
    """K8 under autograd (the counterpart of ``pallas_matmul.py::
    _w4a8_matmul_diff``).  The forward is :func:`w4a8_matmul` (the kernel on
    CUDA, :func:`w4a8_plain` on the CPU) and saves x and the leaf; the
    backward is ``torch.autograd.grad`` of the plain ``ops/quant.py::
    qdense_w4`` on the saved x, for x and a float bias.  The packs and
    scales are frozen.

    That plain program rounds x to per-token int8 codes, and ``round`` has
    a zero derivative, so x's gradient flows only through each row's
    ``amax``: one nonzero a row (ties split it), at the element that sets
    the row's scale.  The JAX package's backward is that same vjp, so the
    port keeps it: its QLoRA training takes this gradient through every
    quantized linear at M <= 512."""

    @staticmethod
    def forward(ctx, x, w4_pack, scale4, bias):
        ctx.save_for_backward(x, w4_pack, scale4, bias)
        return w4a8_matmul(x, w4_pack, scale4, bias)

    @staticmethod
    def backward(ctx, g):
        x, w4_pack, scale4, bias = ctx.saved_tensors
        xx = x.detach().requires_grad_(ctx.needs_input_grad[0])
        bb = None if bias is None else bias.detach().requires_grad_(ctx.needs_input_grad[3])
        need = [t for t in (xx, bb) if t is not None and t.requires_grad]
        with torch.enable_grad():
            y = Q.qdense_w4(xx, _Int4Leaf(w4_pack, scale4, bb))
            grads = iter(torch.autograd.grad(y, need, g))
        dx = next(grads) if xx.requires_grad else None
        db = next(grads) if bb is not None and bb.requires_grad else None
        return dx, None, None, db


def needs_grad(*ts) -> bool:
    """Whether autograd records a call on ``ts``: grad enabled and a
    tensor among them that requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def a8w8_large_takes(K: int, N: int) -> bool:
    """Whether :func:`a8w8_matmul_large` sends a (K, N) product to K7: K a
    multiple of 128 and N of 512, as ``a8w8_matmul_large`` (:249, at its
    default ``block_n``) sends it to its kernel and else to XLA's
    ``qdense``."""
    return K % 128 == 0 and N % 512 == 0


def a8w8_matmul_large(x, w_i8, scale, bias=None):
    """x (..., K) bf16/f32 . int8 W -> (..., N) bf16, for large M (the
    once-per-chunk condition products over 4374 image tokens).  ``w_i8``
    (N, K) int8 contiguous and 16-byte aligned, ``scale`` and ``bias`` (N,)
    float32.

    Routes on shape alone, as the JAX function does: K not a multiple of
    128 or N not of 512 (:func:`a8w8_large_takes`) -> the plain
    ``ops/quant.py::qdense`` on any device (JAX: ``_xla_int8_fallback``).
    Else CUDA: the K7 kernel (a quantize launch, then the GEMM; counted
    once); CPU: :func:`a8w8_large_plain`; anything else raises."""
    *lead, K = x.shape
    N = w_i8.shape[0]
    if not a8w8_large_takes(K, N):
        return Q.qdense(x, _Int8Leaf(w_i8, scale, bias))
    if x.device.type == "cpu":
        return a8w8_large_plain(x, w_i8, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"a8w8_matmul_large: unsupported device {x.device}")
    build.refuse_grad("a8w8_matmul_large", None, x, scale, bias)
    _check_w_i8("a8w8_matmul_large", w_i8, K, x.device)
    _check_vec("a8w8_matmul_large", "scale", scale, N, x.device)
    if bias is not None:
        _check_vec("a8w8_matmul_large", "bias", bias, N, x.device)
    x2 = _check_x("a8w8_matmul_large", x, K)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0 or N == 0:
        return out.reshape(*lead, N)
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    rs = torch.empty((M,), dtype=torch.float32, device=x.device)
    lib, f = build.entry("a8w8_matmul_large",
                         [_P, _I, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P])
    err = f(x2.data_ptr(), int(x2.dtype == torch.float32), x2.stride(0), w_i8.data_ptr(),
            scale.data_ptr(), None if bias is None else bias.data_ptr(), xq.data_ptr(),
            rs.data_ptr(), out.data_ptr(), M, N, K,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "a8w8_matmul_large")
    a8w8_matmul_large.launches += 1
    return out.reshape(*lead, N)


a8w8_matmul_large.launches = 0


def w8a16_matmul(x, w_i8, scale, bias=None):
    """x (..., K) bf16/f32 . int8 W -> (..., N) bf16, weight-only int8: x
    is rounded to bf16 and never quantized.  ``w_i8`` (N, K) int8
    contiguous and 16-byte aligned, ``scale`` and ``bias`` (N,) float32.
    K and N must be multiples of 128 on every device (the JAX function
    asserts it, :80).  CUDA: the K5 kernel under :func:`k5_plan`; CPU:
    :func:`w8a16_plain`; anything else raises."""
    *lead, K = x.shape
    N = w_i8.shape[0]
    if K % 128 or N % 128:
        raise ValueError(f"w8a16_matmul: K = {K} and N = {N} must be multiples of 128")
    if x.device.type == "cpu":
        return w8a16_plain(x, w_i8, scale, bias)
    return _w8a16_launch(x, w_i8, scale, bias, None)


def _w8a16_launch(x, w_i8, scale, bias, plan):
    """Check the operands and launch K5 on CUDA tensors under ``plan`` (mt,
    wn, splits), or :func:`k5_plan`'s when None (the tools and tests time
    and check other plans)."""
    *lead, K = x.shape
    N = w_i8.shape[0]
    if x.device.type != "cuda":
        raise ValueError(f"w8a16_matmul: unsupported device {x.device}")
    build.refuse_grad("w8a16_matmul", None, x, scale, bias)
    _check_w_i8("w8a16_matmul", w_i8, K, x.device)
    _check_vec("w8a16_matmul", "scale", scale, N, x.device)
    if bias is not None:
        _check_vec("w8a16_matmul", "bias", bias, N, x.device)
    x2 = _check_x("w8a16_matmul", x, K)
    if x2.dtype != torch.bfloat16 or not x2.is_contiguous() or x2.data_ptr() % 16:
        # the kernel reads whole 16-byte pieces of bf16 rows
        x2 = x2.to(torch.bfloat16, memory_format=torch.contiguous_format, copy=True)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0 or N == 0:
        return out.reshape(*lead, N)
    plan = plan or k5_card_plan(M, N, K, x.device)
    lib, f = build.entry("w8a16_matmul", [_P, _P, _P, _P, _P] + [_I] * 6 + [_P])
    err = f(x2.data_ptr(), w_i8.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), M, N, K, *plan,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "w8a16_matmul")
    w8a16_matmul.launches += 1
    return out.reshape(*lead, N)


w8a16_matmul.launches = 0


def qdense_kernel_w8a16(x, qp: Q.QLinear):
    """An int8 leaf through K5, bf16 out: the counterpart of
    ``pallas_matmul.py::qdense_pallas`` (weight-only int8, lower error than
    the a8w8 scheme).  No module of the serving path calls it."""
    return w8a16_matmul(x, qp.w_i8, qp.scale, qp.bias)


def qdense_kernel_a8w8(x, qp: Q.QLinear):
    """An int8 leaf, bf16 out: M > 512 -> plain :func:`ops.quant.qdense`
    (the JAX package's XLA route; ``torch._int_mm`` on the card), else K6."""
    if math.prod(x.shape[:-1]) > 512:
        return Q.qdense(x, qp)
    return a8w8_matmul(x, qp.w_i8, qp.scale, qp.bias)


def qdense_kernel_w4(x, qp):
    """Layout-dispatching entry of the serving and training paths, bf16
    out: int8 leaves to :func:`qdense_kernel_a8w8`; grouped-int4 leaves to
    K8, except at M > 512, N % 128 != 0 or a group size not a multiple of
    32, which go to the plain :func:`ops.quant.qdense_w4` as JAX's go to
    XLA.  Under autograd K8 runs inside :class:`W4A8MatmulFn`, as JAX's
    ``qdense_pallas_w4`` runs its kernel inside ``_w4a8_matmul_diff``."""
    if not isinstance(qp, Q.QLinearW4):
        return qdense_kernel_a8w8(x, qp)
    K = x.shape[-1]
    N, G = qp.w4_pack.shape[0], qp.scale4.shape[0]
    if math.prod(x.shape[:-1]) > 512 or (K // G) % 32 or N % 128:
        return Q.qdense_w4(x, qp)
    if needs_grad(x, qp.bias):
        return W4A8MatmulFn.apply(x, qp.w4_pack, qp.scale4, qp.bias)
    return w4a8_matmul(x, qp.w4_pack, qp.scale4, qp.bias)
