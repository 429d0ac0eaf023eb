"""Int8 and grouped-int4 weight quantization for the serving path
(counterpart of ``vla_touch_tpu/ops/quant.py``).

Scheme, identical to the JAX package's:

- int8 weights: per-output-channel symmetric, ``w_i8 = round(w * 127 /
  max|w|)`` (round half to even, clip +-127);
- int4 weights: per (input group, output channel) symmetric in [-7, 7],
  the group scale picked by an MSE clip search, nibbles PLANE-packed two
  per byte (the low nibble holds input rows [0, K/2), the high nibble rows
  [K/2, K));
- activations: dynamic per-token symmetric int8 at the matmul input;
- exact int32 accumulation, then the product of the scales in float32.

The quantized leaves are modules holding buffers named after the JAX
leaves.  Their layouts are chosen for the CUDA kernels (``csrc/
a8w8_matmul.cu``, ``csrc/w4a8_matmul.cu``) and differ from the JAX trees'
(``utils/from_flax.py`` converts):

- :class:`QLinear`: ``w_i8`` (N, K) int8, K contiguous: each output
  channel's row is what the int8 tensor-core B operand reads; ``scale``
  (N,) f32; ``bias`` (N,) f32 or absent;
- :class:`QLinearW4`: ``w4_pack`` (N, K/2) int8, K contiguous, byte j of row
  n holding w[n, j] in its low and w[n, K/2 + j] in its high nibble;
  ``scale4`` (G, N) f32 with G = K / group_size; ``bias`` as above.

The plain functions here (:func:`qdense`, :func:`qdense_w4`) are the
kernels' plain versions; ``ops/quant_matmul.py`` holds the wrappers and the
dispatchers that the serving path calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class QLinear(nn.Module):
    """Int8 linear: ``w_i8`` (N, K) int8, ``scale`` (N,) f32, ``bias`` (N,)
    f32 or None.  The serving path multiplies through
    ``ops/quant_matmul.py::qdense_kernel_w4``."""

    def __init__(self, w_i8: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("w_i8", w_i8)
        self.register_buffer("scale", scale)
        self.register_buffer("bias", bias)


class QLinearW4(nn.Module):
    """Grouped-int4 linear: ``w4_pack`` (N, K/2) int8 plane-packed,
    ``scale4`` (G, N) f32, ``bias`` (N,) f32 or None."""

    def __init__(self, w4_pack: torch.Tensor, scale4: torch.Tensor,
                 bias: torch.Tensor | None = None):
        super().__init__()
        self.register_buffer("w4_pack", w4_pack)
        self.register_buffer("scale4", scale4)
        self.register_buffer("bias", bias)

    @property
    def group_size(self) -> int:
        return 2 * self.w4_pack.shape[1] // self.scale4.shape[0]


class BF16Linear(nn.Module):
    """An unquantized linear of a serving twin: ``weight`` (N, K) bf16,
    ``bias`` (N,) float32 or None; bf16 operands, float32 accumulation and
    bias (:func:`dense_f32acc`), bf16 out."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor | None):
        super().__init__()
        self.register_buffer("weight", weight)
        self.register_buffer("bias", bias)

    def forward(self, x):
        return dense_f32acc(x.to(torch.bfloat16), self.weight, self.bias).to(torch.bfloat16)


def true_div(a, b):
    """IEEE float32 ``a / b`` elementwise, with either side a number.

    ``torch`` turns a division by a Python number into a multiplication by
    its reciprocal (and ``number / tensor`` into ``reciprocal`` times the
    number), which can differ from the quotient by one ulp and so flip an
    int8 bucket against the JAX package; a full tensor keeps the true
    quotient."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return a / b


def _weight_bias(lin):
    """(weight (N, K) f32, bias f32 or None) of an ``nn.Linear``."""
    w = lin.weight.detach().float()
    b = None if lin.bias is None else lin.bias.detach().float()
    return w, b


@torch.no_grad()
def quantize_linear(lin: nn.Linear) -> QLinear:
    """Per-output-channel symmetric int8 of ``lin.weight`` (N, K)."""
    w, b = _weight_bias(lin)
    amax = torch.clamp_min(w.abs().amax(dim=1), 1e-8)               # (N,)
    w_i8 = torch.clamp(torch.round(w * true_div(127.0, amax)[:, None]), -127, 127)
    return QLinear(w_i8.to(torch.int8).contiguous(), true_div(amax, 127.0), b)


def quantize_rows(x):
    """Dynamic per-token int8: x (..., K) -> (codes int8, amax f32 (..., 1)),
    as ``ops/quant.py::qdense`` (amax floor 1e-8, round half to even, clip
    +-127)."""
    xf = x.float()
    amax = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-8)
    x_i8 = torch.clamp(torch.round(xf * true_div(127.0, amax)), -127, 127).to(torch.int8)
    return x_i8, amax


def int_matmul(a_i8, b_i8):
    """Exact int32 product a (M, K) int8 . b (N, K)^T int8 -> (M, N) int32.

    ``torch._int_mm`` on the card (cuBLASLt needs M > 16 and K, N multiples
    of 8, so short products pad rows with zeros); an int32 ``matmul`` on
    the CPU.  A float32 product of the codes would not be exact: |sum|
    reaches 127^2 * K, above 2^24 at K = 4096."""
    if a_i8.device.type != "cuda":
        return torch.matmul(a_i8.int(), b_i8.int().t())
    M = a_i8.shape[0]
    Mp = max(32, -(-M // 8) * 8)
    if Mp != M:
        a_i8 = F.pad(a_i8, (0, 0, 0, Mp - M))
    return torch._int_mm(a_i8.contiguous(), b_i8.contiguous().t())[:M]


def dense_f32acc(x, w, bias=None):
    """``x (..., K) . w (N, K)^T`` with float32 accumulation and output, as
    ``jnp.dot(..., preferred_element_type=float32)`` on bf16 operands.

    On the CPU both operands go to float32 (bf16 products are exact in
    float32).  On the card cuBLAS multiplies in bf16 with float32
    accumulation and rounds the product to bf16 once before the float32
    bias (a float32 GEMM there costs ~15x the time at the 4374-token
    condition K/V projections)."""
    if x.device.type == "cuda" and x.dtype == w.dtype == torch.bfloat16:
        y = F.linear(x, w).float()
    else:
        y = F.linear(x.float(), w.float())
    return y if bias is None else y + bias.float()


def qdense(x, qp: QLinear, out_dtype=torch.bfloat16):
    """Plain a8w8: x (..., K) float -> (..., N): per-token int8 x, int8 W,
    int32 accumulation, ``acc * (amax / 127) * scale + bias`` in float32."""
    *lead, K = x.shape
    x_i8, amax = quantize_rows(x.reshape(-1, K))
    y = int_matmul(x_i8, qp.w_i8).float()
    y = y * true_div(amax, 127.0) * qp.scale
    if qp.bias is not None:
        y = y + qp.bias
    return y.to(out_dtype).reshape(*lead, -1)


# ---- int4 (w4) grouped weight quantization ---------------------------------


def pick_group_size(K: int, requested: int = 128) -> int:
    """Smallest divisor of K that is >= requested, a multiple of 32 and
    leaves an even group count (plane packing splits K/2 on a group
    boundary); else the largest such divisor.  K=1152 -> 192; K in {256,
    2048, 4096} -> 128."""
    cands = [d for d in range(32, K + 1, 32) if K % d == 0 and (K // d) % 2 == 0]
    if not cands:
        raise ValueError(f"no valid int4 group size for K={K}")
    at_least = [d for d in cands if d >= requested]
    return min(at_least) if at_least else max(cands)


def pack_w4(w_i4):
    """(N, K) int codes in [-7, 7] -> (N, K/2) int8 plane-packed."""
    K = w_i4.shape[1]
    lo, hi = w_i4[:, : K // 2].to(torch.int32), w_i4[:, K // 2:].to(torch.int32)
    packed = (lo & 0xF) | ((hi & 0xF) << 4)
    return torch.where(packed > 127, packed - 256, packed).to(torch.int8)


@torch.no_grad()
def quantize_linear_w4(lin: nn.Linear, group_size: int = 128,
                       clip_search: bool = True) -> QLinearW4:
    """Grouped int4 of ``lin.weight`` (N, K): ``scale4`` (G, N), G = K /
    :func:`pick_group_size`.  ``clip_search`` picks each group's clip
    fraction in {0.70, ..., 1.00} x amax by least squared error, as the
    JAX package does."""
    w, b = _weight_bias(lin)
    N, K = w.shape
    gs = pick_group_size(K, group_size)
    G = K // gs
    wg = w.t().reshape(G, gs, N)                                     # (G, gs, N)
    amax = torch.clamp_min(wg.abs().amax(dim=1), 1e-8)              # (G, N)
    if clip_search:
        best_err = best_c = None
        for c in (0.70, 0.75, 0.80, 0.85, 0.90, 0.95, 1.00):
            s = amax * (c / 7.0)
            q = torch.clamp(torch.round(true_div(wg, s[:, None].expand_as(wg))), -7, 7)
            err = torch.sum(torch.square(wg - q * s[:, None]), dim=1)
            if best_err is None:
                best_err, best_c = err, torch.full_like(amax, c)
            else:
                take = err < best_err
                best_err = torch.where(take, err, best_err)
                best_c = torch.where(take, torch.full_like(amax, c), best_c)
        amax = amax * best_c
    w_i4 = torch.clamp(torch.round(wg * true_div(7.0, amax)[:, None]), -7, 7)
    w_i4 = w_i4.reshape(K, N).t()                                   # (N, K)
    return QLinearW4(pack_w4(w_i4).contiguous(), true_div(amax, 7.0).contiguous(), b)


def unpack_w4(pack):
    """(N, K/2) plane-packed int8 -> (N, K) int8 in [-7, 7] (arithmetic
    shifts sign-extend each nibble)."""
    p = pack.to(torch.int32)
    lo = (p << 28) >> 28
    hi = p >> 4
    return torch.cat([lo, hi], dim=1).to(torch.int8)


def dequantize_w4(qp: QLinearW4):
    """(N, K) float32 weights of a :class:`QLinearW4`."""
    G, N = qp.scale4.shape
    w = unpack_w4(qp.w4_pack).float()                               # (N, K)
    K = w.shape[1]
    return (w.t().reshape(G, K // G, N) * qp.scale4[:, None, :]).reshape(K, N).t()


def qdense_w4(x, qp: QLinearW4, out_dtype=torch.bfloat16):
    """Plain w4a8: x (..., K) -> (..., N).  Per-token int8 x, int32
    accumulation per input group, each group scaled by ``scale4`` before
    the float32 sum across groups.  At M > 512 (the condition precompute)
    the weight is dequantized to bf16 and x is NOT quantized, as in the JAX
    package."""
    *lead, K = x.shape
    G, N = qp.scale4.shape
    gs = K // G
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    if M > 512:
        w = dequantize_w4(qp).to(torch.bfloat16)
        y = dense_f32acc(x2.to(torch.bfloat16), w, qp.bias)
        return y.to(out_dtype).reshape(*lead, -1)
    x_i8, amax = quantize_rows(x2)
    w_i8 = unpack_w4(qp.w4_pack)                                    # (N, K)
    y = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for g in range(G):
        sl = slice(g * gs, (g + 1) * gs)
        y = y + int_matmul(x_i8[:, sl], w_i8[:, sl]).float() * qp.scale4[g]
    y = y * true_div(amax, 127.0)
    if qp.bias is not None:
        y = y + qp.bias
    return y.to(out_dtype).reshape(*lead, -1)


def qdense_any(x, qp, out_dtype=torch.bfloat16):
    """Plain dispatch on the leaf's layout (int8 vs grouped int4)."""
    if isinstance(qp, QLinearW4):
        return qdense_w4(x, qp, out_dtype=out_dtype)
    return qdense(x, qp, out_dtype=out_dtype)


def is_linear(m) -> bool:
    return isinstance(m, nn.Linear)


def _quantize_modules(module: nn.Module, quantize_leaf, path=()) -> None:
    """Replace, in place, every ``nn.Linear`` below ``module`` for which
    ``quantize_leaf(path, linear)`` returns a module (None keeps it)."""
    for name, child in list(module.named_children()):
        p = path + (name,)
        if is_linear(child):
            q = quantize_leaf(p, child)
            if q is not None:
                setattr(module, name, q)
        else:
            _quantize_modules(child, quantize_leaf, p)


def quantize_tree(module: nn.Module, should_quantize=None) -> nn.Module:
    """Replace every ``nn.Linear`` (that ``should_quantize(path, linear)``
    admits) with its :class:`QLinear`, in place; returns ``module``."""
    def leaf(path, lin):
        if should_quantize is None or should_quantize(path, lin):
            return quantize_linear(lin)
        return None

    _quantize_modules(module, leaf)
    return module


def quantize_tree_w4(module: nn.Module, should_quantize=None, group_size: int = 128,
                     clip_search: bool = True, w4_select=None) -> nn.Module:
    """Like :func:`quantize_tree` but grouped int4; leaves with no valid
    group size fall back to int8, and ``w4_select(path, linear)`` (optional)
    picks int4 vs int8 per admitted leaf."""
    def leaf(path, lin):
        if should_quantize is not None and not should_quantize(path, lin):
            return None
        if w4_select is not None and not w4_select(path, lin):
            return quantize_linear(lin)
        try:
            return quantize_linear_w4(lin, group_size, clip_search=clip_search)
        except ValueError:
            return quantize_linear(lin)

    _quantize_modules(module, leaf)
    return module
