"""K9 and K10, the w4 megakernels of the planner LLM's decode: the wrappers
of ``csrc/w4_swiglu.cu`` and ``csrc/w4_postattn.cu``, their plain versions
and the SwiGLU dispatcher (counterpart of ``vla_touch_tpu/ops/
pallas_matmul.py:463-986``).

- :func:`w4_swiglu_mlp` (K9): ``down(silu(gate(x)) * up(x))`` over a fused
  gate|up :class:`~vla_touch_tpu_torch.ops.quant.QLinearW4` (rows [0, F)
  gate, [F, 2F) up) and a down leaf, in one launch;
- :func:`w4_postattn_fused` (K10): ``x2 = x + o(att)``, the RMSNorm, K9's
  MLP and the residual, in one launch;
- :func:`qdense_kernel_swiglu`, the counterpart of ``qdense_pallas_swiglu``:
  a non-w4 leaf or M > 32 composes the per-matmul route
  (``ops/quant_matmul.py::qdense_kernel_w4``: K6 / K8 / plain), else K9,
  under autograd inside :class:`W4SwigluFn` (``_w4_swiglu_diff``).  K10
  has no autograd route (nor has its JAX kernel a differentiation rule):
  on a CUDA operand that requires grad, under autograd, it raises, and so
  does K9 called directly.

Each wrapper computes its plain version (:func:`w4_swiglu_plain`,
:func:`w4_postattn_plain`: the JAX package's ``_w4_swiglu_ref`` and
``_w4_postattn_ref`` over ``ops/quant.py::qdense_w4``) on CPU tensors,
launches its kernel on CUDA tensors and raises if the card refuses the
launch; ``.launches`` counts kernel launches.  Both take x (and att) as
bf16, as the TPU kernels do, and write bf16.

Shapes the kernels cannot serve take the composed route, as the JAX
functions do for dims their tiling cannot serve (``:619-630``,
``:815-829``): F and the output width multiples of 128, even group counts,
group sizes multiples of 32, matching leaf widths, and for K10 M <= 32.
The TPU's 12 MiB VMEM budget is not a condition here (Hopper has no such
limit); in its place the Hopper kernels keep the int8 codes of up to 32
rows in one block's shared memory, so on a card both need M <= 32 and a
width whose codes fit (the kernel library's own budget,
``w4_megakernel_fits``: K <= 6219 at M > 16 on an H100).  The plain
versions on the CPU have no such limit.  At Qwen2.5-7B width every
condition holds, as JAX's own pick the kernels there.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from vla_touch_tpu_torch.csrc import build
from vla_touch_tpu_torch.ops import quant as Q
from vla_touch_tpu_torch.ops import quant_matmul as QM

_P = ctypes.c_void_p
_I = ctypes.c_int

MAX_M = 32                          # rows of qdense_pallas_swiglu's K9 route


def silu_mul(g, u):
    """The megakernels' SwiGLU product (``pallas_matmul.py::_silu_mul``):
    the logistic in float32, ``g * sigmoid(g)`` cast to g's dtype, then
    times u in that dtype."""
    gf = g.float()
    return (gf * torch.sigmoid(gf)).to(g.dtype) * u


def w4_swiglu_plain(x, gu, down, out_dtype=torch.bfloat16):
    """The plain version of K9 (``_w4_swiglu_ref``)."""
    act = Q.qdense_w4(x, gu, out_dtype=torch.bfloat16)
    g, u = act.chunk(2, dim=-1)
    return Q.qdense_w4(silu_mul(g, u), down, out_dtype=out_dtype)


def rmsnorm(x, w, eps):
    """RMSNorm as the JAX package computes it (``planning/llm.py::_rmsnorm``,
    and K10's norm): float32 mean of squares, rsqrt, times the float32
    weight, cast to x's dtype."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * w).to(x.dtype)


def w4_postattn_plain(x, att, o, gu, down, norm_w, eps=1e-6, out_dtype=torch.bfloat16):
    """The plain version of K10 (``_w4_postattn_ref``): every cast of the
    kernel's ladder, including :func:`silu_mul`'s float32 logistic."""
    x2 = x + Q.qdense_w4(att, o, out_dtype=x.dtype)
    h = rmsnorm(x2, norm_w, eps)
    return (x2 + w4_swiglu_plain(h, gu, down, x2.dtype)).to(out_dtype)


def _composed_swiglu(x, gu, down):
    """gate|up, silu_mul, down through the per-matmul dispatcher."""
    g, u = QM.qdense_kernel_w4(x, gu).chunk(2, dim=-1)
    return QM.qdense_kernel_w4(silu_mul(g, u), down)


@functools.lru_cache(maxsize=None)
def _fits_on_card(index: int, M: int, K: int) -> bool:
    lib, f = build.entry("w4_swiglu", [_I, _I, ctypes.POINTER(_I)], symbol="w4_megakernel_fits")
    fits = _I(0)
    with torch.cuda.device(index):
        build.check(lib, f(M, K, ctypes.byref(fits)), "w4_megakernel_fits")
    return bool(fits.value)


def _fits(M, K, device) -> bool:
    """Whether the megakernels serve M rows of width K on ``device``: on a
    card, the kernel library's shared-memory budget; on the CPU, always."""
    if device.type != "cuda":
        return True
    return _fits_on_card(torch.cuda.current_device() if device.index is None else device.index,
                         M, K)


def _w4(qp) -> bool:
    return isinstance(qp, Q.QLinearW4)


def _grouping_ok(*leaves) -> bool:
    """Even group counts and group sizes that are multiples of 32."""
    return all(qp.scale4.shape[0] % 2 == 0 and qp.group_size % 32 == 0 for qp in leaves)


def _swiglu_shape_ok(M, K, gu, down) -> bool:
    if not (_w4(gu) and _w4(down)):
        return False
    N2, F = gu.w4_pack.shape[0], gu.w4_pack.shape[0] // 2
    N = down.w4_pack.shape[0]
    return (M <= MAX_M and N2 % 2 == 0 and F % 128 == 0
            and N % 128 == 0 and 2 * gu.w4_pack.shape[1] == K
            and 2 * down.w4_pack.shape[1] == F and _grouping_ok(gu, down)
            and _fits(M, K, gu.w4_pack.device))


def _postattn_shape_ok(M, Ka, D, o, gu, down) -> bool:
    if not (_w4(o) and _w4(gu) and _w4(down)):
        return False
    F = gu.w4_pack.shape[0] // 2
    return (M <= MAX_M and D % 128 == 0 and F % 128 == 0 and gu.w4_pack.shape[0] % 2 == 0
            and o.w4_pack.shape[0] == D and down.w4_pack.shape[0] == D
            and 2 * o.w4_pack.shape[1] == Ka and 2 * gu.w4_pack.shape[1] == D
            and 2 * down.w4_pack.shape[1] == F and _grouping_ok(o, gu, down)
            and _fits(M, max(Ka, D), o.w4_pack.device))


def _leaf_args(what, qp, device):
    """(w4_pack, scale4, bias) pointers of a leaf, checked."""
    N = qp.w4_pack.shape[0]
    for name, t, dt in (("w4_pack", qp.w4_pack, torch.int8), ("scale4", qp.scale4, torch.float32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != device:
            raise ValueError(f"{what}: {name} must be a contiguous {dt} on {device}, "
                             f"got {t.dtype} on {t.device}")
    if qp.scale4.shape[1] != N:
        raise ValueError(f"{what}: scale4 {tuple(qp.scale4.shape)} for {N} columns")
    b = qp.bias
    if b is not None:
        QM._check_vec(what, "bias", b, N, device)
    return qp.w4_pack.data_ptr(), qp.scale4.data_ptr(), None if b is None else b.data_ptr()


def _rows(what, t, K):
    """t (..., K) as a contiguous, 16-byte aligned bf16 (M, K) (the kernels
    read rows 16 bytes at a time)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    t = t.reshape(-1, K).to(torch.bfloat16).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def w4_swiglu_mlp(x, gu, down):
    """K9: x (..., K) -> (..., N) bf16, ``down(silu_mul(gate(x), up(x)))``
    over grouped-int4 leaves, x taken as bf16.  Shapes K9 cannot serve
    compose the per-matmul route; otherwise CUDA launches the kernel and
    CPU computes :func:`w4_swiglu_plain`."""
    *lead, K = x.shape
    M = math.prod(lead)
    if M == 0 or not _swiglu_shape_ok(M, K, gu, down):
        return _composed_swiglu(x, gu, down)
    x = x.to(torch.bfloat16)
    if x.device.type == "cpu":
        return w4_swiglu_plain(x, gu, down)
    build.refuse_grad("w4_swiglu_mlp", "ops.w4_fused.W4SwigluFn (qdense_kernel_swiglu takes it "
                      "under grad)", x, gu.scale4, gu.bias, down.scale4, down.bias)
    x2 = _rows("w4_swiglu_mlp", x, K)
    F, N = gu.w4_pack.shape[0] // 2, down.w4_pack.shape[0]
    dev = x.device
    gw, gs, gb = _leaf_args("w4_swiglu_mlp gate|up", gu, dev)
    dw, ds, db = _leaf_args("w4_swiglu_mlp down", down, dev)
    act = torch.empty((M, F), dtype=torch.bfloat16, device=dev)
    aq = torch.empty((M, F), dtype=torch.int8, device=dev)
    amax = torch.empty((M,), dtype=torch.int32, device=dev)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    lib, f = build.entry("w4_swiglu", [_P] * 11 + [_I] * 6 + [_P], symbol="w4_swiglu_mlp")
    err = f(x2.data_ptr(), gw, gs, gb, dw, ds, db, act.data_ptr(), aq.data_ptr(),
            amax.data_ptr(), out.data_ptr(), M, K, F, N, gu.scale4.shape[0],
            down.scale4.shape[0], torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "w4_swiglu_mlp")
    w4_swiglu_mlp.launches += 1
    return out.reshape(*lead, N)


w4_swiglu_mlp.launches = 0


def w4_postattn_fused(x, att, o, gu, down, norm_w, eps: float = 1e-6):
    """K10: x (..., D), att (..., Ka) -> (..., D) bf16: ``x2 = x + o(att)``,
    ``h = rmsnorm(x2) * norm_w`` (float32, cast to bf16), ``x2 +
    down(silu_mul(gate(h), up(h)))``, x and att taken as bf16.  Shapes K10
    cannot serve compose o through the per-matmul route and the MLP through
    :func:`w4_swiglu_mlp`; otherwise CUDA launches the kernel and CPU
    computes :func:`w4_postattn_plain`."""
    *lead, Ka = att.shape
    D = x.shape[-1]
    M = math.prod(lead)
    x = x.to(torch.bfloat16)
    att = att.to(torch.bfloat16)
    if M == 0 or not _postattn_shape_ok(M, Ka, D, o, gu, down):
        x2 = x + QM.qdense_kernel_w4(att, o)
        return x2 + w4_swiglu_mlp(rmsnorm(x2, norm_w, eps), gu, down)
    if x.device.type == "cpu":
        return w4_postattn_plain(x, att, o, gu, down, norm_w, eps)
    build.refuse_grad("w4_postattn_fused", None, x, att, norm_w,
                      *(t for qp in (o, gu, down) for t in (qp.scale4, qp.bias)))
    dev = x.device
    xr, ar = _rows("w4_postattn_fused", x, D), _rows("w4_postattn_fused", att, Ka)
    if norm_w.dtype != torch.float32 or norm_w.shape != (D,) or norm_w.device != dev \
            or not norm_w.is_contiguous():
        raise ValueError(f"w4_postattn_fused: norm_w must be a contiguous float32 ({D},) "
                         f"on {dev}, got {norm_w.dtype} {tuple(norm_w.shape)}")
    if norm_w.data_ptr() % 16:
        norm_w = norm_w.clone()                        # read 16 bytes at a time
    F = gu.w4_pack.shape[0] // 2
    ow, os_, ob = _leaf_args("w4_postattn_fused o", o, dev)
    gw, gs, gb = _leaf_args("w4_postattn_fused gate|up", gu, dev)
    dw, ds, db = _leaf_args("w4_postattn_fused down", down, dev)
    x2 = torch.empty((M, D), dtype=torch.bfloat16, device=dev)
    act = torch.empty((M, F), dtype=torch.bfloat16, device=dev)
    aq = torch.empty((M, F), dtype=torch.int8, device=dev)
    amax = torch.empty((M,), dtype=torch.int32, device=dev)
    out = torch.empty((M, D), dtype=torch.bfloat16, device=dev)
    lib, f = build.entry("w4_postattn", [_P] * 17 + [_I] * 7 + [ctypes.c_float, _P],
                         symbol="w4_postattn_fused")
    err = f(xr.data_ptr(), ar.data_ptr(), ow, os_, ob, norm_w.data_ptr(), gw, gs, gb, dw, ds,
            db, x2.data_ptr(), act.data_ptr(), aq.data_ptr(), amax.data_ptr(), out.data_ptr(),
            M, Ka, D, F, o.scale4.shape[0], gu.scale4.shape[0], down.scale4.shape[0],
            float(eps), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "w4_postattn_fused")
    w4_postattn_fused.launches += 1
    return out.reshape(*lead, D)


w4_postattn_fused.launches = 0


class W4SwigluFn(torch.autograd.Function):
    """K9 under autograd (the counterpart of ``pallas_matmul.py::
    _w4_swiglu_diff``): the forward is :func:`w4_swiglu_mlp` and saves x;
    the backward is ``torch.autograd.grad`` of :func:`w4_swiglu_plain` on
    the saved x in its own dtype (JAX's ``_w4_swiglu_ref``, with
    :func:`silu_mul`'s float32 logistic).  The leaves are frozen.  As in
    :class:`~vla_touch_tpu_torch.ops.quant_matmul.W4A8MatmulFn`, each
    quantized product passes gradient to its input only through the rows'
    ``amax``."""

    @staticmethod
    def forward(ctx, x, gu, down):
        ctx.save_for_backward(x)
        ctx.leaves = (gu, down)
        return w4_swiglu_mlp(x, gu, down)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xx = x.detach().requires_grad_(True)
        with torch.enable_grad():
            y = w4_swiglu_plain(xx, *ctx.leaves)
            (dx,) = torch.autograd.grad(y, [xx], g)
        return dx, None, None


def qdense_kernel_swiglu(x, gu, down):
    """The SwiGLU dispatcher (``qdense_pallas_swiglu``): w4 leaves at M <= 32
    go to :func:`w4_swiglu_mlp` (K9; under autograd through
    :class:`W4SwigluFn`); anything else composes the per-matmul route, bf16
    out."""
    if not (_w4(gu) and _w4(down)) or math.prod(x.shape[:-1]) > MAX_M:
        return _composed_swiglu(x, gu, down)
    if QM.needs_grad(x):
        return W4SwigluFn.apply(x, gu, down)
    return w4_swiglu_mlp(x, gu, down)
