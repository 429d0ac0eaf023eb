"""K6 (a8w8) and K8 (w4a8): the wrappers of ``csrc/a8w8_matmul.cu`` and
``csrc/w4a8_matmul.cu``, and the dispatchers of the serving path
(counterpart of the serving part of ``vla_touch_tpu/ops/pallas_matmul.py``).

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
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from vla_touch_tpu_torch.csrc import build
from vla_touch_tpu_torch.ops import quant as Q

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


def a8w8_matmul(x, w_i8, scale, bias=None):
    """x (..., K) bf16/f32 . int8 W -> (..., N) bf16.  ``w_i8`` (N, K) int8
    contiguous with K % 16 == 0, ``scale`` (N,) and ``bias`` (N,) float32.
    CUDA: the K6 kernel; CPU: :func:`a8w8_plain`; anything else raises."""
    if x.device.type == "cpu":
        return a8w8_plain(x, w_i8, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"a8w8_matmul: unsupported device {x.device}")
    *lead, K = x.shape
    if w_i8.dtype != torch.int8 or w_i8.dim() != 2 or w_i8.shape[1] != K \
            or not w_i8.is_contiguous() or w_i8.device != x.device:
        raise ValueError(f"a8w8_matmul: w_i8 must be a contiguous int8 (N, {K}) on "
                         f"{x.device}, got {w_i8.dtype} {tuple(w_i8.shape)}")
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
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    rs = torch.empty((M,), dtype=torch.float32, device=x.device)
    lib, f = build.entry("a8w8_matmul", [_P, _I, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P])
    err = f(x2.data_ptr(), int(x2.dtype == torch.float32), x2.stride(0), w_i8.data_ptr(),
            scale.data_ptr(), None if bias is None else bias.data_ptr(), xq.data_ptr(),
            rs.data_ptr(), out.data_ptr(), M, N, K,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "a8w8_matmul")
    a8w8_matmul.launches += 1
    return out.reshape(*lead, N)


a8w8_matmul.launches = 0


def w4a8_matmul(x, w4_pack, scale4, bias=None):
    """x (..., K) bf16/f32 . grouped-int4 W -> (..., N) bf16.  ``w4_pack``
    (N, K/2) int8 contiguous, plane-packed, K % 32 == 0; ``scale4`` (G, N)
    float32, G even, group size K/G a multiple of 32; ``bias`` (N,)
    float32.  CUDA: the K8 kernel; CPU: :func:`w4a8_plain`."""
    if x.device.type == "cpu":
        return w4a8_plain(x, w4_pack, scale4, bias)
    if x.device.type != "cuda":
        raise ValueError(f"w4a8_matmul: unsupported device {x.device}")
    *lead, K = x.shape
    if w4_pack.dtype != torch.int8 or w4_pack.dim() != 2 or 2 * w4_pack.shape[1] != K \
            or not w4_pack.is_contiguous() or w4_pack.device != x.device:
        raise ValueError(f"w4a8_matmul: w4_pack must be a contiguous int8 (N, {K // 2}) "
                         f"on {x.device}, got {w4_pack.dtype} {tuple(w4_pack.shape)}")
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
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0 or N == 0:
        return out.reshape(*lead, N)
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    rs = torch.empty((M,), dtype=torch.float32, device=x.device)
    lib, f = build.entry("w4a8_matmul",
                         [_P, _I, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
    err = f(x2.data_ptr(), int(x2.dtype == torch.float32), x2.stride(0),
            w4_pack.data_ptr(), scale4.data_ptr(),
            None if bias is None else bias.data_ptr(), xq.data_ptr(), rs.data_ptr(),
            out.data_ptr(), M, N, K, G,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "w4a8_matmul")
    w4a8_matmul.launches += 1
    return out.reshape(*lead, N)


w4a8_matmul.launches = 0


def qdense_kernel_a8w8(x, qp: Q.QLinear):
    """An int8 leaf, bf16 out: M > 512 -> plain :func:`ops.quant.qdense`
    (the JAX package's XLA route; ``torch._int_mm`` on the card), else K6."""
    if math.prod(x.shape[:-1]) > 512:
        return Q.qdense(x, qp)
    return a8w8_matmul(x, qp.w_i8, qp.scale, qp.bias)


def qdense_kernel_w4(x, qp):
    """Layout-dispatching entry of the serving path, bf16 out: int8 leaves
    to :func:`qdense_kernel_a8w8`; grouped-int4 leaves to K8, except at
    M > 512, N % 128 != 0 or a group size not a multiple of 32, which go to
    the plain :func:`ops.quant.qdense_w4` as JAX's go to XLA."""
    if not isinstance(qp, Q.QLinearW4):
        return qdense_kernel_a8w8(x, qp)
    K = x.shape[-1]
    N, G = qp.w4_pack.shape[0], qp.scale4.shape[0]
    if math.prod(x.shape[:-1]) > 512 or (K // G) % 32 or N % 128:
        return Q.qdense_w4(x, qp)
    return w4a8_matmul(x, qp.w4_pack, qp.scale4, qp.bias)
