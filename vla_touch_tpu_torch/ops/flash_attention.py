"""K1: masked flash attention — the wrapper of ``csrc/flash_attention.cu``
(counterpart of ``vla_touch_tpu/ops/pallas_attention.py``).

:func:`flash_attention` launches the CUDA kernel on CUDA tensors and
computes :func:`attention_plain` on CPU tensors.  ``flash_attention.launches``
counts kernel launches (plain calls are not counted).
"""

from __future__ import annotations

import ctypes

import torch

_NEG_INF = -1e30
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def attention_plain(q, k, v, kv_mask=None, scale=None):
    """Einsum-and-softmax attention in float32 on (B, L, H, D) tensors.

    ``kv_mask`` (B, Lkv) bool, True = valid.  A query whose keys are all
    masked returns 0, as the kernels (TPU and CUDA) do."""
    B, Lq, H, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    qf = q.float() * scale
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, k.float())
    if kv_mask is not None:
        valid = kv_mask.bool()
        scores = scores.masked_fill(~valid[:, None, None, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    if kv_mask is not None:
        out = out * valid.any(dim=1).to(out.dtype)[:, None, None, None]
    return out.to(q.dtype)


def _lib():
    from vla_touch_tpu_torch.csrc import build

    lib = build.library("flash_attention")
    if lib.flash_attention_bf16.argtypes is None:
        lib.flash_attention_bf16.argtypes = (
            [_P] * 5 + [_I] * 5 + [_L] * 10 + [ctypes.c_float, _P])
        lib.flash_attention_bf16.restype = _I
    return lib


def _check_operand(name, t, B, H, D):
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: {name} must be bfloat16, got {t.dtype}")
    if t.dim() != 4 or t.shape[0] != B or t.shape[2] != H or t.shape[3] != D:
        raise ValueError(f"flash_attention: {name} has shape {tuple(t.shape)}")
    if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} needs unit stride on D, "
                         f"strides that are multiples of 8 and a 16-byte "
                         f"aligned start (strides {t.stride()})")


def mask_arg(what, kv_mask, B, Lkv, device):
    """(pointer or None, row stride) of a (B, Lkv) bool/uint8 key mask with
    contiguous rows on ``device``, as the attention kernels take it."""
    if kv_mask is None:
        return None, 0
    if kv_mask.shape != (B, Lkv) or kv_mask.device != device:
        raise ValueError(f"{what}: mask shape {tuple(kv_mask.shape)}"
                         f" on {kv_mask.device}, want ({B}, {Lkv})")
    if kv_mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"{what}: mask dtype {kv_mask.dtype}")
    if kv_mask.stride(1) != 1:
        raise ValueError(f"{what}: mask rows must be contiguous")
    return kv_mask.data_ptr(), kv_mask.stride(0)


def flash_attention(q, k, v, kv_mask=None, scale=None):
    """Attention q (B, Lq, H, D), k/v (B, Lkv, H, D) -> (B, Lq, H, D).

    CUDA: bf16 operands, D <= 128 and a multiple of 8, mask (B, Lkv) bool
    or uint8; anything else raises.  CPU: :func:`attention_plain`.
    """
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_mask=kv_mask, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Lq, H, D = q.shape
    Lkv = k.shape[1]
    if D % 8 or D > 128:
        raise ValueError(f"flash_attention: head dim {D} must be a multiple "
                         f"of 8 and <= 128")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}")
        _check_operand(name, t, B, H, D)
    if v.shape[1] != Lkv:
        raise ValueError("flash_attention: k and v lengths differ")
    mask_ptr, m_sb = mask_arg("flash_attention", kv_mask, B, Lkv, q.device)
    scale = D ** -0.5 if scale is None else float(scale)
    out = torch.empty((B, Lq, H, D), dtype=torch.bfloat16, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    from vla_touch_tpu_torch.csrc import build

    err = lib.flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
        B, Lq, Lkv, H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        m_sb, scale, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
