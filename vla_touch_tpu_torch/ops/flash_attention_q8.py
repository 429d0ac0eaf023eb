"""K3 and K4: flash attention over an int8 K/V cache — the wrappers of
``csrc/flash_attention_q8.cu`` (counterpart of the int8-KV part of
``vla_touch_tpu/ops/pallas_attention.py``).

The cache holds int8 codes with per-(B, H, D) float32 scales, the amax over
the KV length / 127 (:func:`quantize_kv`).  Two layouts:

- K3, :func:`flash_attention_q8`: k/v (B, Lkv, H, D), from :func:`quantize_kv`;
- K4, :func:`flash_attention_q8t`: k/v (B, H, D, Lkv), Lkv contiguous, from
  :func:`quantize_kv_t`.  Its rows are padded to a multiple of 16 keys in
  storage, so that every row starts 16-byte aligned; the tensors returned
  are (B, H, D, Lkv) views of that storage.

Both compute ``softmax(q' k_i8^T) v_i8 * v_scale`` with ``q' = bf16(q *
D^-0.5 * k_scale)`` formed in float32 by the wrapper, as the TPU wrappers
do; a fully masked query row gives 0.  On CUDA tensors the wrappers launch
the kernel (``.launches`` counts them, one per call); on CPU tensors they
compute :func:`attention_q8_plain`; anything else raises.

The kernel cuts the keys into :func:`split_plan`'s splits (the plan of
``ops/flash_attention.py``, which K1 shares) of 64-key tiles.
With more than one split, each writes its partial softmax state into
float32 scratch the wrapper allocates, and a second launch of the same call
merges them: m* = max_s m_s, l* = sum_s e^(m_s - m*) l_s, out = sum_s
e^(m_s - m*) acc_s / max(l*, 1e-30) x v_scale.
"""

from __future__ import annotations

import ctypes

import torch

from vla_touch_tpu_torch.csrc import build
from vla_touch_tpu_torch.ops.flash_attention import (BK, _sm_count,  # noqa: F401
                                                     mask_arg, split_plan)
from vla_touch_tpu_torch.ops.quant import true_div

_NEG_INF = -1e30
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _quantize(x):
    """(B, L, H, D) -> (int8 codes, scales (B, H, D)): amax over L."""
    xf = x.float()
    amax = torch.clamp_min(xf.abs().amax(dim=1, keepdim=True), 1e-8)
    xi = torch.clamp(torch.round(xf * true_div(127.0, amax)), -127, 127).to(torch.int8)
    return xi, true_div(amax[:, 0], 127.0)


def quantize_kv(k, v):
    """(B, L, H, D) K and V -> (k_i8, k_scale, v_i8, v_scale): int8 codes
    (B, L, H, D) and per-(B, H, D) float32 scales."""
    k_i8, sk = _quantize(k)
    v_i8, sv = _quantize(v)
    return k_i8, sk, v_i8, sv


def _to_bhdl(x_i8):
    """(B, L, H, D) int8 -> (B, H, D, L) view of storage whose rows are
    padded to a multiple of 16 keys."""
    B, L, H, D = x_i8.shape
    Lp = -(-L // 16) * 16
    store = torch.zeros((B, H, D, Lp), dtype=torch.int8, device=x_i8.device)
    store[..., :L] = x_i8.permute(0, 2, 3, 1)
    return store[..., :L]


def quantize_kv_t(k, v):
    """(B, L, H, D) K and V -> the transposed cache (k_t, k_scale, v_t,
    v_scale): k_t/v_t (B, H, D, L) int8, L contiguous; scales (B, H, D)."""
    k_i8, sk, v_i8, sv = quantize_kv(k, v)
    return _to_bhdl(k_i8), sk, _to_bhdl(v_i8), sv


def prescale_q(q, k_scale, scale=None):
    """bf16(q * scale * k_scale) in float32, the kernels' q (B, Lq, H, D)."""
    D = q.shape[-1]
    scale = D ** -0.5 if scale is None else float(scale)
    return (q.float() * scale * k_scale[:, None].float()).to(torch.bfloat16)


def attention_q8_plain(q, k_i8, k_scale, v_i8, v_scale, kv_mask=None, scale=None):
    """The plain version of K3 (and, on (B, H, D, L) views permuted to
    (B, L, H, D), of K4): float32 scores of the pre-scaled bf16 q against
    the int8 codes, float32 softmax and p.v, the V scale applied last; a
    fully masked row gives 0.  Output in q's dtype."""
    qs = prescale_q(q, k_scale, scale).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qs, k_i8.float())
    if kv_mask is not None:
        valid = kv_mask.bool()
        scores = scores.masked_fill(~valid[:, None, None, :], _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v_i8.float()) * v_scale[:, None].float()
    if kv_mask is not None:
        out = out * valid.any(dim=1).to(out.dtype)[:, None, None, None]
    return out.to(q.dtype)


def attention_q8t_plain(q, k_t, k_scale, v_t, v_scale, kv_mask=None, scale=None):
    """The plain version of K4 on the (B, H, D, L) cache."""
    return attention_q8_plain(q, k_t.permute(0, 3, 1, 2), k_scale,
                              v_t.permute(0, 3, 1, 2), v_scale, kv_mask, scale)


def _launch(name, transposed, q, k, k_scale, v, v_scale, kv_mask, scale):
    build.refuse_grad(name, None, q, k_scale, v_scale)
    B, Lq, H, D = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{name}: q must be bfloat16, got {q.dtype}")
    if D % 16 or D > 128:
        raise ValueError(f"{name}: head dim {D} must be a multiple of 16 and <= 128")
    if transposed:
        Lkv = k.shape[3]
        want = (B, H, D, Lkv)
    else:
        Lkv = k.shape[1]
        want = (B, Lkv, H, D)
    for what, t in (("k", k), ("v", v)):
        if t.dtype != torch.int8 or tuple(t.shape) != want or t.device != q.device:
            raise ValueError(f"{name}: {what} must be int8 {want} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if t.stride(3) != 1 or any(s % 16 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} needs a unit last stride, strides that are "
                             f"multiples of 16 and a 16-byte aligned start "
                             f"(strides {t.stride()})")
    for what, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(t.shape) != (B, H, D) or t.device != q.device:
            raise ValueError(f"{name}: {what} must be ({B}, {H}, {D}) on {q.device}")
    mask_ptr, m_sb = mask_arg(name, kv_mask, B, Lkv, q.device)
    out = torch.empty((B, Lq, H, D), dtype=torch.bfloat16, device=q.device)
    if out.numel() == 0:
        return out
    qs = prescale_q(q, k_scale, scale)
    vs = v_scale.float().contiguous()
    if transposed:
        ks_, vs_ = (k.stride(0), k.stride(1), k.stride(2)), (v.stride(0), v.stride(1),
                                                              v.stride(2))
    else:
        ks_, vs_ = (k.stride(0), k.stride(2), k.stride(1)), (v.stride(0), v.stride(2),
                                                              v.stride(1))
    splits, tps = split_plan(B, Lq, Lkv, H, _sm_count(q.device.index))
    scratch = None
    if splits > 1:
        # per split: acc (B, H, splits, Lq, D), then m and l (B, H, splits, Lq)
        scratch = torch.empty(B * H * splits * Lq * (D + 2), dtype=torch.float32,
                              device=q.device)
    lib, f = build.entry("flash_attention_q8",
                         [_I] + [_P] * 6 + [_I] * 5 + [_L] * 7 + [_I] * 2 + [_P] * 2)
    err = f(
        int(transposed), qs.data_ptr(), k.data_ptr(), v.data_ptr(), vs.data_ptr(),
        mask_ptr, out.data_ptr(), B, Lq, Lkv, H, D, *ks_, *vs_, m_sb, splits, tps,
        None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, name)
    return out


def flash_attention_q8(q, k_i8, k_scale, v_i8, v_scale, kv_mask=None, scale=None):
    """K3: q (B, Lq, H, D) bf16, k_i8/v_i8 (B, Lkv, H, D) int8, scales
    (B, H, D), ``kv_mask`` (B, Lkv) bool -> (B, Lq, H, D) bf16.  CPU:
    :func:`attention_q8_plain`."""
    if q.device.type == "cpu":
        return attention_q8_plain(q, k_i8, k_scale, v_i8, v_scale, kv_mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_q8: unsupported device {q.device}")
    out = _launch("flash_attention_q8", False, q, k_i8, k_scale, v_i8, v_scale,
                  kv_mask, scale)
    flash_attention_q8.launches += 1
    return out


flash_attention_q8.launches = 0


def flash_attention_q8t(q, k_t, k_scale, v_t, v_scale, kv_mask=None, scale=None):
    """K4: as :func:`flash_attention_q8` on the transposed cache k_t/v_t
    (B, H, D, Lkv) int8.  CPU: :func:`attention_q8t_plain`."""
    if q.device.type == "cpu":
        return attention_q8t_plain(q, k_t, k_scale, v_t, v_scale, kv_mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_q8t: unsupported device {q.device}")
    out = _launch("flash_attention_q8t", True, q, k_t, k_scale, v_t, v_scale,
                  kv_mask, scale)
    flash_attention_q8t.launches += 1
    return out


flash_attention_q8t.launches = 0
