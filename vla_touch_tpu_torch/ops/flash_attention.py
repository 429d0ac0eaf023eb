"""K1: masked flash attention — the wrapper of ``csrc/flash_attention.cu``
(counterpart of ``vla_touch_tpu/ops/pallas_attention.py``).

:func:`flash_attention` launches the CUDA kernel on CUDA tensors and
computes :func:`attention_plain` on CPU tensors.  ``flash_attention.launches``
counts wrapper calls that launch (plain calls are not counted): one per call,
with or without a combine launch.

The kernel cuts the keys into :func:`split_plan`'s splits of 64-key tiles,
the plan K3/K4 (``ops/flash_attention_q8.py``) share.  With more than one
split, each writes its partial softmax state into float32 scratch the
wrapper allocates, and a second launch of the same call merges them: m* =
max_s m_s, l* = sum_s e^(m_s - m*) l_s, out = sum_s e^(m_s - m*) acc_s /
max(l*, 1e-30).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from vla_touch_tpu_torch.utils.device import sm_count as _sm_count

_NEG_INF = -1e30
BK = 64              # keys per tile of the attention kernels
MAX_ROWS = 128       # query rows per CTA of the attention kernels
MAX_D = 256          # the widest head dim K1 takes
PIECE = 128          # V columns of one K1 CTA above D 128
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


def split_plan(B, Lq, Lkv, H, n_sms, rows=MAX_ROWS, resident=None, min_tiles=2):
    """(splits, tiles per split) of an attention kernel's keys, cut into
    64-key tiles, for B x H x q tiles (of ``rows`` query rows) CTAs.

    ``resident`` None (K3/K4): about 4 CTAs per SM, at least two tiles per
    split.  ``resident`` = the CTAs one SM holds at once (K1): one wave,
    as many splits as fit beside the other CTAs, at least ``min_tiles``
    tiles per split.  Every split holds ``tiles per split`` tiles but the
    last; one split when that many tiles already fill the card or the cache
    is that short."""
    n_tiles = -(-Lkv // BK)
    ctas = B * H * -(-Lq // rows)
    if resident is None:
        tps = max(min_tiles, n_tiles * ctas // (4 * n_sms))
    else:
        tps = max(min_tiles, -(-n_tiles // max(1, resident * n_sms // ctas)))
    if n_tiles <= tps:
        return 1, max(1, n_tiles)
    return -(-n_tiles // tps), tps


# K1's splits hold at least 4 tiles: a combine launch costs more than a
# 2-tile split saves (on an H100, CLIP's 4-tile call took 0.0105 ms whole
# and 0.0143 ms in 2 splits)
K1_MIN_TILES = 4


def cta_rows(Lq):
    """Query rows per CTA of K1: every row of a short-query call (Lq <= 128)
    in one CTA, in warps of 16 rows, at least 4 warps; 128-row q tiles for
    longer calls."""
    return 16 * max(4, -(-Lq // 16)) if Lq <= MAX_ROWS else MAX_ROWS


def k1_plan(B, Lq, Lkv, H, n_sms, resident):
    """(rows per CTA, splits, tiles per split) of a K1 call, ``resident``
    CTAs of that many rows to an SM."""
    rows = cta_rows(Lq)
    return (rows,) + split_plan(B, Lq, Lkv, H, n_sms, rows, resident, K1_MIN_TILES)


@functools.cache
def _resident(D: int, rows: int) -> int:
    """CTAs of K1 at head dim D and ``rows`` query rows one SM holds at once
    (CUDA's occupancy calculator on the built kernel)."""
    from vla_touch_tpu_torch.csrc import build

    lib, f = build.entry("flash_attention", [_I, _I, ctypes.POINTER(_I)],
                         "flash_attention_resident")
    n = _I(0)
    build.check(lib, f(D, rows, ctypes.byref(n)), "flash_attention_resident")
    return n.value


def pieces(D):
    """K1's CTAs per q tile and split: above D 128 each computes one
    ``PIECE``-column piece of the output (over the scores of the full D)."""
    return -(-D // PIECE) if D > PIECE else 1


def card_plan(B, Lq, Lkv, H, D, index=0):
    """:func:`k1_plan` on CUDA device ``index`` (at D padded to a multiple
    of 8, as the wrapper launches it; above D 128 the pieces count as heads)."""
    D8 = -(-D // 8) * 8
    return k1_plan(B, Lq, Lkv, H * pieces(D8), _sm_count(index), _resident(D8, cta_rows(Lq)))


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

    CUDA: bf16 operands, D <= 256, mask (B, Lkv) bool or uint8; anything
    else raises.  A D that is not a multiple of 8 (the kernel's 16-byte
    column piece) runs on zero columns padded to the next multiple: the
    scores do not change, the extra output columns are dropped, and the
    scale stays D ** -0.5 of the true D.  CPU: :func:`attention_plain`.
    """
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_mask=kv_mask, scale=scale)
    from vla_touch_tpu_torch.csrc import build

    build.refuse_grad("flash_attention", "ops.attention.dot_product_attention "
                      "(FlashAttentionFn)", q, k, v)
    return _launch(q, k, v, kv_mask, scale, card_plan)


class FlashAttentionFn(torch.autograd.Function):
    """K1 under autograd.  The forward is :func:`flash_attention` (the
    kernel on CUDA, :func:`attention_plain` on the CPU) and saves q, k, v
    and the mask; the backward recomputes :func:`attention_plain` on them
    and returns its ``torch.autograd.grad``.  That is the program the JAX
    package differentiates when it trains: its attention under grad is the
    float32 einsum and softmax (``_attention_xla``), and it has no backward
    kernel for any attention, so neither has the port."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.scale = scale
        return flash_attention(q, k, v, kv_mask=kv_mask, scale=scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kv_mask = ctx.saved_tensors
        ops = [t.detach().requires_grad_(t.requires_grad) for t in (q, k, v)]
        need = [t for t in ops if t.requires_grad]
        with torch.enable_grad():
            out = attention_plain(*ops, kv_mask=kv_mask, scale=ctx.scale)
            grads = iter(torch.autograd.grad(out, need, g))
        return tuple(next(grads) if t.requires_grad else None for t in ops) + (None, None)


def pad_head_dim(*ts):
    """``ts`` with zero columns appended to the head dim up to a multiple of
    8, the kernel's 16-byte column piece.  Zero q and k columns add nothing
    to a score and zero v columns give zero output columns, so attention of
    the padded operands at the true D's scale, cut back to D columns, is
    the attention of ``ts``."""
    return tuple(F.pad(t, (0, -t.shape[-1] % 8)) for t in ts)


def _launch(q, k, v, kv_mask, scale, plan):
    """Check the operands and launch K1 on CUDA tensors with ``plan(B, Lq,
    Lkv, H, D, device index)`` -> (rows per CTA, splits, tiles per split)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Lq, H, D = q.shape
    Lkv = k.shape[1]
    if D > MAX_D:
        raise ValueError(f"flash_attention: head dim {D} must be <= {MAX_D}")
    scale = D ** -0.5 if scale is None else float(scale)
    if D % 8:
        for name, t in (("k", k), ("v", v)):
            if t.dim() != 4 or t.shape[3] != D:
                raise ValueError(f"flash_attention: {name} has shape {tuple(t.shape)}")
        out = _launch(*pad_head_dim(q, k, v), kv_mask, scale, plan)
        return out[..., :D].contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}")
        _check_operand(name, t, B, H, D)
    if v.shape[1] != Lkv:
        raise ValueError("flash_attention: k and v lengths differ")
    mask_ptr, m_sb = mask_arg("flash_attention", kv_mask, B, Lkv, q.device)
    out = torch.empty((B, Lq, H, D), dtype=torch.bfloat16, device=q.device)
    if out.numel() == 0:
        return out
    rows, splits, tps = plan(B, Lq, Lkv, H, D, q.device.index)
    scratch = None
    if splits > 1:
        # per split: acc (B, H, splits, Lq, D), then m and l (B, H, splits, Lq)
        scratch = torch.empty(B * H * splits * Lq * (D + 2), dtype=torch.float32,
                              device=q.device)
    from vla_touch_tpu_torch.csrc import build

    lib, f = build.entry("flash_attention", [_P] * 5 + [_I] * 5 + [_L] * 10
                         + [ctypes.c_float] + [_I] * 3 + [_P] * 2, "flash_attention_bf16")
    err = f(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(),
            B, Lq, Lkv, H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            m_sb, scale, rows, splits, tps,
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
