"""Scaled-dot-product attention (counterpart of
``vla_touch_tpu/ops/attention.py``).

Layout (B, L, H, D) for q/k/v; ``kv_mask`` optional (B, L_kv) bool, True =
valid.  There is one path: :func:`dot_product_attention` always goes
through kernel K1's wrapper, which launches the CUDA kernel on CUDA tensors
and computes the plain einsum version on CPU tensors.
"""

from __future__ import annotations

from vla_touch_tpu_torch.ops import flash_attention as _fa

# The plain version of K1 (einsum + f32 softmax), kept under the JAX
# package's naming for its einsum path.
_attention_plain = _fa.attention_plain


def dot_product_attention(q, k, v, kv_mask=None, scale=None):
    """Fused attention: q (B, Lq, H, D), k/v (B, Lkv, H, D) -> (B, Lq, H, D)."""
    return _fa.flash_attention(q, k, v, kv_mask=kv_mask, scale=scale)
