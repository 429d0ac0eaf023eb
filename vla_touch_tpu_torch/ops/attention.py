"""Scaled-dot-product attention (counterpart of
``vla_touch_tpu/ops/attention.py``).

Layout (B, L, H, D) for q/k/v; ``kv_mask`` optional (B, L_kv) bool, True =
valid.  :func:`dot_product_attention` has two routes, both through kernel
K1's wrapper (the CUDA kernel on CUDA tensors, the plain einsum version on
CPU tensors):

- under ``no_grad`` / ``inference_mode``, or when no operand requires
  grad, it calls the wrapper directly (serving; every launch counted);
- when grad mode is on and an operand requires grad (training), it goes
  through ``FlashAttentionFn``: the same forward, and a backward that
  recomputes the plain float32 einsum and softmax under autograd.  The JAX
  package trains through that plain program (its attention under grad is
  ``_attention_xla``) and has no backward kernel, so the port has none.
  On CUDA the wrapper raises if called directly with such operands: its
  output would carry no gradient.

K1 takes bf16 operands.  A float32 module on the card (``rdt_tiny``, a
float32 ViT) attends through it on its q, k and v rounded to bf16, the
output cast back to the module's dtype; on the CPU the plain version runs
in the operands' dtype.
"""

from __future__ import annotations

import torch

from vla_touch_tpu_torch.ops import flash_attention as _fa

# The plain version of K1 (einsum + f32 softmax), kept under the JAX
# package's naming for its einsum path.
_attention_plain = _fa.attention_plain


def dot_product_attention(q, k, v, kv_mask=None, scale=None):
    """Fused attention: q (B, Lq, H, D), k/v (B, Lkv, H, D) -> (B, Lq, H, D)."""
    if q.device.type == "cuda" and q.dtype != torch.bfloat16:
        bf16 = torch.bfloat16
        return dot_product_attention(q.to(bf16), k.to(bf16), v.to(bf16), kv_mask,
                                     scale).to(q.dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _fa.FlashAttentionFn.apply(q, k, v, kv_mask, scale)
    return _fa.flash_attention(q, k, v, kv_mask=kv_mask, scale=scale)
