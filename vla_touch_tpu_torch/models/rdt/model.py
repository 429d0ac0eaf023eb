"""RDT — Robotics Diffusion Transformer (counterpart of
``vla_touch_tpu/models/rdt/model.py``).

A DiT-style transformer over [timestep, ctrl_freq, state, action x horizon]
tokens whose blocks alternate masked cross-attention to the language
condition (even blocks) and the image condition (odd blocks).  The
conditions are fixed across the denoise loop, so their per-block K/V are
computed once (:meth:`RDT.compute_cond_kv`) and reused by
:meth:`RDT.forward_cached` at every solver step; :meth:`RDT.forward`
recomputes them in every block: the reference's sampler and the training
forward.

Serving modules hold their weights in the compute dtype and compute in it.
Training holds float32 master weights (``runner.init_rdt_train``): every
Linear is a ``CastLinear`` and :attr:`RDT.compute_dtype` is set, so the
weights, biases and positional embeddings are cast to the compute dtype at
each use, as flax casts them, while the RmsNorm scales enter their float32
statistics uncast, as the JAX package's ``RmsNorm`` does.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vla_touch_tpu_torch.config import RDTModelConfig
from vla_touch_tpu_torch.ops import attention as A
from vla_touch_tpu_torch.ops.nn import Mlp, RmsNorm, SelfAttention, compute_dtype_of, silu
from vla_touch_tpu_torch.ops.pos_embed import (
    get_1d_sincos_pos_embed_from_grid,
    get_multimodal_cond_pos_embed,
    timestep_embedding,
)


class TimestepEmbedder(nn.Module):
    """Sinusoidal frequency embedding -> SiLU MLP."""

    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        self.fc1 = nn.Linear(frequency_embedding_size, hidden_size)
        self.fc2 = nn.Linear(hidden_size, hidden_size)

    def forward(self, t):
        freq = timestep_embedding(t, self.frequency_embedding_size,
                                  dtype=compute_dtype_of(self.fc1))
        return self.fc2(silu(self.fc1(freq)))


class CrossAttentionSized(nn.Module):
    """Masked cross-attention with a separable K/V path."""

    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.hidden_size, self.num_heads = hidden_size, num_heads
        hd = hidden_size // num_heads
        self.q = nn.Linear(hidden_size, hidden_size)
        self.kv = nn.Linear(hidden_size, 2 * hidden_size)
        self.q_norm = RmsNorm(hd)
        self.k_norm = RmsNorm(hd)
        self.proj = nn.Linear(hidden_size, hidden_size)

    def compute_kv(self, c):
        """Condition (B, L, C) -> post-norm K and V (B, L, H, D).  V stays a
        strided view of the projection (K1 reads through strides)."""
        B, L, _ = c.shape
        hd = self.hidden_size // self.num_heads
        kv = self.kv(c).reshape(B, L, 2, self.num_heads, hd)
        return self.k_norm(kv[:, :, 0]), kv[:, :, 1]

    def attend(self, x, k, v, mask=None):
        B, N, C = x.shape
        q = self.q_norm(self.q(x).reshape(B, N, self.num_heads, C // self.num_heads))
        out = A.dot_product_attention(q, k, v, kv_mask=mask)
        return self.proj(out.reshape(B, N, C))


class RDTBlock(nn.Module):
    """Self-attn -> masked cross-attn -> MLP, each pre-RmsNorm residual."""

    def __init__(self, hidden_size: int, num_heads: int):
        super().__init__()
        self.norm1 = RmsNorm(hidden_size)
        self.attn = SelfAttention(hidden_size, num_heads)
        self.norm2 = RmsNorm(hidden_size)
        self.cross_attn = CrossAttentionSized(hidden_size, num_heads)
        self.norm3 = RmsNorm(hidden_size)
        self.ffn = Mlp(hidden_size, hidden_size)

    def call_cached(self, x, k, v, mask=None):
        x = x + self.attn(self.norm1(x))
        x = x + self.cross_attn.attend(self.norm2(x), k, v, mask)
        return x + self.ffn(self.norm3(x))

    def compute_kv(self, c):
        return self.cross_attn.compute_kv(c)

    def forward(self, x, c, mask=None):
        """The full block: the condition's K/V recomputed from ``c``."""
        return self.call_cached(x, *self.compute_kv(c), mask)


class RDT(nn.Module):
    def __init__(self, cfg: RDTModelConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.t_embedder = TimestepEmbedder(H)
        self.freq_embedder = TimestepEmbedder(H)
        self.blocks = nn.ModuleList(RDTBlock(H, cfg.num_heads)
                                    for _ in range(cfg.depth))
        self.final_norm = RmsNorm(H)
        self.final_ffn = Mlp(H, H, cfg.output_dim)
        self.x_pos_embed = nn.Parameter(torch.empty(1, cfg.horizon + 3, H))
        self.lang_cond_pos_embed = nn.Parameter(
            torch.empty(1, cfg.max_lang_cond_len, H))
        self.img_cond_pos_embed = nn.Parameter(torch.empty(1, cfg.img_cond_len, H))
        # None: compute in the weights' dtype (serving); set for master
        # weights (training)
        self.compute_dtype = None

    def sincos_pos_embeds(self) -> dict:
        """The sincos tables the positional embeddings start from."""
        cfg = self.cfg
        x_emb = get_multimodal_cond_pos_embed(
            cfg.hidden_size, OrderedDict([("timestep", 1), ("ctrl_freq", 1),
                                          ("state", 1), ("action", cfg.horizon)]))
        # ("lang", -max_len): every row is the position-0 vector
        lang_emb = get_multimodal_cond_pos_embed(
            cfg.hidden_size, OrderedDict([("lang", -cfg.max_lang_cond_len)]),
            embed_modality=False)
        if cfg.img_pos_embed_grid is None:
            img_emb = get_1d_sincos_pos_embed_from_grid(
                cfg.hidden_size, np.arange(cfg.img_cond_len))
        else:
            img_emb = get_multimodal_cond_pos_embed(
                cfg.hidden_size,
                OrderedDict([("image", tuple(cfg.img_pos_embed_grid))]),
                embed_modality=False)
        return {"x_pos_embed": x_emb[None], "lang_cond_pos_embed": lang_emb[None],
                "img_cond_pos_embed": img_emb[None]}

    @torch.no_grad()
    def init_special_(self, generator):
        """Random init: sincos positional tables, zero final projection."""
        for name, table in self.sincos_pos_embeds().items():
            p = getattr(self, name)
            p.copy_(torch.as_tensor(table, dtype=p.dtype))
        self.final_ffn.fc2.weight.zero_()

    def _dtype(self) -> torch.dtype:
        return self.compute_dtype or self.x_pos_embed.dtype

    def _embed_x(self, x, freq, t):
        dtype = self._dtype()
        t_tok = self.t_embedder(t)
        f_tok = self.freq_embedder(freq)
        x = torch.cat([t_tok[:, None], f_tok[:, None], x.to(dtype)], dim=1)
        return x + self.x_pos_embed.to(dtype)

    def add_cond_pos(self, lang_c, img_c):
        dtype = self._dtype()
        lang_c = lang_c.to(dtype) + self.lang_cond_pos_embed[:, : lang_c.shape[1]].to(dtype)
        img_c = img_c.to(dtype) + self.img_cond_pos_embed.to(dtype)
        return lang_c, img_c

    def compute_cond_kv(self, lang_c, img_c):
        """Per-block (k, v) of the pos-embedded conditions, once per chunk."""
        conds = self.add_cond_pos(lang_c, img_c)
        return [blk.compute_kv(conds[i % 2]) for i, blk in enumerate(self.blocks)]

    def forward_cached(self, x, freq, t, cond_kv, lang_mask=None, img_mask=None):
        """Denoise-loop forward with the conditions as cached K/V."""
        x = self._embed_x(x, freq, t)
        masks = (lang_mask, img_mask)
        for i, blk in enumerate(self.blocks):
            k, v = cond_kv[i]
            x = blk.call_cached(x, k, v, masks[i % 2])
        out = self.final_ffn(self.final_norm(x))
        return out[:, -self.cfg.horizon:]

    def forward(self, x, freq, t, lang_c, img_c, lang_mask=None, img_mask=None):
        """The full forward: every block recomputes its condition K/V from
        the raw conditions (the training forward, and the reference's
        sampler at every solver step).  x (B, horizon + 1, D) adapted
        [state, action...] tokens; returns (B, horizon, output_dim).  With
        ``remat_blocks`` and grad mode on, each block is recomputed in the
        backward pass (``torch.utils.checkpoint``, non-reentrant)."""
        x = self._embed_x(x, freq, t)
        conds = self.add_cond_pos(lang_c, img_c)
        masks = (lang_mask, img_mask)
        remat = self.cfg.remat_blocks and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            if remat:
                x = checkpoint(blk, x, conds[i % 2], masks[i % 2], use_reentrant=False)
            else:
                x = blk(x, conds[i % 2], masks[i % 2])
        out = self.final_ffn(self.final_norm(x))
        return out[:, -self.cfg.horizon:]
