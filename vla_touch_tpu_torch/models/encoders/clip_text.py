"""CLIP text transformer, the text tower of the planner's ViFiCLIP
(counterpart of ``vla_touch_tpu/models/encoders/clip_text.py``).

Token + learned positional embeddings, pre-LN blocks under a causal mask
plus the padding mask, a final LayerNorm and pooling at the first EOS token
(HF ``pooler_output``).  The blocks are the vision tower's
:class:`~vla_touch_tpu_torch.models.encoders.vit.ViTBlock` driven with an
additive bias, so their attention is the plain einsum and softmax
(``ViTSelfAttention`` with a mask), as the JAX package computes it: K1
takes a key mask per row, and a causal bias is not one.

``clip_text_from_hf`` maps an HF ``CLIPTextModel`` state dict to the flax
tree of this tower (``utils/from_flax.py`` turns that into the port's
names); the key space is the ``clip_vit_b16_text`` manifest.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from vla_touch_tpu_torch.models.encoders.vit import ViTBlock, ViTConfig

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    mlp_dim: int = 2048
    max_positions: int = 77
    layernorm_eps: float = 1e-5
    eos_token_id: int = 49407

    def vit(self) -> ViTConfig:
        """The block config shared with the vision tower (quick GELU, pre-LN
        residual blocks; the patch and image fields are unused)."""
        return ViTConfig(hidden_size=self.hidden_size, num_layers=self.num_layers,
                         num_heads=self.num_heads, mlp_dim=self.mlp_dim,
                         use_layerscale=False, quick_gelu=True,
                         layernorm_eps=self.layernorm_eps)


CLIP_TEXT_B16 = CLIPTextConfig()


def causal_bias(length: int, device=None) -> torch.Tensor:
    """(1, 1, L, L) additive causal mask: 0 on and below the diagonal, -1e9
    above."""
    m = torch.full((length, length), NEG_INF, dtype=torch.float32, device=device)
    return torch.triu(m, diagonal=1)[None, None]


def padding_bias(attention_mask) -> torch.Tensor:
    """(B, L) {0, 1} key-padding mask -> (B, 1, 1, L) additive bias."""
    return (1.0 - attention_mask.float())[:, None, None, :] * NEG_INF


def eos_pool(hidden, input_ids, eos_token_id: int):
    """The hidden state at the FIRST EOS of each row (argmax of the EOS
    indicator; a row without EOS pools position 0)."""
    pos = (input_ids == eos_token_id).int().argmax(dim=-1)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), pos]


class CLIPTextTower(nn.Module):
    """Plain CLIP text transformer: (input_ids, attention_mask) ->
    (last hidden states, pooled)."""

    # None: compute in the weights' dtype; set by vit.master_weights_
    compute_dtype = None

    def __init__(self, cfg: CLIPTextConfig = CLIP_TEXT_B16):
        super().__init__()
        self.cfg = cfg
        self.token_embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size))
        self.pos_embed = nn.Parameter(torch.empty(cfg.max_positions, cfg.hidden_size))
        vc = cfg.vit()
        self.blocks = nn.ModuleList(ViTBlock(vc) for _ in range(cfg.num_layers))
        self.final_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layernorm_eps)

    @torch.no_grad()
    def init_special_(self, generator):
        self.token_embed.normal_(0.0, 0.02, generator=generator)
        self.pos_embed.normal_(0.0, 0.01, generator=generator)

    def _dtype(self) -> torch.dtype:
        return self.compute_dtype or self.token_embed.dtype

    def embed(self, input_ids):
        L = input_ids.shape[1]
        return (self.token_embed[input_ids] + self.pos_embed[None, :L]).to(self._dtype())

    def forward(self, input_ids, attention_mask=None):
        x = self.embed(input_ids)
        bias = causal_bias(input_ids.shape[1], x.device)
        if attention_mask is not None:
            bias = bias + padding_bias(attention_mask)
        for blk in self.blocks:
            x = blk(x, bias)
        x = self.final_norm(x)
        return x, eos_pool(x, input_ids, self.cfg.eos_token_id)


def clip_text_from_hf(sd: dict, num_layers: int) -> dict:
    """HF ``CLIPTextModel`` state dict -> :class:`CLIPTextTower`'s flax tree
    (the JAX package's names; ``utils/from_flax.py::to_state_dict`` makes
    the port's).  Linear weights transpose (out, in) -> (in, out);
    embeddings as they are."""
    def t(name):
        return np.ascontiguousarray(np.asarray(sd[name]).T)

    def a(name):
        return np.asarray(sd[name])

    p = {
        "token_embed": a("text_model.embeddings.token_embedding.weight"),
        "pos_embed": a("text_model.embeddings.position_embedding.weight"),
        "final_norm": {"scale": a("text_model.final_layer_norm.weight"),
                       "bias": a("text_model.final_layer_norm.bias")},
    }
    for i in range(num_layers):
        h = f"text_model.encoder.layers.{i}"
        p[f"block{i}"] = {
            "norm1": {"scale": a(f"{h}.layer_norm1.weight"), "bias": a(f"{h}.layer_norm1.bias")},
            "attention": {
                "query": {"kernel": t(f"{h}.self_attn.q_proj.weight"),
                          "bias": a(f"{h}.self_attn.q_proj.bias")},
                "key": {"kernel": t(f"{h}.self_attn.k_proj.weight"),
                        "bias": a(f"{h}.self_attn.k_proj.bias")},
                "value": {"kernel": t(f"{h}.self_attn.v_proj.weight"),
                          "bias": a(f"{h}.self_attn.v_proj.bias")},
                "output": {"kernel": t(f"{h}.self_attn.out_proj.weight"),
                           "bias": a(f"{h}.self_attn.out_proj.bias")},
            },
            "norm2": {"scale": a(f"{h}.layer_norm2.weight"), "bias": a(f"{h}.layer_norm2.bias")},
            "fc1": {"kernel": t(f"{h}.mlp.fc1.weight"), "bias": a(f"{h}.mlp.fc1.bias")},
            "fc2": {"kernel": t(f"{h}.mlp.fc2.weight"), "bias": a(f"{h}.mlp.fc2.bias")},
        }
    return p
