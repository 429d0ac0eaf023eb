"""Tactile-token splicing for the planner LLM (counterpart of
``vla_touch_tpu/planning/llm_splice.py``): tactile video features are
projected to the LLM width by a two-layer exact-GELU MLP and spliced into
the input-embedding sequence between the tactile delimiter embeddings, one
feature vector per ``<tact>`` placeholder."""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from vla_touch_tpu_torch.ops.nn import gelu_erf

TACTILE_START = "<|tactile_start|>"
TACTILE_END = "<|tactile_end|>"
TACTILE_PLACEHOLDER = "<tact>"


class TactileProjector(nn.Module):
    """CLIP-video feature (feature_dim) -> LLM embedding width."""

    def __init__(self, feature_dim: int, llm_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(feature_dim, llm_dim)
        self.fc2 = nn.Linear(llm_dim, llm_dim)

    def forward(self, feats):
        return self.fc2(gelu_erf(self.fc1(feats)))


def init_tactile_projector(feature_dim: int, llm_dim: int, seed: int = 0,
                           device=None) -> TactileProjector:
    """A seeded random float32 projector on ``device`` (default CUDA)."""
    from vla_touch_tpu_torch.utils.random_init import build_module

    return build_module(lambda: TactileProjector(feature_dim, llm_dim), seed, device,
                        torch.float32)


def split_on_placeholders(text: str) -> list:
    """Alternating [text, PLACEHOLDER, text, ...] segments of a prompt."""
    parts = text.split(TACTILE_PLACEHOLDER)
    out = []
    for i, p in enumerate(parts):
        if i > 0:
            out.append(TACTILE_PLACEHOLDER)
        if p:
            out.append(p)
    return out


def _as2d(a):
    a = torch.as_tensor(a)
    return a[None] if a.dim() == 1 else a


def splice_embeddings(segment_embeds: Sequence, tactile_feats: Sequence, start_embed,
                      end_embed):
    """seg_0, [start, tact_0, end], seg_1, [start, tact_1, end], ... as one
    (L, D) tensor (``torch.cat`` promotes mixed dtypes as ``jnp`` does)."""
    assert len(segment_embeds) == len(tactile_feats) + 1
    dev = torch.as_tensor(start_embed).device
    pieces = [_as2d(segment_embeds[0]).to(dev)]
    for feats, seg in zip(tactile_feats, segment_embeds[1:]):
        pieces += [_as2d(start_embed), _as2d(feats).to(dev), _as2d(end_embed),
                   _as2d(seg).to(dev)]
    return torch.cat(pieces, dim=0)


def process_user_input(text: str, tactile_videos: list, embed_text_fn: Callable,
                       encode_video_fn: Callable, project_fn: Callable, start_embed,
                       end_embed):
    """Split on placeholders (empty segments between adjacent placeholders
    kept), embed the text segments, encode and project the videos, splice.
    An empty segment is a (0, D) tensor of the delimiters' dtype."""
    text_segments = text.split(TACTILE_PLACEHOLDER)
    n_tact = len(text_segments) - 1
    assert n_tact == len(tactile_videos), (n_tact, len(tactile_videos))
    start = torch.as_tensor(start_embed)
    seg_embeds = [embed_text_fn(s) if s else start.new_zeros((0, start.shape[-1]))
                  for s in text_segments]
    feats = [project_fn(encode_video_fn(v)) for v in tactile_videos]
    return splice_embeddings(seg_embeds, feats, start_embed, end_embed)
