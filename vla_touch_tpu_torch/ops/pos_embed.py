"""Sin/cos positional embeddings (counterpart of
``vla_touch_tpu/ops/pos_embed.py``).

The grid tables are numpy (init time); the two scalar embeddings are torch
functions.  Two conventions coexist and are kept: grid embeds
``concat([sin, cos])``, GLIDE timestep embeds ``concat([cos, sin])``.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import numpy as np
import torch


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos) -> np.ndarray:
    """MAE-style 1-D sincos table: (M,) positions -> (M, embed_dim)."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    pos = np.asarray(pos, dtype=np.float64).reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_nd_sincos_pos_embed_from_grid(embed_dim: int, grid_sizes) -> np.ndarray:
    """N-D sincos table over a grid; dims with size <= 1 carry no embedding.
    Returns shape ``grid_sizes + (embed_dim,)``."""
    grid_sizes = tuple(grid_sizes)
    num_valid = len([s for s in grid_sizes if s > 1])
    emb = np.zeros(grid_sizes + (embed_dim,))
    dim_per_grid = embed_dim // max(num_valid, 1)
    if dim_per_grid % 2 != 0:
        dim_per_grid -= 1
    valid_idx = 0
    for axis, size in enumerate(grid_sizes):
        if size <= 1:
            continue
        table = get_1d_sincos_pos_embed_from_grid(dim_per_grid, np.arange(size))
        shape = [1] * len(grid_sizes) + [dim_per_grid]
        shape[axis] = -1
        emb[..., valid_idx * dim_per_grid:(valid_idx + 1) * dim_per_grid] += (
            table.reshape(shape))
        valid_idx += 1
    return emb


def get_multimodal_cond_pos_embed(embed_dim: int, mm_cond_lens: OrderedDict,
                                  embed_modality: bool = True) -> np.ndarray:
    """Concatenated per-modality positional embeddings.

    Each (modality, length) entry contributes ``|length|`` rows.  With
    ``embed_modality`` the first half of the channels encodes the modality
    and the second half the position within it.  ``image`` may pass a tuple
    of grid sizes (negative size = no embedding along that axis).
    """
    num_modalities = len(mm_cond_lens)
    modality_pos_embed = np.zeros((num_modalities, embed_dim))
    if embed_modality:
        modality_pos_embed[:, : embed_dim // 2] = get_1d_sincos_pos_embed_from_grid(
            embed_dim // 2, np.arange(num_modalities))
        pos_dim = embed_dim // 2
    else:
        pos_dim = embed_dim

    rows = []
    for idx, (modality, cond_len) in enumerate(mm_cond_lens.items()):
        if modality == "image" and isinstance(cond_len, (tuple, list)):
            all_sizes = tuple(abs(x) for x in cond_len)
            embed_sizes = tuple(x if x > 0 else 1 for x in cond_len)
            grid_embed = get_nd_sincos_pos_embed_from_grid(pos_dim, embed_sizes)
            block = np.zeros(all_sizes + (embed_dim,))
            block[..., -pos_dim:] += grid_embed
            block = block.reshape(-1, embed_dim)
        else:
            n = cond_len if cond_len > 0 else 1
            table = get_1d_sincos_pos_embed_from_grid(pos_dim, np.arange(n))
            block = np.zeros((abs(cond_len), embed_dim))
            block[:, -pos_dim:] += table
        block = block + modality_pos_embed[idx]
        rows.append(block)
    return np.concatenate(rows, axis=0)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0,
                       dtype=torch.float32) -> torch.Tensor:
    """GLIDE-style scalar embedding: (N,) -> (N, dim), ``concat([cos, sin])``.
    Computed in float32, returned in ``dtype``."""
    t = t.to(torch.float32)
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = t[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb.to(dtype)


def sinusoidal_pos_emb(t: torch.Tensor, dim: int, dtype=torch.float32) -> torch.Tensor:
    """Diffusion-policy UNet step embedding: (N,) -> (N, dim),
    ``concat([sin, cos])`` with a ``half - 1`` denominator."""
    t = t.to(torch.float32)
    half = dim // 2
    emb_scale = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -emb_scale)
    args = t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1).to(dtype)
