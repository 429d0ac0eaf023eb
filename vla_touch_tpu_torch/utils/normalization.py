"""Padded min-max action normalization (counterpart of
``vla_touch_tpu/utils/normalization.py``).

The per-dimension [min, max] range is expanded by ``padding_factor``
(default 1.4) around its center, then mapped to [-1, 1].  Stats are a dict
with keys ``{action,vla}_{mins,maxs}``, one vector per action dimension
(numpy arrays or tensors).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

DEFAULT_PADDING_FACTOR = 1.4
_EPS = 1e-6


def _padded_bounds(mins, maxs, padding_factor: float, device):
    mins = torch.as_tensor(mins, dtype=torch.float32, device=device)
    maxs = torch.as_tensor(maxs, dtype=torch.float32, device=device)
    center = (mins + maxs) / 2.0
    padded_range = (maxs - mins) * padding_factor
    padded_mins = center - padded_range / 2.0
    safe_range = torch.where(padded_range < _EPS,
                             torch.ones_like(padded_range), padded_range)
    return padded_mins, safe_range


def _select_stats(stats: Mapping, action_type: str):
    if action_type == "expert":
        return stats["action_mins"], stats["action_maxs"]
    if action_type == "vla":
        return stats["vla_mins"], stats["vla_maxs"]
    raise ValueError(f"Unknown action_type: {action_type}. Use 'expert' or 'vla'.")


def normalize_actions(actions: torch.Tensor, stats: Mapping,
                      action_type: str = "expert",
                      padding_factor: float = DEFAULT_PADDING_FACTOR):
    """Map actions into [-1, 1] using the padded per-dim range."""
    mins, maxs = _select_stats(stats, action_type)
    padded_mins, safe_range = _padded_bounds(mins, maxs, padding_factor,
                                             actions.device)
    return 2.0 * (actions - padded_mins) / safe_range - 1.0


def denormalize_actions(normalized: torch.Tensor, stats: Mapping,
                        action_type: str = "expert",
                        padding_factor: float = DEFAULT_PADDING_FACTOR):
    """Inverse of :func:`normalize_actions`."""
    mins, maxs = _select_stats(stats, action_type)
    padded_mins, safe_range = _padded_bounds(mins, maxs, padding_factor,
                                             normalized.device)
    return (normalized + 1.0) / 2.0 * safe_range + padded_mins


def compute_minmax_stats(expert_actions: np.ndarray, vla_actions: np.ndarray) -> dict:
    """Global per-dimension min/max stats over the whole dataset: everything
    but the last axis flattened.  float32 numpy arrays.  (No range floor:
    ``ControllerDataset.get_normalization_stats`` floors a range below 1e-6
    to 1 and does not call this, as in the JAX package.)"""
    ea = np.asarray(expert_actions, dtype=np.float32).reshape(-1, np.shape(expert_actions)[-1])
    va = np.asarray(vla_actions, dtype=np.float32).reshape(-1, np.shape(vla_actions)[-1])
    return {
        "action_mins": ea.min(axis=0),
        "action_maxs": ea.max(axis=0),
        "action_range": ea.max(axis=0) - ea.min(axis=0),
        "vla_mins": va.min(axis=0),
        "vla_maxs": va.max(axis=0),
        "vla_range": va.max(axis=0) - va.min(axis=0),
    }
