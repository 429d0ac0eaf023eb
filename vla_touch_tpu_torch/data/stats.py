"""Dataset statistics tool (counterpart of ``vla_touch_tpu/data/stats.py``).

Streaming mean, std, min and max over every episode's state trajectory
(the std nonzero-aware over the 128-D unified vectors), written to a
``dataset_stat.json`` that the training pipeline's condition masking reads.
"""

from __future__ import annotations

import json
import os

import numpy as np

from vla_touch_tpu_torch.config import DataConfig
from vla_touch_tpu_torch.data.vla_dataset import UnifiedVLADataset


def compute_dataset_stat(dataset: UnifiedVLADataset) -> dict:
    """Moments over every episode's onset-aligned state trajectory.

    The std is the nonzero-normalized form: second moments accumulate over
    zero-suppressed values but divide by each dimension's NONZERO count, so
    sparsely populated dimensions (a mostly closed gripper) keep a usable
    scale for the state-noise pipeline."""
    EPS = 1e-8
    n = 0
    s1 = z_s1 = z_s2 = mins = maxs = nz_count = None
    for i in range(len(dataset)):
        sample = dataset.get_item(index=i, state_only=True)
        states = np.asarray(sample["state"], np.float64)
        z_states = np.where(np.abs(states) <= EPS, 0.0, states)
        if s1 is None:
            d = states.shape[-1]
            s1, z_s1, z_s2 = np.zeros(d), np.zeros(d), np.zeros(d)
            mins, maxs = np.full(d, np.inf), np.full(d, -np.inf)
            nz_count = np.zeros(d)
        n += states.shape[0]
        s1 += states.sum(0)
        z_s1 += z_states.sum(0)
        z_s2 += (z_states ** 2).sum(0)
        mins = np.minimum(mins, states.min(0))
        maxs = np.maximum(maxs, states.max(0))
        nz_count += (np.abs(states) > EPS).sum(0)
    nz = np.maximum(nz_count, 1.0)
    cnt = max(n, 1)
    mean = s1 / cnt
    std = np.sqrt(np.maximum(z_s2 / nz - (z_s1 / cnt) ** 2 * (cnt / nz), 0.0))
    return {
        "state_mean": mean.astype(np.float32),
        "state_std": std.astype(np.float32),
        "state_min": mins.astype(np.float32),
        "state_max": maxs.astype(np.float32),
        "nonzero_fraction": (nz_count / cnt).astype(np.float32),
        "num_steps": int(n),
    }


def process_dataset(cfg: DataConfig, out_path: str, file_paths=None) -> dict:
    """Compute and write ``dataset_stat.json`` keyed by dataset name, over
    the episodes of ``cfg.data_format`` (or ``file_paths``)."""
    all_stats = {}
    for name in cfg.dataset_names:
        ds = UnifiedVLADataset(cfg, file_paths=file_paths, dataset_name=name)
        st = compute_dataset_stat(ds)
        all_stats[name] = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                           for k, v in st.items()}
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(all_stats, f, indent=2)
    return all_stats
