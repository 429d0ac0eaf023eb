"""Controller training dataset (BRIDGeR / LSTM) — counterpart of
``vla_touch_tpu/data/controller_dataset.py``.

Windows over VLA-augmented episodes:

- (episode, start) pairs from the motion onset on, every ``stride`` steps;
- a sample: the context + horizon states, the VLA chunk recorded at
  ``start + context`` (the chunk predicted at the first future step), the
  expert future states, GelSight forces and displacements over the window,
  the context's resized camera frames in [0, 1];
- the gripper divided by 255 on expert future states and VLA actions (raw
  on the context states);
- global per-dimension min/max stats over the files;
- a deterministic train/val file split (:class:`ControllerDataModule`).

Batches are numpy dicts; the trainer moves them to the device.
"""

from __future__ import annotations

import collections
from typing import Optional, Sequence

import numpy as np

from vla_touch_tpu_torch.data.episode import (GRIPPER_SCALE, EpisodeFile,
                                              list_episode_files, qpos_from_episode)


def _episode_files(data_dir: str, data_format: str) -> list:
    if data_format == "epc":
        raise NotImplementedError("the native .epc episode cache is not ported yet")
    return list_episode_files(data_dir)


class ControllerDataset:
    def __init__(self, data_dir: Optional[str] = None,
                 file_paths: Optional[Sequence[str]] = None,
                 context_frames: int = 2, horizon: int = 8,
                 use_images: bool = True, stride: int = 1,
                 data_format: str = "h5"):
        assert data_dir or file_paths
        self.file_paths = (list(file_paths) if file_paths
                           else _episode_files(data_dir, data_format))
        self.context_frames = context_frames
        self.horizon = horizon
        self.use_images = use_images
        self.stride = stride
        self._build_index()
        self.stats = self.get_normalization_stats()

    def _build_index(self):
        self.episode_indices = []
        for file_idx, path in enumerate(self.file_paths):
            with EpisodeFile(path) as f:
                ref = np.asarray(f["ee_poses"])
                n = ref.shape[0]
                idx = np.where(np.any(np.abs(ref - ref[0:1]) > 1e-2, axis=1))[0]
                if len(idx) == 0:
                    continue
                last = n - (self.context_frames + self.horizon - 1)
                for start in range(int(idx[0]), last, self.stride):
                    self.episode_indices.append((file_idx, start))

    def __len__(self):
        return len(self.episode_indices)

    def __getitem__(self, i: int) -> dict:
        file_idx, start = self.episode_indices[i]
        ctx, hor = self.context_frames, self.horizon
        with EpisodeFile(self.file_paths[file_idx]) as f:
            qpos = qpos_from_episode(f)[start:start + ctx + hor]
            future = qpos[ctx:].copy()
            future[:, -1] /= GRIPPER_SCALE            # actions, not observations
            # float32 before the gripper rescale, as the JAX package reads it
            vla = np.asarray(f["vla_action"][start + ctx], np.float32)[:hor].copy()
            vla[:, -1] /= GRIPPER_SCALE
            out = {
                "states": qpos.astype(np.float32),
                "vla_actions": vla,
                "expert_actions": future.astype(np.float32),
                "forces": np.asarray(f["gelsight_force/forces"][start:start + ctx + hor],
                                     np.float32),
                "disps": np.asarray(f["gelsight_force/displacement"]
                                    [start:start + ctx + hor], np.float32),
            }
            if self.use_images:
                for cam in (1, 2):
                    out[f"images_cam{cam}"] = np.asarray(
                        f[f"camera{cam}_resized"][start:start + ctx], np.float32) / 255.0
        return out

    def get_normalization_stats(self) -> dict:
        d = 10
        a_min, a_max = np.full(d, np.inf), np.full(d, -np.inf)
        v_min, v_max = np.full(d, np.inf), np.full(d, -np.inf)
        for path in self.file_paths:
            with EpisodeFile(path) as f:
                expert = qpos_from_episode(f)
                expert[:, -1] /= GRIPPER_SCALE
                vla = np.asarray(f["vla_action"], np.float32).copy()
                vla[:, :, -1] /= GRIPPER_SCALE
                a_min, a_max = np.minimum(a_min, expert.min(0)), np.maximum(a_max, expert.max(0))
                v_min = np.minimum(v_min, vla.min((0, 1)))
                v_max = np.maximum(v_max, vla.max((0, 1)))
        a_rng, v_rng = a_max - a_min, v_max - v_min
        a_rng[a_rng < 1e-6] = 1.0
        v_rng[v_rng < 1e-6] = 1.0
        return {"action_mins": a_min.astype(np.float32), "action_maxs": a_max.astype(np.float32),
                "vla_mins": v_min.astype(np.float32), "vla_maxs": v_max.astype(np.float32),
                "action_range": a_rng.astype(np.float32), "vla_range": v_rng.astype(np.float32)}

    def batches(self, batch_size: int, rng: np.random.Generator, shuffle: bool = True,
                drop_last: bool = True, workers: int = 0, prefetch_depth: int = 2):
        """Yield stacked numpy batch dicts.  ``workers`` > 0 builds them in a
        thread pool, ``workers + prefetch_depth`` in flight; the order and
        contents are those of the in-line path."""
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        end = len(order) - (len(order) % batch_size if drop_last else 0)
        starts = [order[i:i + batch_size] for i in range(0, end, batch_size)]

        def build(idxs):
            samples = [self[int(j)] for j in idxs]
            return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

        if workers <= 0:
            for idxs in starts:
                yield build(idxs)
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as pool:
            pending = collections.deque()
            for idxs in starts:
                pending.append(pool.submit(build, idxs))
                if len(pending) > workers + prefetch_depth:
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()


class ControllerDataModule:
    """Deterministic train/val file split."""

    def __init__(self, data_dir: str, context_frames: int = 2, horizon: int = 8,
                 use_images: bool = True, val_ratio: float = 0.1,
                 stride: int = 1, seed: int = 42, data_format: str = "h5"):
        files = _episode_files(data_dir, data_format)
        order = np.random.default_rng(seed).permutation(len(files))
        n_val = max(1, int(len(files) * val_ratio)) if len(files) > 1 else 0
        val_idx = set(order[:n_val].tolist())
        self.train_files = [f for i, f in enumerate(files) if i not in val_idx]
        self.val_files = [f for i, f in enumerate(files) if i in val_idx]
        kw = dict(context_frames=context_frames, horizon=horizon,
                  use_images=use_images, stride=stride)
        self.train_dataset = ControllerDataset(file_paths=self.train_files, **kw)
        self.val_dataset = (ControllerDataset(file_paths=self.val_files, **kw)
                            if self.val_files else None)
        # deployment uses the train split's stats
        self.stats = self.train_dataset.stats
