"""Unified VLA episode dataset for RDT finetuning (counterpart of
``vla_touch_tpu/data/vla_dataset.py``: the same numpy draws for the same
seed).

Samples one (random-timestep) training example per draw:

- episode-length-weighted episode choice;
- motion-onset skip: timesteps start at ``first_idx - 1``;
- random step in [first_idx - 1, num_steps - chunk/2) with actions taken at
  ``step_id + 2``;
- gripper /255 rescale;
- chunk padding with the last action;
- 10-D -> 128-D unified vector scatter;
- 2-frame image history, padded with the first frame, masked by onset;
  camera1 -> cam_high, camera2 -> cam_right_wrist, left wrist empty;

plus per-episode state statistics used by the condition-masking pipeline.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from vla_touch_tpu_torch.config import DataConfig
from vla_touch_tpu_torch.data.episode import (
    GRIPPER_SCALE,
    EpisodeFile,
    list_episode_files,
    motion_onset_index,
    qpos_from_episode,
)
from vla_touch_tpu_torch.utils.image import pad_and_resize_batch
from vla_touch_tpu_torch.utils.state_vec import fill_in_state


class UnifiedVLADataset:
    """Episode sampler over ``{root}/{name}_hdf5_gelsight/episode_*.h5``."""

    def __init__(self, cfg: DataConfig, file_paths: Optional[Sequence[str]] = None,
                 dataset_name: Optional[str] = None, seed: int = 0):
        self.cfg = cfg
        self.dataset_name = dataset_name or cfg.dataset_names[0]
        if file_paths is None:
            import os
            pattern = (".epc",) if cfg.data_format == "epc" else (".h5", ".npz")
            file_paths = list_episode_files(
                os.path.join(cfg.data_root,
                             f"{self.dataset_name}_hdf5_gelsight"),
                pattern=pattern)
        self.file_paths = list(file_paths)
        self.rng = np.random.default_rng(seed)

        lens = []
        keep = []
        for p in self.file_paths:
            n = self._episode_len(p)
            if n is not None:
                keep.append(p)
                lens.append(n)
        self.file_paths = keep
        self.episode_lens = np.asarray(lens)
        self.total_episode_lengths = int(self.episode_lens.sum())
        self.episode_sample_weights = self.episode_lens / self.episode_lens.sum()

    def _episode_len(self, path) -> Optional[int]:
        with EpisodeFile(path) as f:
            n = f["ee_poses"].shape[0]
        return n if n >= 32 else None

    def __len__(self):
        return len(self.file_paths)

    def get_item(self, index: Optional[int] = None, state_only: bool = False):
        for _ in range(1000):
            if index is None:
                file_path = self.rng.choice(
                    self.file_paths, p=self.episode_sample_weights)
            else:
                file_path = self.file_paths[index]
            sample = (self.parse_file(file_path) if not state_only
                      else self.parse_file_state_only(file_path))
            if sample is not None:
                return sample
            index = int(self.rng.integers(0, len(self.file_paths)))
        raise RuntimeError(
            f"dataset '{self.dataset_name}': no episode yielded a valid "
            "sample in 1000 attempts (all episodes too short for "
            f"chunk_size={self.cfg.chunk_size} or static)")

    # -- parsing -----------------------------------------------------------

    def parse_file(self, file_path: str):
        cfg = self.cfg
        with EpisodeFile(file_path) as f:
            qpos = qpos_from_episode(f)
            instruction_embedding = np.asarray(f["instruct_embeddings"])[0]
            num_steps = qpos.shape[0]
            if num_steps < 32:
                return None
            first_idx = motion_onset_index(qpos)
            if first_idx is None:
                return None

            high = num_steps - cfg.chunk_size // 2
            if first_idx - 1 >= high:
                # Episode too short (or motion starts too late) for the
                # chunk horizon: invalid, caller resamples.
                return None
            step_id = int(self.rng.integers(first_idx - 1, high))
            action_id = step_id + 2

            qpos = qpos / np.array([[1] * 9 + [GRIPPER_SCALE]])
            state = qpos[step_id:step_id + 1]
            state_std = np.std(qpos, axis=0)
            state_mean = np.mean(qpos, axis=0)
            state_norm = np.sqrt(np.mean(qpos**2, axis=0))

            actions = qpos[action_id:action_id + cfg.chunk_size]
            if actions.shape[0] < cfg.chunk_size:
                actions = np.concatenate(
                    [actions, np.tile(actions[-1:],
                                      (cfg.chunk_size - actions.shape[0], 1))],
                    axis=0)

            sample = {
                "meta": {
                    "dataset_name": self.dataset_name,
                    "#steps": num_steps,
                    "step_id": step_id,
                    "instruction_embedding": instruction_embedding,
                },
                "state": fill_in_state(state),
                "state_std": fill_in_state(state_std),
                "state_mean": fill_in_state(state_mean),
                "state_norm": fill_in_state(state_norm),
                "state_indicator": fill_in_state(np.ones(10)),
                "actions": fill_in_state(actions),
            }

            cam_high = self._parse_img(f, "camera1", step_id)
            valid_len = min(step_id - (first_idx - 1) + 1, cfg.img_history_size)
            mask = np.array([False] * (cfg.img_history_size - valid_len)
                            + [True] * valid_len)
            sample.update({
                "cam_high": cam_high,
                "cam_high_mask": mask,
                "cam_left_wrist": np.zeros((cfg.img_history_size, 0, 0, 0)),
                "cam_left_wrist_mask": mask.copy(),
                "cam_right_wrist": self._parse_img(f, "camera2", step_id),
                "cam_right_wrist_mask": mask.copy(),
            })
            return sample

    def _parse_img(self, f: EpisodeFile, key: str, step_id: int):
        cfg = self.cfg
        if f"{key}/{key}" not in f:
            return np.zeros((cfg.img_history_size, 0, 0, 0))
        imgs = np.asarray(
            f[f"{key}/{key}"][max(step_id - cfg.img_history_size + 1, 0):
                              step_id + 1])
        imgs = pad_and_resize_batch(imgs, cfg.image_size)
        if imgs.shape[0] < cfg.img_history_size:
            imgs = np.concatenate(
                [np.tile(imgs[:1], (cfg.img_history_size - imgs.shape[0],
                                    1, 1, 1)), imgs], axis=0)
        return imgs

    def parse_file_state_only(self, file_path: str):
        with EpisodeFile(file_path) as f:
            qpos = qpos_from_episode(f)
        first_idx = motion_onset_index(qpos)
        if first_idx is None:
            return None
        qpos = qpos / np.array([[1] * 9 + [GRIPPER_SCALE]])
        return {"state": fill_in_state(qpos[first_idx - 1:])}
