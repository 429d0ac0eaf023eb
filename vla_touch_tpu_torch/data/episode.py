"""Episode files: the reader the controller dataset needs (counterpart of
part of ``vla_touch_tpu/data/episode.py``).

One ``episode_*.h5`` per episode: ``ee_poses`` (T, 7) xyz + xyzw
quaternion, ``gripper_pos`` (T,) raw 0..255, ``camera{1,2}/camera{1,2}``
(T, H, W, 3) uint8, ``gelsight_force/forces`` (T, 3) and
``displacement`` (T, 2), and, once the distillation pass ran,
``vla_action`` (T, chunk, 10) and ``camera{1,2}_resized``.  ``h5py`` is
imported where a file is opened, so the package imports where h5py is
absent; the native ``.epc`` cache and the npz layout are not read by the
port yet.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

from vla_touch_tpu_torch.utils.geometry import quaternion_to_ortho6d

GRIPPER_SCALE = 255.0


def natural_sort(filenames):
    def key(s):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]
    return sorted(filenames, key=key)


def list_episode_files(data_dir: str) -> list:
    """The ``.h5`` episode files under ``data_dir``, each directory's in
    natural order."""
    out = []
    for root, _, files in os.walk(data_dir):
        out += [os.path.join(root, f) for f in natural_sort(files) if f.endswith(".h5")]
    return out


class EpisodeFile:
    """Read access to an h5 episode by key (``'camera1/camera1'``,
    ``'ee_poses'``, ...)."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def __enter__(self):
        if self.path.endswith(".epc"):
            raise NotImplementedError(
                f"{self.path}: the native .epc episode cache is not ported yet")
        import h5py

        self._f = h5py.File(self.path, "r")
        return self

    def __exit__(self, *exc):
        if self._f is not None:
            self._f.close()
        self._f = None
        return False

    def __contains__(self, key: str) -> bool:
        return key in self._f

    def __getitem__(self, key: str):
        return self._f[key]


def qpos_from_episode(f) -> np.ndarray:
    """[ee_pos (3), ortho6d (6), raw gripper (1)] (T, 10), float64; the
    gripper stays on its raw 0..255 scale."""
    ee = np.asarray(f["ee_poses"], np.float64)
    pos, quat = ee[:, :3], ee[:, 3:7]
    o6 = np.asarray(quaternion_to_ortho6d(quat), np.float64)
    grip = np.asarray(f["gripper_pos"], np.float64).reshape(-1, 1)
    return np.concatenate([pos, o6, grip], axis=-1)


def motion_onset_index(qpos: np.ndarray, eps: float = 1e-2) -> Optional[int]:
    """First index where any qpos dimension moved more than ``eps`` from the
    initial pose; None if the episode is static."""
    delta = np.abs(qpos - qpos[0:1])
    idx = np.where(np.any(delta > eps, axis=1))[0]
    return int(idx[0]) if len(idx) else None
