"""Episode files: readers and the synthetic-fixture writer (counterpart of
``vla_touch_tpu/data/episode.py``).

One ``episode_*.h5`` (or ``.npz``) per episode: ``ee_poses`` (T, 7) xyz +
xyzw quaternion, ``gripper_pos`` (T,) raw 0..255,
``camera{1,2}/camera{1,2}`` (T, H, W, 3) uint8, ``instruct_embeddings``
(1, L, D) float32, ``gelsight_force/forces`` (T, 3) and ``displacement``
(T, 2), and, once the distillation pass ran, ``vla_action`` (T, chunk, 10)
and ``camera{1,2}_resized``.  The npz layout flattens the h5 groups
(``camera1/camera1`` is ``camera1_images``, ``gelsight_force/forces`` is
``gelsight_forces``).  ``h5py`` is imported where an h5 file is opened, so
a machine without it reads and writes npz episodes.  Packed ``.epc``
caches (``runtime/native_loader.py``) are read through the same keys.
"""

from __future__ import annotations

import os
import re
import struct
import zipfile
from typing import Optional

import numpy as np

from vla_touch_tpu_torch.utils.geometry import quaternion_to_ortho6d

GRIPPER_SCALE = 255.0


def natural_sort(filenames):
    def key(s):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]
    return sorted(filenames, key=key)


def list_episode_files(data_dir: str, pattern=(".h5",)) -> list:
    """Episode files under ``data_dir``, each directory's in natural order.

    The default lists h5 only (the controller dataset reads h5); pass
    ``(".h5", ".npz")`` for the RDT sampler.  When one episode exists in
    both formats, the h5 file is listed."""
    if isinstance(pattern, str):
        pattern = (pattern,)
    out = []
    for root, _, files in os.walk(data_dir):
        chosen = {}
        for f in files:
            for ext in pattern:
                if f.endswith(ext):
                    stem = f[: -len(ext)]
                    if stem not in chosen or ext == ".h5":
                        chosen[stem] = f
        out += [os.path.join(root, f) for f in natural_sort(list(chosen.values()))]
    return out


NPZ_ALIASES = {
    "camera1/camera1": "camera1_images",
    "camera2/camera2": "camera2_images",
    "gelsight_force/forces": "gelsight_forces",
    "gelsight_force/displacement": "gelsight_displacement",
}


def npz_member_map(path: str, zf, key: str):
    """A read-only memory map of member ``key`` of the npz at ``path`` (its
    ``zipfile.ZipFile`` ``zf``) when the member is stored uncompressed
    (``np.savez``), else None.  Reading a slice of the map reads those
    bytes only: a sample takes 2 of an episode's frames."""
    info = zf.getinfo(key + ".npy")
    if info.compress_type != zipfile.ZIP_STORED:
        return None
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        head = f.read(30)                      # the zip local file header
        n_name, n_extra = struct.unpack("<HH", head[26:30])
        f.seek(info.header_offset + 30 + n_name + n_extra)
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read(f)
        offset = f.tell()
    if dtype.hasobject:
        return None
    return np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=shape,
                     order="F" if fortran else "C")


class _EpcFrames:
    """One camera of a ``.epc`` cache as an h5-dataset-like view: ``shape``
    and integer or contiguous-slice indexing, decoding only the frames
    asked for (``EpisodeCache.host_frames``: the host's threads, or nvJPEG
    on the card and one copy back)."""

    def __init__(self, cache, cam: int):
        self._cache = cache
        self._cam = cam
        self.shape = (cache.T, cache.H, cache.W, 3)

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return self._cache.host_frames(self._cam, int(idx), 1)[0]
        start, stop, step = idx.indices(self.shape[0])
        if step != 1:
            raise IndexError("only contiguous slices supported")
        return self._cache.host_frames(self._cam, start, max(stop - start, 0))

    def __array__(self, dtype=None, copy=None):
        out = self._cache.host_frames(self._cam, 0, self.shape[0])
        return out if dtype is None else out.astype(dtype)


class _EpcVla:
    """The per-step VLA chunks of a ``.epc`` cache as an h5-dataset-like
    view: an integer index reads one (chunk, D) record."""

    def __init__(self, cache):
        self._cache = cache
        self.shape = (cache.T, cache.chunk, cache.state_dim)

    def __len__(self):
        return self.shape[0]

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return self._cache.read_window(int(idx), 1, vla_at=int(idx))["vla"]
        start, stop, step = idx.indices(self.shape[0])
        if step != 1:
            raise IndexError("only contiguous slices supported")
        if stop <= start:
            return np.zeros((0,) + self.shape[1:], np.float32)
        return np.stack([self[t] for t in range(start, stop)])

    def __array__(self, dtype=None, copy=None):
        out = self[0:self.shape[0]]
        return out if dtype is None else out.astype(dtype)


class EpisodeFile:
    """Read access to an h5, npz or ``.epc`` episode by h5-style key
    (``'camera1/camera1'``, ``'ee_poses'``, ...).  An uncompressed npz
    member comes back as a read-only memory map (:func:`npz_member_map`),
    sliced like the array ``np.load`` reads.  A ``.epc`` cache is served by
    the mmap'd C++ cache: numeric records as copies, cameras and VLA chunks
    as lazy views that read on slice."""

    def __init__(self, path: str):
        self.path = path
        self.is_epc = path.endswith(".epc")
        self.is_h5 = not (path.endswith(".npz") or self.is_epc)
        self._f = None

    def __enter__(self):
        if self.is_epc:
            from vla_touch_tpu_torch.runtime.native_loader import EpisodeCache

            self._f = EpisodeCache(self.path)
        elif self.is_h5:
            import h5py

            self._f = h5py.File(self.path, "r")
        else:
            self._f = np.load(self.path, allow_pickle=False)
        return self

    def __exit__(self, *exc):
        if self._f is not None:
            self._f.close()
        self._f = None
        return False

    def _epc_keys(self) -> set:
        c = self._f
        keys = {"qpos", "gelsight_force/forces", "gelsight_force/displacement"}
        if c.has_raw_pose:
            keys |= {"ee_poses", "gripper_pos"}
        if c.lang_len:
            keys.add("instruct_embeddings")
        if c.has_vla:
            keys.add("vla_action")
        keys |= {f"camera{i + 1}/camera{i + 1}" for i in range(c.n_cams)}
        return keys

    def __contains__(self, key: str) -> bool:
        if self.is_epc:
            return key in self._epc_keys()
        if self.is_h5:
            return key in self._f
        return NPZ_ALIASES.get(key, key) in self._f.files

    def _get_epc(self, key: str):
        c = self._f
        if key not in self._epc_keys():
            raise KeyError(key)
        if key in ("ee_poses", "gripper_pos"):
            return c.read_raw_pose()[0 if key == "ee_poses" else 1]
        if key == "instruct_embeddings":
            return c.read_lang()[None]                 # the h5 shape (1, L, D)
        if key == "vla_action":
            return _EpcVla(c)
        if key.startswith("camera"):
            return _EpcFrames(c, int(key[len("camera")]) - 1)
        field = {"qpos": "qpos", "gelsight_force/forces": "forces",
                 "gelsight_force/displacement": "disps"}[key]
        return c.read_window(0, c.T)[field]

    def get(self, key: str):
        """The record at h5-style ``key`` ('camera1/camera1', 'ee_poses',
        ...); ``KeyError`` when the episode has none."""
        if self.is_epc:
            return self._get_epc(key)
        if self.is_h5:
            return self._f[key]
        name = NPZ_ALIASES.get(key, key)
        mapped = npz_member_map(self.path, self._f.zip, name)
        return self._f[name] if mapped is None else mapped

    __getitem__ = get


def qpos_from_episode(f) -> np.ndarray:
    """[ee_pos (3), ortho6d (6), raw gripper (1)] (T, 10), float64; the
    gripper stays on its raw 0..255 scale.  A ``.epc`` cache packed without
    raw poses (v1) has only its float32 qpos."""
    if "ee_poses" not in f and "qpos" in f:
        return np.asarray(f["qpos"], np.float64)
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


def write_synthetic_episode(path: str, num_steps: int = 80, img_size: int = 48,
                            chunk: int = 64, lang_len: int = 8,
                            lang_dim: int = 4096, seed: int = 0,
                            with_vla: bool = True,
                            resized_size: int = 384) -> None:
    """Write a schema-complete synthetic episode (a smooth random EEF
    trajectory, moving-blob cameras, correlated forces) as an npz (the
    flattened keys), the same arrays as the JAX package's h5 writer draws
    for the same seed; a machine without ``h5py`` makes data with it."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, num_steps)[:, None]
    # still for the first ~5 steps (motion onset)
    onset = 5
    ramp = np.clip((np.arange(num_steps) - onset) / (num_steps - onset), 0, 1)[:, None]
    pos = 0.4 + 0.2 * np.sin(2 * np.pi * t * rng.uniform(0.5, 1.5, 3)) * ramp
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = 0.5 * ramp[:, 0] * np.sin(2 * np.pi * t[:, 0])
    quat = np.stack([axis[0] * np.sin(ang / 2), axis[1] * np.sin(ang / 2),
                     axis[2] * np.sin(ang / 2), np.cos(ang / 2)], axis=-1)
    gripper = (128 + 120 * np.sin(np.pi * t[:, 0]) * ramp[:, 0]).astype(np.float64)

    def smooth_frames(phase: float) -> np.ndarray:
        """Gradient background + a moving gaussian blob."""
        yy, xx = np.mgrid[0:img_size, 0:img_size].astype(np.float32)
        out = np.zeros((num_steps, img_size, img_size, 3), np.uint8)
        for i in range(num_steps):
            cx = img_size * (0.3 + 0.4 * np.sin(2 * np.pi * (i / num_steps) + phase))
            cy = img_size * (0.3 + 0.4 * np.cos(2 * np.pi * (i / num_steps) + phase))
            blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (img_size * 0.8))
            frame = np.stack([
                60 + 120 * xx / img_size + 120 * blob,
                60 + 120 * yy / img_size + 60 * blob,
                90 + 100 * blob,
            ], axis=-1)
            out[i] = np.clip(frame, 0, 255).astype(np.uint8)
        return out

    arrays = {
        "ee_poses": np.concatenate([pos, quat], -1),
        "gripper_pos": gripper,
        "camera1/camera1": smooth_frames(0.0),
        "camera2/camera2": smooth_frames(1.5),
    }
    arrays["gelsight_force/forces"] = (
        0.5 * np.sin(2 * np.pi * t * np.array([1.0, 1.3, 0.7]))
        + 0.05 * rng.normal(size=(num_steps, 3)))
    arrays["gelsight_force/displacement"] = 0.1 * rng.normal(size=(num_steps, 2))
    arrays["instruct_embeddings"] = rng.normal(
        size=(1, lang_len, lang_dim)).astype(np.float32)
    if with_vla:
        qpos = qpos_from_episode(arrays)
        qpos_scaled = qpos / np.array([[1] * 9 + [GRIPPER_SCALE]])
        # "VLA" chunks: future expert states + noise, the gripper back on
        # its raw scale
        vla = np.zeros((num_steps, chunk, 10), np.float64)
        for i in range(num_steps):
            idx = np.minimum(np.arange(i, i + chunk), num_steps - 1)
            vla[i] = qpos_scaled[idx] + 0.01 * rng.normal(size=(chunk, 10))
        vla[:, :, -1] *= GRIPPER_SCALE
        arrays["vla_action"] = vla
        small = min(resized_size, 64)  # keep fixtures small
        for cam in ("camera1_resized", "camera2_resized"):
            arrays[cam] = rng.integers(0, 255, (num_steps, small, small, 3), np.uint8)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{NPZ_ALIASES.get(k, k): v for k, v in arrays.items()})


def make_synthetic_dataset(root: str, n_episodes: int = 3, **kw) -> list:
    """``n_episodes`` synthetic episodes ``episode_{i}.npz`` (seeds 0..n-1)
    under ``root``."""
    paths = []
    for i in range(n_episodes):
        p = os.path.join(root, f"episode_{i}.npz")
        write_synthetic_episode(p, seed=i, **kw)
        paths.append(p)
    return paths
