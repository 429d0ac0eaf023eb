"""Raw capture -> episode files (counterpart of
``vla_touch_tpu/data/capture.py``).

1. :func:`label_instructions`: an instruction per episode directory (the
   interactive labeler is ``data/label_tool.py``);
2. :func:`precompute_instructions`: each episode's T5 embedding, from the
   embedder it is given (``models/encoders/t5_native.NativeT5Embedder``
   on the card, or ``t5.T5Embedder``);
3. :func:`process_gelsight`: marker tracking over the ``gelsight/``
   frames on the card (``ops/marker_tracking.py::estimate_force_sequence``)
   -> ``forces.npy`` / ``displacement.npy``;
4. :func:`convert_to_hdf5`: the episode directory (camera frames, npys,
   the instruction embedding) -> one ``episode_*.h5`` (lzf), or the port's
   npz layout where the out path ends in ``.npz`` (a machine without
   ``h5py``).

Episode directory layout::

    episode_dir/
      camera1/000000.jpg ...      camera2/000000.jpg ...
      gelsight/000000.jpg ...
      ee_poses.npy (T, 7)         gripper_pos.npy (T,)
      instruction.txt             [instruct_lang.npy after step 2]
      [gelsight_force/forces.npy + displacement.npy after step 3]
"""

from __future__ import annotations

import os
import re
from typing import Optional, Sequence

import numpy as np


def _sorted_frames(d: str, pattern: str = r".*\.(jpg|jpeg|png)$") -> list:
    rx = re.compile(pattern, re.IGNORECASE)
    names = [n for n in os.listdir(d) if rx.match(n)]

    def key(s):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]

    return [os.path.join(d, n) for n in sorted(names, key=key)]


def _load_frames(paths: Sequence[str]) -> np.ndarray:
    """(T, H, W, 3) uint8 RGB."""
    import cv2

    return np.stack([cv2.imread(p, cv2.IMREAD_COLOR)[:, :, ::-1] for p in paths])


def label_instructions(capture_root: str, labels: dict) -> None:
    """Write ``instruction.txt`` per episode directory from a name -> text
    map."""
    for name, text in labels.items():
        path = os.path.join(capture_root, name, "instruction.txt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text.strip() + "\n")


def precompute_instructions(capture_root: str, embedder) -> list:
    """Step 2: embed each episode's instruction with ``embedder`` (anything
    with ``get_text_embeddings``), saved as ``instruct_lang.npy``; returns
    the written paths."""
    from vla_touch_tpu_torch.models.encoders.t5 import LanguageEncoder

    return LanguageEncoder(embedder).encode_directory(capture_root)


def process_gelsight(episode_dir: str, tracker_cfg=None, device=None) -> dict:
    """Step 3: marker-track the ``gelsight/`` frames against the first
    (calibration) frame on ``device`` (default CUDA) in one batched pass;
    save forces (T, 3) and displacement (T, 2) float32."""
    import torch

    from vla_touch_tpu_torch.ops import marker_tracking as MT
    from vla_touch_tpu_torch.utils.device import resolve_device

    cfg = tracker_cfg or MT.TrackerConfig()
    dev = resolve_device(device)
    frames = torch.as_tensor(_load_frames(_sorted_frames(os.path.join(episode_dir,
                                                                      "gelsight"))),
                             device=dev)
    baseline = MT.calibrate(frames[0], cfg)
    out = MT.estimate_force_sequence(frames, baseline, cfg)
    forces = out["forces"].cpu().numpy().astype(np.float32)
    disps = out["displacements"].cpu().numpy().astype(np.float32)
    os.makedirs(os.path.join(episode_dir, "gelsight_force"), exist_ok=True)
    np.save(os.path.join(episode_dir, "gelsight_force", "forces.npy"), forces)
    np.save(os.path.join(episode_dir, "gelsight_force", "displacement.npy"), disps)
    return {"forces": forces, "displacements": disps}


def convert_to_hdf5(episode_dir: str, out_path: str) -> str:
    """Step 4: assemble the episode: an h5 file (lzf compression, the
    episode schema), or the port's npz layout (``data/episode.py``'s
    flattened keys, uncompressed) where ``out_path`` ends in ``.npz``."""
    from vla_touch_tpu_torch.data.episode import NPZ_ALIASES

    ee_poses = np.load(os.path.join(episode_dir, "ee_poses.npy"))
    gripper = np.load(os.path.join(episode_dir, "gripper_pos.npy"))
    cam1 = _load_frames(_sorted_frames(os.path.join(episode_dir, "camera1")))
    cam2 = _load_frames(_sorted_frames(os.path.join(episode_dir, "camera2")))
    instruct = np.load(os.path.join(episode_dir, "instruct_lang.npy"))
    forces = np.load(os.path.join(episode_dir, "gelsight_force", "forces.npy"))
    disps = np.load(os.path.join(episode_dir, "gelsight_force", "displacement.npy"))

    T = min(len(ee_poses), len(gripper), len(cam1), len(cam2), len(forces))
    arrays = {
        "ee_poses": ee_poses[:T], "gripper_pos": gripper[:T],
        "camera1/camera1": cam1[:T], "camera2/camera2": cam2[:T],
        "instruct_embeddings": instruct[None] if instruct.ndim == 2 else instruct,
        "gelsight_force/forces": forces[:T], "gelsight_force/displacement": disps[:T],
    }
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    if out_path.endswith(".npz"):
        np.savez(out_path, **{NPZ_ALIASES.get(k, k): v for k, v in arrays.items()})
        return out_path
    import h5py

    with h5py.File(out_path, "w") as f:
        for key, value in arrays.items():
            lzf = key.startswith("camera")
            f.create_dataset(key, data=value, compression="lzf" if lzf else None)
    return out_path


def add_npy_to_h5(h5_path: str, key: str, array: np.ndarray,
                  group: Optional[str] = None) -> None:
    """Attach or replace a dataset of an h5 file."""
    import h5py

    with h5py.File(h5_path, "a") as f:
        node = f.require_group(group) if group else f
        if key in node:
            del node[key]
        node.create_dataset(key, data=array)


def _episodes_in_range(capture_root: str, episode_range: tuple) -> list:
    """Episode directories named ``*_<num>`` with num in the inclusive
    range (the batch tools' matching rule)."""
    start, end = episode_range
    out = []
    for name in sorted(os.listdir(capture_root)):
        path = os.path.join(capture_root, name)
        if not os.path.isdir(path):
            continue
        parts = name.split("_")
        if len(parts) < 2 or not parts[1].isdigit():
            continue
        if start <= int(parts[1]) <= end:
            out.append(path)
    return out


def batch_rename_files(capture_root: str, episode_range: tuple, old_filename: str,
                       new_filename: str, subfolder: Optional[str] = None) -> dict:
    """Rename one file across a range of episodes; returns ``{"renamed":
    n, "not_found": m}``."""
    import shutil

    renamed, not_found = 0, 0
    for episode_path in _episodes_in_range(capture_root, episode_range):
        file_dir = os.path.join(episode_path, subfolder) if subfolder else episode_path
        old_path = os.path.join(file_dir, old_filename)
        if not os.path.exists(old_path):
            not_found += 1
            continue
        shutil.move(old_path, os.path.join(file_dir, new_filename))
        renamed += 1
    return {"renamed": renamed, "not_found": not_found}


def batch_create_instructions(capture_root: str, episode_range: tuple,
                              instruction: str) -> int:
    """Write the same ``instruction.txt`` to a range of episodes without
    reviewing them; returns the number written."""
    n = 0
    for episode_path in _episodes_in_range(capture_root, episode_range):
        with open(os.path.join(episode_path, "instruction.txt"), "w") as f:
            f.write(instruction.strip() + "\n")
        n += 1
    return n
