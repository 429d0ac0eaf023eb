"""Controller-dataset generation: the offline VLA distillation pass
(counterpart of ``vla_touch_tpu/data/distill.py``).

For every timestep of every episode, run the finetuned RDT policy on the
2-frame observation window and write the predicted action chunk as
``vla_action`` (T, chunk, 10) beside the 384^2 ``camera1_resized`` /
``camera2_resized`` frames the controllers train against.  The frames go
through a JPEG round trip first (OpenCV, quality 90), so controller training
sees the deployment loop's compression artifacts.

An h5 episode becomes an h5 copy with the new keys (``h5py``); an npz
episode an npz with them (a machine without ``h5py``).
"""

from __future__ import annotations

import os
import shutil
from typing import Callable

import numpy as np

from vla_touch_tpu_torch.data.episode import (EpisodeFile, list_episode_files,
                                              qpos_from_episode)
from vla_touch_tpu_torch.utils.image import pad_and_resize_for_siglip


def _jpeg_roundtrip(img: np.ndarray, quality: int = 90) -> np.ndarray:
    import cv2

    ok, enc = cv2.imencode(".jpg", img[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])
    if not ok:
        raise RuntimeError("JPEG encode failed")
    return cv2.imdecode(enc, cv2.IMREAD_COLOR)[:, :, ::-1]


def _distill(f, policy_step: Callable, instruction_key: str, image_size: int) -> dict:
    """The new keys of one episode: ``policy_step`` at every timestep."""
    qpos = qpos_from_episode(f)
    T = qpos.shape[0]
    cam1 = np.asarray(f["camera1/camera1"])
    cam2 = np.asarray(f["camera2/camera2"])
    text = np.array(np.asarray(f[instruction_key])[0])     # a writable copy of a memory map
    chunks = []
    resized1 = np.zeros((T, image_size, image_size, 3), np.uint8)
    resized2 = np.zeros((T, image_size, image_size, 3), np.uint8)
    for t in range(T):
        t_prev = max(t - 1, 0)
        frames = [_jpeg_roundtrip(cam1[t_prev]), _jpeg_roundtrip(cam2[t_prev]), None,
                  _jpeg_roundtrip(cam1[t]), _jpeg_roundtrip(cam2[t]), None]
        chunks.append(np.asarray(policy_step(qpos[t], frames, text))[0])
        resized1[t] = pad_and_resize_for_siglip(frames[3], image_size)
        resized2[t] = pad_and_resize_for_siglip(frames[4], image_size)
    return {"vla_action": np.stack(chunks).astype(np.float32),
            "camera1_resized": resized1, "camera2_resized": resized2}


def record_vla_actions_for_episode(h5_in: str, h5_out: str, policy_step: Callable,
                                   instruction_key: str = "instruct_embeddings",
                                   image_size: int = 384, batch_hint: int = 1) -> str:
    """Augment one episode (h5 or npz; the output in the input's format).
    ``batch_hint`` is accepted and unused, as in the JAX package.

    ``policy_step(proprio (10,), images [6 x HxWx3 or None], text_embeds
    (L, D)) -> (1, chunk, 10)``: the deployment policy wrapper's ``step``
    (``runtime/policy.py::RoboticDiffusionTransformerModel.step``)."""
    if h5_in.endswith(".npz"):
        with EpisodeFile(h5_in) as f:
            new = _distill(f, policy_step, instruction_key, image_size)
        with np.load(h5_in, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files if k not in new}
        os.makedirs(os.path.dirname(h5_out) or ".", exist_ok=True)
        np.savez(h5_out, **arrays, **new)
        return h5_out
    import h5py

    shutil.copy(h5_in, h5_out)
    with h5py.File(h5_out, "a") as f:
        new = _distill(f, policy_step, instruction_key, image_size)
        for key, value in new.items():
            if key in f:
                del f[key]
            f.create_dataset(key, data=value,
                             compression=None if key == "vla_action" else "lzf")
    return h5_out


def record_vla_actions_for_dataset(in_dir: str, out_dir: str, policy_step: Callable,
                                   image_size: int = 384) -> list:
    """Augment every h5 or npz episode under ``in_dir`` into ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    return [record_vla_actions_for_episode(path, os.path.join(out_dir, os.path.basename(path)),
                                           policy_step, image_size=image_size)
            for path in list_episode_files(in_dir, pattern=(".h5", ".npz"))]
