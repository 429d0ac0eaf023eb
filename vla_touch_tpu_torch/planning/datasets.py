"""Tactile frames for the planner: loading and CLIP preprocessing (the
port's numpy copy of ``clip_preprocess`` and ``load_video_frames`` from
``vla_touch_tpu/planning/datasets.py``).

The JAX package reads frames and resizes them with OpenCV.  The port reads
PNG and JPEG frames with Pillow and resizes in numpy: :func:`resize_cubic_u8`
is OpenCV's ``INTER_CUBIC`` for uint8 (Keys cubic a = -0.75, pixel centres
aligned, edges replicated, fixed-point weights of 2^11 and the rounding
shift of 2^22), which a test holds to ``cv2.resize`` within one level.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

_COEF_BITS = 11                      # OpenCV's INTER_RESIZE_COEF_BITS


def _cubic_taps(n_src: int, n_dst: int):
    """(indices (n_dst, 4), int weights (n_dst, 4)) of one axis."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    x = (f - s).astype(np.float32)
    A = np.float32(-0.75)
    one = np.float32(1.0)
    c0 = ((A * (x + one) - np.float32(5) * A) * (x + one) + np.float32(8) * A) * (x + one) \
        - np.float32(4) * A
    c1 = ((A + np.float32(2)) * x - (A + np.float32(3))) * x * x + one
    y = one - x
    c2 = ((A + np.float32(2)) * y - (A + np.float32(3))) * y * y + one
    c3 = one - c0 - c1 - c2
    coef = np.rint(np.stack([c0, c1, c2, c3], -1) * np.float32(1 << _COEF_BITS))
    idx = np.clip(s[:, None] + np.arange(-1, 3), 0, n_src - 1)
    return idx, coef.astype(np.int64)


def resize_cubic_u8(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 (H, W, C) -> (size, size, C), as ``cv2.resize(img, (size,
    size), interpolation=cv2.INTER_CUBIC)``; the same size is a copy."""
    H, W = img.shape[:2]
    if (H, W) == (size, size):
        return img.copy()
    xi, xc = _cubic_taps(W, size)
    yi, yc = _cubic_taps(H, size)
    src = img.astype(np.int64)
    rows = np.einsum("hwjc,wj->hwc", src[:, xi], xc)               # (H, size, C)
    out = np.einsum("hjwc,hj->hwc", rows[yi], yc)
    out = (out + (1 << (2 * _COEF_BITS - 1))) >> (2 * _COEF_BITS)
    return np.clip(out, 0, 255).astype(np.uint8)


def clip_preprocess(frames: np.ndarray, frame_size: int = 224) -> np.ndarray:
    """uint8 (L, H, W, 3) -> normalized float32 (L, S, S, 3)."""
    out = np.zeros((frames.shape[0], frame_size, frame_size, 3), np.float32)
    for i, f in enumerate(frames):
        img = resize_cubic_u8(np.asarray(f, np.uint8), frame_size)
        out[i] = (img.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
    return out


def _read_frame(path: str) -> np.ndarray:
    """A PNG or JPEG frame -> uint8 (H, W, 3) RGB, through Pillow."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def load_video_frames(tactile_dir: str, max_frames: Optional[int] = None) -> np.ndarray:
    """uint8 RGB frames (L, H, W, 3) of a tactile directory, in name order,
    ``max_frames`` evenly spaced (the training crop waits for training)."""
    names = sorted(os.listdir(tactile_dir))
    paths = [os.path.join(tactile_dir, n) for n in names
             if n.lower().endswith((".jpg", ".jpeg", ".png"))]
    if max_frames and len(paths) > max_frames:
        idx = np.linspace(0, len(paths) - 1, max_frames).astype(int)
        paths = [paths[i] for i in idx]
    return np.stack([_read_frame(p) for p in paths])
