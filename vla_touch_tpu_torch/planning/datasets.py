"""Tactile datasets of the planner (counterpart of
``vla_touch_tpu/planning/datasets.py``): frame loading with one shared
random crop across a video, CLIP preprocessing, the property-regression
dataset (sample directories of ``tactile/`` frames and a ``data.json`` with
the split and the hardness/roughness ratings; batches pad each video to the
longest by repeating its first frame) and the tactile-LLM QA dataset (rows
of QA files with ``<tact>`` placeholders, optional RAG context).

Every random draw goes through the dataset's ``np.random.default_rng(seed)``
in the JAX package's order, so both packages give the same batches.

The JAX package reads frames and resizes them with OpenCV.  The port reads
PNG and JPEG frames with Pillow and resizes in numpy: :func:`resize_cubic_u8`
is OpenCV's ``INTER_CUBIC`` for uint8 (Keys cubic a = -0.75, pixel centres
aligned, edges replicated, fixed-point weights of 2^11 and the rounding
shift of 2^22), which a test holds to ``cv2.resize`` within one level.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

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


def load_video_frames(tactile_dir: str, max_frames: Optional[int] = None,
                      rng: Optional[np.random.Generator] = None,
                      crop_size: Optional[int] = None) -> np.ndarray:
    """uint8 RGB frames (L, H, W, 3) of a tactile directory, in name order,
    ``max_frames`` evenly spaced; with ``rng`` and ``crop_size`` (training)
    one random ``crop_size`` square shared by every frame (y drawn, then
    x), where the frames are larger than it."""
    names = sorted(os.listdir(tactile_dir))
    paths = [os.path.join(tactile_dir, n) for n in names
             if n.lower().endswith((".jpg", ".jpeg", ".png"))]
    if max_frames and len(paths) > max_frames:
        idx = np.linspace(0, len(paths) - 1, max_frames).astype(int)
        paths = [paths[i] for i in idx]
    frames = np.stack([_read_frame(p) for p in paths])
    if crop_size is not None and rng is not None:
        H, W = frames.shape[1:3]
        if H > crop_size and W > crop_size:
            y = int(rng.integers(0, H - crop_size))
            x = int(rng.integers(0, W - crop_size))
            frames = frames[:, y:y + crop_size, x:x + crop_size]
    return frames


class TactilePropertyRegressionDataset:
    """Samples ``data_path/<dataset>_<...>/`` of the split ``split_name``
    whose name starts with one of ``datasets`` and whose ``data.json`` has
    properties: (frames, [hardness, roughness])."""

    def __init__(self, data_path: str, split_name: str, datasets: Sequence[str],
                 frame_size: int = 224, max_frames: int = 8, flip_p: float = 0.0,
                 seed: int = 0):
        self.data_path = data_path
        self.split_name = split_name
        self.frame_size = frame_size
        self.max_frames = max_frames
        self.flip_p = flip_p
        self.rng = np.random.default_rng(seed)
        self.samples: list = []
        for name in sorted(os.listdir(data_path)):
            sample_dir = os.path.join(data_path, name)
            meta_path = os.path.join(sample_dir, "data.json")
            tact_dir = os.path.join(sample_dir, "tactile")
            if not os.path.exists(meta_path) or not os.path.isdir(tact_dir):
                continue
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("split") != split_name or name.split("_")[0] not in datasets:
                continue
            if "properties" not in meta:
                continue
            self.samples.append({
                "tactile": tact_dir,
                "dataset": name.split("_")[0],
                "properties": np.array([meta["properties"]["hardness"],
                                        meta["properties"]["roughness"]], np.float32),
            })

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int) -> dict:
        s = self.samples[i]
        frames = load_video_frames(s["tactile"], self.max_frames, self.rng)
        frames = clip_preprocess(frames, self.frame_size)
        if self.split_name == "train":
            # both draws are made whatever flip_p is
            if self.rng.random() < self.flip_p:
                frames = frames[:, :, ::-1]
            if self.rng.random() < self.flip_p:
                frames = frames[:, ::-1]
        return {"frames": frames, "properties": s["properties"],
                "dataset": s["dataset"], "path": s["tactile"]}

    def batches(self, batch_size: int, shuffle: bool = True):
        """Batches of ``batch_size`` samples (an order shuffled per call when
        ``shuffle``); a shorter video is padded in front with copies of its
        first frame."""
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order), batch_size):
            items = [self[int(j)] for j in order[i:i + batch_size]]
            L = max(it["frames"].shape[0] for it in items)
            frames = np.stack([
                np.concatenate([np.repeat(it["frames"][:1], L - len(it["frames"]), axis=0),
                                it["frames"]], axis=0)
                if len(it["frames"]) < L else it["frames"] for it in items])
            yield {"frames": frames,
                   "properties": np.stack([it["properties"] for it in items]),
                   "datasets": [it["dataset"] for it in items],
                   "paths": [it["path"] for it in items]}


class TactileLLMDataset:
    """QA rows of ``qa_files`` in split ``split_name`` (a row without a
    split is a training row): a question with ``<tact>`` placeholders, the
    tactile video dirs and the answer; with ``rag_bank`` a row's
    ``rag_query`` prefixes its question with the nearest known objects."""

    def __init__(self, qa_files: Sequence[str], split_name: str = "train",
                 rag_bank: Optional[dict] = None, retrieval_num: int = 1):
        self.samples: list = []
        self.rag_bank = rag_bank
        self.retrieval_num = retrieval_num
        for path in qa_files:
            with open(path) as f:
                rows = json.load(f)
            self.samples += [row for row in rows if row.get("split", "train") == split_name]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int) -> dict:
        row = dict(self.samples[i])
        if self.rag_bank is not None and "rag_query" in row:
            from vla_touch_tpu_torch.planning.encoder import rag_lookup

            hits = rag_lookup(self.rag_bank, np.asarray(row["rag_query"], np.float32),
                              top_k=self.retrieval_num)
            context = "; ".join(f"{label} (sim {sim:.2f})" for label, sim in hits)
            row["question"] = f"Similar known objects: {context}.\n" + row["question"]
        return row
