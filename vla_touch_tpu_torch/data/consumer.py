"""VLA consumer dataset: the training-time conditioning pipeline and
collator (counterpart of ``vla_touch_tpu/data/consumer.py``: the same
numpy draws, so the same seed gives the same batches).

Wraps the episode sampler and applies, per sample,

- condition masking with prob ``cond_mask_prob``: ctrl_freq -> 0, states ->
  the dataset's state mean, state_elem_mask -> zeros, per-camera image ->
  background, the (precomputed) language embedding kept;
- state noise at a given SNR in dB scaled by the episode state-std;
- image augmentation on 50% of valid frames: color jitter and/or
  noise + blur corruption (cv2 is imported by the blur only);
- pad-to-square with the SigLIP background;
- retries on sample errors.

The collator stacks samples and pads the variable-length precomputed T5
embeddings, emitting the batch ``rdt_compute_loss`` consumes.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import numpy as np

from vla_touch_tpu_torch.config import DataConfig
from vla_touch_tpu_torch.data.vla_dataset import UnifiedVLADataset
from vla_touch_tpu_torch.utils.image import pad_and_resize_for_siglip

_SIGLIP_MEAN = 0.5
_BG_VALUE = int(0.5 * 255)


_NOISE_SCALE_MAX = 0.05 * 255        # imgaug scale/lam upper bound (12.75)


def _additive_noise(img: np.ndarray, rng: np.random.Generator,
                    kind: str) -> np.ndarray:
    """One imgaug Additive*Noise op: scale/lam ~ U(0, 12.75) per image,
    per_channel with prob 0.5 (otherwise one plane broadcast over RGB),
    result clipped to uint8 per op (imgaug clips after every augmenter)."""
    scale = rng.uniform(0.0, _NOISE_SCALE_MAX)
    shape = img.shape if rng.random() < 0.5 else img.shape[:2] + (1,)
    if kind == "gaussian":
        noise = rng.normal(0.0, max(scale, 1e-12), shape)
    elif kind == "laplace":
        noise = rng.laplace(0.0, max(scale, 1e-12), shape)
    else:  # poisson: ADDITIVE Poisson(lam) samples — brightens by ~lam
        noise = rng.poisson(scale, shape).astype(np.float32)
    out = img.astype(np.float32) + noise
    # round, don't truncate: a float->uint8 cast floors, biasing the noise
    # mean by -0.5 (imgaug rounds)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def _blur(img: np.ndarray, rng: np.random.Generator, kind: str) -> np.ndarray:
    """One imgaug blur op with the reference's parameter ranges."""
    import cv2

    if kind == "gaussian":
        sigma = rng.uniform(0.0, 3.0)
        if sigma < 1e-3:
            return img
        return cv2.GaussianBlur(img, (0, 0), sigma)
    if kind == "average":
        k = int(rng.integers(2, 8))
        return cv2.blur(img, (k, k))
    if kind == "median":
        k = int(rng.choice([3, 5, 7, 9, 11]))
        return cv2.medianBlur(img, k)
    # motion: k in {3..36}, random angle; line kernel through the center
    k = int(rng.integers(3, 37))
    angle = rng.uniform(0.0, 360.0)
    kernel = np.zeros((k, k), np.float32)
    c = (k - 1) / 2.0
    dx, dy = np.cos(np.deg2rad(angle)), np.sin(np.deg2rad(angle))
    for t in np.linspace(-c, c, 2 * k):
        x, y = int(round(c + t * dx)), int(round(c + t * dy))
        if 0 <= x < k and 0 <= y < k:
            kernel[y, x] = 1.0
    kernel /= kernel.sum()
    return cv2.filter2D(img, -1, kernel)


def image_corrupt(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """The reference's imgaug op inventory::

        Sequential(random_order=True)[
          OneOf[AdditiveGaussianNoise(scale=U(0, .05*255), per_channel=.5),
                AdditiveLaplaceNoise(scale=same, per_channel=.5),
                AdditivePoissonNoise(lam=same, per_channel=.5)],
          SomeOf((0, 1))[OneOf[GaussianBlur(sigma=U(0, 3)),
                               AverageBlur(k=U{2..7}),
                               MedianBlur(k=odd{3..11})],
                         MotionBlur(k=U{3..36})]]

    numpy/cv2 implementation (imgaug is not vendored): one noise op always
    runs; a blur stage runs with prob 1/2 and is then the classic-blur
    OneOf or motion blur with equal odds; the two stages execute in random
    order."""
    def noise_stage(x):
        kind = ("gaussian", "laplace", "poisson")[int(rng.integers(0, 3))]
        return _additive_noise(x, rng, kind)

    def blur_stage(x):
        if rng.integers(0, 2) == 0:          # SomeOf((0,1)): none
            return x
        if rng.integers(0, 2) == 0:          # OneOf classic blurs
            kind = ("gaussian", "average", "median")[int(rng.integers(0, 3))]
        else:
            kind = "motion"
        return _blur(x, rng, kind)

    stages = [noise_stage, blur_stage]
    if rng.random() < 0.5:                   # random_order=True
        stages.reverse()
    out = img
    for stage in stages:
        out = stage(out)
    return out


def color_jitter(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Brightness/contrast/saturation jitter (≙ torchvision ColorJitter
    (0.3, 0.4, 0.5, 0.03))."""
    out = img.astype(np.float32)
    out = out * rng.uniform(0.7, 1.3)                       # brightness
    mean = out.mean()
    out = (out - mean) * rng.uniform(0.6, 1.4) + mean       # contrast
    gray = out.mean(axis=-1, keepdims=True)
    out = gray + (out - gray) * rng.uniform(0.5, 1.5)       # saturation
    return np.clip(out, 0, 255).astype(np.uint8)


class VLAConsumerDataset:
    """Multi-dataset consumer: one :class:`UnifiedVLADataset` per name in
    ``cfg.dataset_names``, sampled by ``dataset_weights``."""

    def __init__(self, cfg: DataConfig, dataset: Optional[UnifiedVLADataset] = None,
                 dataset_stats: Optional[dict] = None, seed: int = 0,
                 file_paths=None, dataset_weights: Optional[Sequence[float]] = None):
        self.cfg = cfg
        if dataset is not None:
            self.datasets = [dataset]
        elif file_paths is not None:
            self.datasets = [UnifiedVLADataset(cfg, file_paths=file_paths,
                                               seed=seed)]
        else:
            self.datasets = [
                UnifiedVLADataset(cfg, dataset_name=name, seed=seed + i)
                for i, name in enumerate(cfg.dataset_names)
            ]
        w = np.asarray(dataset_weights if dataset_weights is not None
                       else [1.0] * len(self.datasets), np.float64)
        self.dataset_weights = w / w.sum()
        self.rng = np.random.default_rng(seed)
        # Per-dataset state stats for the masking path: prefer the
        # precomputed dataset_stat.json, fall back to an in-place scan of
        # the episodes.
        if dataset_stats is None:
            import json as _json
            import os as _os

            stat_path = _os.path.join(cfg.data_root, "dataset_stat.json")
            if _os.path.exists(stat_path):
                raw = _json.load(open(stat_path))
                dataset_stats = {
                    name: {"state_mean": np.asarray(v["state_mean"],
                                                    np.float32),
                           "state_std": np.asarray(v["state_std"],
                                                   np.float32)}
                    for name, v in raw.items()
                }
            else:
                dataset_stats = {}
        elif "state_mean" in dataset_stats:  # single-dataset legacy shape
            dataset_stats = {ds.dataset_name: dataset_stats
                             for ds in self.datasets}
        # Scan any active dataset the stat file doesn't cover (stale/partial
        # dataset_stat.json must not turn into a KeyError at sample time).
        for ds in self.datasets:
            if ds.dataset_name in dataset_stats:
                continue
            states = [ds.get_item(i, state_only=True)["state"]
                      for i in range(len(ds))]
            all_states = np.concatenate(states, axis=0)
            dataset_stats[ds.dataset_name] = {
                "state_mean": all_states.mean(0),
                "state_std": all_states.std(0),
            }
        self.dataset_stats = dataset_stats

    @property
    def dataset(self) -> UnifiedVLADataset:
        return self.datasets[0]

    def fork(self, key: Sequence[int]) -> "VLAConsumerDataset":
        """A copy that shares the episodes and statistics and draws from
        generators seeded by ``key`` (its own, and ``key + (i,)`` for its
        i-th dataset), so that samples drawn on threads, each from its own
        fork, are a function of the keys."""
        out = copy.copy(self)
        out.rng = np.random.default_rng(tuple(key))
        out.datasets = []
        for i, ds in enumerate(self.datasets):
            ds = copy.copy(ds)
            ds.rng = np.random.default_rng(tuple(key) + (i,))
            out.datasets.append(ds)
        return out

    def _background(self) -> np.ndarray:
        s = self.cfg.image_size
        return np.full((s, s, 3), _BG_VALUE, np.uint8)

    def sample(self) -> dict:
        cfg = self.cfg
        rng = self.rng
        ds = self.datasets[int(rng.choice(len(self.datasets),
                                          p=self.dataset_weights))]
        for attempt in range(1000):
            try:
                res = ds.get_item()
                break
            except RuntimeError:
                # get_item's own bounded retry already concluded the data is
                # systematically invalid — don't multiply the retry budgets.
                raise
            except Exception as e:
                if attempt % 50 == 0:
                    import logging

                    logging.getLogger("consumer").warning(
                        "sample retry %d on %s: %r", attempt,
                        ds.dataset_name, e)
        else:
            raise RuntimeError(
                f"dataset '{ds.dataset_name}' failed 1000 consecutive "
                "sample attempts — data is systematically invalid")

        p = cfg.cond_mask_prob
        out = {
            "dataset_name": res["meta"]["dataset_name"],
            "ctrl_freq": (cfg.control_freq if rng.random() > p else 0.0),
        }

        states = res["state"].copy()
        if cfg.state_noise_snr is not None:
            snr_scale = res["state_std"] / np.sqrt(
                10 ** (cfg.state_noise_snr / 10))
            states = states + rng.normal(0.0, snr_scale, states.shape)
        ds_stats = self.dataset_stats[res["meta"]["dataset_name"]]
        mean = np.tile(np.asarray(ds_stats["state_mean"])[None],
                       (states.shape[0], 1))
        out["states"] = states if rng.random() > p else mean
        out["actions"] = res["actions"]
        out["state_elem_mask"] = (res["state_indicator"]
                                  if rng.random() > p
                                  else np.zeros_like(res["state_indicator"]))
        out["state_norm"] = res["state_norm"]

        # Image window: (history x cameras) frames in
        # [ext_{t-1}, right_{t-1}, left_{t-1}, ext_t, ...] order.
        metas = [(res["cam_high"], res["cam_high_mask"]),
                 (res["cam_right_wrist"], res["cam_right_wrist_mask"]),
                 (res["cam_left_wrist"], res["cam_left_wrist_mask"])]
        # Per-camera mask probability; the exterior camera (index 0) can be
        # masked more/less aggressively.
        cam_probs = [p] * len(metas)
        if cfg.cam_ext_mask_prob >= 0.0:
            cam_probs[0] = cfg.cam_ext_mask_prob
        frames, masks = [], []
        for i in range(cfg.img_history_size):
            for j, (imgs, valid) in enumerate(metas):
                ok = (bool(valid[i]) and np.prod(imgs[i].shape) > 0
                      and rng.random() > cam_probs[j])
                if not ok:
                    frames.append(self._background())
                    masks.append(False)
                    continue
                img = imgs[i].astype(np.uint8)
                if cfg.image_aug and rng.random() > 0.5:
                    aug = rng.choice(["corrupt_only", "color_only", "both"])
                    if aug != "corrupt_only":
                        img = color_jitter(img, rng)
                    if aug != "color_only":
                        img = image_corrupt(img, rng)
                if img.shape[:2] != (cfg.image_size, cfg.image_size):
                    img = pad_and_resize_for_siglip(img, cfg.image_size)
                frames.append(img)
                masks.append(True)
        out["images"] = np.stack(frames)          # (H*C, S, S, 3) uint8
        out["image_mask"] = np.asarray(masks)
        out["lang_embed"] = res["meta"]["instruction_embedding"]
        return out


def collate(samples: list, max_lang_len: Optional[int] = None) -> dict:
    """Stack samples; pad variable-length language embeddings and build the
    attention mask.

    Emits the batch consumed by ``rdt_compute_loss`` (images stay uint8 for
    cheap host->device transfer; normalization happens on device).
    """
    L = max_lang_len or max(s["lang_embed"].shape[0] for s in samples)
    lang = np.zeros((len(samples), L, samples[0]["lang_embed"].shape[-1]),
                    np.float32)
    lang_mask = np.zeros((len(samples), L), bool)
    for i, s in enumerate(samples):
        n = min(s["lang_embed"].shape[0], L)
        lang[i, :n] = s["lang_embed"][:n]
        lang_mask[i, :n] = True
    return {
        "lang_tokens": lang,
        "lang_mask": lang_mask,
        "images": np.stack([s["images"] for s in samples]),
        "image_mask": np.stack([s["image_mask"] for s in samples]),
        "state_tokens": np.stack([s["states"] for s in samples]).astype(np.float32),
        "action_gt": np.stack([s["actions"] for s in samples]).astype(np.float32),
        "action_mask": np.stack(
            [s["state_elem_mask"][None] for s in samples]).astype(np.float32),
        "ctrl_freqs": np.asarray([s["ctrl_freq"] for s in samples], np.float32),
        "state_norm": np.stack([s["state_norm"] for s in samples]).astype(np.float32),
        "dataset_names": [s["dataset_name"] for s in samples],
    }
