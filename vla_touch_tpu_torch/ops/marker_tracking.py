"""GelSight marker tracking on the device (counterpart of
``vla_touch_tpu/ops/marker_tracking.py``).

grayscale -> Gaussian blur -> adaptive threshold -> morphological open ->
grid-local weighted centroids -> displacement vs a calibration baseline ->
force [dx, dy, magnitude].  The separable filters are two banded-matrix
products (``SAME`` zero padding); the 3x3 min/max pools are
``max_pool2d`` (the pool's padding never wins a min or a max).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

# cv2.getGaussianKernel(k, 0) uses fixed binomial tables for k <= 7.
_CV2_SMALL_GAUSSIAN = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                 0.03125]),
}


def _gaussian_kernel1d(ksize: int, sigma: float | None) -> np.ndarray:
    if sigma is None and ksize in _CV2_SMALL_GAUSSIAN:
        return _CV2_SMALL_GAUSSIAN[ksize].astype(np.float32)
    if sigma is None:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = (ksize - 1) / 2
    x = np.arange(ksize) - r
    k = np.exp(-(x**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _band(n: int, kernel: tuple) -> np.ndarray:
    """(n, n) matrix M with (M @ v)[i] = sum_d k[d] v[i + d - r], zero
    outside [0, n): a SAME cross-correlation along one axis."""
    k = np.asarray(kernel, np.float32)
    r = (len(k) - 1) // 2
    m = np.zeros((n, n), np.float32)
    for d, kd in enumerate(k):
        off = d - r
        i = np.arange(max(0, -off), min(n, n - off))
        m[i, i + off] = kd
    return m


def _sep_filter(img: torch.Tensor, k1d: np.ndarray) -> torch.Tensor:
    """Separable 2-D filter on (H, W) float32, SAME zero padding."""
    H, W = img.shape
    key = tuple(float(v) for v in k1d)
    mh = torch.as_tensor(_band(H, key), device=img.device)
    mw = torch.as_tensor(_band(W, key), device=img.device)
    return mh @ img @ mw.T


def gaussian_blur(img, ksize: int = 5, sigma: float | None = None):
    """cv2.GaussianBlur semantics with cv2's default kernels."""
    return _sep_filter(img, _gaussian_kernel1d(ksize, sigma))


def adaptive_threshold_inv(img, block: int = 11, c: float = 2.0):
    """ADAPTIVE_THRESH_GAUSSIAN_C + THRESH_BINARY_INV:
    mask = img < gaussian_local_mean(img) - c."""
    local_mean = _sep_filter(img, _gaussian_kernel1d(block, None))
    return (img < local_mean - c).float()


def morph_open(mask, k: int = 3):
    """Erosion then dilation with a k x k ones kernel."""
    m = mask[None, None]
    eroded = -F.max_pool2d(-m, k, stride=1, padding=k // 2)
    return F.max_pool2d(eroded, k, stride=1, padding=k // 2)[0, 0]


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    grid_rows: int = 7                 # expected marker grid (7x9 = 63)
    grid_cols: int = 9
    min_cell_mass: float = 4.0         # px of marker mass for a valid cell
    blur_ksize: int = 5
    thresh_block: int = 11
    thresh_c: float = 2.0
    filter_coords: tuple = ()          # dead-marker (x, y) coordinates
    filter_threshold: float = 5.0


def marker_mask(frame, cfg: TrackerConfig):
    """RGB/gray frame (H, W[, 3]) -> binary marker mask (H, W)."""
    x = frame.float()
    if x.dim() == 3:
        x = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    x = gaussian_blur(x, cfg.blur_ksize)
    return morph_open(adaptive_threshold_inv(x, cfg.thresh_block, cfg.thresh_c))


def grid_centroids(mask, cfg: TrackerConfig):
    """Per-cell weighted centroids: (R*C, 2) (x, y) pixel coordinates,
    (R*C,) masses and (R*C,) validity."""
    H, W = mask.shape
    R, C = cfg.grid_rows, cfg.grid_cols
    ch, cw = H // R, W // C
    dev = mask.device
    m = mask[: R * ch, : C * cw].reshape(R, ch, C, cw).permute(0, 2, 1, 3)
    ys = torch.arange(ch, dtype=torch.float32, device=dev)[None, None, :, None]
    xs = torch.arange(cw, dtype=torch.float32, device=dev)[None, None, None, :]
    mass = m.sum(dim=(2, 3))
    safe = torch.clamp(mass, min=1e-6)
    cy = (m * ys).sum(dim=(2, 3)) / safe
    cx = (m * xs).sum(dim=(2, 3)) / safe
    oy = (torch.arange(R, dtype=torch.float32, device=dev) * ch)[:, None]
    ox = (torch.arange(C, dtype=torch.float32, device=dev) * cw)[None, :]
    cents = torch.stack([cx + ox, cy + oy], dim=-1).reshape(R * C, 2)
    mass = mass.reshape(R * C)
    valid = mass >= cfg.min_cell_mass
    if cfg.filter_coords:
        fc = torch.tensor(cfg.filter_coords, dtype=torch.float32,
                          device=dev).reshape(-1, 2)
        d = torch.linalg.norm(cents[:, None, :] - fc[None, :, :], dim=-1)
        valid = valid & torch.all(d >= cfg.filter_threshold, dim=1)
    return cents, mass, valid


@torch.inference_mode()
def calibrate(frame, cfg: TrackerConfig = TrackerConfig()):
    """Baseline marker state from the first (unloaded) frame."""
    cents, _, valid = grid_centroids(marker_mask(frame, cfg), cfg)
    return {"centroids": cents, "valid": valid}


@torch.inference_mode()
def estimate_force(frame, baseline: dict, cfg: TrackerConfig = TrackerConfig()):
    """Force from one frame vs the calibration baseline: ``displacement``
    (N, 2), ``valid`` (N,), ``mean_disp`` (2,), ``magnitude`` (),
    ``direction`` (2,) and ``force`` = [dx, dy, magnitude]."""
    cents, _, valid = grid_centroids(marker_mask(frame, cfg), cfg)
    both = valid & baseline["valid"]
    disp = torch.where(both[:, None], cents - baseline["centroids"],
                       torch.zeros_like(cents))
    n = torch.clamp(both.sum(), min=1)
    mean_disp = disp.sum(dim=0) / n
    mag = torch.linalg.norm(mean_disp)
    direction = torch.where(mag > 0, mean_disp / torch.clamp(mag, min=1e-12),
                            torch.zeros_like(mean_disp))
    return {"displacement": disp, "valid": both, "mean_disp": mean_disp,
            "magnitude": mag, "direction": direction,
            "force": torch.cat([mean_disp, mag[None]])}
