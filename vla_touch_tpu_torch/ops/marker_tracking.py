"""GelSight marker tracking on the device (counterpart of
``vla_touch_tpu/ops/marker_tracking.py``).

grayscale -> Gaussian blur -> adaptive threshold (or, for HSR-lighting
sensors, invert -> histogram equalization -> blur -> fixed threshold) ->
morphological open -> grid-local weighted centroids -> displacement vs a
calibration baseline -> force [dx, dy, magnitude].  The separable filters
are two banded-matrix products (``SAME`` zero padding); the 3x3 min/max
pools are ``max_pool2d`` (the pool's padding never wins a min or a max).

Every stage takes frames with leading batch dimensions, so
:func:`estimate_force_sequence` runs a whole (T, H, W[, 3]) episode as one
pass (the frames folded into the products' rows, one histogram ``bincount``
over ``frame * 256 + bin``) and :func:`estimate_force` is its T = 1 case.
The sums whose order could depend on the batch are exact: centroid sums
add integers, and the cells' displacements are summed in float64, where
their sum is exact, then rounded once to float32.
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
    """Separable 2-D filter on (..., H, W) float32, SAME zero padding."""
    H, W = img.shape[-2:]
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
    """Erosion then dilation with a k x k ones kernel, on (..., H, W)."""
    m = mask.reshape((-1, 1) + mask.shape[-2:])
    eroded = -F.max_pool2d(-m, k, stride=1, padding=k // 2)
    return F.max_pool2d(eroded, k, stride=1, padding=k // 2).reshape(mask.shape)


def equalize_hist(img):
    """cv2.equalizeHist on uint8-valued (..., H, W) frames (floats in [0,
    255] accepted; values are rounded to bins), each frame on its own
    histogram: ``lut[i] = round((cdf[i] - cdf_min) / max(total - cdf_min,
    1) * 255)`` in float32, rounded half to even and clipped, with cdf_min
    the first nonzero cdf value."""
    H, W = img.shape[-2:]
    xi = torch.clamp(torch.round(img.float()), 0, 255).to(torch.int64).reshape(-1, H * W)
    n = xi.shape[0]
    frame = torch.arange(n, device=img.device)[:, None] * 256
    hist = torch.bincount((frame + xi).reshape(-1), minlength=n * 256).reshape(n, 256)
    cdf = torch.cumsum(hist, dim=1)
    big = torch.iinfo(torch.int64).max
    cdf_min = torch.where(hist > 0, cdf, big).min(dim=1, keepdim=True).values
    denom = torch.clamp(H * W - cdf_min, min=1)
    lut = torch.round((cdf - cdf_min).float() / denom.float() * 255.0)
    lut = torch.clamp(lut, 0, 255)
    return torch.gather(lut, 1, xi).reshape(img.shape)


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    grid_rows: int = 7                 # expected marker grid (7x9 = 63)
    grid_cols: int = 9
    min_cell_mass: float = 4.0         # px of marker mass for a valid cell
    blur_ksize: int = 5
    thresh_block: int = 11
    thresh_c: float = 2.0
    # 'standard': adaptive threshold; 'hsr': HSR lighting (invert ->
    # equalizeHist -> blur -> fixed threshold hsr_threshold)
    gelsight_version: str = "standard"
    hsr_threshold: float = 50.0
    filter_coords: tuple = ()          # dead-marker (x, y) coordinates
    filter_threshold: float = 5.0


def _gray(frame, rgb: bool):
    x = frame.float()
    if rgb:
        x = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    return x


def _mask(x, cfg: TrackerConfig):
    """Grayscale (..., H, W) -> binary marker masks."""
    if cfg.gelsight_version == "hsr":
        # markers dark on a light field: after the inversion and the
        # equalization they are bright, so a fixed threshold finds them
        x = gaussian_blur(equalize_hist(255.0 - x), cfg.blur_ksize)
        return morph_open((x > cfg.hsr_threshold).float())
    x = gaussian_blur(x, cfg.blur_ksize)
    return morph_open(adaptive_threshold_inv(x, cfg.thresh_block, cfg.thresh_c))


def marker_mask(frame, cfg: TrackerConfig):
    """RGB/gray frame (H, W[, 3]) -> binary marker mask (H, W)."""
    return _mask(_gray(frame, frame.dim() == 3), cfg)


def _norm2(v):
    """Euclidean norm over a last axis of 2, as two products and a sum."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def grid_centroids(mask, cfg: TrackerConfig):
    """Per-cell weighted centroids of (..., H, W) masks: (..., R*C, 2) (x, y)
    pixel coordinates, (..., R*C) masses and (..., R*C) validity."""
    H, W = mask.shape[-2:]
    lead = mask.shape[:-2]
    R, C = cfg.grid_rows, cfg.grid_cols
    ch, cw = H // R, W // C
    dev = mask.device
    m = mask[..., : R * ch, : C * cw].reshape(lead + (R, ch, C, cw)).transpose(-3, -2)
    ys = torch.arange(ch, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(cw, dtype=torch.float32, device=dev)[None, :]
    mass = m.sum(dim=(-2, -1))                          # (..., R, C), integers
    safe = torch.clamp(mass, min=1e-6)
    cy = (m * ys).sum(dim=(-2, -1)) / safe
    cx = (m * xs).sum(dim=(-2, -1)) / safe
    oy = (torch.arange(R, dtype=torch.float32, device=dev) * ch)[:, None]
    ox = (torch.arange(C, dtype=torch.float32, device=dev) * cw)[None, :]
    cents = torch.stack([cx + ox, cy + oy], dim=-1).reshape(lead + (R * C, 2))
    mass = mass.reshape(lead + (R * C,))
    valid = mass >= cfg.min_cell_mass
    if cfg.filter_coords:
        fc = torch.tensor(cfg.filter_coords, dtype=torch.float32,
                          device=dev).reshape(-1, 2)
        d = _norm2(cents[..., :, None, :] - fc)
        valid = valid & torch.all(d >= cfg.filter_threshold, dim=-1)
    return cents, mass, valid


@torch.inference_mode()
def calibrate(frame, cfg: TrackerConfig = TrackerConfig()):
    """Baseline marker state from the first (unloaded) frame."""
    cents, _, valid = grid_centroids(marker_mask(frame, cfg), cfg)
    return {"centroids": cents, "valid": valid}


def _forces(frames, baseline: dict, cfg: TrackerConfig, rgb: bool) -> dict:
    """estimate_force over (T, H, W[, 3]) frames: every output gains a
    leading T."""
    cents, _, valid = grid_centroids(_mask(_gray(frames, rgb), cfg), cfg)
    both = valid & baseline["valid"]
    disp = torch.where(both[..., None], cents - baseline["centroids"],
                       torch.zeros_like(cents))
    n = torch.clamp(both.sum(dim=-1, keepdim=True), min=1)
    mean_disp = disp.double().sum(dim=-2).float() / n
    mag = _norm2(mean_disp)
    direction = torch.where(mag[..., None] > 0,
                            mean_disp / torch.clamp(mag, min=1e-12)[..., None],
                            torch.zeros_like(mean_disp))
    return {"displacement": disp, "valid": both, "mean_disp": mean_disp,
            "magnitude": mag, "direction": direction,
            "force": torch.cat([mean_disp, mag[..., None]], dim=-1)}


@torch.inference_mode()
def estimate_force(frame, baseline: dict, cfg: TrackerConfig = TrackerConfig()):
    """Force from one frame vs the calibration baseline: ``displacement``
    (N, 2), ``valid`` (N,), ``mean_disp`` (2,), ``magnitude`` (),
    ``direction`` (2,) and ``force`` = [dx, dy, magnitude]."""
    out = _forces(frame[None], baseline, cfg, frame.dim() == 3)
    return {k: v[0] for k, v in out.items()}


@torch.inference_mode()
def estimate_force_sequence(frames, baseline: dict, cfg: TrackerConfig = TrackerConfig()):
    """A (T, H, W[, 3]) episode in one batched pass: ``forces`` (T, 3) and
    ``displacements`` (T, 2), frame t's equal to :func:`estimate_force` on
    frame t."""
    out = _forces(frames, baseline, cfg, frames.dim() == 4)
    return {"forces": out["force"], "displacements": out["mean_disp"]}
