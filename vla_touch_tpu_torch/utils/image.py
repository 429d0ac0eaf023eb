"""Image preprocessing (counterpart of ``vla_touch_tpu/utils/image.py``).

``pad_and_resize_for_siglip`` is the host-side zero-pad-to-square + area
resize of the deployment wrapper (``pad_and_resize_batch`` over frames);
``siglip_normalize`` maps uint8 pixels to [-1, 1] on the device.
"""

from __future__ import annotations

import numpy as np
import torch


def pad_and_resize_for_siglip(image: np.ndarray, target_size: int = 384) -> np.ndarray:
    """Zero-pad centered to a square, then INTER_AREA resize (host, numpy).

    A frame that is already ``target_size`` square is returned as a copy
    without touching OpenCV (cv2 copies at scale 1 too); only a real resize
    imports cv2, as the JAX package does.
    """
    h, w, c = image.shape
    m = max(h, w)
    canvas = np.zeros((m, m, c), dtype=image.dtype)
    ph, pw = (m - h) // 2, (m - w) // 2
    canvas[ph:ph + h, pw:pw + w] = image
    if m == target_size:
        return canvas
    import cv2

    return cv2.resize(canvas, (target_size, target_size),
                      interpolation=cv2.INTER_AREA)


def pad_and_resize_batch(images: np.ndarray, target_size: int = 384) -> np.ndarray:
    """(N, H, W, C) frames, each through :func:`pad_and_resize_for_siglip`."""
    out = np.zeros((images.shape[0], target_size, target_size, images.shape[-1]),
                   dtype=images.dtype)
    for i, img in enumerate(images):
        out[i] = pad_and_resize_for_siglip(img, target_size)
    return out


# The JAX package's normalizations run under jit, where XLA turns x / c into
# x * (1 / c) (the reciprocal rounded to float32) and the CPU backend fuses
# x * r - m into one fused multiply-add.  The port does the same arithmetic:
# x * r - m in float64 is exact for uint8 pixels (8 x 24 bits, one add) and
# rounds once to float32, as the FMA does, on the CPU and the card alike.
_RECIP_255 = float(np.float32(1) / np.float32(255))
_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_RECIP_STD = np.float32(1) / np.array([0.229, 0.224, 0.225], np.float32)


def imagenet_normalize(images: torch.Tensor) -> torch.Tensor:
    """/255 + ImageNet mean/std normalize, channels-last (DinoV2 input)."""
    mean = torch.tensor(_IMAGENET_MEAN, dtype=torch.float64, device=images.device)
    rstd = torch.tensor(_IMAGENET_RECIP_STD, device=images.device)
    return (images.double() * _RECIP_255 - mean).float() * rstd


def siglip_normalize(images: torch.Tensor) -> torch.Tensor:
    """SigLIP preprocessing: /255 then rescale to [-1, 1] (mean=std=0.5)."""
    return (images.double() * _RECIP_255 - 0.5).float() * 2.0
