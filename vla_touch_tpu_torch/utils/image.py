"""Image preprocessing (counterpart of ``vla_touch_tpu/utils/image.py``).

``pad_and_resize_for_siglip`` is the host-side zero-pad-to-square + area
resize of the deployment wrapper; ``siglip_normalize`` maps uint8 pixels to
[-1, 1] on the device.
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


def imagenet_normalize(images: torch.Tensor) -> torch.Tensor:
    """/255 + ImageNet mean/std normalize, channels-last (DinoV2 input)."""
    mean = torch.tensor([0.485, 0.456, 0.406], dtype=torch.float32,
                        device=images.device)
    std = torch.tensor([0.229, 0.224, 0.225], dtype=torch.float32,
                       device=images.device)
    return (images.float() / 255.0 - mean) / std


def siglip_normalize(images: torch.Tensor) -> torch.Tensor:
    """SigLIP preprocessing: /255 then rescale to [-1, 1] (mean=std=0.5)."""
    x = images.float() / 255.0
    return (x - 0.5) / 0.5
