"""The controllers' DinoV2 feature extractor (counterpart of
``vla_touch_tpu/models/encoders/dinov2_runtime.py``).

:func:`encode_images` keeps the reference wrapper's input heuristics: /255
when the batch's max is above 1, and ImageNet normalisation unless the
batch's mean (after that) is below 0.5 (it then counts as normalised
already).  Both are global reductions over the whole batch, not per image.
The encoder is a ``DinoV2Encoder`` module; its self-attention runs through
K1, which takes bf16, so the encoder is built in bf16 unless the caller
asks for float32 (CPU).  Weights persist beside a controller checkpoint as
``image_encoder_{name}.msgpack`` in the JAX package's flax layout.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from vla_touch_tpu_torch.models.encoders.vit import (DINOV2_BASE, DINOV2_SMALL,
                                                     DinoV2Encoder, ViTConfig)

_CONFIGS = {"dinov2-small": DINOV2_SMALL, "dinov2-base": DINOV2_BASE}
_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def config_for(name: str) -> ViTConfig:
    return _CONFIGS[name]


def encode_images(encoder: DinoV2Encoder, images) -> torch.Tensor:
    """images (B, H, W, C) or (B, T, H, W, C) (the last frame is used),
    uint8 or float, on the encoder's device -> float32 (B, D) CLS features,
    without gradients."""
    x = torch.as_tensor(images)
    if x.dim() == 5:
        x = x[:, -1]
    x = x.float()
    x = torch.where(x.max() > 1.0, x / 255.0, x)
    mean = torch.tensor(_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(_STD, dtype=torch.float32, device=x.device)
    x = torch.where(x.mean() < 0.5, x, (x - mean) / std)
    with torch.no_grad():
        return encoder(x).float()


def init_params(name: str, seed: int = 0, device=None,
                dtype=torch.bfloat16) -> DinoV2Encoder:
    """A seeded random encoder of config ``name`` on ``device`` (default
    CUDA)."""
    from vla_touch_tpu_torch.models.encoders.vit import init_vit

    return init_vit(DinoV2Encoder, config_for(name), seed=seed, device=device, dtype=dtype)


def save_params(ckpt_dir: str, name: str, encoder: DinoV2Encoder) -> str:
    """Persist the encoder beside a controller checkpoint (float32 flax
    tree), so evaluation reproduces the features the controller was
    trained on."""
    from vla_touch_tpu_torch.utils import checkpoint as ckpt
    from vla_touch_tpu_torch.utils.from_flax import to_flax

    path = os.path.join(ckpt_dir, f"image_encoder_{name}.msgpack")
    ckpt.save_pytree(path, to_flax(encoder))
    return path


def load_params(ckpt_dir: str, name: str, device=None,
                dtype=torch.bfloat16) -> Optional[DinoV2Encoder]:
    """The persisted encoder (or the legacy ``image_encoder.msgpack``), on
    ``device`` (default CUDA) in ``dtype``; None when the checkpoint holds
    neither."""
    from vla_touch_tpu_torch.utils import checkpoint as ckpt
    from vla_touch_tpu_torch.utils import from_flax as FF
    from vla_touch_tpu_torch.utils.device import resolve_device

    path = os.path.join(ckpt_dir, f"image_encoder_{name}.msgpack")
    if not os.path.exists(path):
        path = os.path.join(ckpt_dir, "image_encoder.msgpack")
    if not os.path.exists(path):
        return None
    dev = resolve_device(device)
    with torch.device("meta"):
        enc = DinoV2Encoder(config_for(name))
    enc = enc.to_empty(device=dev).to(dtype)
    FF.load_into(enc, FF.dinov2_runtime(ckpt.load_pytree(path)))
    return enc.eval().requires_grad_(False)
