"""Training and evaluation of the planner's tactile encoder (counterpart of
``vla_touch_tpu/planning/train_encoder.py``).

- :func:`train_property_encoder`: the per-sensor adapters and the property
  classifier trained against hardness/roughness ratings on the frozen CLIP
  video feature (AdamW, decay 1e-6, over every adapter and the
  classifier), ``training.jsonl`` every 5 steps, the encoder saved.
- :func:`train_vificlip_contrastive`: a ViFiCLIP trained with the symmetric
  video <-> text contrastive loss over the two logit scales.  With
  ``freeze_text_encoder`` the whole text tower (its prompts and gates too)
  gets no gradient, no update and no decay, as optax's ``multi_transform``
  with ``set_to_zero`` leaves it: its parameters stop requiring grad before
  the optimizer is built, so the optimizer holds no state for them.  The
  vision tower and the logit scales train.
- :func:`evaluate_encoder`: threshold accuracy, pairwise success and MSE on
  a split.

Parameters, optimizer state and the loss are float32.  The contrastive
trainer's towers compute in ``compute_dtype`` (bf16 on the card, where the
vision tower's self-attention reaches K1 through
``ops/attention.py::dot_product_attention``: ``FlashAttentionFn`` under
grad); the property trainer's CLIP runs in the state's dtype under
``no_grad`` (the K1 wrapper itself).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from vla_touch_tpu_torch.models.encoders.vit import master_weights_
from vla_touch_tpu_torch.planning import encoder as PE
from vla_touch_tpu_torch.planning.datasets import TactilePropertyRegressionDataset
from vla_touch_tpu_torch.planning.eval import (
    pairwise_comparison_success,
    threshold_classification_accuracy,
)
from vla_touch_tpu_torch.train.optim import AdamW, float32_math

logger = logging.getLogger("train_encoder")


def property_loss(st: PE.TactileEncoderState, frames, targets, sensor: str = "dotted"):
    """MSE of the classifier's [hardness, roughness] on the adapted video
    feature; the CLIP video runs under ``no_grad``, as the JAX trainer's
    ``stop_gradient`` holds it (it never trains the CLIP tower)."""
    with torch.no_grad():
        video = st.clip(frames)
    preds = st.classifier(st.adapters[sensor](video))
    return torch.mean(torch.square(preds - targets))


def _device(st: PE.TactileEncoderState) -> torch.device:
    return st.classifier.fc1.weight.device


def train_property_encoder(data_path: str, output_dir: str, datasets=("physiclear",),
                           epochs: int = 10, batch_size: int = 8, lr: float = 1e-4,
                           frame_size: int = 224, max_frames: int = 4, cfg=None,
                           state: Optional[PE.TactileEncoderState] = None, seed: int = 0,
                           sensor: str = "dotted", device=None) -> PE.TactileEncoderState:
    """Train ``state`` (default: a seeded encoder on ``device``, default
    CUDA) on the train split of ``data_path``; returns it, saved under
    ``output_dir/encoder``."""
    float32_math()
    st = state or PE.init_tactile_encoder(cfg or PE.CLIP_VIT_B16, seed, device)
    dev = _device(st)
    ds = TactilePropertyRegressionDataset(data_path, "train", datasets, frame_size=frame_size,
                                          max_frames=max_frames, seed=seed)
    if len(ds) == 0:
        raise ValueError(f"no training samples under {data_path}")
    trainable = nn.ModuleList([st.adapters, st.classifier]).requires_grad_(True)
    opt = AdamW(trainable.parameters(), weight_decay=1e-6)
    os.makedirs(output_dir, exist_ok=True)
    log_path = os.path.join(output_dir, "training.jsonl")
    it = 0
    try:
        for epoch in range(epochs):
            for batch in ds.batches(batch_size):
                loss = property_loss(st, torch.as_tensor(batch["frames"], device=dev),
                                     torch.as_tensor(batch["properties"], device=dev), sensor)
                opt.zero_grad()
                loss.backward()
                opt.step(lr)
                if it % 5 == 0:
                    with open(log_path, "a") as f:
                        f.write(json.dumps({"step": it, "epoch": epoch,
                                            "loss": float(loss.detach())}) + "\n")
                it += 1
    finally:
        opt.zero_grad()
        trainable.requires_grad_(False)
    PE.save_tactile_encoder(os.path.join(output_dir, "encoder"), st)
    return st


def contrastive_loss(model: PE.ViFiCLIPModel, batch: dict, device):
    """The contrastive loss of ``model`` on one batch (``frames``,
    ``input_ids``, optional ``attention_mask``) moved to ``device``."""
    am = batch.get("attention_mask")
    video, text, scales = model(torch.as_tensor(batch["frames"], device=device),
                                torch.as_tensor(batch["input_ids"], device=device),
                                None if am is None else torch.as_tensor(am, device=device))
    return PE.vificlip_contrastive_loss(video, text, scales)


def train_vificlip_contrastive(batches, *, vision_cfg=None, text_cfg=None,
                               prompt_learning: bool = True,
                               freeze_text_encoder: bool = True, num_prompts: int = 4,
                               prompt_depth_vision: int = 9, prompt_depth_text: int = 9,
                               epochs: int = 1, lr: float = 1e-4, seed: int = 0,
                               model: Optional[PE.ViFiCLIPModel] = None,
                               log_path: Optional[str] = None, device=None,
                               compute_dtype: torch.dtype = torch.bfloat16,
                               projection_dim: Optional[int] = None):
    """Train a ViFiCLIP with the symmetric contrastive loss.

    ``batches``: dicts of ``frames`` (B, L, H, W, 3) normalised videos,
    ``input_ids`` (B, Lt) CLIP token ids (row i the caption of video i) and
    an optional ``attention_mask`` (B, Lt); iterated once per epoch.
    ``model``: a float32 :class:`ViFiCLIPModel` to train in place (its
    Linears and LayerNorms become the master-weight casting kinds, see
    ``vit.master_weights_``), else a seeded one on ``device`` (default
    CUDA) from the configs, the prompt options and ``projection_dim``
    (``ViFiCLIPModel``'s; the towers of CLIP ViT-B/16 and text B/16 need
    512).  Returns ``(model, losses)``."""
    batches = list(batches)
    if not batches:
        raise ValueError("no contrastive batches")
    float32_math()
    if model is None:
        model = PE.init_vificlip_model(
            vision_cfg or PE.CLIP_VIT_B16, text_cfg or PE.CLIP_TEXT_B16, seed, device,
            prompt_learning=prompt_learning, num_prompts=num_prompts,
            prompt_depth_vision=prompt_depth_vision, prompt_depth_text=prompt_depth_text,
            projection_dim=projection_dim)
    dev = model.logit_scale_tactile.device
    master_weights_(model, compute_dtype)
    model.requires_grad_(True)
    if freeze_text_encoder:
        model.text.requires_grad_(False)
    opt = AdamW(model.parameters(), weight_decay=1e-6)
    losses = []
    try:
        for epoch in range(epochs):
            for batch in batches:
                loss = contrastive_loss(model, batch, dev)
                opt.zero_grad()
                loss.backward()
                opt.step(lr)
                losses.append(float(loss.detach()))
                if log_path is not None:
                    with open(log_path, "a") as f:
                        f.write(json.dumps({"epoch": epoch, "loss": losses[-1]}) + "\n")
    finally:
        opt.zero_grad()
        model.requires_grad_(False)
    return model, losses


def evaluate_encoder(st: PE.TactileEncoderState, data_path: str, datasets=("physiclear",),
                     split: str = "test", frame_size: int = 224, max_frames: int = 4,
                     hardness_threshold: float = 5.0, sensor: str = "dotted") -> dict:
    """Hardness threshold accuracy, hardness and roughness pairwise success,
    MSE and the sample count on ``split`` of ``data_path``."""
    ds = TactilePropertyRegressionDataset(data_path, split, datasets, frame_size=frame_size,
                                          max_frames=max_frames)
    dev = _device(st)
    preds, labels = [], []
    for batch in ds.batches(batch_size=8, shuffle=False):
        feats = PE.encode_tactile_video(st, torch.as_tensor(batch["frames"], device=dev), sensor)
        preds.append(PE.classify_properties(st, feats).cpu().numpy())
        labels.append(batch["properties"])
    preds, labels = np.concatenate(preds), np.concatenate(labels)
    result = {
        "hardness_threshold_acc": threshold_classification_accuracy(
            preds[:, 0], labels[:, 0], hardness_threshold),
        "hardness_pairwise": pairwise_comparison_success(preds[:, 0], labels[:, 0]),
        "roughness_pairwise": pairwise_comparison_success(preds[:, 1], labels[:, 1]),
        "mse": float(np.mean((preds - labels) ** 2)),
        "num_samples": int(len(preds)),
    }
    logger.info("encoder eval: %s", json.dumps(result))
    return result
