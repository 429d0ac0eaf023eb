"""The planner's tactile encoder, inference only (counterpart of
``vla_touch_tpu/planning/encoder.py``): ViFiCLIP (frame-wise CLIP ViT-B/16,
the pooled CLS token, mean over frames, L2 normalisation), the per-sensor
residual ``Adapter`` and the hardness/roughness ``PropertyClassifier``,
plus the RAG helpers.

The CLIP tower runs in the state's dtype (bf16 on the card, where its
197-token self-attention goes through K1, ``ops/attention.py``); the frame
mean, the normalisation, the adapters and the classifier run in float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from vla_touch_tpu_torch.models.encoders.vit import CLIP_VIT_B16, ViTConfig, ViTEncoder
from vla_touch_tpu_torch.ops.nn import gelu_erf


class CLIPVisionPooled(nn.Module):
    """CLIP vision tower -> the final-layernormed CLS token (B, D)."""

    def __init__(self, cfg: ViTConfig = CLIP_VIT_B16):
        super().__init__()
        self.vit = ViTEncoder(cfg)

    def forward(self, pixels):
        return self.vit(pixels)[:, 0]


class ViFiCLIPVideo(nn.Module):
    """(B, L, H, W, 3) normalised frames -> L2-normalised video feature (B, D)."""

    def __init__(self, cfg: ViTConfig = CLIP_VIT_B16):
        super().__init__()
        self.clip = CLIPVisionPooled(cfg)

    def forward(self, frames):
        B, L, H, W, C = frames.shape
        dt = self.clip.vit.patch_embed.weight.dtype
        feats = self.clip(frames.reshape(B * L, H, W, C).to(dt)).float()
        video = feats.reshape(B, L, -1).mean(dim=1)
        return video / torch.linalg.vector_norm(video, dim=-1, keepdim=True).clamp_min(1e-12)


class Adapter(nn.Module):
    """Residual two-layer exact-GELU MLP, with an output alignment when the
    widths differ."""

    def __init__(self, input_size: int, output_size: int):
        super().__init__()
        self.rfc1 = nn.Linear(input_size, 512)
        self.rfc2 = nn.Linear(512, input_size)
        if input_size != output_size:
            self.align = nn.Linear(input_size, output_size)

    @torch.no_grad()
    def init_special_(self, generator):
        # the JAX package's truncated_normal(1e-3) kernels: near identity
        for m in self.children():
            m.weight.normal_(0.0, 1e-3, generator=generator)

    def forward(self, x):
        combined = self.rfc2(gelu_erf(self.rfc1(x))) + x
        if hasattr(self, "align"):
            combined = self.align(gelu_erf(combined))
        return combined


class PropertyClassifier(nn.Module):
    """Hardness and roughness regression heads: (B, D) -> (B, 2)."""

    def __init__(self, input_size: int = 768):
        super().__init__()
        self.fc1 = nn.Linear(input_size, 512)
        self.fc2 = nn.Linear(512, 256)
        self.hardness_fc = nn.Linear(256, 1)
        self.roughness_fc = nn.Linear(256, 1)

    def forward(self, x):
        h = gelu_erf(self.fc2(gelu_erf(self.fc1(x))))
        return torch.cat([self.hardness_fc(h), self.roughness_fc(h)], dim=-1)


@dataclasses.dataclass
class TactileEncoderState:
    """The deployable encoder bundle: the ViFiCLIP video tower, one adapter
    per sensor type and the property classifier."""

    cfg: ViTConfig
    clip: ViFiCLIPVideo
    adapters: nn.ModuleDict
    classifier: PropertyClassifier
    feature_dim: int = 768


def init_tactile_encoder(cfg: ViTConfig = CLIP_VIT_B16, seed: int = 0, device=None,
                         dtype=torch.bfloat16,
                         sensors=("dotted", "plain")) -> TactileEncoderState:
    """Seeded random encoder on ``device`` (default CUDA): the CLIP tower in
    ``dtype``, adapters and classifier in float32."""
    from vla_touch_tpu_torch.utils.random_init import build_module

    D = cfg.hidden_size
    clip = build_module(lambda: ViFiCLIPVideo(cfg), seed, device, dtype)
    adapters = nn.ModuleDict({
        s: build_module(lambda: Adapter(D, D), seed + 1 + i, device, torch.float32)
        for i, s in enumerate(sensors)})
    classifier = build_module(lambda: PropertyClassifier(D), seed + 1 + len(sensors), device,
                              torch.float32)
    return TactileEncoderState(cfg=cfg, clip=clip, adapters=adapters, classifier=classifier,
                               feature_dim=D)


@torch.no_grad()
def encode_tactile_video(state: TactileEncoderState, frames, sensor: str = "dotted"):
    """(B, L, H, W, 3) normalised frames -> adapted video features (B, D)
    float32, on the encoder's device."""
    dev = state.clip.clip.vit.patch_embed.weight.device
    video = state.clip(torch.as_tensor(frames, device=dev))
    return state.adapters[sensor](video)


@torch.no_grad()
def classify_properties(state: TactileEncoderState, features):
    """(B, D) -> (B, 2) [hardness, roughness]."""
    return state.classifier(torch.as_tensor(features).float())


# ---- RAG embeddings ------------------------------------------------------------


def generate_rag_embeddings(features: np.ndarray, labels: list) -> dict:
    """Store normalized features with their labels for retrieval."""
    f = np.asarray(features, np.float32)
    f = f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-12)
    return {"embeddings": f, "labels": list(labels)}


def rag_lookup(bank: dict, query: np.ndarray, top_k: int = 3) -> list:
    """Cosine-similarity top-k retrieval."""
    q = np.asarray(query, np.float32)
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    sims = bank["embeddings"] @ q.reshape(-1)
    idx = np.argsort(-sims)[:top_k]
    return [(bank["labels"][i], float(sims[i])) for i in idx]
