"""The planner's tactile encoder (counterpart of
``vla_touch_tpu/planning/encoder.py``): ViFiCLIP (frame-wise CLIP ViT-B/16,
the pooled CLS token, mean over frames, L2 normalisation), the per-sensor
residual ``Adapter`` and the hardness/roughness ``PropertyClassifier``,
the full two-tower :class:`ViFiCLIPModel` with its prompt-learned towers and
contrastive loss, the encoder's checkpoint directory, and the RAG helpers.

The CLIP towers compute in their dtype: the state's for serving (bf16 on
the card, where the vision tower's self-attention goes through K1,
``ops/attention.py``), or ``compute_dtype`` over float32 master weights in
training (``models/encoders/vit.py::master_weights_``).  The text tower's
causal attention is the plain einsum.  The frame mean, the normalisation,
the adapters, the classifier, the logit scales and the loss are float32.
"""

from __future__ import annotations

import dataclasses
import os
import types
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vla_touch_tpu_torch.models.encoders.clip_text import (
    CLIP_TEXT_B16, CLIPTextConfig, CLIPTextTower, causal_bias, padding_bias)
from vla_touch_tpu_torch.models.encoders.vit import CLIP_VIT_B16, ViTConfig, ViTEncoder
from vla_touch_tpu_torch.ops.nn import gelu_erf
from vla_touch_tpu_torch.utils import checkpoint as ckpt


class CLIPVisionPooled(nn.Module):
    """CLIP vision tower -> the final-layernormed CLS token (B, D)."""

    def __init__(self, cfg: ViTConfig = CLIP_VIT_B16):
        super().__init__()
        self.vit = ViTEncoder(cfg)

    def forward(self, pixels):
        return self.vit(pixels)[:, 0]


def _l2_normalize(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def _video_feature(tower, frames):
    """(B, L, H, W, C) frames through a per-frame ``tower`` -> the float32
    L2-normalised frame mean (B, D)."""
    B, L, H, W, C = frames.shape
    feats = tower(frames.reshape(B * L, H, W, C)).float()
    return _l2_normalize(feats.reshape(B, L, -1).mean(dim=1))


class ViFiCLIPVideo(nn.Module):
    """(B, L, H, W, 3) normalised frames -> L2-normalised video feature (B, D)."""

    def __init__(self, cfg: ViTConfig = CLIP_VIT_B16):
        super().__init__()
        self.clip = CLIPVisionPooled(cfg)

    def forward(self, frames):
        return _video_feature(self.clip, frames)


class PromptLearningCLIPVision(ViTEncoder):
    """VPT-deep prompt-learned CLIP vision tower with per-layer gates ->
    the final-layernormed CLS token (B, D).

    ``prompts[0]`` is appended after the patch tokens, before the pre
    LayerNorm; before layer i in 1..depth-1 the prompt slots' outputs are
    kept as ``before`` and replaced by ``prompts[i]``, and after that layer
    (but the last) the slots blend ``sigmoid(gates[i]) after + (1 -
    sigmoid(gates[i])) before``; layer ``depth`` drops the slots (a depth
    of at least ``num_layers`` drops them after the last block).

    The docstring of the JAX module says only the prompts and gates train;
    its trainer (``train_vificlip_contrastive``) trains the whole tower, and
    so does the port's (ROADMAP C)."""

    def __init__(self, cfg: ViTConfig = CLIP_VIT_B16, num_prompts: int = 4,
                 prompt_depth: int = 9, gate_prior: float = -3.0):
        super().__init__(cfg)
        self.num_prompts, self.prompt_depth, self.gate_prior = (
            num_prompts, prompt_depth, gate_prior)
        self.prompts = nn.Parameter(torch.empty(max(prompt_depth, 1), num_prompts,
                                                cfg.hidden_size))
        self.gates = nn.Parameter(torch.empty(cfg.num_layers))

    @torch.no_grad()
    def init_special_(self, generator):
        super().init_special_(generator)
        self.prompts.normal_(0.0, 0.02, generator=generator)
        self.gates.fill_(self.gate_prior)

    def forward(self, pixels):
        c, n = self.cfg, self.num_prompts
        x = self.embed(pixels)
        B, dt = x.shape[0], x.dtype

        def ctx(i):
            return self.prompts[i].to(dt).expand(B, n, c.hidden_size)

        def body(x):
            return x[:, : x.shape[1] - n]

        x = torch.cat([x, ctx(0)], dim=1)
        if c.use_pre_norm:
            x = self.pre_norm(x)
        for i, blk in enumerate(self.blocks):
            replace = 0 < i < self.prompt_depth
            if replace:
                before = x[:, x.shape[1] - n:]
                x = torch.cat([body(x), ctx(i)], dim=1)
            elif i == self.prompt_depth:
                x = body(x)
            x = blk(x)
            if replace and i != c.num_layers - 1:
                g = torch.sigmoid(self.gates[i]).to(dt)
                x = torch.cat([body(x), g * x[:, x.shape[1] - n:] + (1 - g) * before], dim=1)
        if self.prompt_depth >= c.num_layers:
            x = body(x)
        return self.final_norm(x)[:, 0]


class PromptLearningCLIPText(CLIPTextTower):
    """Deep prompt-learned CLIP text transformer with per-layer gates ->
    (last hidden states, pooled).

    The prompts OVERWRITE the ``num_prompts`` filler slots after BOS
    (positions [1, 1+n)): ``prompts[0]`` at the embedding, ``prompts[i]``
    again before layer i in 1..depth-1, blended with the incoming slots
    through ``sigmoid(gates[i])`` after that layer (but the last).  A depth
    under ``num_layers`` drops the slots before layer ``depth``; from there
    the blocks take the causal and padding bias of the L - n remaining
    tokens, and the EOS index moves back by n, clamped at 0 (a row whose
    EOS comes before slot 1+n pools position 0)."""

    def __init__(self, cfg: CLIPTextConfig = CLIP_TEXT_B16, num_prompts: int = 4,
                 prompt_depth: int = 12, gate_prior: float = -3.0):
        super().__init__(cfg)
        self.num_prompts, self.prompt_depth, self.gate_prior = (
            num_prompts, prompt_depth, gate_prior)
        self.prompts = nn.Parameter(torch.empty(max(prompt_depth, 1), num_prompts,
                                                cfg.hidden_size))
        self.gates = nn.Parameter(torch.empty(cfg.num_layers))

    @torch.no_grad()
    def init_special_(self, generator):
        super().init_special_(generator)
        self.prompts.normal_(0.0, 0.02, generator=generator)
        self.gates.fill_(self.gate_prior)

    def forward(self, input_ids, attention_mask=None):
        c, n, depth = self.cfg, self.num_prompts, self.prompt_depth
        B, L = input_ids.shape
        x = self.embed(input_ids)
        dt, dev = x.dtype, x.device

        def put(x, i):
            ctx = self.prompts[i].to(dt).expand(B, n, c.hidden_size)
            return torch.cat([x[:, :1], ctx, x[:, 1 + n:]], dim=1)

        if depth > 0:
            x = put(x, 0)
        bias, short_bias = causal_bias(L, dev), causal_bias(L - n, dev)
        if attention_mask is not None:
            bias = bias + padding_bias(attention_mask)
            short_bias = short_bias + padding_bias(
                torch.cat([attention_mask[:, :1], attention_mask[:, 1 + n:]], dim=1))
        dropped = False
        for i, blk in enumerate(self.blocks):
            replace = 0 < i < depth
            if replace:
                before = x[:, 1:1 + n]
                x = put(x, i)
            elif i == depth and 0 < depth < c.num_layers:
                x = torch.cat([x[:, :1], x[:, 1 + n:]], dim=1)
                dropped = True
            x = blk(x, short_bias if dropped else bias)
            if replace and i != c.num_layers - 1:
                g = torch.sigmoid(self.gates[i]).to(dt)
                gated = g * x[:, 1:1 + n] + (1 - g) * before
                x = torch.cat([x[:, :1], gated, x[:, 1 + n:]], dim=1)
        x = self.final_norm(x)
        pos = (input_ids == c.eos_token_id).int().argmax(dim=-1)
        if dropped:
            pos = (pos - n).clamp_min(0)
        return x, x[torch.arange(B, device=dev), pos]


LOGIT_SCALE_INIT = float(np.log(1 / 0.07))


class ViFiCLIPModel(nn.Module):
    """The full ViFiCLIP: the tactile-video tower (plain or prompt-learned
    CLIP vision, frames folded into the batch, mean-pooled, L2-normalised),
    the text tower (plain or prompt-learned CLIP text, pooled at EOS,
    L2-normalised) and the two learnable temperatures
    ``logit_scale_tactile`` and ``logit_scale_text`` (log(1/0.07) at init).
    Parameter names are the JAX module's: ``vision``, ``text`` and the two
    scales.

    ``projection_dim``: None (the JAX module: no projection, so the two
    towers must be equally wide), or the width of HF CLIP's bias-free
    ``visual_projection`` and ``text_projection``, which map each pooled
    feature before its normalisation.  CLIP ViT-B/16 (768) beside the B/16
    text tower (512) needs them (512 in the checkpoint); they sit beside
    the towers, so a frozen text tower leaves them training."""

    def __init__(self, vision_cfg: ViTConfig = CLIP_VIT_B16,
                 text_cfg: CLIPTextConfig = CLIP_TEXT_B16, prompt_learning: bool = False,
                 num_prompts: int = 4, prompt_depth_vision: int = 9,
                 prompt_depth_text: int = 9, gate_prior: float = -3.0,
                 projection_dim: Optional[int] = None):
        super().__init__()
        if projection_dim is None and vision_cfg.hidden_size != text_cfg.hidden_size:
            raise ValueError(f"towers of widths {vision_cfg.hidden_size} and "
                             f"{text_cfg.hidden_size} need a projection_dim")
        if projection_dim is not None:
            self.visual_projection = nn.Linear(vision_cfg.hidden_size, projection_dim,
                                               bias=False)
            self.text_projection = nn.Linear(text_cfg.hidden_size, projection_dim, bias=False)
        if prompt_learning:
            self.vision = PromptLearningCLIPVision(vision_cfg, num_prompts,
                                                   prompt_depth_vision, gate_prior)
            self.text = PromptLearningCLIPText(text_cfg, num_prompts, prompt_depth_text,
                                               gate_prior)
        else:
            self.vision = CLIPVisionPooled(vision_cfg)
            self.text = CLIPTextTower(text_cfg)
        self.logit_scale_tactile = nn.Parameter(torch.empty(()))
        self.logit_scale_text = nn.Parameter(torch.empty(()))

    @torch.no_grad()
    def init_special_(self, generator):
        self.logit_scale_tactile.fill_(LOGIT_SCALE_INIT)
        self.logit_scale_text.fill_(LOGIT_SCALE_INIT)

    def forward(self, frames, input_ids=None, attention_mask=None):
        """frames (B, L, H, W, 3); input_ids (B2, Lt) or None.  Returns
        ``(video_features, text_features, logit_scales)``; the features
        have unit L2 norm, ``text_features`` is None without
        ``input_ids``."""
        proj = hasattr(self, "visual_projection")
        video = _video_feature(
            (lambda px: self.visual_projection(self.vision(px))) if proj else self.vision, frames)
        text = None
        if input_ids is not None:
            _, pooled = self.text(input_ids, attention_mask)
            text = _l2_normalize((self.text_projection(pooled) if proj else pooled).float())
        return video, text, {"tactile": self.logit_scale_tactile,
                             "text": self.logit_scale_text}


def init_vificlip_model(vision_cfg: ViTConfig = CLIP_VIT_B16,
                        text_cfg: CLIPTextConfig = CLIP_TEXT_B16, seed: int = 0,
                        device=None, **kw) -> ViFiCLIPModel:
    """A seeded random float32 :class:`ViFiCLIPModel` on ``device``
    (default CUDA); ``kw`` as the model's (``prompt_learning``, ...)."""
    from vla_touch_tpu_torch.utils.random_init import build_module

    return build_module(lambda: ViFiCLIPModel(vision_cfg, text_cfg, **kw), seed, device,
                        torch.float32)


def vificlip_contrastive_loss(video, text, scales, max_scale: float = 100.0):
    """Symmetric InfoNCE over a matched (video_i, text_i) batch: the
    cross-entropy of ``min(exp(scale), max_scale) <v, t>`` in both
    directions, the tactile scale tempering video -> text and the text
    scale text -> video; float32."""
    s_v = torch.clamp(torch.exp(scales["tactile"].float()), max=max_scale)
    s_t = torch.clamp(torch.exp(scales["text"].float()), max=max_scale)
    sims = video.float() @ text.float().T
    labels = torch.arange(video.shape[0], device=sims.device)
    lv = F.cross_entropy(sims * s_v, labels)
    lt = F.cross_entropy(sims.T * s_t, labels)
    return 0.5 * (lv + lt)


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


def save_tactile_encoder(path: str, st: TactileEncoderState) -> None:
    """The JAX package's encoder directory: ``clip.msgpack``,
    ``adapters.msgpack`` (one tree per sensor) and ``classifier.msgpack``
    as flax trees of float32 arrays, and ``meta.json`` (the feature width
    and the CLIP config)."""
    from vla_touch_tpu_torch.utils.from_flax import to_flax

    os.makedirs(path, exist_ok=True)
    ckpt.save_pytree(os.path.join(path, "clip.msgpack"), to_flax(st.clip))
    ckpt.save_pytree(os.path.join(path, "adapters.msgpack"),
                     {s: to_flax(a) for s, a in st.adapters.items()})
    ckpt.save_pytree(os.path.join(path, "classifier.msgpack"), to_flax(st.classifier))
    ckpt.save_json(os.path.join(path, "meta.json"),
                   {"feature_dim": st.feature_dim, "cfg": dataclasses.asdict(st.cfg)})


def load_tactile_encoder(path: str, cfg: Optional[ViTConfig] = None, device=None,
                         dtype=torch.bfloat16) -> TactileEncoderState:
    """An encoder directory written by either package -> the port's state on
    ``device`` (default CUDA), the CLIP tower in ``dtype``; every leaf of
    the files must land on a parameter and every parameter must have one."""
    from vla_touch_tpu_torch.utils.from_flax import tactile_encoder

    meta = ckpt.load_json(os.path.join(path, "meta.json"))
    trees = types.SimpleNamespace(
        cfg=cfg or ViTConfig(**meta["cfg"]), feature_dim=meta["feature_dim"],
        clip_params=ckpt.load_pytree(os.path.join(path, "clip.msgpack")),
        adapter_params=ckpt.load_pytree(os.path.join(path, "adapters.msgpack")),
        classifier_params=ckpt.load_pytree(os.path.join(path, "classifier.msgpack")))
    return tactile_encoder(trees, device=device, dtype=dtype)


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
