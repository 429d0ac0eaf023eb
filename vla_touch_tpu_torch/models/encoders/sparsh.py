"""Sparsh, the tactile MAE-ViT encoder (counterpart of
``vla_touch_tpu/models/encoders/sparsh.py``).

Meta's Sparsh representation: an MAE-pretrained ViT-B/16 over two stacked
RGB GelSight frames (6 channels).  The encoder is the port's
:class:`ViTEncoder` with a 6-channel config, so its self-attention is K1 on
the card; the pooled output is the CLS token.  Inputs are center-cropped to
240 x 240: 15 x 15 patches, 226 tokens with CLS (the positional grid is
square).  :func:`load_pretrained_encoder` reads a timm-layout torch
checkpoint (``weights_only``) with the JAX loader's prefix surgery and qkv
split; without one, the weights are seeded random.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from vla_touch_tpu_torch.models.encoders.vit import ViTConfig, ViTEncoder

SPARSH_VIT_B = ViTConfig(hidden_size=768, num_layers=12, num_heads=12,
                         mlp_dim=3072, patch_size=16, image_size=240,
                         num_channels=6, use_layerscale=False)


class SparshEncoder(nn.Module):
    """Pooled tactile embedding (B, D) of frame pairs (B, H, W, 6)."""

    def __init__(self, cfg: ViTConfig = SPARSH_VIT_B):
        super().__init__()
        self.vit = ViTEncoder(cfg)

    def forward(self, frames_pair):
        return self.vit(frames_pair)[:, 0]


def strip_prefix(sd: dict, prefixes=("model.", "module.", "encoder.")) -> dict:
    """Drop wrapper prefixes (each at most once, in this order) so an MAE
    checkpoint's keys match the bare ViT."""
    out = {}
    for k, v in sd.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def _timm_tree(sd: dict, cfg: ViTConfig) -> dict:
    """The parts of a timm ViT state dict that are present, as the JAX
    encoder's ``vit`` tree (q/k/v split off the fused qkv)."""
    from vla_touch_tpu_torch.utils import torch_port as tp

    vit: dict = {}
    if "patch_embed.proj.weight" in sd:
        vit["patch_embed"] = tp.conv2d(sd["patch_embed.proj.weight"],
                                       sd.get("patch_embed.proj.bias"))
    for name in ("pos_embed", "cls_token"):
        if name in sd:
            vit[name] = np.asarray(sd[name])
    for i in range(cfg.num_layers):
        p = f"blocks.{i}."
        if f"{p}norm1.weight" not in sd:
            continue
        qkv_w = np.asarray(sd[f"{p}attn.qkv.weight"])          # (3D, D)
        qkv_b = np.asarray(sd[f"{p}attn.qkv.bias"])
        D = qkv_w.shape[1]
        vit[f"block{i}"] = {
            "norm1": tp.layernorm(sd[f"{p}norm1.weight"], sd[f"{p}norm1.bias"]),
            "attention": {
                "query": tp.linear(qkv_w[:D], qkv_b[:D]),
                "key": tp.linear(qkv_w[D:2 * D], qkv_b[D:2 * D]),
                "value": tp.linear(qkv_w[2 * D:], qkv_b[2 * D:]),
                "output": tp.linear(sd[f"{p}attn.proj.weight"], sd[f"{p}attn.proj.bias"]),
            },
            "norm2": tp.layernorm(sd[f"{p}norm2.weight"], sd[f"{p}norm2.bias"]),
            "fc1": tp.linear(sd[f"{p}mlp.fc1.weight"], sd[f"{p}mlp.fc1.bias"]),
            "fc2": tp.linear(sd[f"{p}mlp.fc2.weight"], sd[f"{p}mlp.fc2.bias"]),
        }
    if "norm.weight" in sd:
        vit["final_norm"] = tp.layernorm(sd["norm.weight"], sd["norm.bias"])
    return {"vit": vit}


def load_pretrained_encoder(checkpoint_path: Optional[str] = None,
                            cfg: ViTConfig = SPARSH_VIT_B, seed: int = 0, device=None,
                            dtype: torch.dtype = torch.bfloat16) -> SparshEncoder:
    """A :class:`SparshEncoder` on ``device`` (default CUDA) in ``dtype``,
    seeded random, then (with ``checkpoint_path``) every leaf the timm
    checkpoint holds replaced by the checkpoint's (leaves the ViT has not,
    such as an MAE decoder's, are ignored, as the JAX loader ignores
    them)."""
    from vla_touch_tpu_torch.models.encoders.vit import init_vit
    from vla_touch_tpu_torch.utils import from_flax as FF

    module = init_vit(SparshEncoder, cfg, seed=seed, device=device, dtype=dtype)
    if checkpoint_path is None:
        return module
    raw = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    sd = strip_prefix({k: v.float().numpy() for k, v in raw.items()})
    state = {k: v.float().cpu().numpy() for k, v in module.state_dict().items()}
    state.update(FF.to_state_dict(_timm_tree(sd, cfg), lists=("block",)))
    return FF.load_into(module, state)
