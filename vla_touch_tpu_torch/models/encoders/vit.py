"""Vision transformers: DinoV2 (controller conditioning), SigLIP (RDT
image conditioning) and CLIP ViT-B/16 (the planner's tactile encoder) —
counterpart of ``vla_touch_tpu/models/encoders/vit.py``.

Outputs: DinoV2 the final-layernormed CLS token (B, D); SigLIP the
post-layernormed patch tokens (B, N, D); CLIP (``planning/encoder.py``)
the final-layernormed CLS token, after a pre-LayerNorm, quick GELU and a
patch projection without bias.  Self-attention goes through K1
(:func:`ops.attention.dot_product_attention`); the additive-mask variant
(CLIP text only) stays on the plain einsum.

The patch embedding is a matmul over non-overlapping p x p patches
(``patch_embed`` is a Linear over the (ky, kx, channel)-ordered patch).

Hazard kept exact: a checkpoint's positional grid (37 x 37 for DinoV2's 518
native size) is resized to the run's grid (27 x 27 at 384 px) the way
``jax.image.resize(..., "bicubic")`` does it — Keys cubic with a = -0.5 and
an antialiasing kernel stretched by 1/scale when downsampling, which
``torch.nn.functional.interpolate(mode="bicubic")`` (a = -0.75, no
antialias) is not.  :func:`resize_weights` builds that separable weight
matrix in numpy, once per grid pair.

Training keeps float32 master weights and computes in bf16, as flax's
``dtype=bfloat16`` with float32 parameters does: :func:`master_weights_`
makes every Linear cast its weight and bias at use, every LayerNorm compute
in float32 and round its output to the input's dtype, and the towers cast
their embeddings and tokens to ``compute_dtype``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vla_touch_tpu_torch.ops import attention as A
from vla_touch_tpu_torch.ops.nn import cast_linears_, gelu_erf, gelu_tanh, quick_gelu


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int
    num_layers: int
    num_heads: int
    mlp_dim: int
    patch_size: int = 14
    image_size: int = 518          # pos-embed native grid
    num_channels: int = 3
    layernorm_eps: float = 1e-6
    use_cls_token: bool = True     # DinoV2 yes, SigLIP no
    use_layerscale: bool = True    # DinoV2 yes, SigLIP no
    gelu_tanh: bool = False        # SigLIP uses gelu_pytorch_tanh
    quick_gelu: bool = False       # CLIP uses x*sigmoid(1.702x)
    use_pre_norm: bool = False     # CLIP applies LayerNorm before the blocks
    patch_bias: bool = True        # CLIP's patch conv has no bias


DINOV2_SMALL = ViTConfig(hidden_size=384, num_layers=12, num_heads=6,
                         mlp_dim=1536, image_size=518)
DINOV2_BASE = ViTConfig(hidden_size=768, num_layers=12, num_heads=12,
                        mlp_dim=3072, image_size=518)
SIGLIP_SO400M = ViTConfig(hidden_size=1152, num_layers=27, num_heads=16,
                          mlp_dim=4304, image_size=384, use_cls_token=False,
                          use_layerscale=False, gelu_tanh=True)
CLIP_VIT_B16 = ViTConfig(hidden_size=768, num_layers=12, num_heads=12,
                         mlp_dim=3072, patch_size=16, image_size=224,
                         use_layerscale=False, quick_gelu=True,
                         use_pre_norm=True, layernorm_eps=1e-5,
                         patch_bias=False)


@functools.lru_cache(maxsize=16)
def resize_weights(old: int, new: int) -> np.ndarray:
    """(old, new) float64 weights of ``jax.image.resize`` bicubic along one
    axis (scale = new/old, antialiased, Keys a = -0.5, renormalised)."""
    scale = new / old
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(new) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(old)[:, None]) / kernel_scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = np.where(x >= 2.0, 0.0, w)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= old - 0.5)
    return np.where(inside[None, :], w, 0.0)


def interpolate_pos_embed(pos, new_grid: int, old_grid: int, has_cls: bool):
    """Resize a (1, [1 +] old^2, D) positional table to new_grid^2 rows."""
    if new_grid == old_grid:
        return pos
    cls_pos, patch_pos = (pos[:, :1], pos[:, 1:]) if has_cls else (None, pos)
    D = pos.shape[-1]
    w = torch.as_tensor(resize_weights(old_grid, new_grid), dtype=torch.float32,
                        device=pos.device)
    grid = patch_pos.float().reshape(old_grid, old_grid, D)
    grid = torch.einsum("hwd,hy,wx->yxd", grid, w, w).to(pos.dtype)
    out = grid.reshape(1, new_grid * new_grid, D)
    return out if cls_pos is None else torch.cat([cls_pos, out], dim=1)


class ViTSelfAttention(nn.Module):
    """HF-style attention: separate query/key/value Linears + output."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        D = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.query = nn.Linear(D, D)
        self.key = nn.Linear(D, D)
        self.value = nn.Linear(D, D)
        self.output = nn.Linear(D, D)

    def forward(self, x, mask=None):
        """``mask``: optional additive bias broadcastable to (B, heads, N, N)
        (plain path); without it the attention runs through K1."""
        B, N, D = x.shape
        hd = D // self.num_heads
        q = self.query(x).reshape(B, N, self.num_heads, hd)
        k = self.key(x).reshape(B, N, self.num_heads, hd)
        v = self.value(x).reshape(B, N, self.num_heads, hd)
        if mask is None:
            out = A.dot_product_attention(q, k, v)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * (hd ** -0.5)
            scores = scores + mask.to(scores.dtype)
            probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.output(out.reshape(B, N, D))


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        D = cfg.hidden_size
        self.cfg = cfg
        self.norm1 = nn.LayerNorm(D, eps=cfg.layernorm_eps)
        self.attention = ViTSelfAttention(cfg)
        self.norm2 = nn.LayerNorm(D, eps=cfg.layernorm_eps)
        self.fc1 = nn.Linear(D, cfg.mlp_dim)
        self.fc2 = nn.Linear(cfg.mlp_dim, D)
        if cfg.use_layerscale:
            self.layerscale1 = nn.Parameter(torch.ones(D))
            self.layerscale2 = nn.Parameter(torch.ones(D))

    def forward(self, x, mask=None):
        c = self.cfg
        h = self.attention(self.norm1(x), mask)
        if c.use_layerscale:
            h = h * self.layerscale1.to(h.dtype)
        x = x + h
        h = self.fc1(self.norm2(x))
        if c.quick_gelu:
            h = quick_gelu(h)
        elif c.gelu_tanh:
            h = gelu_tanh(h)
        else:
            h = gelu_erf(h)
        h = self.fc2(h)
        if c.use_layerscale:
            h = h * self.layerscale2.to(h.dtype)
        return x + h


class CastLayerNorm(nn.LayerNorm):
    """flax's ``LayerNorm(dtype=...)`` over float32 parameters: statistics
    and normalisation in float32, the output in the input's dtype."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def master_weights_(module: nn.Module, compute_dtype: torch.dtype) -> nn.Module:
    """Make ``module`` (float32 parameters) compute in ``compute_dtype``:
    its Linears become ``CastLinear``, its LayerNorms :class:`CastLayerNorm`
    (parameters, names and tensors unchanged), and every submodule with a
    ``compute_dtype`` attribute (the towers) casts its embeddings to it."""
    cast_linears_(module, compute_dtype)
    for parent in list(module.modules()):
        for name, child in list(parent.named_children()):
            if type(child) is nn.LayerNorm:
                new = CastLayerNorm(child.normalized_shape, eps=child.eps, device="meta")
                new.weight, new.bias = child.weight, child.bias
                setattr(parent, name, new)
        if hasattr(parent, "compute_dtype"):
            parent.compute_dtype = compute_dtype
    return module


class ViTEncoder(nn.Module):
    """Patchify -> [CLS] -> +pos -> [pre LayerNorm] -> blocks -> final
    LayerNorm."""

    # None: compute in the weights' dtype (serving); set by master_weights_
    compute_dtype = None

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        D, p = cfg.hidden_size, cfg.patch_size
        self.patch_embed = nn.Linear(p * p * cfg.num_channels, D, bias=cfg.patch_bias)
        n_pos = (cfg.image_size // p) ** 2 + (1 if cfg.use_cls_token else 0)
        self.pos_embed = nn.Parameter(torch.empty(1, n_pos, D))
        if cfg.use_cls_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        if cfg.use_pre_norm:
            self.pre_norm = nn.LayerNorm(D, eps=cfg.layernorm_eps)
        self.blocks = nn.ModuleList(ViTBlock(cfg) for _ in range(cfg.num_layers))
        self.final_norm = nn.LayerNorm(D, eps=cfg.layernorm_eps)

    @torch.no_grad()
    def init_special_(self, generator):
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        if self.cfg.use_cls_token:
            self.cls_token.zero_()

    def _dtype(self) -> torch.dtype:
        return self.compute_dtype or self.patch_embed.weight.dtype

    def embed(self, pixels):
        """pixels (B, H, W, C) -> [CLS] + patch tokens + positions, in the
        compute dtype (before the pre LayerNorm)."""
        c = self.cfg
        B, H, W, Cc = pixels.shape
        p = c.patch_size
        dt = self._dtype()
        # VALID patchify: trailing pixels that do not fill a patch drop
        # (384 / 14 -> a 27 x 27 grid).
        gh, gw = (H - p) // p + 1, (W - p) // p + 1
        x = pixels[:, : gh * p, : gw * p].to(dt)
        x = x.reshape(B, gh, p, gw, p, Cc).permute(0, 1, 3, 2, 4, 5)
        x = self.patch_embed(x.reshape(B, gh * gw, p * p * Cc))
        if c.use_cls_token:
            x = torch.cat([self.cls_token.to(dt).expand(B, 1, -1), x], dim=1)
        return x + interpolate_pos_embed(self.pos_embed, gh, c.image_size // p,
                                         c.use_cls_token).to(dt)

    def forward(self, pixels):
        """pixels: (B, H, W, C) already normalised, channels-last."""
        x = self.embed(pixels)
        if self.cfg.use_pre_norm:
            x = self.pre_norm(x)
        for blk in self.blocks:
            x = blk(x)
        return self.final_norm(x)


class DinoV2Encoder(nn.Module):
    """Pooled CLS embedding (B, D)."""

    def __init__(self, cfg: ViTConfig = DINOV2_SMALL):
        super().__init__()
        self.vit = ViTEncoder(cfg)

    def forward(self, pixels):
        return self.vit(pixels)[:, 0]


class SiglipVisionEncoder(nn.Module):
    """Post-layernormed patch tokens (B, N, D)."""

    def __init__(self, cfg: ViTConfig = SIGLIP_SO400M):
        super().__init__()
        self.vit = ViTEncoder(cfg)

    def forward(self, pixels):
        return self.vit(pixels)


def init_vit(module_cls, cfg: ViTConfig, seed: int = 0, device=None,
             dtype=torch.bfloat16) -> nn.Module:
    """A seeded random encoder (``DinoV2Encoder``/``SiglipVisionEncoder``)."""
    from vla_touch_tpu_torch.utils.random_init import build_module

    return build_module(lambda: module_cls(cfg), seed, device, dtype)
