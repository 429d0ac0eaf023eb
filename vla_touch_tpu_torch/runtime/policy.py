"""Deployment policy wrapper: the VLA inference API (counterpart of
``vla_touch_tpu/runtime/policy.py``, cold paths).

``step(proprio, images, text_embeds)`` packs the low-dim state into the
128-D unified vector with its availability mask, SigLIP-encodes the
6-image window (2 frames x [exterior, right wrist, left wrist]; missing
cameras become the SigLIP-mean background), runs the DPM-Solver++
``rdt_predict_action`` and unpacks the chunk back to robot units.  A
:class:`QuantRDTRunner` (``models/rdt/quant_serve.py``) as ``rdt`` routes
the chunk to the int8/int4 serving twin, with ``kv_cache`` picking its
condition cache.

The JAX PRNG key becomes an explicit ``init_noise`` tensor or a
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import itertools
import zlib
from typing import Optional, Sequence

import numpy as np
import torch

from vla_touch_tpu_torch.models.encoders.vit import (
    SIGLIP_SO400M, SiglipVisionEncoder, ViTConfig, init_vit)
from vla_touch_tpu_torch.models.rdt import quant_serve as Q
from vla_touch_tpu_torch.models.rdt import runner as R
from vla_touch_tpu_torch.utils import state_vec as SV
from vla_touch_tpu_torch.utils.device import resolve_device
from vla_touch_tpu_torch.utils.image import (pad_and_resize_for_siglip,
                                             siglip_normalize)


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    rdt: R.RDTRunnerConfig = dataclasses.field(default_factory=R.RDTRunnerConfig)
    vision: ViTConfig = SIGLIP_SO400M
    state_indices: tuple = tuple(SV.FRANKA_EEF_STATE_INDICES)
    # Per-dim proprio scale divided out before packing (gripper / 255).
    state_scale: tuple = tuple([1.0] * 9 + [255.0])
    # Per-dim ACTION scale multiplied back on unpack; None = state_scale.
    action_scale: tuple = None
    control_frequency: float = 10.0
    image_size: int = 384
    img_history_size: int = 2
    num_cameras: int = 3


def franka_eef_policy_config(**kw) -> PolicyConfig:
    return PolicyConfig(**kw)


def _encode_frames(cfg: PolicyConfig, vision: SiglipVisionEncoder, images,
                   image_mask, dtype, absent=(), bg_tokens=None):
    """(B, nf, S, S, 3) frames -> (B, nf*729, C) SigLIP tokens.

    ``absent`` frame indices + ``bg_tokens`` (729, C) from
    :func:`encode_background_tokens`: frames that are always the padded
    background skip the tower and their constant tokens are spliced in."""
    B, nf = images.shape[:2]
    absent = tuple(sorted(absent))
    if absent and bg_tokens is not None and 0 < len(absent) < nf:
        present = [i for i in range(nf) if i not in absent]
        sub = _encode_frames(cfg, vision, images[:, present],
                             image_mask[:, present], dtype)
        sub = sub.reshape(B, len(present), -1, sub.shape[-1])
        bg = bg_tokens.to(dtype)[None].expand((B,) + tuple(bg_tokens.shape))
        parts, j = [], 0
        for i in range(nf):
            if i in absent:
                parts.append(bg)
            else:
                parts.append(sub[:, j])
                j += 1
        return torch.cat(parts, dim=1)
    x = siglip_normalize(images)
    x = torch.where(image_mask[:, :, None, None, None], x, torch.zeros_like(x))
    S = cfg.image_size
    tokens = vision(x.reshape(B * nf, S, S, 3).to(dtype))
    return tokens.reshape(B, -1, tokens.shape[-1]).to(dtype)


@torch.inference_mode()
def encode_background_tokens(cfg: PolicyConfig, vision: SiglipVisionEncoder):
    """SigLIP tokens (729, C) of the padded-background frame."""
    dev = next(vision.parameters()).device
    S = cfg.image_size
    z = torch.zeros((1, 1, S, S, 3), dtype=torch.float32, device=dev)
    return _encode_frames(cfg, vision, z, torch.zeros((1, 1), dtype=torch.bool,
                                                      device=dev),
                          cfg.rdt.model.compute_dtype)[0]


@torch.inference_mode()
def encode_frames(cfg: PolicyConfig, vision, images, image_mask, absent=(),
                  bg_tokens=None):
    """Standalone frame encoder: (B, nf, S, S, 3) -> (B, nf*729, C)."""
    return _encode_frames(cfg, vision, images, image_mask,
                          cfg.rdt.model.compute_dtype, absent=absent,
                          bg_tokens=bg_tokens)


def _predict_from_tokens(cfg: PolicyConfig, rdt, proprio, img_tokens, text_embeds,
                         text_mask, init_noise=None, generator=None,
                         kv_cache: str = "bf16"):
    """State pack + denoise + unpack.  A :class:`QuantRDTRunner` goes to the
    quantized twin (``kv_cache`` picks its condition cache), anything else
    to the bf16 runner, whose cache is bf16."""
    m = cfg.rdt.model
    B = proprio.shape[0]
    dev = proprio.device
    dtype = m.compute_dtype
    # JAX's jit divides by the constant scale as a product with its float32
    # reciprocal; so does the port, on the CPU and the card alike
    recip = torch.tensor(np.float32(1) / np.asarray(cfg.state_scale, np.float32), device=dev)
    idx = torch.tensor(cfg.state_indices, dtype=torch.long, device=dev)
    state = torch.zeros((B, m.state_token_dim), dtype=torch.float32, device=dev)
    state[:, idx] = proprio.float() * recip
    mask = torch.zeros((B, m.state_token_dim), dtype=torch.float32, device=dev)
    mask[:, idx] = 1.0
    out_scale = torch.tensor(cfg.action_scale if cfg.action_scale is not None
                             else cfg.state_scale, dtype=torch.float32, device=dev)
    args = (cfg.rdt, rdt, text_embeds.to(dtype), text_mask, img_tokens.to(dtype),
            state[:, None, :].to(dtype), mask[:, None, :],
            torch.full((B,), cfg.control_frequency, dtype=torch.float32, device=dev))
    if isinstance(rdt, Q.QuantRDTRunner):
        chunk = Q.rdt_predict_action_quant(*args, init_noise=init_noise,
                                           generator=generator, kv_cache=kv_cache)
    else:
        chunk = R.rdt_predict_action(*args, init_noise=init_noise, generator=generator)
    return chunk[:, :, idx] * out_scale


@torch.inference_mode()
def policy_step(cfg: PolicyConfig, rdt, vision, proprio, images, image_mask,
                text_embeds, text_mask, absent=(), bg_tokens=None,
                init_noise=None, generator=None, kv_cache: str = "bf16"):
    """One action-chunk inference.

    proprio (B, D_low) raw robot state; images (B, 6, S, S, 3) uint8 frames
    [ext_{t-1}, right_{t-1}, left_{t-1}, ext_t, right_t, left_t];
    image_mask (B, 6) bool; text_embeds (B, L, 4096); text_mask (B, L) bool;
    ``kv_cache`` ('bf16' | 'int8' | 'int8t' | 'int8x') the condition cache
    of a quantized ``rdt``.  Returns (B, horizon, D_low) actions in raw
    robot units.
    """
    tokens = _encode_frames(cfg, vision, images, image_mask,
                            cfg.rdt.model.compute_dtype, absent, bg_tokens)
    return _predict_from_tokens(cfg, rdt, proprio, tokens, text_embeds,
                                text_mask, init_noise, generator, kv_cache)


@torch.inference_mode()
def policy_step_cached(cfg: PolicyConfig, rdt, vision, proprio, new_images,
                       new_image_mask, prev_tokens, text_embeds, text_mask,
                       absent=(), bg_tokens=None, init_noise=None,
                       generator=None, kv_cache: str = "bf16"):
    """Replan reusing the previous call's tokens of the t-1 frames; SigLIP
    runs on the 3 new frames only.  Returns ``(actions, cur_tokens)``."""
    dtype = cfg.rdt.model.compute_dtype
    cur = _encode_frames(cfg, vision, new_images, new_image_mask, dtype,
                         absent, bg_tokens)
    tokens = torch.cat([prev_tokens.to(dtype), cur], dim=1)
    actions = _predict_from_tokens(cfg, rdt, proprio, tokens, text_embeds,
                                   text_mask, init_noise, generator, kv_cache)
    return actions, cur


def _frame_digest(frames: np.ndarray, mask: np.ndarray) -> int:
    return zlib.crc32(mask.tobytes() + np.ascontiguousarray(frames).tobytes())


class RoboticDiffusionTransformerModel:
    """Stateful wrapper with the reference class name and API.

    ``cache_frames`` (default True) skips re-encoding the t-1 frames when
    they are byte-identical to the previous call's t frames (checked with a
    content digest).  ``absent_cameras`` are cameras this deployment never
    provides; SigLIP skips them and splices background tokens.
    """

    def __init__(self, cfg: PolicyConfig, rdt, vision, cache_frames: bool = True,
                 absent_cameras=(), seed: int = 0):
        self.cfg = cfg
        self.rdt = rdt
        self.vision = vision
        # a QuantRDTRunner holds its weights as buffers
        self.device = next(itertools.chain(rdt.parameters(), rdt.buffers())).device
        self.cache_frames = cache_frames
        self.absent_cameras = tuple(sorted(absent_cameras))
        self._bg_tokens = None
        self._token_cache = None          # (digest, (1, 3*729, C) tokens)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @classmethod
    def create(cls, cfg: Optional[PolicyConfig] = None, seed: int = 0, rdt=None,
               vision=None, cache_frames: bool = True, absent_cameras=(),
               device=None):
        """Random weights from ``seed`` unless ``rdt``/``vision`` are given."""
        cfg = cfg or PolicyConfig()
        dev = resolve_device(device)
        if rdt is None:
            rdt = R.init_rdt(cfg.rdt, seed=seed, device=dev)
        if vision is None:
            vision = init_vit(SiglipVisionEncoder, cfg.vision, seed=seed + 1,
                              device=dev, dtype=cfg.rdt.model.compute_dtype)
        return cls(cfg, rdt, vision, cache_frames=cache_frames,
                   absent_cameras=absent_cameras, seed=seed)

    def _absent(self, nf: int):
        if not self.absent_cameras:
            return (), None
        if self._bg_tokens is None:
            self._bg_tokens = encode_background_tokens(self.cfg, self.vision)
        absent = tuple(c + 3 * f for f in range(nf // 3) for c in self.absent_cameras)
        return absent, self._bg_tokens

    def reset(self):
        """Drop cached frame tokens (episode boundary / camera change)."""
        self._token_cache = None

    def step(self, proprio, images: Sequence, text_embeds, text_mask=None,
             init_noise=None) -> np.ndarray:
        """images: 6 HxWx3 uint8 arrays or None (missing camera).  Returns
        (1, horizon, D_low) actions.  ``init_noise`` (1, horizon, 128) fixes
        the solver's starting noise; otherwise the model's generator draws
        it."""
        cfg, dev = self.cfg, self.device
        S = cfg.image_size
        frames = np.zeros((1, 6, S, S, 3), np.uint8)
        mask = np.zeros((1, 6), bool)
        for i, img in enumerate(images):
            if img is None:
                continue
            frames[0, i] = pad_and_resize_for_siglip(np.asarray(img), S)
            mask[0, i] = True
        proprio_t = torch.as_tensor(np.asarray(proprio, np.float32).reshape(1, -1),
                                    device=dev)
        text = np.asarray(text_embeds, np.float32)
        if text.ndim == 2:
            text = text[None]
        text_mask = (np.ones(text.shape[:2], bool) if text_mask is None
                     else np.asarray(text_mask, bool).reshape(text.shape[:2]))
        text_t = torch.as_tensor(text, device=dev)
        tmask_t = torch.as_tensor(text_mask, device=dev)
        kw = dict(init_noise=init_noise, generator=self.generator)

        def dev_frames(sl):
            return (torch.as_tensor(frames[:, sl], device=dev),
                    torch.as_tensor(mask[:, sl], device=dev))

        if self.cache_frames:
            ab3, bg = self._absent(3)
            prev_digest = _frame_digest(frames[:, :3], mask[:, :3])
            if self._token_cache is not None and self._token_cache[0] == prev_digest:
                prev_tokens = self._token_cache[1]
            else:
                prev_tokens = encode_frames(cfg, self.vision, *dev_frames(slice(0, 3)),
                                            absent=ab3, bg_tokens=bg)
            out, cur = policy_step_cached(
                cfg, self.rdt, self.vision, proprio_t, *dev_frames(slice(3, 6)),
                prev_tokens, text_t, tmask_t, absent=ab3, bg_tokens=bg, **kw)
            self._token_cache = (_frame_digest(frames[:, 3:], mask[:, 3:]), cur)
        else:
            ab6, bg = self._absent(6)
            out = policy_step(cfg, self.rdt, self.vision, proprio_t,
                              *dev_frames(slice(0, 6)), text_t, tmask_t,
                              absent=ab6, bg_tokens=bg, **kw)
        return out.cpu().numpy()


def create_model(cfg: Optional[PolicyConfig] = None, **kw):
    """Reference-named factory."""
    return RoboticDiffusionTransformerModel.create(cfg, **kw)
