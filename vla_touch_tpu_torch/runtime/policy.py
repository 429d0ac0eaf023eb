"""Deployment policy wrapper: the VLA inference API (counterpart of
``vla_touch_tpu/runtime/policy.py``).

``step(proprio, images, text_embeds)`` packs the low-dim state into the
128-D unified vector with its availability mask, SigLIP-encodes the
6-image window (2 frames x [exterior, right wrist, left wrist]; missing
cameras become the SigLIP-mean background), runs the DPM-Solver++
``rdt_predict_action`` and unpacks the chunk back to robot units.  A
:class:`QuantRDTRunner` (``models/rdt/quant_serve.py``) as ``rdt`` routes
the chunk to the int8/int4 serving twin, with ``kv_cache`` picking its
condition cache; a :class:`ViTServe` (``models/encoders/vit_serve.py``) as
``vision`` routes SigLIP to its serving twin.

``step(..., prior_actions=, skip_steps=)`` is the steady-state replan: the
previous chunk, shifted by the executed ticks, is re-noised and only the
solver's tail runs (:func:`policy_step_cached_warm` with the t-1 frames'
cached tokens, :func:`policy_step_warm` without).

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

from vla_touch_tpu_torch.models.encoders import vit_serve as VS
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


def franka_joint_policy_config(**kw) -> PolicyConfig:
    """8-D joint-space Franka: the gripper's proprio divides by 4.7888, its
    action multiplies by 13.9231."""
    return PolicyConfig(state_indices=tuple(SV.FRANKA_JOINT_STATE_INDICES),
                        state_scale=tuple([1.0] * 7 + [4.7888]),
                        action_scale=tuple([1.0] * 7 + [13.9231]), **kw)


def aloha_policy_config(**kw) -> PolicyConfig:
    """14-D bimanual ALOHA joints at 25 Hz."""
    return PolicyConfig(state_indices=tuple(SV.ALOHA_STATE_INDICES),
                        state_scale=tuple([1.0] * 14), control_frequency=25.0, **kw)


def _device_of(module) -> torch.device:
    """The device of a module's first parameter or buffer (the serving
    twins hold their weights as buffers)."""
    return next(itertools.chain(module.parameters(), module.buffers())).device


def _encode_frames(cfg: PolicyConfig, vision, images, image_mask, dtype, absent=(),
                   bg_tokens=None):
    """(B, nf, S, S, 3) frames -> (B, nf*729, C) SigLIP tokens.  ``vision``
    is the port's ``SiglipVisionEncoder`` or its serving twin
    (:func:`vit_serve.quantize_vit_params`), told apart by type.

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
    flat = x.reshape(B * nf, S, S, 3)
    if VS.is_vit_serve_tree(vision):
        tokens = vision(flat, dtype=dtype)
    else:
        tokens = vision(flat.to(dtype))
    return tokens.reshape(B, -1, tokens.shape[-1]).to(dtype)


@torch.inference_mode()
def encode_background_tokens(cfg: PolicyConfig, vision):
    """SigLIP tokens (729, C) of the padded-background frame."""
    dev = _device_of(vision)
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
                         kv_cache: str = "bf16", prior_actions=None, skip_steps: int = 0):
    """State pack + denoise + unpack.  A :class:`QuantRDTRunner` goes to the
    quantized twin (``kv_cache`` picks its condition cache), anything else
    to the bf16 runner, whose cache is bf16.  ``prior_actions`` (B,
    horizon, D_low) in raw robot units, already shifted by the executed
    ticks, with ``skip_steps`` > 0 warm-starts the solver's tail; it is
    packed into the 128-wide vector only then."""
    m = cfg.rdt.model
    B = proprio.shape[0]
    dev = proprio.device
    dtype = m.compute_dtype
    # JAX's jit divides by a constant scale as a product with its float32
    # reciprocal; so does the port, on the CPU and the card alike
    recip = torch.tensor(np.float32(1) / np.asarray(cfg.state_scale, np.float32), device=dev)
    idx = torch.tensor(cfg.state_indices, dtype=torch.long, device=dev)
    state = torch.zeros((B, m.state_token_dim), dtype=torch.float32, device=dev)
    state[:, idx] = proprio.float() * recip
    mask = torch.zeros((B, m.state_token_dim), dtype=torch.float32, device=dev)
    mask[:, idx] = 1.0
    out_scale = np.asarray(cfg.action_scale if cfg.action_scale is not None
                           else cfg.state_scale, np.float32)
    prior128 = None
    if prior_actions is not None and skip_steps > 0:
        out_recip = torch.tensor(np.float32(1) / out_scale, device=dev)
        prior128 = torch.zeros((B, m.horizon, m.output_dim), dtype=torch.float32, device=dev)
        prior128[:, :, idx] = torch.as_tensor(prior_actions, device=dev).float() * out_recip
    args = (cfg.rdt, rdt, text_embeds.to(dtype), text_mask, img_tokens.to(dtype),
            state[:, None, :].to(dtype), mask[:, None, :],
            torch.full((B,), cfg.control_frequency, dtype=torch.float32, device=dev))
    kw = dict(init_noise=init_noise, generator=generator, prior_chunk=prior128,
              skip_steps=skip_steps)
    if isinstance(rdt, Q.QuantRDTRunner):
        chunk = Q.rdt_predict_action_quant(*args, kv_cache=kv_cache, **kw)
    else:
        chunk = R.rdt_predict_action(*args, **kw)
    return chunk[:, :, idx] * torch.tensor(out_scale, device=dev)


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
    return policy_step_warm(cfg, rdt, vision, proprio, images, image_mask, text_embeds,
                            text_mask, None, 0, absent, bg_tokens, init_noise, generator,
                            kv_cache)


@torch.inference_mode()
def policy_step_warm(cfg: PolicyConfig, rdt, vision, proprio, images, image_mask,
                     text_embeds, text_mask, prior_actions, skip_steps: int, absent=(),
                     bg_tokens=None, init_noise=None, generator=None,
                     kv_cache: str = "bf16"):
    """:func:`policy_step` warm-started: ``prior_actions`` (B, horizon,
    D_low), the previous chunk in raw robot units already shifted by the
    executed ticks, seeds the solver at step ``skip_steps``."""
    tokens = _encode_frames(cfg, vision, images, image_mask,
                            cfg.rdt.model.compute_dtype, absent, bg_tokens)
    return _predict_from_tokens(cfg, rdt, proprio, tokens, text_embeds, text_mask,
                                init_noise, generator, kv_cache, prior_actions, skip_steps)


@torch.inference_mode()
def policy_step_cached(cfg: PolicyConfig, rdt, vision, proprio, new_images,
                       new_image_mask, prev_tokens, text_embeds, text_mask,
                       absent=(), bg_tokens=None, init_noise=None,
                       generator=None, kv_cache: str = "bf16"):
    """Replan reusing the previous call's tokens of the t-1 frames; SigLIP
    runs on the 3 new frames only.  Returns ``(actions, cur_tokens)``."""
    return policy_step_cached_warm(cfg, rdt, vision, proprio, new_images, new_image_mask,
                                   prev_tokens, text_embeds, text_mask, None, 0, absent,
                                   bg_tokens, init_noise, generator, kv_cache)


@torch.inference_mode()
def policy_step_cached_warm(cfg: PolicyConfig, rdt, vision, proprio, new_images,
                            new_image_mask, prev_tokens, text_embeds, text_mask,
                            prior_actions, skip_steps: int, absent=(), bg_tokens=None,
                            init_noise=None, generator=None, kv_cache: str = "bf16"):
    """The steady-state replan: the t-1 frames' cached tokens and a
    warm-started solver tail.  Contracts of :func:`policy_step_cached`
    (returns ``(actions, cur_tokens)``) and :func:`policy_step_warm`."""
    dtype = cfg.rdt.model.compute_dtype
    cur = _encode_frames(cfg, vision, new_images, new_image_mask, dtype,
                         absent, bg_tokens)
    tokens = torch.cat([prev_tokens.to(dtype), cur], dim=1)
    actions = _predict_from_tokens(cfg, rdt, proprio, tokens, text_embeds, text_mask,
                                   init_noise, generator, kv_cache, prior_actions,
                                   skip_steps)
    return actions, cur


def _frame_digest(frames: np.ndarray, mask: np.ndarray) -> int:
    return zlib.crc32(mask.tobytes() + np.ascontiguousarray(frames).tobytes())


class RoboticDiffusionTransformerModel:
    """Stateful wrapper with the reference class name and API.

    ``cache_frames`` (default True) skips re-encoding the t-1 frames when
    they are byte-identical to the previous call's t frames (checked with a
    content digest).  ``absent_cameras`` are cameras this deployment never
    provides; SigLIP skips them and splices background tokens.  ``kv_cache``
    is the condition cache of a quantized ``rdt`` ('bf16' | 'int8' |
    'int8t' | 'int8x'; the bf16 runner's is bf16).
    """

    def __init__(self, cfg: PolicyConfig, rdt, vision, cache_frames: bool = True,
                 absent_cameras=(), seed: int = 0, kv_cache: str = "bf16"):
        if kv_cache not in Q.KV_CACHES:
            raise ValueError(f"kv_cache {kv_cache!r} not in {Q.KV_CACHES}")
        self.cfg = cfg
        self.kv_cache = kv_cache
        self.rdt = rdt
        self.vision = vision
        self.device = _device_of(rdt)
        self.cache_frames = cache_frames
        self.absent_cameras = tuple(sorted(absent_cameras))
        self._bg_tokens = None
        self._token_cache = None          # (digest, (1, 3*729, C) tokens)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    @classmethod
    def create(cls, cfg: Optional[PolicyConfig] = None, seed: int = 0, rdt=None,
               vision=None, cache_frames: bool = True, absent_cameras=(),
               device=None, kv_cache: str = "bf16"):
        """Random weights from ``seed`` unless ``rdt``/``vision`` are given."""
        cfg = cfg or PolicyConfig()
        dev = resolve_device(device)
        if rdt is None:
            rdt = R.init_rdt(cfg.rdt, seed=seed, device=dev)
        if vision is None:
            vision = init_vit(SiglipVisionEncoder, cfg.vision, seed=seed + 1,
                              device=dev, dtype=cfg.rdt.model.compute_dtype)
        return cls(cfg, rdt, vision, cache_frames=cache_frames,
                   absent_cameras=absent_cameras, seed=seed, kv_cache=kv_cache)

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
             prior_actions=None, skip_steps: int = 0, init_noise=None) -> np.ndarray:
        """images: 6 HxWx3 uint8 arrays or None (missing camera).  Returns
        (1, horizon, D_low) actions.  ``prior_actions`` (horizon, D_low),
        the previous chunk shifted by the executed ticks, with
        ``skip_steps`` > 0 warm-starts the replan; with the frame-token
        cache that is the steady-state dispatch.  ``init_noise`` (1,
        horizon, 128) fixes the solver's starting (or re-noising) noise;
        otherwise the model's generator draws it."""
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
        kw = dict(init_noise=init_noise, generator=self.generator, kv_cache=self.kv_cache)
        warm = prior_actions is not None and skip_steps > 0
        prior = None
        if warm:
            prior = torch.as_tensor(np.asarray(prior_actions, np.float32)
                                    .reshape(1, -1, len(cfg.state_indices)), device=dev)

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
            out, cur = policy_step_cached_warm(
                cfg, self.rdt, self.vision, proprio_t, *dev_frames(slice(3, 6)),
                prev_tokens, text_t, tmask_t, prior, skip_steps if warm else 0,
                absent=ab3, bg_tokens=bg, **kw)
            self._token_cache = (_frame_digest(frames[:, 3:], mask[:, 3:]), cur)
        elif warm:
            ab6, bg = self._absent(6)
            out = policy_step_warm(cfg, self.rdt, self.vision, proprio_t,
                                   *dev_frames(slice(0, 6)), text_t, tmask_t, prior,
                                   skip_steps, absent=ab6, bg_tokens=bg, **kw)
        else:
            ab6, bg = self._absent(6)
            out = policy_step(cfg, self.rdt, self.vision, proprio_t,
                              *dev_frames(slice(0, 6)), text_t, tmask_t,
                              absent=ab6, bg_tokens=bg, **kw)
        return out.cpu().numpy()


def create_model(cfg: Optional[PolicyConfig] = None, **kw):
    """Reference-named factory."""
    return RoboticDiffusionTransformerModel.create(cfg, **kw)
