"""BRIDGeR diffusion refinement controller (counterpart of
``vla_touch_tpu/models/controllers/bridge.py``).

A 3-layer exact-GELU MLP encodes [DinoV2 CLS x2, state, force] into the
conditioning vector; a stochastic-interpolants b/v/s UNet bundle
transports the normalised VLA chunk (prior x0) toward an expert-like chunk;
padded min-max normalisation on both ends.  Training (float32, autograd)
runs the per-network UNets of ``unet1d.py``; the SDE runs the EMA weights
of the v/s (or b/s) pair through the stacked serving UNet and kernel K2.

Checkpoints are the JAX package's: ``controller.msgpack`` (the parameter
tree, force decoder included), ``bridge_model.msgpack`` (``{"ema",
"num_updates"}``, the EMA of the ``si`` tree), ``stats.json`` and
``model_args.json``, in flax's msgpack layout (``utils/checkpoint.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from vla_touch_tpu_torch.config import BridgeControllerConfig, InterpolantConfig
from vla_touch_tpu_torch.models.controllers import interpolants as SI
from vla_touch_tpu_torch.models.controllers import unet1d_serve as US
from vla_touch_tpu_torch.models.controllers.unet1d import SITripleUnet
from vla_touch_tpu_torch.ops.nn import gelu_erf
from vla_touch_tpu_torch.utils import checkpoint as ckpt
from vla_touch_tpu_torch.utils import ema as ema_lib
from vla_touch_tpu_torch.utils.normalization import (denormalize_actions,
                                                     normalize_actions)


class BridgeControllerModule(nn.Module):
    """Observation encoder, the b/v/s UNet bundle and, with
    ``force_decoder`` (training, ``cfg.use_force``), the auxiliary force
    reconstruction head ``fd_fc1..3``.  A deployable module (no decoder)
    holds the EMA weights in ``si`` (:func:`deployable`)."""

    def __init__(self, cfg: BridgeControllerConfig, force_decoder: bool = False):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_dim
        self.se_fc1 = nn.Linear(cfg.raw_obs_dim, h)
        self.se_fc2 = nn.Linear(h, h)
        self.se_fc3 = nn.Linear(h, h)
        self.si = SITripleUnet(cfg.state_dim, global_cond_dim=h,
                               down_dims=tuple(cfg.unet_down_dims))
        if force_decoder and cfg.use_force:
            self.fd_fc1 = nn.Linear(h, h)
            self.fd_fc2 = nn.Linear(h, h // 2)
            self.fd_fc3 = nn.Linear(h // 2, cfg.force_dim)

    def encode_obs(self, state, cam1_feat=None, cam2_feat=None, forces=None):
        """[cam1, cam2, state(, force)] -> obs_cond (B, hidden_dim)."""
        parts = []
        if self.cfg.use_visual:
            parts += [cam1_feat, cam2_feat]
        parts.append(state)
        if self.cfg.use_force:
            parts.append(forces)
        x = torch.cat([p.to(self.se_fc1.weight.dtype) for p in parts], dim=-1)
        x = gelu_erf(self.se_fc1(x))
        x = gelu_erf(self.se_fc2(x))
        return self.se_fc3(x)

    def decode_force(self, obs_cond):
        """Auxiliary force reconstruction from the conditioning vector."""
        x = gelu_erf(self.fd_fc1(obs_cond))
        x = gelu_erf(self.fd_fc2(x))
        return self.fd_fc3(x)

    def nets(self) -> dict:
        """(x, t, cond) -> prediction callables of the live b/v/s nets."""
        return {"b": self.si.b_net, "v": self.si.v_net, "s": self.si.s_net}


@dataclasses.dataclass
class BridgeControllerState:
    """The trainable module (force decoder included), the EMA of its
    ``si`` nets (names relative to ``si``) and the normalisation stats."""

    cfg: BridgeControllerConfig
    module: BridgeControllerModule
    ema: ema_lib.EmaState
    stats: Optional[dict] = None


def init_bridge_controller(cfg: BridgeControllerConfig, seed: int = 0,
                           device=None) -> BridgeControllerState:
    """A seeded random controller in float32 on ``device`` (default CUDA),
    its parameters trainable, its EMA a copy of ``si``."""
    from vla_touch_tpu_torch.utils.random_init import build_module

    module = build_module(lambda: BridgeControllerModule(cfg, force_decoder=True), seed,
                          device).requires_grad_(True).train()
    return BridgeControllerState(cfg=cfg, module=module, ema=ema_lib.init(module.si))


@torch.no_grad()
def deployable(st: BridgeControllerState) -> BridgeControllerModule:
    """The serving module: the observation encoder of ``st.module`` and the
    EMA weights as ``si`` (the force decoder dropped), frozen."""
    with torch.device("meta"):
        m = BridgeControllerModule(st.cfg)
    m = m.to_empty(device=st.module.se_fc1.weight.device)
    for name, p in m.named_parameters():
        src = (st.ema.shadow[name[len("si."):]] if name.startswith("si.")
               else st.module.get_parameter(name))
        p.copy_(src)
    return m.eval().requires_grad_(False)


def stacked_vs(module: BridgeControllerModule) -> dict:
    """The v/s nets stacked for the serving UNet, cast once to the
    inference dtype (68.5 M parameters at the deployment widths)."""
    return US.stack_unets([module.si.v_net, module.si.s_net], dtype=module.cfg.unet_dtype)


def stacked_bs(module: BridgeControllerModule) -> dict:
    """The b/s nets stacked for the serving UNet ('bs' SDE)."""
    return US.stack_unets([module.si.b_net, module.si.s_net], dtype=module.cfg.unet_dtype)


@torch.inference_mode()
def bridge_predict(cfg: BridgeControllerConfig, module: BridgeControllerModule,
                   stats, state, vla_actions, cam1_feat=None, cam2_feat=None,
                   forces=None, diffuse_steps: Optional[int] = None,
                   stacked: Optional[dict] = None, noise_seq=None,
                   generator: Optional[torch.Generator] = None):
    """Refine a VLA chunk.  state (B, state_dim); vla_actions (B, H,
    state_dim) -> (B, H, state_dim) in raw action units.

    The SDE is ``cfg.interpolant.sde_type``: 'vs' evaluates the stacked v/s
    pair, 'bs' the b/s pair, each pair in one stacked UNet pass per step.
    ``stacked``: that pair (:func:`stacked_vs` / :func:`stacked_bs`),
    computed here when absent.  ``noise_seq`` (n_steps, B, H, state_dim)
    fixes the SDE's Brownian increments; otherwise ``generator`` draws them.
    """
    sde = cfg.interpolant.sde_type
    if sde not in ("vs", "bs"):
        raise NotImplementedError(sde)
    obs_cond = module.encode_obs(state, cam1_feat, cam2_feat, forces)
    vla_n = normalize_actions(vla_actions.float(), stats, "vla")
    if stacked is None:
        stacked = stacked_vs(module) if sde == "vs" else stacked_bs(module)
    down_dims = tuple(cfg.unet_down_dims)

    def pair(x, t, c):
        out = US.unet_forward_stacked(stacked, x, t, c, down_dims=down_dims)
        return out[0], out[1]

    refined = SI.sde_sample(cfg.interpolant, {f"{sde}_fused": pair}, vla_n, obs_cond,
                            diffuse_steps or cfg.interpolant.diffusion_steps,
                            noise_seq=noise_seq, generator=generator)
    return denormalize_actions(refined, stats, "expert")


def _si_losses(cfg: BridgeControllerConfig, module: BridgeControllerModule, batch: dict,
               draws: Optional[dict], generator: Optional[torch.Generator]):
    obs = module.encode_obs(batch["state"], batch.get("cam1_feat"), batch.get("cam2_feat"),
                            batch.get("forces"))
    return obs, SI.si_training_loss(cfg.interpolant, module.nets(), obs, batch["expert_act"],
                                    batch.get("vla_act"), draws, generator)


def bridge_loss(cfg: BridgeControllerConfig, module: BridgeControllerModule, batch: dict,
                draws: Optional[dict] = None, generator: Optional[torch.Generator] = None):
    """Training loss: the v+s+b implicit losses on normalised actions.

    ``batch``: normalised ``expert_act``/``vla_act`` (B, H, D), ``state``
    (B, D), optional ``cam1_feat``/``cam2_feat``/``forces``.  ``draws``
    (``interpolants.training_draws``) or ``generator`` give t and z.
    Returns (total, SILosses)."""
    _, losses = _si_losses(cfg, module, batch, draws, generator)
    return losses.total, losses


def bridge_force_reconstruction_loss(cfg: BridgeControllerConfig,
                                     module: BridgeControllerModule, obs_cond, target_force):
    return torch.mean(torch.square(module.decode_force(obs_cond) - target_force))


def bridge_train_loss(cfg: BridgeControllerConfig, module: BridgeControllerModule,
                      batch: dict, draws: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None):
    """The trainer's objective: :func:`bridge_loss` plus, with force on and
    ``batch["current_force"]``, the force reconstruction term.  Returns
    (total, SILosses)."""
    obs, losses = _si_losses(cfg, module, batch, draws, generator)
    total = losses.total
    if cfg.use_force and "current_force" in batch:
        total = total + bridge_force_reconstruction_loss(cfg, module, obs,
                                                         batch["current_force"])
    return total, losses


# ---- checkpoint I/O -------------------------------------------------------------


def save_bridge_controller(path: str, st: BridgeControllerState) -> None:
    from vla_touch_tpu_torch.utils.from_flax import to_flax

    os.makedirs(path, exist_ok=True)
    ckpt.save_pytree(os.path.join(path, "controller.msgpack"), to_flax(st.module))
    ckpt.save_pytree(os.path.join(path, "bridge_model.msgpack"),
                     {"ema": to_flax(st.module.si, st.ema.shadow),
                      "num_updates": np.asarray(int(st.ema.num_updates), np.int32)})
    if st.stats is not None:
        ckpt.save_stats(os.path.join(path, "stats.json"), st.stats)
    ckpt.save_json(os.path.join(path, "model_args.json"), dataclasses.asdict(st.cfg))


def config_from_json(raw: dict) -> BridgeControllerConfig:
    raw = dict(raw)
    raw["interpolant"] = InterpolantConfig(**raw["interpolant"])
    raw["unet_down_dims"] = tuple(raw["unet_down_dims"])
    return BridgeControllerConfig(**raw)


def load_bridge_controller(path: str, cfg: Optional[BridgeControllerConfig] = None,
                           device=None) -> BridgeControllerState:
    """A checkpoint written by this module or by the JAX package's
    ``save_bridge_controller``, on ``device`` (default CUDA)."""
    from vla_touch_tpu_torch.utils import from_flax as FF
    from vla_touch_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if cfg is None:
        cfg = config_from_json(ckpt.load_json(os.path.join(path, "model_args.json")))
    with torch.device("meta"):
        module = BridgeControllerModule(cfg, force_decoder=True)
    module = module.to_empty(device=dev)
    FF.load_into(module, FF.bridge_controller_full(
        ckpt.load_pytree(os.path.join(path, "controller.msgpack"))))
    blob = ckpt.load_pytree(os.path.join(path, "bridge_model.msgpack"))
    shadow = FF.unet_bundle(blob["ema"])
    own = dict(module.si.named_parameters())
    if set(shadow) != set(own):
        raise KeyError(f"bridge_model.msgpack: EMA names differ from si: "
                       f"{sorted(set(shadow) ^ set(own))[:8]}")
    ema = ema_lib.EmaState(
        shadow={k: torch.from_numpy(np.array(v, np.float32)).to(dev) for k, v in shadow.items()},
        num_updates=torch.as_tensor(np.asarray(blob["num_updates"]), dtype=torch.int32))
    stats = None
    stats_path = os.path.join(path, "stats.json")
    if os.path.exists(stats_path):
        stats = ckpt.load_stats(stats_path)
    return BridgeControllerState(cfg=cfg, module=module.requires_grad_(True).train(),
                                 ema=ema, stats=stats)
