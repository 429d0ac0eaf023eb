"""BRIDGeR diffusion refinement controller (counterpart of
``vla_touch_tpu/models/controllers/bridge.py``, inference only).

A 3-layer exact-GELU MLP encodes [DinoV2 CLS x2, state, force] into the
conditioning vector; the stochastic-interpolants SDE transports the
normalised VLA chunk (prior x0) toward an expert-like chunk with the EMA
weights of the v/s UNets; padded min-max normalisation on both ends.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vla_touch_tpu_torch.config import BridgeControllerConfig
from vla_touch_tpu_torch.models.controllers import interpolants as SI
from vla_touch_tpu_torch.models.controllers import unet1d_serve as US
from vla_touch_tpu_torch.models.controllers.unet1d import SITripleUnet
from vla_touch_tpu_torch.ops.nn import gelu_erf
from vla_touch_tpu_torch.utils.normalization import (denormalize_actions,
                                                     normalize_actions)


class BridgeControllerModule(nn.Module):
    """Observation encoder + the b/v/s UNet bundle.  For deployment the
    ``si`` nets hold the EMA weights (``utils.from_flax.bridge_controller``)."""

    def __init__(self, cfg: BridgeControllerConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_dim
        self.se_fc1 = nn.Linear(cfg.raw_obs_dim, h)
        self.se_fc2 = nn.Linear(h, h)
        self.se_fc3 = nn.Linear(h, h)
        self.si = SITripleUnet(cfg.state_dim, global_cond_dim=h,
                               down_dims=tuple(cfg.unet_down_dims))

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


def init_bridge_controller(cfg: BridgeControllerConfig, seed: int = 0,
                           device=None) -> BridgeControllerModule:
    """A seeded random controller (float32; the SDE casts once to
    ``cfg.inference_dtype`` through :func:`stacked_vs`)."""
    from vla_touch_tpu_torch.utils.random_init import build_module

    return build_module(lambda: BridgeControllerModule(cfg), seed, device)


def stacked_vs(module: BridgeControllerModule) -> dict:
    """The v/s nets stacked for the serving UNet, cast once to the
    inference dtype (68.5 M parameters at the deployment widths)."""
    return US.stack_unets([module.si.v_net, module.si.s_net],
                          dtype=module.cfg.unet_dtype)


@torch.inference_mode()
def bridge_predict(cfg: BridgeControllerConfig, module: BridgeControllerModule,
                   stats, state, vla_actions, cam1_feat=None, cam2_feat=None,
                   forces=None, diffuse_steps: Optional[int] = None,
                   stacked: Optional[dict] = None, noise_seq=None,
                   generator: Optional[torch.Generator] = None):
    """Refine a VLA chunk.  state (B, state_dim); vla_actions (B, H,
    state_dim) -> (B, H, state_dim) in raw action units.

    ``stacked``: :func:`stacked_vs` output, computed here when absent.
    ``noise_seq`` (n_steps, B, H, state_dim) fixes the SDE's Brownian
    increments; otherwise ``generator`` draws them.
    """
    if cfg.interpolant.sde_type != "vs":
        raise NotImplementedError("the serving path runs the 'vs' SDE")
    obs_cond = module.encode_obs(state, cam1_feat, cam2_feat, forces)
    vla_n = normalize_actions(vla_actions.float(), stats, "vla")
    if stacked is None:
        stacked = stacked_vs(module)
    down_dims = tuple(cfg.unet_down_dims)

    def vs_fused(x, t, c):
        out = US.unet_forward_stacked(stacked, x, t, c, down_dims=down_dims)
        return out[0], out[1]

    refined = SI.sde_sample(cfg.interpolant, {"vs_fused": vs_fused}, vla_n,
                            obs_cond, diffuse_steps or cfg.interpolant.diffusion_steps,
                            noise_seq=noise_seq, generator=generator)
    return denormalize_actions(refined, stats, "expert")
