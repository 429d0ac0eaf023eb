"""Stochastic-interpolants bridge SDE (BRIDGeR) — counterpart of
``vla_touch_tpu/models/controllers/interpolants.py``, sampling only.

The bridge transports the VLA prior chunk x0 toward the expert chunk
through x_t = w0(t) x0 + w1(t) x1 + gamma(t) z, z ~ d N(0, I).  Kept as in
the reference: the SDE noise term is ``dt * sqrt(2 eps(t)) * d * randn``
(dt, not sqrt(dt)); eps and the noise scale use the step's scalar t;
gamma-inverse is clamped to [0, gamma_inv_max].
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vla_touch_tpu_torch.config import InterpolantConfig

_SQRT2 = 1.4142


def epsilon(cfg: InterpolantConfig, t):
    et = cfg.epsilon_type
    if et == "t(t-1)":
        return t * (1 - t)
    if et == "1-t":
        return (1 - t) * 1.0
    if et == "1-sqrt(t)":
        return 1 - t ** 0.5
    if et == "1-t^2":
        return 1 - t * t
    if et == "0":
        return t * 0.0
    raise NotImplementedError(et)


def gamma(cfg: InterpolantConfig, t):
    gt = cfg.gamma_type
    if gt == "(2t(t-1))^0.5":
        return _SQRT2 * torch.sqrt(t * (1 - t))
    if gt == "2^0.5*t(t-1)":
        return _SQRT2 * t * (1 - t)
    if gt == "(1-t)^2(2t)^0.5":
        return _SQRT2 * torch.square(1 - t) * torch.sqrt(t)
    raise NotImplementedError(gt)


def gamma_der(cfg: InterpolantConfig, t):
    gt = cfg.gamma_type
    if gt == "(2t(t-1))^0.5":
        return (1 - 2 * t) / torch.sqrt(2 * (t - torch.square(t)) + 1e-4)
    if gt == "2^0.5*t(t-1)":
        return _SQRT2 * (1 - 2 * t)
    if gt == "(1-t)^2(2t)^0.5":
        return _SQRT2 * (2 * (t - 1) * torch.sqrt(t)
                         + torch.square(1 - t) / (2.0 * torch.sqrt(t + 1e-4)))
    raise NotImplementedError(gt)


def gamma_inv(cfg: InterpolantConfig, t):
    gt = cfg.gamma_type
    if gt == "(2t(t-1))^0.5":
        raw = 1 / (_SQRT2 * torch.sqrt(t * (1 - t) + 1e-4))
    elif gt == "2^0.5*t(t-1)":
        raw = 1 / (_SQRT2 * t * (1 - t) + 1e-4)
    elif gt == "(1-t)^2(2t)^0.5":
        raw = 1 / (_SQRT2 * torch.square(1 - t) * torch.sqrt(t) + 1e-4)
    else:
        raise NotImplementedError(gt)
    return torch.clamp(raw, 0.0, cfg.gamma_inv_max)


def _bdims(t, x):
    """Broadcast per-sample t (B,) across x's trailing dims."""
    return t.reshape(t.shape + (1,) * (x.dim() - t.dim()))


@torch.inference_mode()
def sde_sample(cfg: InterpolantConfig, nets: dict, x_prior, cond,
               diffuse_steps: Optional[int] = None, score_weight: float = 1.0,
               noise_seq=None, generator: Optional[torch.Generator] = None):
    """Forward Euler-Maruyama simulation of the bridge SDE.

    ``nets``: ``{"vs_fused": fn}`` returning (v, s) from one stacked
    evaluation, or ``{"v": fn, "s": fn}`` (sde_type 'vs'), or
    ``{"b": fn, "s": fn}`` ('bs'); each (x, t, cond) -> drift term.
    ``noise_seq`` (n_steps,) + x.shape standard normals fixes the Brownian
    increments; otherwise they are drawn with ``generator``.
    """
    n = diffuse_steps or cfg.diffusion_steps
    delta_t = 1.0 / n
    x = x_prior.float()
    B = x.shape[0]
    if noise_seq is not None:
        noise_seq = torch.as_tensor(noise_seq, dtype=torch.float32, device=x.device)
    for step in range(n):
        # t in float32, as the JAX scan computes it
        t_scalar = np.clip(np.float32(step + 1) / np.float32(n),
                           np.float32(cfg.t_min), np.float32(1.0 - cfg.t_min))
        t = torch.full((B,), float(t_scalar), dtype=torch.float32, device=x.device)
        eps_t = float(epsilon(cfg, t_scalar))
        if cfg.sde_type == "vs":
            if "vs_fused" in nets:
                v_val, s_raw = nets["vs_fused"](x, t, cond)
            else:
                s_raw, v_val = nets["s"](x, t, cond), nets["v"](x, t, cond)
            s_val = s_raw.float() * _bdims(gamma_inv(cfg, t), x)
            ggd = _bdims(gamma_der(cfg, t) * gamma(cfg, t), x)
            b_val = v_val.float() - ggd * s_val * eps_t
        elif cfg.sde_type == "bs":
            s_val = nets["s"](x, t, cond).float() * _bdims(gamma_inv(cfg, t), x)
            b_val = nets["b"](x, t, cond).float()
        else:
            raise NotImplementedError(cfg.sde_type)
        noise_scale = delta_t * float(np.sqrt(np.float32(2) * np.float32(eps_t)))
        if noise_seq is None:
            z = torch.randn(x.shape, generator=generator, dtype=torch.float32,
                            device=x.device)
        else:
            z = noise_seq[step]
        dw = cfg.beta_max * z
        x = x + (b_val + score_weight * eps_t * s_val) * delta_t
        x = x + noise_scale * dw
    return x
