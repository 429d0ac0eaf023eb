"""Stochastic-interpolants bridge diffusion (BRIDGeR) — counterpart of
``vla_touch_tpu/models/controllers/interpolants.py``: the schedule
families, the implicit v/s/b training losses and the Euler-Maruyama SDE.

The bridge transports the VLA prior chunk x0 toward the expert chunk
through x_t = w0(t) x0 + w1(t) x1 + gamma(t) z, z ~ d N(0, I).  Kept as in
the reference: the SDE noise term is ``dt * sqrt(2 eps(t)) * d * randn``
(dt, not sqrt(dt)); eps and the noise scale use the step's scalar t;
gamma-inverse is clamped to [0, gamma_inv_max].

Randomness is explicit: the training draws (t, the noise z, a Gaussian
prior x0) are arguments or come from a ``torch.Generator``, and the SDE's
Brownian increments come as ``noise_seq`` or from a generator.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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


def interpolant_weights(cfg: InterpolantConfig, t):
    """(w0, w1) mixing weights of the interpolant."""
    it = cfg.interpolant_type
    if it == "linear":
        return 1 - t, t
    if it == "reverse_power3":
        return 1 - t ** 3, t ** 3
    if it == "reverse_power4":
        return 1 - t ** 4, t ** 4
    if it == "power3":
        return (1 - t) ** 3, 1 - (1 - t) ** 3
    if it == "power4":
        return (1 - t) ** 4, 1 - (1 - t) ** 4
    if it == "gaussian_encode_decode":
        c2 = torch.square(torch.cos(t * float(np.float32(np.pi))))
        return c2 * (t <= 0.5), c2 * (t > 0.5)
    if it == "reverse_linear":
        w0 = (1 - 2 * t) * (t <= 0.5)
        return w0, 1 - w0
    raise NotImplementedError(it)


def interpolant_dev(cfg: InterpolantConfig, x0, x1, t):
    """d/dt x_t, its deterministic part."""
    it = cfg.interpolant_type
    if it == "linear":
        return x1 - x0
    if it == "power3":
        return 3 * (1 - t) ** 2 * (x1 - x0)
    if it == "power4":
        return 4 * (1 - t) ** 3 * (x1 - x0)
    if it == "reverse_power3":
        return 3 * t ** 2 * (x1 - x0)
    if it == "reverse_power4":
        return 4 * t ** 3 * (x1 - x0)
    if it == "gaussian_encode_decode":
        pi = float(np.float32(np.pi))
        core = -2 * pi * torch.cos(pi * t) * torch.sin(pi * t)
        return core * torch.where(t <= 0.5, x0, x1)
    if it == "reverse_linear":
        return torch.where(t <= 0.5, 2 * (x1 - x0), torch.zeros_like(x1 - x0))
    raise NotImplementedError(it)


def _bdims(t, x):
    """Broadcast per-sample t (B,) across x's trailing dims."""
    return t.reshape(t.shape + (1,) * (x.dim() - t.dim()))


# ---- forward process + losses --------------------------------------------------


def _clip_t(cfg: InterpolantConfig, t):
    return torch.clamp(t, float(np.float32(cfg.t_min)), float(np.float32(1.0 - cfg.t_min)))


def q_sample(cfg: InterpolantConfig, t, x0, x1, z):
    """x_t ~ q(x_t | x0, x1) for the standard normal ``z`` (x0's shape):
    returns (x_t, beta_max z), the noise already scaled by d = beta_max."""
    tb = _clip_t(cfg, _bdims(t, x0))
    z = cfg.beta_max * z.float()
    w0, w1 = interpolant_weights(cfg, tb)
    return w0 * x0 + w1 * x1 + gamma(cfg, tb) * z, z


class SILosses(NamedTuple):
    total: torch.Tensor
    v_loss: torch.Tensor
    s_loss: torch.Tensor
    b_loss: torch.Tensor


def si_losses(cfg: InterpolantConfig, nets: dict, xt, t, x0, x1, z, cond) -> SILosses:
    """The implicit v/s/b losses.  ``nets``: callables ``v``, ``s``, ``b``
    of (x, t, cond) -> prediction."""
    t = _clip_t(cfg, t)
    partial_t = interpolant_dev(cfg, x0, x1, _bdims(t, x0))

    def flat(a):
        return a.reshape(a.shape[0], -1)

    v = nets["v"](xt, t, cond)
    v_loss = torch.mean(0.5 * torch.sum(torch.square(flat(v)), -1)
                        - torch.sum(flat(partial_t) * flat(v), -1))
    s = nets["s"](xt, t, cond)
    s_loss = torch.mean(0.5 * torch.sum(torch.square(flat(s)), -1)
                        + torch.sum(flat(z) * flat(s), -1))
    b = nets["b"](xt, t, cond)
    gd = gamma_der(cfg, t)[:, None]
    b_loss = torch.mean(0.5 * torch.sum(torch.square(flat(b)), -1)
                        - torch.sum((flat(partial_t) + gd * flat(z)) * flat(b), -1))
    return SILosses(v_loss + s_loss + b_loss, v_loss, s_loss, b_loss)


def training_draws(batch: int, shape, device, generator: Optional[torch.Generator] = None,
                   prior: bool = False) -> dict:
    """The draws of one training loss: ``t`` (B,) uniform in [0, 1), ``z``
    (shape) standard normal, and with ``prior`` the Gaussian prior ``x0``."""
    out = {"t": torch.rand((batch,), generator=generator, device=device),
           "z": torch.randn(shape, generator=generator, device=device)}
    if prior:
        out["x0"] = torch.randn(shape, generator=generator, device=device)
    return out


def si_training_loss(cfg: InterpolantConfig, nets: dict, obs_cond, expert_act,
                     vla_act=None, draws: Optional[dict] = None,
                     generator: Optional[torch.Generator] = None) -> SILosses:
    """The training objective: x_t from (t, z) and the three implicit losses.
    ``vla_act`` None takes the Gaussian prior ``draws["x0"]``.  ``draws``
    (:func:`training_draws`' keys) default to fresh ones from ``generator``."""
    x1 = expert_act.float()
    if draws is None:
        draws = training_draws(x1.shape[0], x1.shape, x1.device, generator,
                               prior=vla_act is None)
    x0 = (draws["x0"] if vla_act is None else vla_act).float()
    t = draws["t"].float()
    xt, z = q_sample(cfg, t, x0, x1, draws["z"])
    return si_losses(cfg, nets, xt.detach(), t, x0, x1, z, obs_cond)


# ---- the SDE --------------------------------------------------------------------


@torch.inference_mode()
def sde_sample(cfg: InterpolantConfig, nets: dict, x_prior, cond,
               diffuse_steps: Optional[int] = None, score_weight: float = 1.0,
               noise_seq=None, generator: Optional[torch.Generator] = None,
               record_traj: bool = False):
    """Forward Euler-Maruyama simulation of the bridge SDE.

    ``nets``: for sde_type 'vs' ``{"vs_fused": fn}`` returning (v, s) from
    one stacked evaluation, or ``{"v": fn, "s": fn}``; for 'bs'
    ``{"bs_fused": fn}`` returning (b, s), or ``{"b": fn, "s": fn}``; each
    (x, t, cond) -> drift term.
    ``noise_seq`` (n_steps,) + x.shape standard normals fixes the Brownian
    increments; otherwise they are drawn with ``generator``.
    ``record_traj``: return ``(x_final, traj)``, ``traj`` (n + 1,) +
    x.shape, the states from ``x_prior`` (as float32) to ``x_final``.
    """
    n = diffuse_steps or cfg.diffusion_steps
    delta_t = 1.0 / n
    x = x_prior.float()
    B = x.shape[0]
    if noise_seq is not None:
        noise_seq = torch.as_tensor(noise_seq, dtype=torch.float32, device=x.device)
    traj = [x] if record_traj else None
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
            if "bs_fused" in nets:
                b_val, s_raw = nets["bs_fused"](x, t, cond)
            else:
                s_raw, b_val = nets["s"](x, t, cond), nets["b"](x, t, cond)
            s_val = s_raw.float() * _bdims(gamma_inv(cfg, t), x)
            b_val = b_val.float()
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
        if record_traj:
            traj.append(x)
    if record_traj:
        return x, torch.stack(traj)
    return x
