"""Warm-replan quality: does a warm-started replan predict as well as a cold
one?  (The protocol of the JAX package's ``tests/test_warm_quality.py``.)

A tiny RDT (``rdt_tiny``) learns a family of sinusoid trajectories (6
active action dims; the state holds position and velocity, so the phase is
identifiable): 900 AdamW steps at batch 64, optax's defaults (lr 1e-3,
weight decay 1e-4).  Then, on 16 trajectories, four replans 4 executed
ticks apart compare against the true future chunk:

- COLD: the full 5-step solver from noise;
- WARM: the previous chunk shifted by the executed ticks (tail held, the
  control loop's prior), re-noised to solver step 2 and denoised over the
  last 3 steps (the warm chunk feeds the next replan);
- PRIOR: that shifted chunk itself.

:func:`check` holds the result to the four asserts: the loss halves, cold
MSE < 0.2 x the signal power, warm < prior (the replan refines its prior)
and warm < 1.6 x cold + 1e-3.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vla_touch_tpu_torch.config import NoiseSchedulerConfig, rdt_tiny
from vla_touch_tpu_torch.models.rdt import runner as R
from vla_touch_tpu_torch.runtime.control_loop import shift_prior
from vla_touch_tpu_torch.train.optim import AdamW
from vla_touch_tpu_torch.utils.device import resolve_device

ADIM = 6          # active action dims (of 128)
H = 8             # rdt_tiny horizon
SHIFT = 4         # executed ticks between replans
W = 0.25          # trajectory angular frequency
STEPS, BATCH, LR, WEIGHT_DECAY = 900, 64, 1e-3, 1e-4
REPLANS, ROWS, WARM_SKIP = 4, 16, 2


def _traj(phase, t):
    """phase (..., ADIM), t scalar or (...) -> x(t) (..., ADIM)."""
    return 0.8 * np.sin(W * np.asarray(t)[..., None] + phase)


def _state_tokens(phase, t):
    s = np.zeros(phase.shape[:-1] + (1, 128), np.float32)
    s[..., 0, :ADIM] = _traj(phase, t)
    s[..., 0, ADIM:2 * ADIM] = 0.8 * W * np.cos(W * np.asarray(t)[..., None] + phase)
    return s


def chunk_gt(phase, t):
    """(B,) start times -> (B, H, 128) ground-truth future chunks."""
    out = np.zeros((phase.shape[0], H, 128), np.float32)
    for k in range(H):
        out[:, k, :ADIM] = _traj(phase, np.asarray(t) + k + 1)
    return out


def make_batch(rng, m, B, phase=None, t=None):
    """(phase, t, numpy batch) of ``B`` trajectories; phase and start time
    drawn from ``rng`` unless given."""
    phase = rng.uniform(0, 2 * np.pi, (B, ADIM)) if phase is None else phase
    t = rng.uniform(0, 50, (B,)) if t is None else t
    amask = np.zeros((B, 1, 128), np.float32)
    amask[:, :, :ADIM] = 1.0
    return phase, t, {
        "lang_tokens": np.zeros((B, 4, m.lang_token_dim), np.float32),
        "lang_mask": np.ones((B, 4), bool),
        "img_tokens": np.zeros((B, m.img_cond_len, m.img_token_dim), np.float32),
        "state_tokens": _state_tokens(phase, t),
        "action_gt": chunk_gt(phase, t),
        "action_mask": amask,
        "ctrl_freqs": np.full((B,), 10.0, np.float32),
    }


def _mse(a, b):
    return float(np.mean(np.square(np.asarray(a)[..., :ADIM] - np.asarray(b)[..., :ADIM])))


class Protocol:
    """The tiny RDT, its optimizer and the protocol's random streams.

    ``draws="host"`` takes every random draw (weights, data, the loss's
    noise and timesteps, the solver's starting noise) from host generators
    seeded by ``seed``, so the card and the CPU run one stream;
    ``draws="device"`` takes the weights, the loss's draws and the solver's
    noise from generators on ``device`` instead (the data stays on the
    host's)."""

    def __init__(self, device=None, dtype: str = "float32", seed: int = 0,
                 draws: str = "host"):
        if draws not in ("host", "device"):
            raise ValueError(f"draws must be 'host' or 'device', not {draws!r}")
        self.dev = resolve_device(device)
        self.draw_dev = torch.device("cpu") if draws == "host" else self.dev
        self.m = rdt_tiny(dtype=dtype)
        self.rcfg = R.RDTRunnerConfig(model=self.m, noise=NoiseSchedulerConfig())
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator(self.draw_dev).manual_seed(seed + 1)
        self.module = R.init_rdt_train(self.rcfg, seed, self.draw_dev).to(self.dev)
        self.opt = AdamW(self.module.parameters(), weight_decay=WEIGHT_DECAY)

    def tensors(self, b: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.dev) for k, v in b.items()}

    def train_step(self) -> torch.Tensor:
        """One AdamW step on a fresh batch of BATCH trajectories; returns
        the loss."""
        draws = R.loss_draws(self.rcfg, (BATCH, H, 128), self.draw_dev, self.gen)
        loss = R.rdt_compute_loss(self.rcfg, self.module,
                                  self.tensors(make_batch(self.rng, self.m, BATCH)[2]),
                                  noise=draws["noise"].to(self.dev),
                                  timesteps=draws["timesteps"].to(self.dev))
        self.opt.zero_grad()
        loss.backward()
        self.opt.step(LR)
        return loss

    def chunk(self, phase, t, prior=None, skip=0, noise_seed=3) -> np.ndarray:
        """(ROWS, H, 128) chunks at start times ``t``: the full solver from
        noise seeded by ``noise_seed``, or with ``prior`` re-noised to solver
        step ``skip``."""
        b = self.tensors(make_batch(self.rng, self.m, ROWS, phase=phase, t=t)[2])
        noise = torch.randn((ROWS, H, 128), device=self.draw_dev,
                            generator=torch.Generator(self.draw_dev).manual_seed(noise_seed))
        return R.rdt_predict_action(
            self.rcfg, self.module, b["lang_tokens"], b["lang_mask"], b["img_tokens"],
            b["state_tokens"], b["action_mask"], b["ctrl_freqs"],
            init_noise=noise.to(self.dev),
            prior_chunk=None if prior is None else torch.as_tensor(prior, device=self.dev),
            skip_steps=skip).cpu().numpy()


def run(device=None, dtype: str = "float32", seed: int = 0, draws: str = "host") -> dict:
    """Train and replan on ``device`` (default CUDA), computing in ``dtype``
    (float32 master weights), the streams seeded by ``seed`` and drawn as
    :class:`Protocol` says.  Returns the first and last loss, the cold,
    warm and prior MSEs, the signal power and the training seconds."""
    p = Protocol(device, dtype, seed, draws)
    t0 = time.perf_counter()
    first = None
    for it in range(STEPS):
        loss = p.train_step()
        if it == 0:
            first = loss.item()
    last = loss.item()
    train_s = time.perf_counter() - t0

    phase = make_batch(p.rng, p.m, ROWS)[0]
    cold_mses, warm_mses, prior_mses = [], [], []
    chunk = p.chunk(phase, np.full((ROWS,), 20.0))
    for i in range(REPLANS):
        t_next = np.full((ROWS,), 20.0 + (i + 1) * SHIFT)
        gt = chunk_gt(phase, t_next)
        prior = np.stack([shift_prior(c, SHIFT) for c in chunk])
        cold = p.chunk(phase, t_next, noise_seed=10 + i)
        warm = p.chunk(phase, t_next, prior=prior, skip=WARM_SKIP, noise_seed=10 + i)
        cold_mses.append(_mse(cold, gt))
        warm_mses.append(_mse(warm, gt))
        prior_mses.append(_mse(prior, gt))
        chunk = warm                    # steady state: the warm chunk feeds the next replan
    gt_var = float(np.mean(np.square(chunk_gt(phase, np.full((ROWS,), 22.0))[..., :ADIM])))
    return {"first_loss": first, "last_loss": last, "cold_mse": float(np.mean(cold_mses)),
            "warm_mse": float(np.mean(warm_mses)), "prior_mse": float(np.mean(prior_mses)),
            "signal_power": gt_var, "train_s": train_s}


def check(r: dict) -> None:
    """The four asserts of the protocol."""
    # DDPM loss over random timesteps keeps a large high-noise floor: a 2x
    # drop means the denoiser learned the family
    assert r["last_loss"] < r["first_loss"] * 0.5, (r["first_loss"], r["last_loss"])
    assert r["cold_mse"] < 0.2 * r["signal_power"], (r["cold_mse"], r["signal_power"])
    assert r["warm_mse"] < r["prior_mse"], (r["warm_mse"], r["prior_mse"])
    assert r["warm_mse"] < r["cold_mse"] * 1.6 + 1e-3, (r["warm_mse"], r["cold_mse"])
