"""Diffusion noise schedule and the DPM-Solver++ 2M sampler (counterpart of
``vla_touch_tpu/ops/schedulers.py``).

Schedule tables are computed in numpy float64 and stored as float32, exactly
as the JAX package stores them; the per-step scalar arithmetic runs in
float32 numpy scalars so the solver applies the same coefficients.  The
denoise loop is a Python loop over the (3-5) solver steps.

Math: Lu et al., "DPM-Solver++" (arXiv:2211.01095), 2M midpoint update in
data-prediction space::

  x_t = (sigma_t / sigma_s) x_s - alpha_t (e^{-h} - 1) D0
        - 0.5 alpha_t (e^{-h} - 1) D1
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Literal

import numpy as np
import torch


def make_betas(num_train_timesteps: int,
               beta_schedule: str = "squaredcos_cap_v2",
               beta_start: float = 0.0001,
               beta_end: float = 0.02) -> np.ndarray:
    """Beta table; formulas match the diffusers conventions by name."""
    T = num_train_timesteps
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, T, dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, T, dtype=np.float64) ** 2
    if beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2
        i = np.arange(T, dtype=np.float64)
        betas = 1.0 - alpha_bar((i + 1) / T) / alpha_bar(i / T)
        return np.minimum(betas, 0.999)
    raise ValueError(f"Unknown beta_schedule: {beta_schedule}")


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Beta-schedule configuration plus its cumulative-alpha table."""

    num_train_timesteps: int = 1000
    beta_schedule: str = "squaredcos_cap_v2"
    beta_start: float = 0.0001
    beta_end: float = 0.02

    def alphas_cumprod_np(self) -> np.ndarray:
        betas = make_betas(self.num_train_timesteps, self.beta_schedule,
                           self.beta_start, self.beta_end)
        return np.cumprod(1.0 - betas)

    @property
    def alphas_cumprod(self) -> np.ndarray:
        """float32 table, as the JAX schedule stores it."""
        return self.alphas_cumprod_np().astype(np.float32)

    @classmethod
    def create(cls, num_train_timesteps: int = 1000,
               beta_schedule: str = "squaredcos_cap_v2",
               beta_start: float = 0.0001, beta_end: float = 0.02):
        return cls(num_train_timesteps, beta_schedule, beta_start, beta_end)

    def _scales(self, x0, timesteps):
        """(sqrt(acp_t), sqrt(1 - acp_t)), float32 tables taken with numpy's
        correctly rounded square root (torch's CPU float32 sqrt is not
        always) and indexed at ``timesteps`` on x0's device, shaped to
        broadcast over x0's trailing dims, cast to x0's dtype."""
        acp = self.alphas_cumprod
        t = torch.as_tensor(timesteps, device=x0.device).long()
        shape = tuple(t.shape) + (1,) * (x0.dim() - t.dim())
        return tuple(torch.as_tensor(table, device=x0.device)[t].reshape(shape).to(x0.dtype)
                     for table in (np.sqrt(acp), np.sqrt(np.float32(1) - acp)))

    # ---- DDPM forward process (training) ----------------------------------
    def add_noise(self, x0, noise, timesteps):
        """x_t = sqrt(acp_t) x0 + sqrt(1 - acp_t) eps; ``timesteps`` int
        (B,), broadcast over x0's trailing dims."""
        sa, sn = self._scales(x0, timesteps)
        return sa * x0 + sn * noise

    def velocity(self, x0, noise, timesteps):
        """v-prediction target: v = sqrt(acp) eps - sqrt(1 - acp) x0."""
        sa, sn = self._scales(x0, timesteps)
        return sa * noise - sn * x0


@dataclasses.dataclass(frozen=True)
class DPMSolverTables:
    """Per-step solver tables: ``timesteps`` (S,) model-facing train-timestep
    indices; ``alpha_t``/``sigma_t``/``lambda_t`` (S+1,) float32, entry i =
    state before step i; ``use_first_order`` (S,) bool."""

    timesteps: np.ndarray
    alpha_t: np.ndarray
    sigma_t: np.ndarray
    lambda_t: np.ndarray
    use_first_order: np.ndarray


def make_dpm_tables(schedule: DiffusionSchedule, num_inference_steps: int,
                    lower_order_final: bool = True,
                    final_sigma: Literal["zero", "sigma_min"] = "zero",
                    ) -> DPMSolverTables:
    """Precompute the solver tables ("linspace" timestep spacing)."""
    T = schedule.num_train_timesteps
    acp = schedule.alphas_cumprod_np().astype(np.float64)
    timesteps = (np.linspace(0, T - 1, num_inference_steps + 1)
                 .round()[::-1][:-1].astype(np.int64))
    sigmas_full = np.sqrt((1 - acp) / acp)
    sigmas = np.interp(timesteps, np.arange(T), sigmas_full)
    last = 0.0 if final_sigma == "zero" else float(np.sqrt((1 - acp[0]) / acp[0]))
    sigmas = np.concatenate([sigmas, [last]])

    alpha_t = 1.0 / np.sqrt(1.0 + sigmas**2)
    sigma_t = sigmas * alpha_t
    lam = np.log(np.maximum(alpha_t, 1e-20)) - np.log(np.maximum(sigma_t, 1e-20))

    first = np.zeros(num_inference_steps, dtype=bool)
    first[0] = True  # no history yet
    if lower_order_final and num_inference_steps < 15:
        first[-1] = True

    return DPMSolverTables(
        timesteps=timesteps.astype(np.int32),
        alpha_t=alpha_t.astype(np.float32),
        sigma_t=sigma_t.astype(np.float32),
        lambda_t=lam.astype(np.float32),
        use_first_order=first,
    )


def model_output_to_x0(model_output, x, step_idx: int, tables: DPMSolverTables,
                       prediction_type: str):
    """Network output at solver step ``step_idx`` -> x0-prediction."""
    a = float(tables.alpha_t[step_idx])
    s = float(tables.sigma_t[step_idx])
    if prediction_type == "sample":
        return model_output
    if prediction_type == "epsilon":
        return (x - s * model_output) / a
    if prediction_type == "v_prediction":
        return a * x - s * model_output
    raise ValueError(f"Unsupported prediction type {prediction_type}")


def dpm_solver_step(x, x0_pred, x0_prev, step_idx: int, tables: DPMSolverTables):
    """One DPM-Solver++ 2M (midpoint) update.  ``x0_prev`` is the previous
    step's x0-prediction (unused on first-order steps).  The scalar
    coefficients are float32, as in the JAX solver."""
    i = step_idx
    lam_s, lam_t = tables.lambda_t[i], tables.lambda_t[i + 1]
    sig_s, sig_t = tables.sigma_t[i], tables.sigma_t[i + 1]
    a_t = tables.alpha_t[i + 1]
    h = lam_t - lam_s
    phi = np.expm1(-h)                      # (e^{-h} - 1), float32
    first_term = float(sig_t / sig_s) * x - float(a_t * phi) * x0_pred
    if tables.use_first_order[i]:
        return first_term
    h_0 = lam_s - tables.lambda_t[max(i, 1) - 1]
    d1 = (x0_pred - x0_prev) / float(h_0 / h)
    return first_term + float(np.float32(-0.5) * a_t * phi) * d1


def sample_dpm_solver(model_fn: Callable, x_init: torch.Tensor,
                      schedule: DiffusionSchedule, num_inference_steps: int,
                      prediction_type: str = "sample",
                      lower_order_final: bool = True,
                      final_sigma: Literal["zero", "sigma_min"] = "zero",
                      start_index: int = 0):
    """Run the DPM-Solver++ denoise loop.

    ``model_fn(x, t)``: x (B, ...) in ``x_init``'s dtype, t int32 (B,)
    train-timestep indices -> prediction of the configured type.  The solver
    state is float32 (float64 when ``x_init`` is float64).

    ``start_index`` > 0 runs only the schedule's tail (the warm-started
    replan): ``x_init`` must sit at step ``start_index``'s noise level
    (:func:`dpm_renoise`), and the first executed step is first order, since
    no earlier prediction exists.
    """
    if not 0 <= start_index < num_inference_steps:
        raise ValueError(
            f"start_index {start_index} not in [0, {num_inference_steps}): an "
            "empty solver tail would return the (re)noised input unchanged")
    tables = make_dpm_tables(schedule, num_inference_steps,
                             lower_order_final, final_sigma)
    if start_index:
        first = tables.use_first_order.copy()
        first[start_index] = True
        tables = dataclasses.replace(tables, use_first_order=first)
    in_dtype = x_init.dtype
    state_dtype = torch.float64 if in_dtype == torch.float64 else torch.float32
    batch = x_init.shape[0]
    x = x_init.to(state_dtype)
    x0_prev = torch.zeros_like(x)
    for step_idx in range(start_index, num_inference_steps):
        t = torch.full((batch,), int(tables.timesteps[step_idx]),
                       dtype=torch.int32, device=x.device)
        out = model_fn(x.to(in_dtype), t).to(state_dtype)
        x0 = model_output_to_x0(out, x, step_idx, tables, prediction_type)
        x = dpm_solver_step(x, x0, x0_prev, step_idx, tables)
        x0_prev = x0
    return x.to(in_dtype)


def dpm_renoise(x0, noise, schedule: DiffusionSchedule,
                num_inference_steps: int, start_index: int,
                lower_order_final: bool = True,
                final_sigma: Literal["zero", "sigma_min"] = "zero"):
    """A clean sample placed at solver step ``start_index``'s noise level,
    ``alpha_t x0 + sigma_t noise`` in float32: the warm start's entry to
    :func:`sample_dpm_solver`.

    XLA contracts the JAX package's jitted expression into one FMA,
    ``fma(alpha_t, x0, sigma_t * noise)``; so does this, in float64, where
    the product of two float32 values is exact."""
    tables = make_dpm_tables(schedule, num_inference_steps,
                             lower_order_final, final_sigma)
    a = float(tables.alpha_t[start_index])
    s = float(tables.sigma_t[start_index])
    return (a * x0.double() + (s * noise.float()).double()).float()


def sample_ddpm(model_fn: Callable, x_init: torch.Tensor, schedule: DiffusionSchedule,
                prediction_type: str = "sample", clip_sample: bool = False,
                noises=None, generator=None):
    """Full-length ancestral DDPM sampling (T = train timesteps), t from
    T - 1 down to 0.  The posterior noise of the step at t is ``noises[T -
    1 - t]`` ((T,) + x's shape) when given, else a draw from ``generator``;
    the step at t = 0 adds none."""
    acp = torch.as_tensor(schedule.alphas_cumprod, device=x_init.device)
    T = schedule.num_train_timesteps
    acp_prev = torch.cat([torch.ones(1, device=acp.device), acp[:-1]])
    alphas = acp / acp_prev
    batch = x_init.shape[0]
    x = x_init.float()
    for i, t in enumerate(range(T - 1, -1, -1)):
        out = model_fn(x, torch.full((batch,), t, dtype=torch.int32,
                                     device=x.device)).float()
        a_t, acp_t, acp_p = alphas[t], acp[t], acp_prev[t]
        beta_t = 1.0 - a_t
        if prediction_type == "sample":
            x0 = out
        elif prediction_type == "epsilon":
            x0 = (x - torch.sqrt(1 - acp_t) * out) / torch.sqrt(acp_t)
        else:
            raise ValueError(prediction_type)
        if clip_sample:
            x0 = torch.clamp(x0, -1.0, 1.0)
        coef_x0 = torch.sqrt(acp_p) * beta_t / (1 - acp_t)
        coef_xt = torch.sqrt(a_t) * (1 - acp_p) / (1 - acp_t)
        mean = coef_x0 * x0 + coef_xt * x
        var = torch.clamp(beta_t * (1 - acp_p) / (1 - acp_t), min=1e-20)
        noise = (torch.as_tensor(noises[i], dtype=torch.float32, device=x.device)
                 if noises is not None else
                 torch.randn(x.shape, generator=generator, device=x.device))
        x = mean + (torch.sqrt(var) if t > 0 else 0.0) * noise
    return x.to(x_init.dtype)
