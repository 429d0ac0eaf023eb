"""RDT runner: condition adaptors, the training loss and DPM-Solver++
action sampling (counterpart of ``vla_touch_tpu/models/rdt/runner.py``).

:func:`rdt_compute_loss` is the finetuning loss on a module from
:func:`init_rdt_train` (float32 master weights computing in the model's
dtype); its noise and timesteps are given or drawn from a
``torch.Generator`` (the port cannot replay ``jax.random``).  The samplers
below take such a module too: :func:`rdt_predict_action` on the training
module runs the serving path on the current parameters, cast per use.

:func:`rdt_predict_action` adapts the conditions and computes every block's
condition K/V once, then runs the solver loop where each step re-adapts the
noisy chunk and runs :meth:`RDT.forward_cached`.  Given the previous chunk
(``prior_chunk``) and ``skip_steps`` > 0 it warm-starts: the prior is
re-noised to solver step ``skip_steps``'s level and only the schedule's
tail runs.  :func:`rdt_predict_action_reference_style` is the reference's
sampler, which re-runs the full model (every block's condition K/V
included) at every step: the baseline the condition-K/V cache is measured
against.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch
from torch import nn

from vla_touch_tpu_torch.config import NoiseSchedulerConfig, RDTModelConfig
from vla_touch_tpu_torch.models.rdt.model import RDT
from vla_touch_tpu_torch.ops import schedulers as sched_lib
from vla_touch_tpu_torch.ops.nn import cast_linears_, compute_dtype_of, gelu_tanh


class ConditionAdapter(nn.Module):
    """``linear`` or ``mlp{N}x_gelu`` projector: fc0..fc{N-1}, tanh-GELU
    between; the input is cast to the module's dtype first."""

    def __init__(self, projector_type: str, in_features: int, out_features: int):
        super().__init__()
        if projector_type == "linear":
            depth = 1
        else:
            m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
            if not m:
                raise ValueError(f"Unknown projector type: {projector_type}")
            depth = int(m.group(1))
        for i in range(depth):
            self.add_module(f"fc{i}", nn.Linear(in_features if i == 0
                                                else out_features, out_features))
        self.depth = depth

    def forward(self, x):
        x = x.to(compute_dtype_of(self.fc0))
        for i in range(self.depth):
            if i > 0:
                x = gelu_tanh(x)
            x = getattr(self, f"fc{i}")(x)
        return x


class RDTRunnerModule(nn.Module):
    """RDT + its three adaptors (``model`` / ``lang_adaptor`` /
    ``img_adaptor`` / ``state_adaptor``)."""

    def __init__(self, cfg: RDTModelConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.model = RDT(cfg)
        self.lang_adaptor = ConditionAdapter(cfg.lang_adaptor, cfg.lang_token_dim, H)
        self.img_adaptor = ConditionAdapter(cfg.img_adaptor, cfg.img_token_dim, H)
        self.state_adaptor = ConditionAdapter(cfg.state_adaptor,
                                              2 * cfg.state_token_dim, H)

    def adapt_conditions(self, lang_tokens, img_tokens, state_tokens):
        return (self.lang_adaptor(lang_tokens), self.img_adaptor(img_tokens),
                self.state_adaptor(state_tokens))

    def adapt_state(self, state_tokens):
        return self.state_adaptor(state_tokens)

    def compute_cond_kv(self, lang_c, img_c):
        return self.model.compute_cond_kv(lang_c, img_c)

    def forward_cached(self, x, freq, t, cond_kv, lang_mask=None):
        return self.model.forward_cached(x, freq, t, cond_kv, lang_mask=lang_mask)

    def forward_model(self, x, freq, t, lang_c, img_c, lang_mask=None):
        return self.model(x, freq, t, lang_c, img_c, lang_mask=lang_mask)

    def forward(self, lang_tokens, img_tokens, state_action_traj, ctrl_freqs,
                timesteps, lang_mask=None):
        """The adapted full forward (the training path)."""
        lang_c, img_c, x = self.adapt_conditions(lang_tokens, img_tokens,
                                                 state_action_traj)
        return self.forward_model(x, ctrl_freqs, timesteps, lang_c, img_c, lang_mask)


@dataclasses.dataclass(frozen=True)
class RDTRunnerConfig:
    model: RDTModelConfig = dataclasses.field(default_factory=RDTModelConfig)
    noise: NoiseSchedulerConfig = dataclasses.field(
        default_factory=NoiseSchedulerConfig)


def init_rdt(cfg: RDTRunnerConfig, seed: int = 0, device=None) -> RDTRunnerModule:
    """A seeded random RDT runner in the compute dtype on ``device``
    (default CUDA).  The positional embeddings start from their sincos
    tables and ``final_ffn.fc2`` from zeros, as in the JAX init."""
    from vla_touch_tpu_torch.utils.random_init import build_module

    return build_module(lambda: RDTRunnerModule(cfg.model), seed, device,
                        cfg.model.compute_dtype)


def master_weights_(module: RDTRunnerModule, compute_dtype: torch.dtype) -> RDTRunnerModule:
    """Make ``module``'s parameters master weights: every Linear casts its
    weight and bias to ``compute_dtype`` at use, and the positional
    embeddings are cast where they are added; the RmsNorm scales stay in
    the master dtype, as in the JAX package."""
    cast_linears_(module, compute_dtype)
    module.model.compute_dtype = compute_dtype
    return module


def init_rdt_train(cfg: RDTRunnerConfig, seed: int = 0, device=None,
                   param_dtype: torch.dtype = torch.float32) -> RDTRunnerModule:
    """A seeded random RDT runner for training: parameters in
    ``param_dtype`` (float32 master weights by default) requiring grad,
    computing in ``cfg.model``'s dtype (:func:`master_weights_`)."""
    from vla_touch_tpu_torch.utils.random_init import build_module

    module = build_module(lambda: RDTRunnerModule(cfg.model), seed, device, param_dtype)
    return master_weights_(module, cfg.model.compute_dtype).requires_grad_(True)


def loss_draws(cfg: RDTRunnerConfig, shape, device, generator=None) -> dict:
    """The loss's draws for an action batch of ``shape`` (B, horizon, D):
    ``noise`` float32 ~ N(0, 1) and ``timesteps`` int32 in [0, T)."""
    return {"noise": torch.randn(shape, generator=generator, device=device),
            "timesteps": torch.randint(0, cfg.noise.num_train_timesteps, shape[:1],
                                       generator=generator, device=device,
                                       dtype=torch.int32)}


def rdt_compute_loss(cfg: RDTRunnerConfig, module: RDTRunnerModule, batch: dict,
                     noise=None, timesteps=None,
                     generator: Optional[torch.Generator] = None):
    """The training loss: the MSE between the model's output on the noised
    chunk and the ``prediction_type`` target ("epsilon": the noise;
    "sample": the clean chunk), as a float32 scalar.

    ``batch``: lang_tokens (B, L, Dl), lang_mask (B, L) bool, img_tokens
    (B, Li, Di), state_tokens (B, 1, 128), action_gt (B, H, 128),
    action_mask (B, 1, 128) float, ctrl_freqs (B,).  ``noise`` (B, H, 128)
    and ``timesteps`` (B,) are drawn from ``generator`` when not given."""
    schedule = sched_lib.DiffusionSchedule.create(cfg.noise.num_train_timesteps,
                                                  cfg.noise.beta_schedule)
    action_gt = batch["action_gt"].float()
    if noise is None or timesteps is None:
        draws = loss_draws(cfg, action_gt.shape, action_gt.device, generator)
        noise = draws["noise"] if noise is None else noise
        timesteps = draws["timesteps"] if timesteps is None else timesteps
    noise = torch.as_tensor(noise, dtype=torch.float32, device=action_gt.device)
    timesteps = torch.as_tensor(timesteps, device=action_gt.device)
    noisy_action = schedule.add_noise(action_gt, noise, timesteps)
    state_action = torch.cat([batch["state_tokens"].float(), noisy_action], dim=1)
    mask = batch["action_mask"].float().expand(state_action.shape)
    state_action = torch.cat([state_action, mask], dim=2)
    pred = module(batch["lang_tokens"], batch["img_tokens"], state_action,
                  batch["ctrl_freqs"], timesteps, lang_mask=batch.get("lang_mask"))
    if cfg.noise.prediction_type == "epsilon":
        target = noise
    elif cfg.noise.prediction_type == "sample":
        target = action_gt
    else:
        raise ValueError(cfg.noise.prediction_type)
    return torch.mean(torch.square(pred.float() - target))


def start_noise(m, B, dev, init_noise, generator):
    """(B, horizon, output_dim) float32: ``init_noise``, else a draw from
    ``generator``."""
    if init_noise is None:
        return torch.randn((B, m.horizon, m.output_dim), generator=generator,
                           dtype=torch.float32, device=dev)
    return torch.as_tensor(init_noise, dtype=torch.float32, device=dev)


def solver_start(cfg: RDTRunnerConfig, steps: int, noise, mask_h,
                 prior_chunk=None, skip_steps: int = 0):
    """The solver's starting point: ``noise`` for a cold chunk; for a warm
    one (``skip_steps`` > 0) the prior, masked to the available action
    dims, re-noised to step ``skip_steps``'s level with ``noise``.  Raises
    when ``skip_steps`` is not in [0, steps) or a warm start has no
    prior."""
    if not 0 <= skip_steps < steps:
        raise ValueError(f"skip_steps {skip_steps} not in [0, {steps})")
    if skip_steps == 0:
        return noise
    if prior_chunk is None:
        raise ValueError("skip_steps > 0 needs a prior_chunk")
    schedule = sched_lib.DiffusionSchedule.create(cfg.noise.num_train_timesteps,
                                                  cfg.noise.beta_schedule)
    prior = torch.as_tensor(prior_chunk, dtype=torch.float32, device=noise.device)
    return sched_lib.dpm_renoise(prior * mask_h, noise, schedule, steps, skip_steps)


@torch.inference_mode()
def rdt_predict_action(cfg: RDTRunnerConfig, module: RDTRunnerModule,
                       lang_tokens, lang_mask, img_tokens, state_tokens,
                       action_mask, ctrl_freqs,
                       num_inference_timesteps: Optional[int] = None,
                       init_noise=None, generator: Optional[torch.Generator] = None,
                       prior_chunk=None, skip_steps: int = 0):
    """Action-chunk inference.

    state_tokens (B, 1, 128); action_mask (B, 1, 128) float; returns
    (B, horizon, 128) float32.  ``init_noise`` (B, horizon, 128) fixes the
    starting noise (the warm start's re-noising noise when ``skip_steps`` >
    0); otherwise it is drawn with ``generator``.  ``prior_chunk`` (B,
    horizon, 128), the previous chunk already shifted by the executed
    ticks, with ``skip_steps`` > 0 runs only the solver's last ``steps -
    skip_steps`` steps from it.
    """
    m = cfg.model
    steps = num_inference_timesteps or cfg.noise.num_inference_timesteps
    schedule = sched_lib.DiffusionSchedule.create(cfg.noise.num_train_timesteps,
                                                  cfg.noise.beta_schedule)
    B = state_tokens.shape[0]
    mask_h = action_mask.float().expand(B, m.horizon, m.output_dim)
    noise = start_noise(m, B, state_tokens.device, init_noise, generator)
    x_init = solver_start(cfg, steps, noise, mask_h, prior_chunk, skip_steps)
    state_in = torch.cat([state_tokens, action_mask.to(state_tokens.dtype)], dim=2)
    lang_c, img_c, state_traj = module.adapt_conditions(lang_tokens, img_tokens,
                                                        state_in)
    cond_kv = module.compute_cond_kv(lang_c, img_c)

    def model_fn(noisy_action, t):
        action_in = torch.cat([noisy_action, mask_h], dim=2)
        x = torch.cat([state_traj, module.adapt_state(action_in)], dim=1)
        return module.forward_cached(x, ctrl_freqs, t, cond_kv, lang_mask).float()

    action = sched_lib.sample_dpm_solver(model_fn, x_init, schedule, steps,
                                         prediction_type=cfg.noise.prediction_type,
                                         start_index=skip_steps)
    return action * mask_h


def rdt_predict_action_warm(cfg: RDTRunnerConfig, module: RDTRunnerModule,
                            lang_tokens, lang_mask, img_tokens, state_tokens,
                            action_mask, ctrl_freqs, prior_chunk, skip_steps: int,
                            num_inference_timesteps: Optional[int] = None,
                            init_noise=None, generator: Optional[torch.Generator] = None):
    """The warm-started replan: :func:`rdt_predict_action` with
    ``prior_chunk`` and ``skip_steps``."""
    return rdt_predict_action(cfg, module, lang_tokens, lang_mask, img_tokens,
                              state_tokens, action_mask, ctrl_freqs,
                              num_inference_timesteps=num_inference_timesteps,
                              init_noise=init_noise, generator=generator,
                              prior_chunk=prior_chunk, skip_steps=skip_steps)


@torch.inference_mode()
def rdt_predict_action_reference_style(cfg: RDTRunnerConfig, module: RDTRunnerModule,
                                       lang_tokens, lang_mask, img_tokens, state_tokens,
                                       action_mask, ctrl_freqs,
                                       num_inference_timesteps: Optional[int] = None,
                                       init_noise=None,
                                       generator: Optional[torch.Generator] = None):
    """The reference's sampler: the three adaptors run once, then every
    solver step re-adapts the noisy chunk and runs the full model
    (:meth:`RDT.forward`), recomputing every block's condition K/V.  No
    warm start, no condition-K/V cache.  Same contract as
    :func:`rdt_predict_action`."""
    m = cfg.model
    steps = num_inference_timesteps or cfg.noise.num_inference_timesteps
    schedule = sched_lib.DiffusionSchedule.create(cfg.noise.num_train_timesteps,
                                                  cfg.noise.beta_schedule)
    B = state_tokens.shape[0]
    state_in = torch.cat([state_tokens, action_mask.to(state_tokens.dtype)], dim=2)
    lang_c, img_c, state_traj = module.adapt_conditions(lang_tokens, img_tokens,
                                                        state_in)
    mask_h = action_mask.float().expand(B, m.horizon, m.output_dim)

    def model_fn(noisy_action, t):
        action_in = torch.cat([noisy_action, mask_h], dim=2)
        x = torch.cat([state_traj, module.adapt_state(action_in)], dim=1)
        return module.forward_model(x, ctrl_freqs, t, lang_c, img_c, lang_mask).float()

    noise = start_noise(m, B, state_tokens.device, init_noise, generator)
    action = sched_lib.sample_dpm_solver(model_fn, noise, schedule, steps,
                                         prediction_type=cfg.noise.prediction_type)
    return action * mask_h
