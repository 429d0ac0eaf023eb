"""RDT finetuning: the train state and the train step (counterpart of
``vla_touch_tpu/train/rdt_train.py``, one device).

One :func:`train_step` is the JAX package's jitted step in its order:

- gradient accumulation over the batch's leading ``grad_accum``
  micro-batches: each micro-batch's gradients cast to ``accum_dtype`` and
  summed, then divided by the count in float32 (the loss likewise);
- ``clip_by_global_norm`` and AdamW or 8-bit AdamW
  (``train/optim.py::RDTOptimizer``);
- the update applied to the float32 master weights, or, for
  ``param_dtype='bfloat16'`` (no master copy), to bf16 parameters with
  stochastic rounding (``utils/ema.py::stochastic_round_bf16``);
- the warm-up EMA (``rdt_ema_decay`` at the step before the update), in
  float32 or in bf16 with stochastic rounding;
- the metrics ``loss`` and ``grad_norm`` (of the averaged gradients,
  before clipping).

The draws (each micro-batch's noise and timesteps, the rounding bits) come
from a ``torch.Generator`` or are given: the port cannot replay
``jax.random``.  The sharded step and ZeRO-3 wait for multi-device
training (ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vla_touch_tpu_torch.config import TrainConfig, torch_dtype
from vla_touch_tpu_torch.models.rdt import runner as R
from vla_touch_tpu_torch.train.optim import RDTOptimizer, global_norm
from vla_touch_tpu_torch.utils import ema as ema_lib
from vla_touch_tpu_torch.utils.from_flax import flax_paths


@dataclasses.dataclass
class TrainState:
    """``module``'s parameters are the trained parameters (float32 masters,
    or bf16); names follow the module, their order the JAX tree's."""

    module: R.RDTRunnerModule
    opt_state: object
    ema: ema_lib.EmaState
    step: int

    @property
    def params(self) -> dict:
        return dict(self.module.named_parameters())


def leaf_names(module: R.RDTRunnerModule) -> list:
    """The parameter names in the JAX tree's leaf order (sorted paths): the
    order of the sums over leaves (the global norm)."""
    return [n for n, _ in sorted(flax_paths(module).items(), key=lambda kv: kv[1][0])]


def make_optimizer(tcfg: TrainConfig, module: R.RDTRunnerModule) -> RDTOptimizer:
    """The optimizer of ``module``'s parameters (8-bit moments blocked in
    the JAX layout)."""
    return RDTOptimizer(tcfg, transposed={n for n, (_, t) in flax_paths(module).items() if t})


def _check_param_dtype(tcfg: TrainConfig) -> None:
    if tcfg.param_dtype != "float32" and not tcfg.use_8bit_adam:
        raise ValueError(
            "param_dtype='bfloat16' stores no float32 master copy; float32 "
            "AdamW would then keep bf16 moments.  Use use_8bit_adam=True (int8 "
            "moments, float32 update math).")


def init_train_state(rcfg: R.RDTRunnerConfig, tcfg: TrainConfig, seed: int = 0,
                     device=None, module: Optional[R.RDTRunnerModule] = None) -> TrainState:
    """A fresh state: ``module`` (float32 master weights from
    ``runner.init_rdt_train``; a seeded random one when None) cast to
    ``param_dtype``, zero optimizer state, the EMA shadow a copy of the
    parameters in ``ema_dtype``."""
    _check_param_dtype(tcfg)
    if module is None:
        module = R.init_rdt_train(rcfg, seed, device)
    module.to(torch_dtype(tcfg.param_dtype))
    params = dict(module.named_parameters())
    opt = make_optimizer(tcfg, module)
    return TrainState(module=module, opt_state=opt.init(params),
                      ema=ema_lib.init(params, torch_dtype(tcfg.ema_dtype)), step=0)


def train_draws(rcfg: R.RDTRunnerConfig, tcfg: TrainConfig, state: TrainState,
                batch: dict, generator: Optional[torch.Generator] = None) -> dict:
    """A step's draws from ``generator``: ``noise`` (n_micro, B, H, D),
    ``timesteps`` (n_micro, B) and, for bf16 parameters / EMA,
    ``apply_bits`` / ``ema_bits`` (name -> 16-bit integers)."""
    gt = batch["action_gt"]
    n_micro = gt.shape[0]
    draws = R.loss_draws(rcfg, (n_micro * gt.shape[1],) + tuple(gt.shape[2:]),
                         gt.device, generator)
    out = {"noise": draws["noise"].reshape(gt.shape),
           "timesteps": draws["timesteps"].reshape(gt.shape[:2])}

    def bits():
        return {n: torch.randint(0, 1 << 16, p.shape, generator=generator, device=p.device)
                for n, p in state.module.named_parameters()}
    if tcfg.param_dtype == "bfloat16":
        out["apply_bits"] = bits()
    if tcfg.ema_dtype == "bfloat16":
        out["ema_bits"] = bits()
    return out


def train_step(rcfg: R.RDTRunnerConfig, tcfg: TrainConfig, state: TrainState, batch: dict,
               draws: Optional[dict] = None, generator: Optional[torch.Generator] = None,
               optimizer: Optional[RDTOptimizer] = None):
    """One optimizer step over ``grad_accum`` micro-batches, in place on
    ``state`` -> (state, metrics as device tensors).

    ``batch`` leaves are shaped (grad_accum, micro_batch, ...) on the
    module's device.  ``draws``: :func:`train_draws`' dict (from
    ``generator`` when None)."""
    _check_param_dtype(tcfg)
    opt = optimizer or make_optimizer(tcfg, state.module)
    if draws is None:
        draws = train_draws(rcfg, tcfg, state, batch, generator)
    names = leaf_names(state.module)
    params = state.params
    leaves = [params[n] for n in names]
    acc_dtype = torch_dtype(tcfg.accum_dtype)
    n_micro = batch["action_gt"].shape[0]
    g_sum, loss_sum = None, torch.zeros((), device=leaves[0].device)
    for i in range(n_micro):
        mb = {k: v[i] for k, v in batch.items()}
        loss = R.rdt_compute_loss(rcfg, state.module, mb, noise=draws["noise"][i],
                                  timesteps=draws["timesteps"][i])
        g = [x.to(acc_dtype) for x in torch.autograd.grad(loss, leaves)]
        if g_sum is None:
            g_sum = g
        else:
            torch._foreach_add_(g_sum, g)
        loss_sum = loss_sum + loss.detach()
        del g, loss
    grads = torch._foreach_div([x.float() for x in g_sum], float(n_micro))
    del g_sum
    g_norm = global_norm(grads)
    updates, state.opt_state = opt.update(dict(zip(names, grads)), state.opt_state,
                                          params, g_norm=g_norm)
    del grads
    with torch.no_grad():
        if tcfg.param_dtype == "bfloat16":
            for n in names:
                p = params[n]
                p.copy_(ema_lib.stochastic_round_bf16(p.float() + updates[n].float(),
                                                      draws["apply_bits"][n]))
        else:
            torch._foreach_add_(leaves, [updates[n] for n in names])
    del updates
    decay = ema_lib.rdt_ema_decay(state.step, inv_gamma=tcfg.ema_inv_gamma,
                                  power=tcfg.ema_power, max_value=tcfg.ema_decay)
    state.ema = ema_lib.update(state.ema, params, decay, noise=draws.get("ema_bits"))
    state.step += 1
    return state, {"loss": loss_sum / n_micro, "grad_norm": g_norm}
