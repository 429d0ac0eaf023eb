"""Exponential moving averages of parameters (counterpart of
``vla_touch_tpu/utils/ema.py``).

- :func:`torch_ema_decay`: torch_ema's ``ExponentialMovingAverage`` with
  ``use_num_updates=True`` (the BRIDGeR nets, decay 0.75): min(decay,
  (1 + n) / (10 + n));
- :func:`rdt_ema_decay`: the RDT trainer's warm-up EMA, clip(1 - (1 +
  step / inv_gamma)^-power, min_value, max_value), 0 until
  ``update_after_step``.

The state is a dict of float32 (or bf16) shadow tensors keyed by parameter
name, plus an update counter.  A bf16 shadow is rounded stochastically;
the 16 noise bits of each element come from a ``torch.Generator`` or are
given (the port cannot replay ``jax.random``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class EmaState:
    shadow: dict                 # name -> tensor
    num_updates: torch.Tensor    # int32 scalar


def init(params, dtype=torch.float32) -> EmaState:
    """``params``: a module or a dict name -> tensor."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return EmaState(shadow={k: v.detach().to(dtype).clone() for k, v in params.items()},
                    num_updates=torch.zeros((), dtype=torch.int32))


def stochastic_round_bf16(x, noise=None, generator: Optional[torch.Generator] = None):
    """Unbiased float32 -> bf16 rounding: ``noise`` (x's shape, integers in
    [0, 2^16)) is added to the low 16 bits of x's float32 pattern, which are
    then cut.  Without ``noise`` it is drawn from ``generator``.  Finite
    inputs only."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    if noise is None:
        noise = torch.randint(0, 1 << 16, x.shape, generator=generator, device=x.device)
    r = (bits + torch.as_tensor(noise, device=x.device).to(torch.int64)) & 0xFFFF0000
    r = torch.where(r >= 1 << 31, r - (1 << 32), r).to(torch.int32)
    return r.view(torch.float32).to(torch.bfloat16)


def torch_ema_decay(decay: float, num_updates) -> np.float32:
    n = np.float32(int(num_updates))
    return np.minimum(np.float32(decay), (np.float32(1.0) + n) / (np.float32(10.0) + n))


def rdt_ema_decay(step, update_after_step: int = 0, inv_gamma: float = 1.0,
                  power: float = 0.75, min_value: float = 0.0,
                  max_value: float = 0.9999) -> np.float32:
    s = np.maximum(np.float32(int(step)) - np.float32(update_after_step) - np.float32(1),
                   np.float32(0))
    value = np.float32(1.0) - (np.float32(1.0) + s / np.float32(inv_gamma)) ** np.float32(-power)
    value = np.float32(0.0) if s <= 0 else value
    return np.clip(np.float32(value), np.float32(min_value), np.float32(max_value))


@torch.no_grad()
def update(state: EmaState, params, decay, generator: Optional[torch.Generator] = None,
           noise: Optional[dict] = None) -> EmaState:
    """shadow <- shadow - (1 - decay) (shadow - params), in float32.  A bf16
    shadow is rounded by :func:`stochastic_round_bf16` with ``noise[name]``
    or bits from ``generator``.  ``params``: a module or a dict name ->
    tensor with the shadow's names."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    one_minus = float(np.float32(1.0) - np.float32(decay))
    bf16 = any(s.dtype == torch.bfloat16 for s in state.shadow.values())
    if bf16 and generator is None and noise is None:
        raise ValueError("a bf16 EMA shadow needs noise bits for stochastic rounding")
    names = list(state.shadow)
    if not bf16 and all(s.dtype == torch.float32 for s in state.shadow.values()):
        # the float32 update over all tensors at once, in the same order
        shadow = [state.shadow[n] for n in names]
        d = torch._foreach_sub(shadow, [params[n].detach().float() for n in names])
        torch._foreach_mul_(d, one_minus)
        return EmaState(shadow=dict(zip(names, torch._foreach_sub(shadow, d))),
                        num_updates=state.num_updates + 1)
    out = {}
    for name, s in state.shadow.items():
        sf = s.float()
        new = sf - one_minus * (sf - params[name].detach().float())
        if s.dtype == torch.bfloat16:
            new = stochastic_round_bf16(new, None if noise is None else noise[name], generator)
        out[name] = new.to(s.dtype)
    return EmaState(shadow=out, num_updates=state.num_updates + 1)


def update_torch_ema(state: EmaState, params, decay: float = 0.75) -> EmaState:
    """torch_ema's step: the counter increments BEFORE the decay is
    computed (the first update uses (1 + 1) / (10 + 1))."""
    return update(state, params, torch_ema_decay(decay, int(state.num_updates) + 1))
