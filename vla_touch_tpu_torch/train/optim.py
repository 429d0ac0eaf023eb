"""Optimizers in optax's order.

:class:`AdamW` (the controllers' trainers) is ``optax.adamw`` (b1 0.9, b2
0.999, eps 1e-8, decay on every parameter); it and :class:`RDTOptimizer`
run :func:`adamw_update`, multi-tensor ``torch._foreach`` operations:

    mu <- (1 - b1) g + b1 mu,   nu <- (1 - b2) g^2 + b2 nu,   n <- n + 1
    u  <- (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps) + wd p
    p  <- p + (-lr) u

``torch.optim.AdamW`` decays the parameter before the moment step and folds
the bias corrections differently; its default decay is 1e-2.  The learning
rate is an argument of each step (the trainers compute it on the host).

:class:`RDTOptimizer` is the RDT trainer's ``optax.chain(
clip_by_global_norm(max_grad_norm), adamw | adamw8bit)`` with the learning
rate schedules of ``train/rdt_train.py::make_optimizer``
(:func:`make_schedule`, float32 as optax evaluates them at the update
count).  It works on dicts name -> tensor and keeps optax's state in
:class:`AdamWState` / ``ops.adam8bit.Adam8bitState``; :meth:`to_tree` and
:meth:`from_tree` are that state as optax's nested tuples serialize.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from vla_touch_tpu_torch.ops import adam8bit as A8


class AdamW:
    def __init__(self, params, weight_decay: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = [p for p in params if p.requires_grad]
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, lr: float) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        self.count += 1
        self.mu, self.nu, u = adamw_update(grads, self.mu, self.nu, self.params, self.count,
                                           lr, self.b1, self.b2, self.eps, self.weight_decay)
        torch._foreach_add_(self.params, u)


@torch.no_grad()
def adamw_update(g: list, mu: list, nu: list, params: list, count: int, lr: float,
                 b1: float, b2: float, eps: float, weight_decay: float):
    """One ``optax.adamw`` update of a group of leaves: (mu, nu, updates)
    at the new ``count``, with the bias corrections in float32 as optax
    computes them and the decay of the (float32) parameters added before
    the scale by ``-lr``."""
    mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1), torch._foreach_mul(mu, b1))
    nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                            torch._foreach_mul(nu, b2))
    n = np.float32(count)
    bc1 = float(np.float32(1) - np.float32(b1) ** n)
    bc2 = float(np.float32(1) - np.float32(b2) ** n)
    den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(den, eps)
    u = torch._foreach_div(torch._foreach_div(mu, bc1), den)
    if weight_decay:
        torch._foreach_add_(u, torch._foreach_mul([p.float() for p in params], weight_decay))
    torch._foreach_mul_(u, -float(np.float32(lr)))
    return mu, nu, u


def float32_math() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN convolutions.  The trainers
    run in float32, as the JAX package's do; PyTorch's default lets cuDNN's
    convolutions (the UNet's ``F.conv1d``, forward and backward) take TF32
    inputs.  Process-wide: these are global switches of ``torch.backends``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---- the RDT trainer's optimizer ---------------------------------------------


# The JAX package evaluates its schedule inside the jitted train step, where
# XLA turns a division by a constant into a product with its float32
# reciprocal and contracts a multiply-add into one FMA; so do these (in
# float64, where the product of two float32 values is exact).


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Callable:
    """``optax.linear_schedule``: constant ``init_value`` when
    ``transition_steps`` <= 0."""
    if transition_steps <= 0:
        return lambda count: np.float32(init_value)
    recip = np.float32(1) / np.float32(transition_steps)

    def schedule(count):
        c = np.clip(np.int32(count), 0, transition_steps)
        frac = np.float32(1.0 - np.float64(c) * np.float64(recip))
        return np.float32(np.float64(np.float32(init_value - end_value)) * np.float64(frac)
                    + np.float64(np.float32(end_value)))
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Callable:
    """``optax.cosine_decay_schedule`` with exponent 1."""
    recip = np.float32(1) / np.float32(decay_steps)

    def schedule(count):
        c = np.minimum(np.float32(count), np.float32(decay_steps))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(math.pi) * c * recip))
        return np.float32(init_value) * (np.float32(1 - alpha) * cosine + np.float32(alpha))
    return schedule


def join_schedules(schedules, boundaries) -> Callable:
    """``optax.join_schedules``: schedule i + 1 from boundary i on, at the
    count less that boundary."""
    def schedule(count):
        out = schedules[0](count)
        for boundary, fn in zip(boundaries, schedules[1:]):
            out = out if count < boundary else fn(count - boundary)
        return np.float32(out)
    return schedule


def make_schedule(tcfg) -> Callable:
    """The learning rate a count, as ``rdt_train.make_optimizer`` builds it:
    "constant" and "constant_with_warmup" (a linear warm-up from 0, then
    the rate), "linear" (warm-up, then linear decay to 0 at
    ``max_train_steps``), "cosine" (warm-up, then cosine decay)."""
    lr, warm = tcfg.learning_rate, tcfg.lr_warmup_steps
    warmup = linear_schedule(0.0, lr, warm)
    if tcfg.lr_scheduler in ("constant", "constant_with_warmup"):
        return join_schedules([warmup, lambda count: np.float32(lr)], [warm])
    if tcfg.lr_scheduler == "linear":
        decay = linear_schedule(lr, 0.0, max(tcfg.max_train_steps - warm, 1))
        return join_schedules([warmup, decay], [warm])
    if tcfg.lr_scheduler == "cosine":
        return join_schedules([warmup, cosine_decay_schedule(
            lr, tcfg.max_train_steps - warm)], [warm])
    raise ValueError(tcfg.lr_scheduler)


def global_norm(grads: list) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's sum of squares,
    float32, as ``optax.global_norm``."""
    total = None
    for g in grads:
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: list, max_norm: float, g_norm: torch.Tensor) -> list:
    """``optax.clip_by_global_norm``: the leaves unchanged when the global
    norm is below ``max_norm``, else (g / norm) * max_norm.  One host read
    of the norm."""
    if float(g_norm) < max_norm:
        return grads
    return torch._foreach_mul(torch._foreach_div(grads, g_norm), max_norm)


@dataclasses.dataclass
class AdamWState:
    """``optax.adamw``'s state: the update count (``scale_by_adam``'s and
    ``scale_by_schedule``'s, always equal) and the moments by name."""

    count: int
    mu: dict
    nu: dict


# leaves the float32 AdamW updates at once, to bound its temporaries
_GROUP = 64


class RDTOptimizer:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule, b1,
    b2, eps, weight_decay))`` or, with ``use_8bit_adam``, ``adamw8bit`` in
    its place.  ``transposed``: the parameter names whose JAX layout is
    the transpose (blocking of the 8-bit moments)."""

    def __init__(self, tcfg, transposed=frozenset()):
        self.tcfg = tcfg
        self.schedule = make_schedule(tcfg)
        self.transposed = frozenset(transposed)

    def init(self, params: dict):
        if self.tcfg.use_8bit_adam:
            return A8.init(params)
        return AdamWState(count=0, mu={n: torch.zeros_like(p, dtype=torch.float32)
                                       for n, p in params.items()},
                          nu={n: torch.zeros_like(p, dtype=torch.float32)
                              for n, p in params.items()})

    @torch.no_grad()
    def update(self, grads: dict, state, params: dict, g_norm=None):
        """(updates, new state) for float32 ``grads`` keyed as ``params``;
        ``g_norm``: their global norm when the caller has it."""
        t = self.tcfg
        names = list(grads)
        g = [grads[n] for n in names]
        g_norm = global_norm(g) if g_norm is None else g_norm
        grads = dict(zip(names, clip_by_global_norm(g, t.max_grad_norm, g_norm)))
        if t.use_8bit_adam:
            return A8.update(grads, state, params, self.schedule, t.adam_beta1,
                             t.adam_beta2, t.adam_epsilon, t.weight_decay,
                             self.transposed)
        return self._adamw(grads, state, params)

    def _adamw(self, grads: dict, state: AdamWState, params: dict):
        t = self.tcfg
        lr = float(self.schedule(state.count))
        new = AdamWState(count=state.count + 1, mu={}, nu={})
        updates = {}
        names = list(grads)
        for i in range(0, len(names), _GROUP):
            part = names[i:i + _GROUP]
            mu, nu, u = adamw_update(
                [grads[n] for n in part], [state.mu[n] for n in part],
                [state.nu[n] for n in part], [params[n] for n in part], new.count, lr,
                t.adam_beta1, t.adam_beta2, t.adam_epsilon, t.weight_decay)
            for n, m_, v_, u_ in zip(part, mu, nu, u):
                new.mu[n], new.nu[n], updates[n] = m_, v_, u_
        return updates, new

    # ---- optax's state tree ----

    def to_tree(self, state, nest: Callable, nest_blocks: Callable) -> dict:
        """The state as flax serializes ``chain(clip, adamw | adamw8bit)``'s:
        ``nest(moments by name)`` gives a flax tree of parameter-shaped
        leaves, ``nest_blocks`` one of the 8-bit blocks (no transposes)."""
        count = np.asarray(state.count, np.int32)
        if self.tcfg.use_8bit_adam:
            return {"0": {}, "1": {"count": count,
                                   "m_q": nest_blocks(state.m_q), "m_s": nest_blocks(state.m_s),
                                   "v_q": nest_blocks(state.v_q), "v_s": nest_blocks(state.v_s)}}
        return {"0": {}, "1": {"0": {"count": count, "mu": nest(state.mu),
                                     "nu": nest(state.nu)},
                               "1": {}, "2": {"count": count}}}

    def orbax_tree(self, tree: dict) -> tuple:
        """:meth:`to_tree`'s tree in optax's containers, as orbax records
        them: the chains as tuples and the empty states as None (flax's
        msgpack writes both as dicts).  Read back, it is :meth:`to_tree`'s
        tree with None for ``{}``."""
        inner = tree["1"]
        if self.tcfg.use_8bit_adam:
            return (None, inner)
        return (None, (inner["0"], None, inner["2"]))

    def from_tree(self, tree: dict, unnest: Callable, unnest_blocks: Callable):
        """The inverse of :meth:`to_tree`."""
        inner = tree["1"]
        if self.tcfg.use_8bit_adam:
            return A8.Adam8bitState(
                count=int(inner["count"]), m_q=unnest_blocks(inner["m_q"]),
                m_s=unnest_blocks(inner["m_s"]), v_q=unnest_blocks(inner["v_q"]),
                v_s=unnest_blocks(inner["v_s"]))
        adam = inner["0"]
        if int(inner["2"]["count"]) != int(adam["count"]):
            raise ValueError("optimizer state: the schedule's count differs from Adam's")
        return AdamWState(count=int(adam["count"]), mu=unnest(adam["mu"]),
                          nu=unnest(adam["nu"]))
