"""8-bit AdamW: blockwise-quantized optimizer moments (counterpart of
``vla_touch_tpu/ops/adam8bit.py``).

The first moment and sqrt of the second are stored int8 with one float32
scale per block of 256 values (dynamic symmetric quantization: amax floored
at 1e-12, codes ``round(x * 127 / amax)`` clipped to +-127), dequantized
and requantized inside each update.  A leaf is blocked in the JAX
package's layout (a Linear weight as its transposed flax kernel, the
caller's ``transposed`` flag), so the int8 trees are the JAX package's bit
for bit.  Divisions by 127 are IEEE quotients (``ops.quant.true_div``).
Memory: 2 moments x (1 + 4/256) bytes a parameter, against 8 for float32
Adam.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from vla_touch_tpu_torch.ops.quant import true_div

BLOCK = 256


def n_blocks(numel: int) -> int:
    return -(-numel // BLOCK)


def quantize_blockwise(x: torch.Tensor):
    """A float tensor -> (int8 codes (n_blocks, 256) of its flattened,
    zero-padded values, float32 scales (n_blocks,))."""
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, n_blocks(flat.numel()) * BLOCK - flat.numel()))
    blocks = flat.reshape(-1, BLOCK)
    amax = torch.clamp_min(blocks.abs().amax(dim=1, keepdim=True), 1e-12)
    q = torch.clamp(torch.round(blocks * true_div(127.0, amax)), -127, 127)
    return q.to(torch.int8), true_div(amax[:, 0], 127.0)


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scales[:, None]).reshape(-1)
    return flat[: int(np.prod(shape, dtype=np.int64))].reshape(shape)


@dataclasses.dataclass
class Adam8bitState:
    """optax-ordered state of :func:`update`: the update count and, per
    parameter name, the moments' codes and scales."""

    count: int
    m_q: dict
    m_s: dict
    v_q: dict
    v_s: dict


def init(params: dict) -> Adam8bitState:
    def zq(p):
        return torch.zeros((n_blocks(p.numel()), BLOCK), dtype=torch.int8, device=p.device)

    def zs(p):
        return torch.zeros((n_blocks(p.numel()),), dtype=torch.float32, device=p.device)

    return Adam8bitState(count=0,
                         m_q={n: zq(p) for n, p in params.items()},
                         m_s={n: zs(p) for n, p in params.items()},
                         v_q={n: zq(p) for n, p in params.items()},
                         v_s={n: zs(p) for n, p in params.items()})


def _leaf_update(g, mq, ms, vq, vs, p, lr, bc1, sqrt_bc2, b1, b2, eps, weight_decay):
    """One leaf in the JAX package's layout -> (update, m codes, m scales,
    v codes, v scales)."""
    g = g.float()
    m = dequantize_blockwise(mq, ms, g.shape)
    # the second moment is stored as sqrt(v): int8's 127 levels cover v's
    # squared dynamic range far too coarsely
    sv = dequantize_blockwise(vq, vs, g.shape)
    v = b2 * torch.square(sv) + (1 - b2) * torch.square(g)
    m = b1 * m + (1 - b1) * g
    # sqrt in float64, rounded once: torch's vectorised float32 sqrt on the
    # CPU is not always correctly rounded, and one ulp moves a block's amax
    sv_new = torch.sqrt(v.double()).float()
    denom = sv_new / sqrt_bc2 + eps
    step = m / bc1 / denom
    # coordinates whose sqrt(v) quantizes to zero are unresolvable this
    # step: skipped rather than divided by ~eps
    vq2, vs2 = quantize_blockwise(sv_new)
    resolvable = dequantize_blockwise(vq2, vs2, g.shape) > 0
    step = torch.where(resolvable, step, torch.zeros_like(step))
    if weight_decay:
        step = step + weight_decay * p.float()
    mq2, ms2 = quantize_blockwise(m)
    return -lr * step, mq2, ms2, vq2, vs2


@torch.no_grad()
def update(grads: dict, state: Adam8bitState, params: dict, schedule, b1: float = 0.9,
           b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 0.0,
           transposed=frozenset()):
    """AdamW with int8 blockwise moments -> (float32 updates, new state).

    The learning rate is ``schedule(count + 1)`` (the JAX transformation
    reads its schedule after incrementing the count); the bias corrections
    1 - b^count are float32.  Names in ``transposed`` are blocked as their
    transpose (the flax kernel layout); their updates come back in the
    parameter's own layout."""
    count = state.count + 1
    lr = float(np.float32(schedule(count)))
    c = np.float32(count)
    dev = next(iter(grads.values())).device
    bc1 = torch.tensor(np.float32(1) - np.float32(b1) ** c, device=dev)
    sqrt_bc2 = torch.tensor(np.sqrt(np.float32(1) - np.float32(b2) ** c), device=dev)
    new = Adam8bitState(count=count, m_q={}, m_s={}, v_q={}, v_s={})
    updates = {}
    for name, g in grads.items():
        p = params[name]
        t = name in transposed
        u, mq, ms, vq, vs = _leaf_update(
            g.t() if t else g, state.m_q[name], state.m_s[name], state.v_q[name],
            state.v_s[name], p.t() if t else p, lr, bc1, sqrt_bc2, b1, b2, eps, weight_decay)
        updates[name] = u.t() if t else u
        new.m_q[name], new.m_s[name], new.v_q[name], new.v_s[name] = mq, ms, vq, vs
    return updates, new
