"""Core building blocks as ``torch.nn`` modules (counterpart of
``vla_touch_tpu/ops/nn.py``).

Conventions: parameters live in the module's dtype (the compute dtype: the
port stores bf16 weights where the JAX package keeps f32 masters and casts
per use); normalisation statistics are float32; channels-last (B, T, C)
for the 1-D convolutions, (B, L, H, D) for attention.  Parameter names
mirror the JAX package's flax names so :mod:`utils.from_flax` is a rename
plus layout transforms.

:func:`gelu_erf` is the exact GELU as XLA:CPU compiles
``jax.jit(jax.nn.gelu(x, approximate=False))`` in jax 0.9.0, read off that
program's HLO text (``.lower(x).compile().as_text()``).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from vla_touch_tpu_torch.ops import attention as A

# The activations below are written out operation by operation, as XLA
# computes JAX's: each operation rounds to the array's dtype.  F.silu and
# F.gelu round once; on bf16 they leave 25-45 % of outputs a bf16 step away
# from JAX's.  Both sides are the same arithmetic on the CPU and the card:
# a bf16 op computes in float32 and rounds, and a Python scalar enters a
# bf16 op unrounded, so JAX's constants (cast to the array's dtype) are
# rounded here first.


@functools.cache
def _const(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def silu(x):
    """``jax.nn.silu``: x * logistic(x), logistic as 1 / (1 + exp(-x))."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x):
    """``jax.nn.gelu(approximate=True)`` (``nn.GELU(approximate='tanh')``):
    x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))."""
    c, a = _const(math.sqrt(2 / math.pi), x.dtype), _const(0.044715, x.dtype)
    inner = c * (x + a * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def quick_gelu(x):
    """CLIP's x * sigmoid(1.702 x), the sigmoid as :func:`silu`'s."""
    return x * (1 / (1 + torch.exp(-(_const(1.702, x.dtype) * x))))


# XLA:CPU's erfc(z) in float32, as the compiled HLO writes it out: for |z| < 1,
# 1 - z P(z^2); else e^(-z^2) / |z| Q(1 / z^2), Q one polynomial below |z| = 2
# and another above, 0 once -z^2 < -88.7228394, and 2 minus that for z < 0.
# The CPU backend contracts each multiply-add of the polynomials into an FMA
# and flushes denormal results to 0.
_ERFC_NEAR = (7.85386146e-05, -8.01019371e-04, 5.18832775e-03, -2.68538129e-02,
              1.12835854e-01, -3.76126260e-01, 1.12837911)
_ERFC_MID = (2.32682e-02, -1.38703942e-01, 3.68742466e-01, -5.82473278e-01,
             6.21000469e-01, -4.94451523e-01, 3.40488e-01, -2.74112701e-01,
             5.63825965e-01)
_ERFC_FAR = (-1.0477664e+01, 1.29772e+01, -7.49551868, 2.92101908, -1.01526523,
             4.2184633e-01, -2.82076746e-01, 5.64189494e-01)
_F32_TINY = 2.0 ** -126


def _ftz(x):
    return x.masked_fill(x.abs() < _F32_TINY, 0.0)


def _fma_horner(t, coeffs):
    """Horner's rule in float32 with each multiply-add rounded once, as the
    FMA does: the float64 product of two float32 values is exact."""
    c = [_const(v, torch.float32) for v in coeffs]
    t64 = t.double()
    y = (t64 * c[0] + c[1]).float()
    for ci in c[2:]:
        y = (y.double() * t64 + ci).float()
    return y


def _erfc_xla(z, exp):
    a = z.abs()
    z2 = z * z
    near = (1.0 - z.double() * _fma_horner(z2, _ERFC_NEAR).double()).float()
    r = 1.0 / z2
    q = _ftz(_ftz(exp(-z2)) * (1.0 / a))
    y = _ftz(q * torch.where(a < 2.0, _fma_horner(r, _ERFC_MID), _fma_horner(r, _ERFC_FAR)))
    y = y.masked_fill(-z2 < _const(-88.7228394, torch.float32), 0.0)
    y = torch.where(z < 0.0, 2.0 - y, y)
    return torch.where(a < 1.0, near, y)


def _gelu_erf_program(x, exp):
    """:func:`gelu_erf` written out operation by operation, with ``exp`` as
    the float32 exponential (tests pass XLA's own to isolate the only
    operation written differently)."""
    if x.dtype == torch.float32:
        return _ftz(_ftz(x * 0.5) * _erfc_xla(-x * _const(0.707106769, torch.float32), exp))
    e = _erfc_xla((-x).float() * 0.70703125, exp).to(torch.bfloat16)
    return _ftz(_ftz(x.float() * 0.5).to(torch.bfloat16) * e)


@functools.cache
def _gelu_erf_bf16_table(device: torch.device):
    """:func:`gelu_erf` of every bf16 value, indexed by its 16 bits: computed
    on the CPU (where the tests hold all of it to JAX) and copied to
    ``device``."""
    bits = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    return _gelu_erf_program(bits.view(torch.bfloat16), torch.exp).to(device)


class _GeluErf(torch.autograd.Function):
    """float32 :func:`gelu_erf` with JAX's derivative of
    ``jax.nn.gelu(approximate=False)``: 0.5 erfc(-x / sqrt(2)) + x
    exp(-x^2 / 2) / sqrt(2 pi), in float32, as ``jax.grad`` writes it (erfc's
    rule -2 / sqrt(pi) exp(-u^2) du at u = -x / sqrt(2)).  Autograd through
    the forward's erfc polynomial, selects and flushes would give another
    gradient."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu_erf_program(x, torch.exp)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        c = _const(0.707106769, torch.float32)
        u = -x * c
        q = ((_const(-2 / math.sqrt(math.pi), torch.float32) * (x * 0.5 * g))
             * torch.exp(-(u * u))) * c
        return -q + 0.5 * (g * _erfc_xla(u, torch.exp))


def gelu_erf(x):
    """``jax.nn.gelu(x, approximate=False)`` under ``jit``, as XLA:CPU
    computes it: 0.5 x erfc(-x / sqrt(2)) with :func:`_erfc_xla`, every
    denormal result flushed to 0.

    float32 x: that program.  bfloat16 x: erfc's argument stays float32
    (f32(-x) times bf16(1/sqrt(2)) = 0.70703125; XLA drops the bf16 round
    trip the jaxpr has there), erfc is rounded to bf16, and bf16(0.5 x)
    times it is rounded once.  A bf16 x has 65536 values, so the program
    runs once, on the CPU, over all of them and x indexes that table (one
    copy per device): one gather in place of ~130 elementwise passes."""
    if x.dtype == torch.bfloat16:
        idx = x.view(torch.int16).to(torch.int32) & 0xFFFF
        return _gelu_erf_bf16_table(x.device)[idx]
    if x.dtype != torch.float32:
        raise TypeError(f"gelu_erf: float32 or bfloat16, got {x.dtype}")
    if torch.is_grad_enabled() and x.requires_grad:
        return _GeluErf.apply(x)
    return _gelu_erf_program(x, torch.exp)


def mish(x):
    """Mish: x * tanh(softplus(x))."""
    return x * torch.tanh(F.softplus(x))


class RmsNorm(nn.Module):
    """y = x / sqrt(mean(x^2) + eps) * weight, statistics in float32; the
    output keeps the input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


def compute_dtype_of(linear) -> torch.dtype:
    """The dtype a Linear computes in: a :class:`CastLinear`'s
    ``compute_dtype``, else its weight's."""
    return getattr(linear, "compute_dtype", linear.weight.dtype)


class CastLinear(nn.Linear):
    """A Linear over master weights that computes in ``compute_dtype``, as
    flax's ``Dense(dtype=compute, param_dtype=float32)`` does: input, weight
    and bias are cast to the compute dtype (differentiably, so gradients
    land in the master dtype), the product is rounded, then the bias is
    added and rounded again."""

    compute_dtype: torch.dtype = torch.float32

    def forward(self, x):
        cd = self.compute_dtype
        y = F.linear(x.to(cd), self.weight.to(cd))
        return y if self.bias is None else y + self.bias.to(cd)


def cast_linears_(module: nn.Module, compute_dtype: torch.dtype) -> nn.Module:
    """Replace every ``nn.Linear`` under ``module`` by a :class:`CastLinear`
    computing in ``compute_dtype`` that holds the same parameters (names
    and tensors unchanged)."""
    for parent in list(module.modules()):
        for name, child in list(parent.named_children()):
            if type(child) is nn.Linear:
                new = CastLinear(child.in_features, child.out_features,
                                 bias=child.bias is not None, device="meta")
                new.weight, new.bias = child.weight, child.bias
                new.compute_dtype = compute_dtype
                setattr(parent, name, new)
    return module


class Mlp(nn.Module):
    """fc1 -> tanh-GELU -> fc2, both with bias."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int | None = None):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, out_features or in_features)

    def forward(self, x):
        return self.fc2(gelu_tanh(self.fc1(x)))


class SelfAttention(nn.Module):
    """Fused qkv projection, per-head qk-RmsNorm, attention through K1."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.q_norm = RmsNorm(head_dim)
        self.k_norm = RmsNorm(head_dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, C // self.num_heads)
        q = self.q_norm(qkv[:, :, 0])
        k = self.k_norm(qkv[:, :, 1])
        out = A.dot_product_attention(q, k, qkv[:, :, 2])
        return self.proj(out.reshape(B, N, C))


class CrossAttention(nn.Module):
    """Masked cross-attention: queries from x, keys/values from c."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.q_norm = RmsNorm(head_dim)
        self.k_norm = RmsNorm(head_dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, c, mask=None):
        B, N, C = x.shape
        L = c.shape[1]
        hd = C // self.num_heads
        q = self.q_norm(self.q(x).reshape(B, N, self.num_heads, hd))
        kv = self.kv(c).reshape(B, L, 2, self.num_heads, hd)
        k = self.k_norm(kv[:, :, 0])
        out = A.dot_product_attention(q, k, kv[:, :, 1], kv_mask=mask)
        return self.proj(out.reshape(B, N, C))


class GroupNorm(nn.Module):
    """GroupNorm on channels-last (B, T, C): each group normalised over
    (T, C/G) jointly with the biased variance (torch semantics)."""

    def __init__(self, num_channels: int, num_groups: int = 8, eps: float = 1e-5):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_channels} channels, {num_groups} groups")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        B, T, C = x.shape
        G = self.num_groups
        xf = x.float().reshape(B, T, G, C // G)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = xf.var(dim=(1, 3), keepdim=True, unbiased=False)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(B, T, C)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class Conv1d(nn.Module):
    """1-D convolution on channels-last (B, T, C); weight (F, Cin, k) as
    ``torch.nn.Conv1d``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        y = F.conv1d(x.transpose(1, 2), self.weight, self.bias,
                     stride=self.stride, padding=self.padding)
        return y.transpose(1, 2)


class ConvTranspose1d(nn.Module):
    """Transposed 1-D convolution on channels-last input with
    ``torch.nn.ConvTranspose1d`` semantics (k 4, stride 2, padding 1
    doubles the length); weight (Cin, F, k)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 2, padding: int = 1):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x):
        y = F.conv_transpose1d(x.transpose(1, 2), self.weight, self.bias,
                               stride=self.stride, padding=self.padding)
        return y.transpose(1, 2)


class LayerNorm(nn.Module):
    """flax's ``LayerNorm`` (epsilon 1e-6, ``use_fast_variance``): var =
    max(0, mean(x^2) - mean(x)^2), y = (x - mean) (rsqrt(var + eps) weight)
    + bias."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mu = x.mean(dim=-1, keepdim=True)
        var = torch.clamp_min((x * x).mean(dim=-1, keepdim=True) - mu * mu, 0.0)
        return (x - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def dropout(x, rate: float, keep):
    """flax's ``Dropout`` under the keep mask ``keep`` (x's shape, bool):
    where(keep, x / (1 - rate), 0)."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class LSTMCellTorch(nn.Module):
    """One LSTM cell with torch's gate order (i, f, g, o) and double bias
    (``ih`` and ``hh`` Linears).  carry (h, c); x (B, input_dim)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.ih = nn.Linear(input_size, 4 * hidden_size)
        self.hh = nn.Linear(hidden_size, 4 * hidden_size)

    def forward(self, carry, x):
        h_prev, c_prev = carry
        i, f, g, o = torch.chunk(self.ih(x) + self.hh(h_prev), 4, dim=-1)
        i, f, o = (1 / (1 + torch.exp(-v)) for v in (i, f, o))
        c = f * c_prev + i * torch.tanh(g)
        h = o * torch.tanh(c)
        return (h, c), h


class StackedLSTM(nn.Module):
    """Multi-layer unidirectional LSTM; cells ``layer{i}``.  The sequence
    runs :meth:`step_fn` step by step, so the sequence mode and the
    stateful single step are the same arithmetic."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 2):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", LSTMCellTorch(input_size if i == 0 else hidden_size,
                                                       hidden_size))

    def init_carry(self, batch: int, device=None, dtype=torch.float32):
        z = torch.zeros((batch, self.hidden_size), device=device, dtype=dtype)
        return tuple((z, z) for _ in range(self.num_layers))

    def step_fn(self, carry, x_t):
        """One time step through all layers; carry: tuple of (h, c)."""
        new = []
        inp = x_t
        for i, layer_carry in enumerate(carry):
            layer_carry, inp = getattr(self, f"layer{i}")(layer_carry, inp)
            new.append(layer_carry)
        return tuple(new), inp

    def forward(self, xs, carry=None):
        """xs (B, T, D) -> (ys (B, T, H), final carry)."""
        if carry is None:
            carry = self.init_carry(xs.shape[0], xs.device, xs.dtype)
        ys = []
        for t in range(xs.shape[1]):
            carry, y = self.step_fn(carry, xs[:, t])
            ys.append(y)
        return torch.stack(ys, dim=1), carry
