"""Core building blocks as ``torch.nn`` modules (counterpart of
``vla_touch_tpu/ops/nn.py``).

Conventions: parameters live in the module's dtype (the compute dtype: the
port stores bf16 weights where the JAX package keeps f32 masters and casts
per use); normalisation statistics are float32; channels-last (B, T, C)
for the 1-D convolutions, (B, L, H, D) for attention.  Parameter names
mirror the JAX package's flax names so :mod:`utils.from_flax` is a rename
plus layout transforms.
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
