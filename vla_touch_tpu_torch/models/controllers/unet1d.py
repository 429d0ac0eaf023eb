"""FiLM-conditioned temporal UNet-1D (counterpart of
``vla_touch_tpu/models/controllers/unet1d.py``), channels-last (B, T, C).

Down path over ``down_dims`` (two FiLM residual blocks + stride-2 conv), two
mid blocks, up path with skip concatenation + transposed-conv upsampling,
final Conv1dBlock + pointwise conv.  With ``down_dims`` (256, 512, 512) the
net holds 12 residual blocks: 6 down, 2 mid, 4 up.

This module is the per-network reference form; the serving path evaluates
the stacked v/s nets through :mod:`unet1d_serve` and kernel K2.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from vla_touch_tpu_torch.ops.nn import Conv1d, ConvTranspose1d, GroupNorm, mish
from vla_touch_tpu_torch.ops.pos_embed import sinusoidal_pos_emb


class Conv1dBlock(nn.Module):
    """Conv1d -> GroupNorm -> Mish."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 n_groups: int = 8):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size,
                           padding=kernel_size // 2)
        self.gn = GroupNorm(out_channels, n_groups)

    def forward(self, x):
        return mish(self.gn(self.conv(x)))


class ConditionalResidualBlock1D(nn.Module):
    """Two Conv1dBlocks with FiLM after the first: Mish(cond) @ cond_encoder
    -> [scale | bias] per channel; 1x1 residual conv when Cin != C."""

    def __init__(self, in_channels: int, out_channels: int, cond_dim: int,
                 kernel_size: int = 3, n_groups: int = 8):
        super().__init__()
        self.out_channels = out_channels
        self.block0 = Conv1dBlock(in_channels, out_channels, kernel_size, n_groups)
        self.cond_encoder = nn.Linear(cond_dim, 2 * out_channels)
        self.block1 = Conv1dBlock(out_channels, out_channels, kernel_size, n_groups)
        if in_channels != out_channels:
            self.residual_conv = Conv1d(in_channels, out_channels, 1)

    def forward(self, x, cond):
        out = self.block0(x)
        embed = self.cond_encoder(mish(cond))
        C = self.out_channels
        out = embed[:, None, :C] * out + embed[:, None, C:]
        out = self.block1(out)
        if hasattr(self, "residual_conv"):
            x = self.residual_conv(x)
        return out + x


class ConditionalUnet1D(nn.Module):
    """The diffusion UNet (``use_timestep``) or its plain residual variant."""

    def __init__(self, input_dim: int, global_cond_dim: int,
                 down_dims: Sequence[int] = (256, 512, 1024), kernel_size: int = 5,
                 n_groups: int = 8, diffusion_step_embed_dim: int = 256,
                 use_timestep: bool = True):
        super().__init__()
        self.down_dims = tuple(down_dims)
        self.use_timestep = use_timestep
        self.dsed = diffusion_step_embed_dim
        cond_dim = global_cond_dim
        if use_timestep:
            self.step_fc1 = nn.Linear(self.dsed, 4 * self.dsed)
            self.step_fc2 = nn.Linear(4 * self.dsed, self.dsed)
            cond_dim += self.dsed
        all_dims = [input_dim] + list(down_dims)
        in_out = list(zip(all_dims[:-1], all_dims[1:]))
        self.num_levels = len(in_out)
        kw = dict(cond_dim=cond_dim, kernel_size=kernel_size, n_groups=n_groups)
        for i, (din, dout) in enumerate(in_out):
            self.add_module(f"down{i}_res0", ConditionalResidualBlock1D(din, dout, **kw))
            self.add_module(f"down{i}_res1", ConditionalResidualBlock1D(dout, dout, **kw))
            if i < len(in_out) - 1:
                self.add_module(f"down{i}_down", Conv1d(dout, dout, 3, stride=2,
                                                        padding=1))
        mid = all_dims[-1]
        self.mid0 = ConditionalResidualBlock1D(mid, mid, **kw)
        self.mid1 = ConditionalResidualBlock1D(mid, mid, **kw)
        for i, (din, dout) in enumerate(reversed(in_out[1:])):
            self.add_module(f"up{i}_res0", ConditionalResidualBlock1D(2 * dout, din, **kw))
            self.add_module(f"up{i}_res1", ConditionalResidualBlock1D(din, din, **kw))
            self.add_module(f"up{i}_up", ConvTranspose1d(din, din, 4, stride=2,
                                                         padding=1))
        self.final_block = Conv1dBlock(down_dims[0], down_dims[0], kernel_size,
                                       n_groups)
        self.final_conv = Conv1d(down_dims[0], input_dim, 1)

    def forward(self, sample, timestep=None, global_cond=None):
        """sample (B, T, input_dim); timestep (B,); global_cond (B, G)."""
        feats = []
        if self.use_timestep:
            t_emb = sinusoidal_pos_emb(timestep, self.dsed,
                                       dtype=self.step_fc1.weight.dtype)
            feats.append(self.step_fc2(mish(self.step_fc1(t_emb))))
        if global_cond is not None:
            feats.append(global_cond.to(self.final_conv.weight.dtype))
        cond = torch.cat(feats, dim=-1)
        x = sample.to(self.final_conv.weight.dtype)
        skips = []
        for i in range(self.num_levels):
            x = getattr(self, f"down{i}_res0")(x, cond)
            x = getattr(self, f"down{i}_res1")(x, cond)
            skips.append(x)
            if i < self.num_levels - 1:
                x = getattr(self, f"down{i}_down")(x)
        x = self.mid1(self.mid0(x, cond), cond)
        for i in range(self.num_levels - 1):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = getattr(self, f"up{i}_res0")(x, cond)
            x = getattr(self, f"up{i}_res1")(x, cond)
            x = getattr(self, f"up{i}_up")(x)
        return self.final_conv(self.final_block(x))


class SITripleUnet(nn.Module):
    """b/v/s network bundle of the stochastic-interpolants model."""

    def __init__(self, input_dim: int, global_cond_dim: int,
                 down_dims: Sequence[int] = (256, 512, 512)):
        super().__init__()
        kw = dict(input_dim=input_dim, global_cond_dim=global_cond_dim,
                  down_dims=down_dims)
        self.b_net = ConditionalUnet1D(**kw)
        self.v_net = ConditionalUnet1D(**kw)
        self.s_net = ConditionalUnet1D(**kw)

    def forward(self, sample, timestep, global_cond):
        return (self.b_net(sample, timestep, global_cond),
                self.v_net(sample, timestep, global_cond),
                self.s_net(sample, timestep, global_cond))
