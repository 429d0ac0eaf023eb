"""Configuration dataclasses of the ported slice.

Counterpart of ``vla_touch_tpu/config.py`` restricted to what the port
runs: the RDT model and noise scheduler, the BRIDGeR and LSTM controllers
with the interpolant, and the two controller trainers.  Defaults are
identical; dtypes resolve to torch dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


def torch_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


@dataclasses.dataclass(frozen=True)
class NoiseSchedulerConfig:
    """Upstream RDT-1B ``base.yaml`` noise_scheduler block."""

    num_train_timesteps: int = 1000
    beta_schedule: str = "squaredcos_cap_v2"
    prediction_type: str = "sample"
    clip_sample: bool = False
    num_inference_timesteps: int = 5


@dataclasses.dataclass(frozen=True)
class RDTModelConfig:
    """RDT transformer hyperparameters (defaults: RDT-1B, 2048 x 28 x 32)."""

    hidden_size: int = 2048
    depth: int = 28
    num_heads: int = 32
    horizon: int = 64
    output_dim: int = 128
    state_token_dim: int = 128
    max_lang_cond_len: int = 1024
    img_cond_len: int = 4374         # 2 frames x 3 cams x 729 SigLIP patches
    lang_token_dim: int = 4096       # T5-XXL
    img_token_dim: int = 1152        # SigLIP So400m
    lang_adaptor: str = "mlp2x_gelu"
    img_adaptor: str = "mlp2x_gelu"
    state_adaptor: str = "mlp3x_gelu"
    dtype: str = "bfloat16"
    img_pos_embed_grid: Optional[tuple] = (2, -3, 729)  # (frames, -cams, patches)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


def rdt_1b(**kw) -> RDTModelConfig:
    return RDTModelConfig(**kw)


def rdt_170m(**kw) -> RDTModelConfig:
    return RDTModelConfig(hidden_size=1152, depth=28, num_heads=16, **kw)


def rdt_tiny(**kw) -> RDTModelConfig:
    """Small config for tests; kwargs override the tiny defaults."""
    defaults = dict(hidden_size=128, depth=2, num_heads=4, horizon=8,
                    img_cond_len=24, max_lang_cond_len=16,
                    lang_token_dim=32, img_token_dim=48,
                    img_pos_embed_grid=None, dtype="float32")
    defaults.update(kw)
    return RDTModelConfig(**defaults)


@dataclasses.dataclass(frozen=True)
class InterpolantConfig:
    """BRIDGeR stochastic-interpolant hyperparameters (deployment defaults)."""

    interpolant_type: str = "linear"
    gamma_type: str = "2^0.5*t(t-1)"
    epsilon_type: str = "1-t"
    prior_policy: str = "vla"
    beta_max: float = 0.03           # noise scale `d`
    sde_type: str = "vs"             # 'vs' (velocity-score) | 'bs' (drift-score)
    t_min: float = 0.001
    gamma_inv_max: float = 200.0
    diffusion_steps: int = 10


@dataclasses.dataclass(frozen=True)
class BridgeControllerConfig:
    """BRIDGeR refinement controller."""

    state_dim: int = 10
    hidden_dim: int = 256
    force_dim: int = 3
    use_force: bool = True
    use_visual: bool = True
    horizon: int = 16
    obs_dim: int = 256               # encoded obs width fed to the UNets
    obs_horizon: int = 1
    context_frames: int = 2
    image_model: str = "dinov2-small"
    unet_down_dims: Sequence[int] = (256, 512, 512)
    # Compute dtype of the SDE's UNets (the encoder stays float32).
    inference_dtype: str = "float32"
    interpolant: InterpolantConfig = dataclasses.field(default_factory=InterpolantConfig)

    @property
    def visual_dim(self) -> int:
        return {"dinov2-small": 384, "dinov2-base": 768,
                "dinov2-large": 1024, "dinov2-giant": 1536}[self.image_model]

    @property
    def raw_obs_dim(self) -> int:
        d = self.state_dim
        if self.use_visual:
            d += 2 * self.visual_dim
        if self.use_force:
            d += self.force_dim
        return d

    @property
    def unet_dtype(self) -> torch.dtype:
        return torch_dtype(self.inference_dtype)


@dataclasses.dataclass(frozen=True)
class LSTMControllerConfig:
    """Tactile LSTM residual controller."""

    state_dim: int = 10
    hidden_dim: int = 256
    num_layers: int = 2
    dropout: float = 0.1
    force_dim: int = 3
    use_force: bool = True
    image_model: str = "dinov2-small"

    @property
    def visual_dim(self) -> int:
        return {"dinov2-small": 384, "dinov2-base": 768,
                "dinov2-large": 1024, "dinov2-giant": 1536}[self.image_model]

    @property
    def obs_dim(self) -> int:
        return 2 * self.visual_dim + self.state_dim


@dataclasses.dataclass(frozen=True)
class BridgeTrainConfig:
    """BRIDGeR trainer settings (``bridge_train`` CLI defaults)."""

    horizon: int = 32
    batch_size: int = 128
    epochs: int = 400
    learning_rate: float = 1e-4
    weight_decay: float = 1e-6
    ema_decay: float = 0.75
    context_frames: int = 2
    val_ratio: float = 0.1
    ckpt_period_epochs: int = 50
    seed: int = 42
    data_format: str = "h5"
    prefetch_workers: int = 0


@dataclasses.dataclass(frozen=True)
class LSTMTrainConfig:
    """LSTM trainer settings (``lstm_train`` CLI defaults)."""

    horizon: int = 32
    batch_size: int = 256
    epochs: int = 500
    learning_rate: float = 1e-4
    weight_decay: float = 1e-6
    eval_period_epochs: int = 5
    val_ratio: float = 0.1
    seed: int = 42
    data_format: str = "h5"
    prefetch_workers: int = 0
