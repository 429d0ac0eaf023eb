"""Configuration dataclasses of the ported slice.

Counterpart of ``vla_touch_tpu/config.py`` restricted to what the port
runs: the RDT model and noise scheduler, the BRIDGeR and LSTM controllers
with the interpolant, the two controller trainers, and the RDT finetuning
data and training configurations.  Defaults are
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
    # Recompute each transformer block in the backward pass
    # (torch.utils.checkpoint): ~1/3 more forward FLOPs for dropping every
    # block's activations from the training step's live set.
    remat_blocks: bool = False

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


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Episode dataset behaviour of RDT finetuning."""

    data_root: str = "data/datasets"
    dataset_names: Sequence[str] = ("mango",)
    img_history_size: int = 2
    num_cameras: int = 3
    chunk_size: int = 64             # action horizon written per sample
    image_size: int = 384
    state_dim: int = 10
    cond_mask_prob: float = 0.1
    cam_ext_mask_prob: float = -1.0  # >= 0 overrides cond_mask_prob for the
    #                                  exterior camera
    state_noise_snr: Optional[float] = None
    image_aug: bool = False
    control_freq: int = 10           # Franka (agilex = 25)
    data_format: str = "h5"          # "h5" (+npz); "epc" is not read yet


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """RDT training-loop hyperparameters."""

    batch_size: int = 4
    grad_accum: int = 4
    learning_rate: float = 1e-4
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 500
    weight_decay: float = 1e-3
    adam_beta1: float = 0.9
    adam_beta2: float = 0.95
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    use_8bit_adam: bool = False      # blockwise-int8 moments
    accum_dtype: str = "float32"     # gradient-accumulator dtype
    ema_dtype: str = "float32"       # EMA shadow dtype; "bfloat16" rounds
    #                                  stochastically (utils/ema.py)
    param_dtype: str = "float32"     # "bfloat16" drops the float32 master and
    #                                  applies updates with stochastic
    #                                  rounding (requires use_8bit_adam)
    zero3: bool = False              # parameter sharding: not in the port
    max_train_steps: int = 40000
    checkpointing_period: int = 1000
    checkpoints_total_limit: int = 40
    async_save: bool = False         # write checkpoints on a thread
    sample_period: int = 100
    ema_decay: float = 0.999
    ema_inv_gamma: float = 1.0
    ema_power: float = 0.75
    seed: int = 42
    dp_axis: str = "data"
    prefetch_workers: int = 2
