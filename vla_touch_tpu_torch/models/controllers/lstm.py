"""Tactile LSTM residual controller (counterpart of
``vla_touch_tpu/models/controllers/lstm.py``).

A force MLP encoder, an observation MLP over [DinoV2 CLS x2, state], a
2-layer unidirectional LSTM over [force embedding, normalised VLA action]
and an output head on [LSTM output, obs_cond] predicting a residual delta.
Two modes: the sequence (training; the whole chunk) and the stateful single
step of the control loop (:meth:`LSTMControllerModule.step`).  The sequence
runs the same per-step cell as the single step.  The head's LayerNorm is
flax's (epsilon 1e-6, fast variance); its dropout takes an explicit keep
mask (the trainer draws it, ``train/lstm_train.py::dropout_keep``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
from torch import nn

from vla_touch_tpu_torch.config import LSTMControllerConfig
from vla_touch_tpu_torch.ops.nn import LayerNorm, StackedLSTM, dropout, gelu_erf
from vla_touch_tpu_torch.utils import checkpoint as ckpt
from vla_touch_tpu_torch.utils.normalization import denormalize_actions, normalize_actions


class LSTMControllerModule(nn.Module):
    def __init__(self, cfg: LSTMControllerConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_dim
        self.force_fc1 = nn.Linear(cfg.force_dim, h // 2)
        self.force_fc2 = nn.Linear(h // 2, h // 2)
        self.obs_fc1 = nn.Linear(cfg.obs_dim, h)
        self.obs_fc2 = nn.Linear(h, h)
        self.obs_fc3 = nn.Linear(h, h)
        self.lstm = StackedLSTM(h // 2 + cfg.state_dim, h, cfg.num_layers)
        self.head_fc1 = nn.Linear(2 * h, h)
        self.head_norm = LayerNorm(h)
        self.head_fc2 = nn.Linear(h, cfg.state_dim)

    def encode_force(self, force):
        return self.force_fc2(gelu_erf(self.force_fc1(force)))

    def encode_obs(self, state, cam1_feat, cam2_feat):
        x = torch.cat([cam1_feat, cam2_feat, state], dim=-1).float()
        x = gelu_erf(self.obs_fc1(x))
        x = gelu_erf(self.obs_fc2(x))
        return self.obs_fc3(x)

    def _head(self, lstm_out, obs_cond, keep=None):
        x = self.head_fc1(torch.cat([lstm_out, obs_cond], dim=-1))
        x = gelu_erf(self.head_norm(x))
        if keep is not None:
            x = dropout(x, self.cfg.dropout, keep)
        return self.head_fc2(x)

    def forward(self, obs_cond, vla_actions_n, force_seq, keep=None):
        """Sequence mode: obs_cond (B, h); vla_actions_n (B, T, D)
        normalised; force_seq (B, T, force_dim) -> refined normalised
        actions.  ``keep`` (B, T, h) bool: the head's dropout mask (None:
        no dropout, eval)."""
        f_emb = self.encode_force(force_seq)
        lstm_out, _ = self.lstm(torch.cat([f_emb, vla_actions_n], dim=-1))
        obs_b = obs_cond[:, None, :].expand(-1, lstm_out.shape[1], -1)
        return vla_actions_n + self._head(lstm_out, obs_b, keep)

    def init_carry(self, batch: int, device=None):
        return self.lstm.init_carry(batch, device)

    def step(self, carry, vla_action_n, force, obs_cond):
        """One control tick: (carry, action_n (B, D), force (B, F), obs
        (B, h)) -> (new carry, refined normalised action)."""
        f_emb = self.encode_force(force)
        carry, lstm_out = self.lstm.step_fn(carry, torch.cat([f_emb, vla_action_n], dim=-1))
        return carry, vla_action_n + self._head(lstm_out, obs_cond)


@dataclasses.dataclass
class LSTMControllerState:
    cfg: LSTMControllerConfig
    module: LSTMControllerModule
    stats: Optional[dict] = None


def init_lstm_controller(cfg: LSTMControllerConfig, seed: int = 0,
                         device=None) -> LSTMControllerState:
    """A seeded random controller in float32 on ``device`` (default CUDA),
    trainable."""
    from vla_touch_tpu_torch.utils.random_init import build_module

    module = build_module(lambda: LSTMControllerModule(cfg), seed, device)
    return LSTMControllerState(cfg=cfg, module=module.requires_grad_(True).train())


@torch.no_grad()
def lstm_encode_obs(cfg: LSTMControllerConfig, module: LSTMControllerModule, state,
                    cam1_feat, cam2_feat):
    return module.encode_obs(state, cam1_feat, cam2_feat)


@torch.no_grad()
def lstm_step_predict(cfg: LSTMControllerConfig, module: LSTMControllerModule, stats,
                      carry, obs_cond, vla_action_n, force):
    """Stateful single-step refinement; ``vla_action_n`` normalised VLA;
    returns (carry, denormalised action)."""
    carry, refined_n = module.step(carry, vla_action_n, force, obs_cond)
    return carry, denormalize_actions(refined_n, stats, "expert")


@torch.no_grad()
def lstm_predict_sequence(cfg: LSTMControllerConfig, module: LSTMControllerModule, stats,
                          obs_cond, vla_actions, force_seq):
    """Step-by-step rollout over a chunk from a fresh carry.  ``vla_actions``
    raw (B, T, D); the output denormalised."""
    vla_n = normalize_actions(vla_actions.float(), stats, "vla")
    carry = module.init_carry(vla_n.shape[0], vla_n.device)
    out = []
    for t in range(vla_n.shape[1]):
        carry, refined_n = module.step(carry, vla_n[:, t], force_seq[:, t], obs_cond)
        out.append(refined_n)
    return denormalize_actions(torch.stack(out, dim=1), stats, "expert")


def lstm_loss(cfg: LSTMControllerConfig, module: LSTMControllerModule, batch: dict,
              keep=None):
    """MSE between refined and expert actions, both normalised.  ``keep``:
    the head's dropout mask (None: eval, no dropout)."""
    pred = module(batch["obs_cond"], batch["vla_act"], batch["forces"], keep)
    return torch.mean(torch.square(pred - batch["expert_act"]))


def save_lstm_controller(path: str, st: LSTMControllerState) -> None:
    from vla_touch_tpu_torch.utils.from_flax import to_flax

    os.makedirs(path, exist_ok=True)
    ckpt.save_pytree(os.path.join(path, "tactile_controller.msgpack"), to_flax(st.module))
    if st.stats is not None:
        ckpt.save_stats(os.path.join(path, "stats.json"), st.stats)
    ckpt.save_json(os.path.join(path, "model_args.json"), dataclasses.asdict(st.cfg))


def load_lstm_controller(path: str, cfg: Optional[LSTMControllerConfig] = None,
                         device=None) -> LSTMControllerState:
    """A checkpoint written by this module or the JAX package, on ``device``
    (default CUDA)."""
    from vla_touch_tpu_torch.utils import from_flax as FF
    from vla_touch_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if cfg is None:
        cfg = LSTMControllerConfig(**ckpt.load_json(os.path.join(path, "model_args.json")))
    with torch.device("meta"):
        module = LSTMControllerModule(cfg)
    module = module.to_empty(device=dev)
    FF.load_into(module, FF.lstm_controller(
        ckpt.load_pytree(os.path.join(path, "tactile_controller.msgpack"))))
    stats = None
    stats_path = os.path.join(path, "stats.json")
    if os.path.exists(stats_path):
        stats = ckpt.load_stats(stats_path)
    return LSTMControllerState(cfg=cfg, module=module.requires_grad_(True).train(),
                               stats=stats)
