"""LSTM residual controller training (counterpart of
``vla_touch_tpu/train/lstm_train.py``).

    python -m vla_touch_tpu_torch.train.lstm_train --data_dir DIR [--output_dir OUT]

AdamW (optax's order, decay 1e-6 in the step, a constant learning rate)
over the observation and force encoders, the LSTM and the head; the
observation encoder sits inside the differentiated loss; normalised
VLA/expert actions; the decision-time forces ``forces[ctx-1 : ctx-1+H]``;
the head's dropout mask drawn per step from a generator; evaluation every
``eval_period_epochs`` with a best checkpoint, and a final one.  float32,
TF32 off (``train/optim.py::float32_math``), on CUDA unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from vla_touch_tpu_torch.config import LSTMControllerConfig, LSTMTrainConfig
from vla_touch_tpu_torch.data.controller_dataset import ControllerDataModule
from vla_touch_tpu_torch.models.controllers import lstm as L
from vla_touch_tpu_torch.models.encoders import dinov2_runtime as dino
from vla_touch_tpu_torch.train.optim import AdamW, float32_math
from vla_touch_tpu_torch.utils.device import resolve_device
from vla_touch_tpu_torch.utils.metrics import MetricsLogger
from vla_touch_tpu_torch.utils.normalization import normalize_actions

logger = logging.getLogger("lstm_train")
CONTEXT_FRAMES = 2
WEIGHT_DECAY = 1e-6          # the step's decay, whatever the config says


def _loss_with_obs(ccfg: LSTMControllerConfig, module: L.LSTMControllerModule, batch: dict,
                   keep=None):
    """The loss with obs_cond computed inside it from the raw state and the
    frozen image features (the observation encoder trains jointly)."""
    obs_cond = module.encode_obs(batch["state"], batch["cam1_feat"], batch["cam2_feat"])
    inner = {"obs_cond": obs_cond, "vla_act": batch["vla_act"], "forces": batch["forces"],
             "expert_act": batch["expert_act"]}
    return L.lstm_loss(ccfg, module, inner, keep)


def dropout_keep(ccfg: LSTMControllerConfig, batch: dict, generator=None):
    """A keep mask (B, T, hidden) of the head's dropout for ``batch``: keep
    where a uniform draw is below 1 - rate, as ``jax.random.bernoulli``."""
    B, T = batch["vla_act"].shape[:2]
    u = torch.rand((B, T, ccfg.hidden_dim), generator=generator,
                   device=batch["vla_act"].device)
    return u < 1.0 - ccfg.dropout


def _train_step(ccfg: LSTMControllerConfig, st: L.LSTMControllerState, opt: AdamW,
                batch: dict, lr: float, keep=None, generator=None):
    """One step on ``st`` in place; ``keep`` the dropout mask (drawn from
    ``generator`` when absent).  Returns the loss as a device tensor."""
    if keep is None:
        keep = dropout_keep(ccfg, batch, generator)
    opt.zero_grad()
    loss = _loss_with_obs(ccfg, st.module, batch, keep)
    loss.backward()
    opt.step(lr)
    return loss.detach()


class LSTMControllerTrainer:
    def __init__(self, ccfg: LSTMControllerConfig, tcfg: LSTMTrainConfig, output_dir: str,
                 stats: dict, image_encoder=None, seed: int = 0, device=None):
        self.ccfg, self.tcfg = ccfg, tcfg
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.device = resolve_device(device)
        self.state = L.init_lstm_controller(ccfg, seed=seed, device=self.device)
        self.state.stats = stats
        self.opt = AdamW(self.state.module.parameters(), weight_decay=WEIGHT_DECAY)
        float32_math()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.img = (image_encoder if image_encoder is not None
                    else dino.init_params(ccfg.image_model, seed + 1, self.device))
        self.best_val = float("inf")
        self.metrics = MetricsLogger(output_dir)
        self.metrics_log = self.metrics.jsonl_path

    def _tensor(self, a):
        return torch.as_tensor(a, device=self.device).float()

    def prepare_batch(self, batch: dict) -> dict:
        stats, ctx = self.state.stats, CONTEXT_FRAMES
        horizon = batch["vla_actions"].shape[1]
        feats = {f"cam{c}_feat": dino.encode_images(
            self.img, torch.as_tensor(batch[f"images_cam{c}"][:, -1], device=self.device))
            for c in (1, 2)}
        return {
            "state": self._tensor(batch["states"][:, ctx - 1]), **feats,
            "vla_act": normalize_actions(self._tensor(batch["vla_actions"]), stats, "vla"),
            "expert_act": normalize_actions(self._tensor(batch["expert_actions"]), stats,
                                            "expert"),
            # decision-time forces: the force observed before each executed step
            "forces": self._tensor(batch["forces"][:, ctx - 1: ctx - 1 + horizon]),
        }

    def step(self, batch: dict, keep=None):
        return _train_step(self.ccfg, self.state, self.opt, batch, self.tcfg.learning_rate,
                           keep, self.generator)

    def train(self, data_module, num_epochs: Optional[int] = None, log_every: int = 10):
        tcfg = self.tcfg
        num_epochs = num_epochs or tcfg.epochs
        rng = np.random.default_rng(tcfg.seed)
        step = 0
        for epoch in range(num_epochs):
            for batch in data_module.train_dataset.batches(
                    min(tcfg.batch_size, len(data_module.train_dataset)), rng,
                    workers=tcfg.prefetch_workers):
                loss = self.step(self.prepare_batch(batch))
                if step % log_every == 0:
                    row = self.metrics.log(step, {"loss": float(loss)}, epoch=epoch)
                    logger.info("step %d loss %.5f", step, row["loss"])
                step += 1
            if (epoch + 1) % tcfg.eval_period_epochs == 0:
                val = self.validate(data_module)
                if val is not None and val < self.best_val:
                    self.best_val = val
                    self._save(os.path.join(self.output_dir, "best"))
                    logger.info("epoch %d new best val %.5f", epoch, val)
        self._save(os.path.join(self.output_dir, "final"))
        return self.state

    def _save(self, path: str):
        L.save_lstm_controller(path, self.state)
        dino.save_params(path, self.ccfg.image_model, self.img)

    @torch.no_grad()
    def validate(self, data_module) -> Optional[float]:
        ds = data_module.val_dataset
        if ds is None or len(ds) == 0:
            return None
        losses = [float(_loss_with_obs(self.ccfg, self.state.module, self.prepare_batch(b)))
                  for b in ds.batches(min(self.tcfg.batch_size, len(ds)),
                                      np.random.default_rng(0), shuffle=False)]
        return float(np.mean(losses)) if losses else None


def train_lstm_controller_with_dataset(
        data_dir: str, output_dir: str, ccfg: Optional[LSTMControllerConfig] = None,
        tcfg: Optional[LSTMTrainConfig] = None, image_encoder=None,
        num_epochs: Optional[int] = None, device=None):
    ccfg = ccfg or LSTMControllerConfig()
    tcfg = tcfg or LSTMTrainConfig()
    dm = ControllerDataModule(data_dir, context_frames=CONTEXT_FRAMES, horizon=tcfg.horizon,
                              use_images=True, val_ratio=tcfg.val_ratio, seed=tcfg.seed,
                              data_format=tcfg.data_format)
    trainer = LSTMControllerTrainer(ccfg, tcfg, output_dir, stats=dm.stats,
                                    image_encoder=image_encoder, seed=tcfg.seed,
                                    device=device)
    return trainer.train(dm, num_epochs=num_epochs), trainer


def main(argv=None, device=None):
    import argparse

    p = argparse.ArgumentParser(description="Train the LSTM residual controller")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", default="checkpoints/lstm")
    p.add_argument("--horizon", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--data_format", default="h5", choices=("h5", "epc"))
    p.add_argument("--prefetch_workers", type=int, default=0)
    p.add_argument("--device", default=device, help="default CUDA")
    args = p.parse_args(argv)
    tcfg = LSTMTrainConfig(horizon=args.horizon, batch_size=args.batch_size,
                           epochs=args.epochs, learning_rate=args.lr, seed=args.seed,
                           data_format=args.data_format,
                           prefetch_workers=args.prefetch_workers)
    logging.basicConfig(level=logging.INFO)
    return train_lstm_controller_with_dataset(args.data_dir, args.output_dir,
                                              LSTMControllerConfig(), tcfg,
                                              device=args.device)


if __name__ == "__main__":
    main()
