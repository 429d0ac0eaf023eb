"""BRIDGeR controller training (counterpart of
``vla_touch_tpu/train/bridge_train.py``).

    python -m vla_touch_tpu_torch.train.bridge_train --data_dir DIR [--output_dir OUT]

- AdamW (optax's order, ``train/optim.py``) over the observation encoder,
  the force decoder and the b/v/s nets, the cosine learning rate computed
  on the host per step;
- after each step the EMA of the ``si`` nets (torch_ema, decay 0.75);
- batch prep: the state is the last context frame (raw gripper scale), the
  current force and images; VLA/expert chunks normalised; DinoV2 features
  computed without gradients (K1 in the encoder's attention);
- with force on, the auxiliary force reconstruction loss;
- a best checkpoint gated on the validation loss, periodic checkpoints
  pruned to 5, a final one; the DinoV2 weights persist beside each;
- a jsonl log of the v/s/b losses.

Training runs in float32, TF32 off (``train/optim.py::float32_math``), on
CUDA unless the caller passes ``device="cpu"``.
The draws of each loss (t, z) come from a ``torch.Generator`` seeded from
the trainer's seed, or are given to :func:`_train_step`.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from vla_touch_tpu_torch.config import (BridgeControllerConfig, BridgeTrainConfig,
                                        InterpolantConfig)
from vla_touch_tpu_torch.data.controller_dataset import ControllerDataModule
from vla_touch_tpu_torch.models.controllers import bridge as B
from vla_touch_tpu_torch.models.encoders import dinov2_runtime as dino
from vla_touch_tpu_torch.train.optim import AdamW, float32_math
from vla_touch_tpu_torch.utils import ema as ema_lib
from vla_touch_tpu_torch.utils.checkpoint import prune_checkpoints
from vla_touch_tpu_torch.utils.device import resolve_device
from vla_touch_tpu_torch.utils.metrics import MetricsLogger
from vla_touch_tpu_torch.utils.normalization import normalize_actions

logger = logging.getLogger("bridge_train")


def _train_step(ccfg: BridgeControllerConfig, st: B.BridgeControllerState, opt: AdamW,
                batch: dict, lr: float, draws: Optional[dict] = None,
                generator: Optional[torch.Generator] = None) -> dict:
    """One optimizer step on ``st`` in place, then the EMA update.  Returns
    the step's losses as device tensors (no host sync)."""
    opt.zero_grad()
    total, parts = B.bridge_train_loss(ccfg, st.module, batch, draws, generator)
    total.backward()
    opt.step(lr)
    st.ema = ema_lib.update_torch_ema(st.ema, st.module.si, 0.75)
    return {"loss": total.detach(), "v_loss": parts.v_loss.detach(),
            "s_loss": parts.s_loss.detach(), "b_loss": parts.b_loss.detach()}


class DiffusionControllerTrainer:
    """The reference-named trainer."""

    def __init__(self, ccfg: BridgeControllerConfig, tcfg: BridgeTrainConfig,
                 output_dir: str, stats: dict, image_encoder=None, seed: int = 0,
                 device=None):
        self.ccfg, self.tcfg = ccfg, tcfg
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.device = resolve_device(device)
        self.state = B.init_bridge_controller(ccfg, seed=seed, device=self.device)
        self.state.stats = stats
        self.opt = AdamW(self.state.module.parameters(), weight_decay=tcfg.weight_decay)
        float32_math()
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if ccfg.use_visual:
            self.img = (image_encoder if image_encoder is not None
                        else dino.init_params(ccfg.image_model, seed + 1, self.device))
        self.best_val = float("inf")
        self.metrics = MetricsLogger(output_dir)
        self.metrics_log = self.metrics.jsonl_path

    def _lr(self, step: int, total_steps: int) -> float:
        """Cosine schedule (the reference's CosineAnnealingLR)."""
        return float(0.5 * self.tcfg.learning_rate
                     * (1 + np.cos(np.pi * min(step / max(total_steps, 1), 1.0))))

    def _tensor(self, a):
        return torch.as_tensor(a, device=self.device).float()

    def prepare_batch(self, batch: dict) -> dict:
        """A ``ControllerDataset`` batch (numpy arrays or tensors) -> the
        device batch of :func:`models.controllers.bridge.bridge_loss`."""
        ccfg, stats = self.ccfg, self.state.stats
        ctx = ccfg.context_frames
        out = {"state": self._tensor(batch["states"][:, ctx - 1]),
               "vla_act": normalize_actions(self._tensor(batch["vla_actions"]), stats, "vla"),
               "expert_act": normalize_actions(self._tensor(batch["expert_actions"]), stats,
                                               "expert")}
        if ccfg.use_force:
            out["forces"] = self._tensor(batch["forces"][:, ctx - 1])
            out["current_force"] = out["forces"]
        if ccfg.use_visual:
            for cam in (1, 2):
                out[f"cam{cam}_feat"] = dino.encode_images(
                    self.img, torch.as_tensor(batch[f"images_cam{cam}"][:, -1],
                                              device=self.device))
        return out

    def step(self, batch: dict, lr: float, draws: Optional[dict] = None) -> dict:
        """One training step on a prepared batch."""
        return _train_step(self.ccfg, self.state, self.opt, batch, lr, draws, self.generator)

    def train(self, data_module, num_epochs: Optional[int] = None, save_interval: int = 50,
              log_every: int = 10):
        tcfg = self.tcfg
        num_epochs = num_epochs or tcfg.epochs
        rng = np.random.default_rng(tcfg.seed)
        steps_per_epoch = max(1, len(data_module.train_dataset) // tcfg.batch_size)
        total_steps = steps_per_epoch * num_epochs
        step = 0
        for epoch in range(num_epochs):
            for batch in data_module.train_dataset.batches(tcfg.batch_size, rng,
                                                           workers=tcfg.prefetch_workers):
                lr = self._lr(step, total_steps)
                metrics = self.step(self.prepare_batch(batch), lr)
                if step % log_every == 0:
                    row = self.metrics.log(step, {k: float(v) for k, v in metrics.items()},
                                           epoch=epoch, lr=lr)
                    logger.info("step %d loss %.4f (v %.4f s %.4f b %.4f)", step,
                                row["loss"], row["v_loss"], row["s_loss"], row["b_loss"])
                step += 1
            val = self.validate(data_module)
            if val is not None and val < self.best_val:
                self.best_val = val
                self._save(os.path.join(self.output_dir, "best"))
                logger.info("epoch %d new best val %.4f", epoch, val)
            if (epoch + 1) % save_interval == 0:
                self._save(os.path.join(self.output_dir, f"checkpoint-{epoch + 1}"))
                prune_checkpoints(self.output_dir, total_limit=5)
        self._save(os.path.join(self.output_dir, "final"))
        return self.state

    def _save(self, path: str):
        B.save_bridge_controller(path, self.state)
        if self.ccfg.use_visual:
            # the controller's features are reproducible only with these weights
            dino.save_params(path, self.ccfg.image_model, self.img)

    @torch.no_grad()
    def validate(self, data_module) -> Optional[float]:
        """Mean loss over the validation split, each batch's draws from a
        generator seeded 0."""
        ds = data_module.val_dataset
        if ds is None or len(ds) == 0:
            return None
        losses = []
        for batch in ds.batches(min(self.tcfg.batch_size, len(ds)), np.random.default_rng(0),
                                shuffle=False):
            gen = torch.Generator(device=self.device).manual_seed(0)
            total, _ = B.bridge_loss(self.ccfg, self.state.module, self.prepare_batch(batch),
                                     generator=gen)
            losses.append(float(total))
        return float(np.mean(losses)) if losses else None


def train_diffusion_controller_with_dataset(
        data_dir: str, output_dir: str, ccfg: Optional[BridgeControllerConfig] = None,
        tcfg: Optional[BridgeTrainConfig] = None, image_encoder=None,
        num_epochs: Optional[int] = None, device=None):
    """The reference-named entry: data module, trainer, training."""
    ccfg = ccfg or BridgeControllerConfig()
    tcfg = tcfg or BridgeTrainConfig()
    dm = ControllerDataModule(data_dir, context_frames=ccfg.context_frames,
                              horizon=ccfg.horizon, use_images=ccfg.use_visual,
                              val_ratio=tcfg.val_ratio, seed=tcfg.seed,
                              data_format=tcfg.data_format)
    trainer = DiffusionControllerTrainer(ccfg, tcfg, output_dir, stats=dm.stats,
                                         image_encoder=image_encoder, seed=tcfg.seed,
                                         device=device)
    return trainer.train(dm, num_epochs=num_epochs), trainer


def main(argv=None, device=None):
    import argparse

    p = argparse.ArgumentParser(description="Train the BRIDGeR controller")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", default="checkpoints/bridge")
    p.add_argument("--horizon", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--beta_max", type=float, default=0.03)
    p.add_argument("--no_force", action="store_true")
    p.add_argument("--no_visual", action="store_true")
    p.add_argument("--image_model", default="dinov2-small")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--data_format", default="h5", choices=("h5", "epc"))
    p.add_argument("--prefetch_workers", type=int, default=0)
    p.add_argument("--device", default=device, help="default CUDA")
    args = p.parse_args(argv)
    ccfg = BridgeControllerConfig(
        horizon=args.horizon, use_force=not args.no_force, use_visual=not args.no_visual,
        image_model=args.image_model, interpolant=InterpolantConfig(beta_max=args.beta_max))
    tcfg = BridgeTrainConfig(horizon=args.horizon, batch_size=args.batch_size,
                             epochs=args.epochs, learning_rate=args.lr, seed=args.seed,
                             data_format=args.data_format,
                             prefetch_workers=args.prefetch_workers)
    logging.basicConfig(level=logging.INFO)
    return train_diffusion_controller_with_dataset(args.data_dir, args.output_dir, ccfg, tcfg,
                                                   device=args.device)


if __name__ == "__main__":
    main()
