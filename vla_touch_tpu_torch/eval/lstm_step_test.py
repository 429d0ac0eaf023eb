"""Offline LSTM controller evaluation (counterpart of
``vla_touch_tpu/eval/lstm_step_test.py``).

    python -m vla_touch_tpu_torch.eval.lstm_step_test --ckpt_path CKPT --data_dir DIR

Evaluates through the stateful step-by-step rollout
(:func:`models.controllers.lstm.lstm_predict_sequence`) and reports the
MSE / improvement triplet of ``bridge_test``; ``visualize_dir`` saves the
first samples' trajectory plots.  On CUDA unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from vla_touch_tpu_torch.data.controller_dataset import ControllerDataModule
from vla_touch_tpu_torch.eval.bridge_test import eval_batch, image_encoder_for, report
from vla_touch_tpu_torch.eval.visualize import plot_samples
from vla_touch_tpu_torch.models.controllers import lstm as L
from vla_touch_tpu_torch.models.encoders import dinov2_runtime as dino
from vla_touch_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("lstm_step_test")


def test_lstm_controller(ckpt_path: str, data_dir: str, num_samples: int = 50,
                         horizon: int = 32, seed: int = 0, image_encoder=None,
                         state: Optional[L.LSTMControllerState] = None,
                         data_module=None, visualize_dir: Optional[str] = None,
                         device=None) -> dict:
    dev = resolve_device(device)
    st = state if state is not None else L.load_lstm_controller(ckpt_path, device=dev)
    ccfg = st.cfg
    dm = data_module or ControllerDataModule(data_dir, context_frames=2, horizon=horizon,
                                             use_images=True, seed=42)
    ds = dm.val_dataset if (dm.val_dataset and len(dm.val_dataset)) else dm.train_dataset
    batch = eval_batch(ds, num_samples, seed)
    ctx = 2

    enc = image_encoder_for(ckpt_path, ccfg.image_model, image_encoder, dev)
    f1, f2 = (dino.encode_images(enc, torch.as_tensor(batch[f"images_cam{c}"][:, -1],
                                                     device=dev)) for c in (1, 2))
    obs_cond = L.lstm_encode_obs(ccfg, st.module,
                                 torch.as_tensor(batch["states"][:, ctx - 1], device=dev),
                                 f1, f2)
    H = batch["vla_actions"].shape[1]
    refined = L.lstm_predict_sequence(
        ccfg, st.module, st.stats, obs_cond, torch.as_tensor(batch["vla_actions"], device=dev),
        # decision-time forces
        torch.as_tensor(batch["forces"][:, ctx - 1: ctx - 1 + H], device=dev))
    refined = refined.cpu().numpy()
    if visualize_dir:
        plot_samples(batch["expert_actions"], batch["vla_actions"], refined, visualize_dir)
    return report("lstm_step_test", refined, batch["expert_actions"], batch["vla_actions"],
                  len(batch["states"]))


def main(argv=None, device=None):
    import argparse

    p = argparse.ArgumentParser(description="Evaluate an LSTM controller checkpoint")
    p.add_argument("--ckpt_path", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--num_samples", type=int, default=50)
    p.add_argument("--horizon", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--visualize_dir", default=None)
    p.add_argument("--device", default=device, help="default CUDA")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return test_lstm_controller(args.ckpt_path, args.data_dir, args.num_samples,
                                args.horizon, args.seed, visualize_dir=args.visualize_dir,
                                device=args.device)


if __name__ == "__main__":
    main()
