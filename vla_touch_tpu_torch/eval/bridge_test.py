"""Offline BRIDGeR evaluation (counterpart of
``vla_touch_tpu/eval/bridge_test.py``).

    python -m vla_touch_tpu_torch.eval.bridge_test --ckpt_path CKPT --data_dir DIR

Loads a controller checkpoint (the port's or the JAX package's) and the
validation split, refines randomly drawn windows through
:func:`models.controllers.bridge.bridge_predict` and reports the action
MSE (refined vs expert), the VLA MSE (raw vs expert) and the improvement
(1 - MSE_refined / MSE_VLA) x 100.  The SDE runs the EMA pair of the
checkpoint's ``interpolant.sde_type`` ('vs' or 'bs') through the serving
UNet and K2, in the checkpoint's ``inference_dtype``.  K2 takes bf16 only,
so on CUDA a float32 controller is evaluated in bf16: a warning says so,
and the result's ``inference_dtype`` names the dtype that ran.  To evaluate
another SDE or dtype, pass ``state=`` with that config.  ``visualize_dir``
saves the first samples' trajectory plots (``eval/visualize.py``, needs
matplotlib).  On CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Optional

import numpy as np
import torch

from vla_touch_tpu_torch.data.controller_dataset import ControllerDataModule
from vla_touch_tpu_torch.eval.visualize import plot_samples
from vla_touch_tpu_torch.models.controllers import bridge as B
from vla_touch_tpu_torch.models.encoders import dinov2_runtime as dino
from vla_touch_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("bridge_test")


def eval_batch(ds, num_samples: int, seed: int) -> dict:
    """``num_samples`` windows drawn with replacement (numpy seed ``seed``),
    stacked."""
    idxs = np.random.default_rng(seed).integers(0, len(ds), size=min(num_samples, len(ds)))
    samples = [ds[int(i)] for i in idxs]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def report(what: str, refined, expert, vla, n: int, **extra) -> dict:
    """The MSE / improvement triplet (and ``extra``), logged and printed."""
    action_mse = float(np.mean((refined - expert) ** 2))
    vla_mse = float(np.mean((vla - expert) ** 2))
    improvement = (1.0 - action_mse / vla_mse) * 100.0 if vla_mse > 0 else 0.0
    result = {"action_mse": action_mse, "vla_mse": vla_mse,
              "improvement_pct": improvement, "num_samples": n, **extra}
    logger.info("%s: %s", what, json.dumps(result))
    print(f"Refined action MSE vs expert: {action_mse:.6f}")
    print(f"VLA action MSE vs expert:     {vla_mse:.6f}")
    print(f"Improvement: {improvement:.2f}%")
    return result


def image_encoder_for(ckpt_path: Optional[str], name: str, image_encoder, device):
    """The given encoder, else the one persisted in the checkpoint, else a
    random one (with a warning: the visual metrics then mean nothing)."""
    if image_encoder is None and ckpt_path:
        image_encoder = dino.load_params(ckpt_path, name, device=device)
    if image_encoder is None:
        logger.warning("no persisted image encoder in the checkpoint; using a random "
                       "init: visual metrics are meaningless")
        image_encoder = dino.init_params(name, 7, device)
    return image_encoder


def test_diffusion_controller(ckpt_path: str, data_dir: str, num_samples: int = 50,
                              seed: int = 0, image_encoder=None,
                              state: Optional[B.BridgeControllerState] = None,
                              data_module=None, diffuse_steps: Optional[int] = None,
                              visualize_dir: Optional[str] = None, noise_seq=None,
                              device=None) -> dict:
    dev = resolve_device(device)
    st = state if state is not None else B.load_bridge_controller(ckpt_path, device=dev)
    ccfg = st.cfg
    dm = data_module or ControllerDataModule(
        data_dir, context_frames=ccfg.context_frames, horizon=ccfg.horizon,
        use_images=ccfg.use_visual, seed=42)
    ds = dm.val_dataset if (dm.val_dataset and len(dm.val_dataset)) else dm.train_dataset
    batch = eval_batch(ds, num_samples, seed)

    ctx = ccfg.context_frames
    kw = {}
    if ccfg.use_visual:
        enc = image_encoder_for(ckpt_path, ccfg.image_model, image_encoder, dev)
        for cam in (1, 2):
            kw[f"cam{cam}_feat"] = dino.encode_images(
                enc, torch.as_tensor(batch[f"images_cam{cam}"][:, -1], device=dev))
    if ccfg.use_force:
        kw["forces"] = torch.as_tensor(batch["forces"][:, ctx - 1], device=dev)
    pcfg = ccfg
    if dev.type == "cuda" and ccfg.inference_dtype != "bfloat16":
        logger.warning("K2 takes bf16 only: the %s controller is evaluated in bfloat16 "
                       "on CUDA", ccfg.inference_dtype)
        pcfg = dataclasses.replace(ccfg, inference_dtype="bfloat16")
    module = B.deployable(dataclasses.replace(st, cfg=pcfg))
    refined = B.bridge_predict(
        pcfg, module, st.stats, torch.as_tensor(batch["states"][:, ctx - 1], device=dev),
        torch.as_tensor(batch["vla_actions"], device=dev), diffuse_steps=diffuse_steps,
        noise_seq=noise_seq, generator=torch.Generator(device=dev).manual_seed(seed), **kw)
    refined = refined.cpu().numpy()
    if visualize_dir:
        plot_samples(batch["expert_actions"], batch["vla_actions"], refined, visualize_dir)
    return report("bridge_test", refined, batch["expert_actions"], batch["vla_actions"],
                  len(batch["states"]), inference_dtype=pcfg.inference_dtype)


def main(argv=None, device=None):
    import argparse

    p = argparse.ArgumentParser(description="Evaluate a BRIDGeR checkpoint")
    p.add_argument("--ckpt_path", required=True)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--num_samples", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--diffuse_steps", type=int, default=None)
    p.add_argument("--visualize_dir", default=None)
    p.add_argument("--device", default=device, help="default CUDA")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return test_diffusion_controller(args.ckpt_path, args.data_dir, args.num_samples,
                                     args.seed, diffuse_steps=args.diffuse_steps,
                                     visualize_dir=args.visualize_dir, device=args.device)


if __name__ == "__main__":
    main()
