"""End-to-end VLA-Touch workflow on synthetic data at tiny scale, on the
PyTorch port (``vla_touch_tpu_torch``): ``examples/full_pipeline.py``'s
stages at its configurations, on the GPU unless told otherwise.

 1. synthetic episodes (npz: the port's episodes are npz or ``.epc``)
 2. dataset statistics
 3. offline VLA distillation (policy.step writes vla_action into the npz)
 4. BRIDGeR + LSTM controller training (public trainer APIs)
 5. bridger_test / lstm_step_test evaluation
 6. closed-loop replay through the chunk scheduler

Usage:  python examples/torch_full_pipeline.py [workdir] [--device cpu]
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def shrink_dinov2():
    """DinoV2-small cut to one layer at 28^2, as the controllers use it
    here (it stays so for the process)."""
    from vla_touch_tpu_torch.models.encoders import dinov2_runtime as dino
    from vla_touch_tpu_torch.models.encoders.vit import ViTConfig

    dino._CONFIGS["dinov2-small"] = ViTConfig(
        hidden_size=384, num_layers=1, num_heads=4, mlp_dim=64,
        image_size=28, patch_size=14)


def policy_config():
    """The tiny policy: ``rdt_tiny`` (16-wide language) with 2 solver
    steps over a 1-layer ViT at 28^2."""
    from vla_touch_tpu_torch.config import NoiseSchedulerConfig, rdt_tiny
    from vla_touch_tpu_torch.models.encoders.vit import ViTConfig
    from vla_touch_tpu_torch.models.rdt import runner as R
    from vla_touch_tpu_torch.runtime import policy as P

    tiny_vit = ViTConfig(hidden_size=48, num_layers=1, num_heads=4,
                         mlp_dim=96, image_size=28, patch_size=14,
                         use_cls_token=False, use_layerscale=False,
                         gelu_tanh=True)
    return P.PolicyConfig(
        rdt=R.RDTRunnerConfig(model=rdt_tiny(lang_token_dim=16),
                              noise=NoiseSchedulerConfig(num_inference_timesteps=2)),
        vision=tiny_vit, image_size=28)


def instruction():
    """The walkthrough's instruction embedding (4 tokens, 16 wide)."""
    return np.random.default_rng(0).normal(size=(4, 16)).astype(np.float32)


def main(workdir: str = "/tmp/vla_touch_torch_demo", device=None):
    """Every stage on ``device`` (None: the GPU); returns the summary it
    writes to ``workdir/summary.json``."""
    from vla_touch_tpu_torch.config import (
        BridgeControllerConfig, BridgeTrainConfig, DataConfig, InterpolantConfig,
        LSTMControllerConfig, LSTMTrainConfig)
    from vla_touch_tpu_torch.data.distill import record_vla_actions_for_dataset
    from vla_touch_tpu_torch.data.episode import list_episode_files, make_synthetic_dataset
    from vla_touch_tpu_torch.data.stats import process_dataset
    from vla_touch_tpu_torch.runtime import policy as P

    os.makedirs(workdir, exist_ok=True)
    raw_dir = os.path.join(workdir, "episodes_raw")
    aug_dir = os.path.join(workdir, "episodes")
    npz = (".npz",)

    # Tiny model configs so the demo runs in minutes.
    shrink_dinov2()
    pcfg = policy_config()

    print("== 1. synthetic episodes (stand-in for the raw-capture pipeline)")
    make_synthetic_dataset(raw_dir, n_episodes=3, num_steps=40, img_size=28,
                           chunk=8, lang_dim=16, with_vla=False, resized_size=28)

    print("== 2. dataset statistics")
    stats = process_dataset(DataConfig(chunk_size=8),
                            os.path.join(workdir, "dataset_stat.json"),
                            file_paths=list_episode_files(raw_dir, pattern=npz))
    print("   state_mean[30:33] =",
          np.round(stats["mango"]["state_mean"][30:33], 3).tolist())

    print("== 3. offline VLA distillation (writes vla_action into the episodes)")
    model = P.create_model(pcfg, seed=0, device=device)
    text = instruction()

    def policy_step(proprio, images, _text):
        return model.step(proprio, images, text)

    record_vla_actions_for_dataset(raw_dir, aug_dir, policy_step, image_size=28)

    print("== 4. controller training (public trainer APIs)")
    from vla_touch_tpu_torch.train.bridge_train import train_diffusion_controller_with_dataset
    from vla_touch_tpu_torch.train.lstm_train import train_lstm_controller_with_dataset

    bcfg = BridgeControllerConfig(
        hidden_dim=32, horizon=8, unet_down_dims=(16, 32),
        interpolant=InterpolantConfig(diffusion_steps=5))
    _, btr = train_diffusion_controller_with_dataset(
        aug_dir, os.path.join(workdir, "bridge_ckpt"), bcfg,
        BridgeTrainConfig(horizon=8, batch_size=16, epochs=3, val_ratio=0.34),
        device=device)
    lcfg = LSTMControllerConfig(hidden_dim=32, num_layers=1)
    _, ltr = train_lstm_controller_with_dataset(
        aug_dir, os.path.join(workdir, "lstm_ckpt"), lcfg,
        LSTMTrainConfig(horizon=8, batch_size=16, epochs=3, val_ratio=0.34),
        device=device)

    print("== 5. offline evaluation (bridger_test / lstm_step_test)")
    from vla_touch_tpu_torch.eval.bridge_test import test_diffusion_controller
    from vla_touch_tpu_torch.eval.lstm_step_test import test_lstm_controller

    bres = test_diffusion_controller(
        os.path.join(workdir, "bridge_ckpt", "final"), aug_dir,
        num_samples=12, image_encoder=btr.img, device=device)
    lres = test_lstm_controller(
        os.path.join(workdir, "lstm_ckpt", "final"), aug_dir,
        num_samples=12, horizon=8, image_encoder=ltr.img, device=device)

    print("== 6. closed-loop replay with the chunk scheduler")
    from vla_touch_tpu_torch.runtime.control_loop import (
        ChunkScheduler, ControlLoopConfig, EpisodeReplay)

    replay = EpisodeReplay(list_episode_files(aug_dir, pattern=npz)[0])

    def plan_fn(window):
        return model.step(window.current.state, window.image_sequence(), text)[0]

    sched = ChunkScheduler(ControlLoopConfig(chunk_size=8, replan_interval=4,
                                             gripper_deadband=0.0), plan_fn)
    loop = replay.run(sched, steps=12)

    summary = {
        "bridge_eval": bres,
        "lstm_eval": lres,
        "replay_tracking_mse": loop["tracking_mse"],
        "replay_steps": loop["steps"],
    }
    out_path = os.path.join(workdir, "summary.json")
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=2)
    print("== done; summary at", out_path)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("workdir", nargs="?", default="/tmp/vla_touch_torch_demo")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args()
    main(a.workdir, device=a.device)
