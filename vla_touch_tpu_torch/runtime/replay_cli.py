"""Deployment replay CLI (counterpart of
``vla_touch_tpu/runtime/replay_cli.py``).

Runs the full control loop (the VLA, then the BRIDGeR or LSTM refiner,
through the chunk scheduler) against a recorded episode instead of a
robot, and reports the tracking MSE and each stage's latency
(:mod:`utils.profiling`: ``vla_plan``, ``vla_plan_warm``,
``bridge_refine``, ``lstm_step``; each span ends with the stage's result
on the host, so it covers the device work).

    python -m vla_touch_tpu_torch.runtime.replay_cli --episode ep.npz \\
        [--rdt_checkpoint model.safetensors] [--refiner bridge|lstm|none] \\
        [--bridge_ckpt dir] [--lstm_ckpt dir] [--warm_skip 2] [--device cpu]

Episodes are npz, or h5 where ``h5py`` imports.  It runs on CUDA unless
``--device`` names another device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging

import numpy as np
import torch

from vla_touch_tpu_torch.runtime.control_loop import (ChunkScheduler, ControlLoopConfig,
                                                      EpisodeReplay)
from vla_touch_tpu_torch.utils import profiling as prof

logger = logging.getLogger("replay")


def _prep_cam(img, device, size: int = 384):
    """A camera frame as the controllers train on it: pad-resized to a
    ``size`` square, float32 in [0, 1], batch of one."""
    from vla_touch_tpu_torch.utils.image import pad_and_resize_for_siglip

    x = pad_and_resize_for_siglip(np.asarray(img), size).astype(np.float32)[None] / 255.0
    return torch.as_tensor(x, device=device)


def _load_encoder(ckpt_dir: str, image_model: str, device):
    """The DinoV2 persisted beside a controller checkpoint (bf16 on CUDA,
    where its attention runs through K1; float32 elsewhere), else a random
    one with a warning."""
    from vla_touch_tpu_torch.models.encoders import dinov2_runtime as dino

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    enc = dino.load_params(ckpt_dir, image_model, device=device, dtype=dtype)
    if enc is None:
        logger.warning("checkpoint has no persisted image encoder; using random init")
        enc = dino.init_params(image_model, 7, device, dtype=dtype)
    return enc


def build_scheduler(args, replay) -> ChunkScheduler:
    """The chunk scheduler of ``args`` (the CLI's flags) over ``replay``'s
    episode, on ``args.device``."""
    from vla_touch_tpu_torch.runtime import policy as P
    from vla_touch_tpu_torch.utils.device import resolve_device

    dev = resolve_device(getattr(args, "device", None))
    cfg = P.PolicyConfig()
    if args.rdt_checkpoint:
        from vla_touch_tpu_torch.utils.torch_port import load_rdt_runner

        rdt = load_rdt_runner(args.rdt_checkpoint, cfg.rdt, device=dev)
        with torch.no_grad():          # bf16 weights, as the JAX CLI casts them
            for p in rdt.parameters():
                p.copy_(p.to(torch.bfloat16).to(p.dtype))
        model = P.create_model(cfg, rdt=rdt, device=dev)
    else:
        logger.warning("no --rdt_checkpoint: using randomly initialized RDT")
        model = P.create_model(cfg, seed=0, device=dev)
    text = replay.instruction()

    # each stage ends with its result copied to the host, so its span covers
    # the device work it queued
    def plan_fn(window):
        with prof.stage("vla_plan"):
            chunk = model.step(window.current.state, window.image_sequence(), text)
        return chunk[0]

    plan_warm_fn = None
    if getattr(args, "warm_skip", 0) > 0:
        def plan_warm_fn(window, prior):
            with prof.stage("vla_plan_warm"):
                chunk = model.step(window.current.state, window.image_sequence(), text,
                                   prior_actions=prior, skip_steps=args.warm_skip)
            return chunk[0]

    bridge_fn = lstm_fn = None
    if args.refiner == "bridge":
        from vla_touch_tpu_torch.models.controllers import bridge as BR
        from vla_touch_tpu_torch.models.encoders import dinov2_runtime as dino

        st = BR.load_bridge_controller(args.bridge_ckpt, device=dev)
        bcfg = st.cfg
        if dev.type == "cuda" and bcfg.inference_dtype != "bfloat16":
            logger.warning("K2 takes bf16 only: the %s controller runs in bfloat16 on CUDA",
                           bcfg.inference_dtype)
            bcfg = dataclasses.replace(bcfg, inference_dtype="bfloat16")
        module = BR.deployable(dataclasses.replace(st, cfg=bcfg))
        stacked = (BR.stacked_vs if bcfg.interpolant.sde_type == "vs"
                   else BR.stacked_bs)(module)
        encoder = _load_encoder(args.bridge_ckpt, bcfg.image_model, dev)

        def bridge_fn(obs, chunk_window):
            with prof.stage("bridge_refine"):
                kw = {}
                if bcfg.use_visual:
                    kw = dict(cam1_feat=dino.encode_images(encoder, _prep_cam(obs.images[0],
                                                                              dev)),
                              cam2_feat=dino.encode_images(encoder, _prep_cam(obs.images[1],
                                                                              dev)))
                if bcfg.use_force:
                    kw["forces"] = torch.as_tensor(obs.force[None], dtype=torch.float32,
                                                   device=dev)
                # the same SDE draws at every replan, as the JAX CLI's fixed key
                out = BR.bridge_predict(
                    bcfg, module, st.stats,
                    torch.as_tensor(obs.state[None], dtype=torch.float32, device=dev),
                    torch.as_tensor(chunk_window[None], dtype=torch.float32, device=dev),
                    stacked=stacked, generator=torch.Generator(device=dev).manual_seed(0),
                    **kw).cpu().numpy()
            return out[0]

    elif args.refiner == "lstm":
        from vla_touch_tpu_torch.models.controllers import lstm as LC
        from vla_touch_tpu_torch.models.encoders import dinov2_runtime as dino
        from vla_touch_tpu_torch.utils.normalization import normalize_actions

        st = LC.load_lstm_controller(args.lstm_ckpt, device=dev)
        module = st.module.eval().requires_grad_(False)
        encoder = _load_encoder(args.lstm_ckpt, st.cfg.image_model, dev)
        obs_cond = {}

        def lstm_fn(carry, obs, action, first):
            with prof.stage("lstm_step"):
                if first or carry is None:
                    carry = module.init_carry(1, dev)
                    f1 = dino.encode_images(encoder, _prep_cam(obs.images[0], dev))
                    f2 = dino.encode_images(encoder, _prep_cam(obs.images[1], dev))
                    obs_cond["v"] = LC.lstm_encode_obs(
                        st.cfg, module, torch.as_tensor(obs.state[None], dtype=torch.float32,
                                                        device=dev), f1, f2)
                act_n = normalize_actions(torch.as_tensor(action[None], dtype=torch.float32,
                                                          device=dev), st.stats, "vla")
                carry, refined = LC.lstm_step_predict(
                    st.cfg, module, st.stats, carry, obs_cond["v"], act_n,
                    torch.as_tensor(obs.force[None], dtype=torch.float32, device=dev))
                refined = refined.cpu().numpy()
            return carry, refined[0]

    loop_cfg = ControlLoopConfig(
        chunk_size=cfg.rdt.model.horizon, replan_interval=args.replan_interval,
        refiner=args.refiner, refine_horizon=args.refine_horizon,
        gripper_deadband=args.gripper_deadband)
    return ChunkScheduler(loop_cfg, plan_fn, bridge_refine_fn=bridge_fn,
                          lstm_step_fn=lstm_fn, plan_warm_fn=plan_warm_fn)


def main(argv=None):
    p = argparse.ArgumentParser(description="Replay the control loop over a "
                                            "recorded episode")
    p.add_argument("--episode", required=True)
    p.add_argument("--rdt_checkpoint", default=None)
    p.add_argument("--refiner", choices=["none", "bridge", "lstm"], default="none")
    p.add_argument("--bridge_ckpt", default=None)
    p.add_argument("--lstm_ckpt", default=None)
    p.add_argument("--replan_interval", type=int, default=16)
    p.add_argument("--warm_skip", type=int, default=0,
                   help="warm-start replans: skip this many solver steps, "
                        "seeding from the previous (shifted) chunk")
    p.add_argument("--refine_horizon", type=int, default=16)
    p.add_argument("--gripper_deadband", type=float, default=2.0)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, which must be present)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    replay = EpisodeReplay(args.episode)
    sched = build_scheduler(args, replay)
    result = replay.run(sched, steps=args.steps)
    report = {
        "steps": result["steps"],
        "tracking_mse": result["tracking_mse"],
        "stages": prof.stage_stats(reset=True),
    }
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
