"""RDT finetuning loop (counterpart of ``vla_touch_tpu/train/rdt_loop.py``).

    python -m vla_touch_tpu_torch.train.rdt_loop --data_root DIR [--output_dir OUT]
    torchrun --nproc_per_node N -m vla_touch_tpu_torch.train.rdt_loop --data_root DIR

- the consumer dataset (condition masking, state noise, image aug) built
  into ``batch_size x grad_accum`` batches by host threads
  (``data/pipeline.py::PrefetchLoader``);
- the frozen SigLIP encoding of every frame under ``no_grad`` (K1 in its
  attention), masked frames set to the background after normalisation;
- :func:`train.rdt_train.train_step` (accumulation, clipping, AdamW or
  8-bit AdamW, EMA) on the card, TF32 off (``train/optim.py::float32_math``);
  over several ranks (a launcher's environment, or ``--coordinator`` /
  ``--num_processes`` / ``--process_id`` in each process; ``--local_rank``
  or ``LOCAL_RANK`` picks the card) and with ``--zero3``, the sharded step
  (``make_sharded_train_step``, a data-parallel mesh over every rank:
  ZeRO-2, or ZeRO-3 with ``--zero3``);
- ``checkpoint-<step>`` directories in the JAX package's layouts (a
  checkpoint written by either package resumes in the other), optionally
  written on a thread, pruned to ``checkpoints_total_limit``, resumed from
  the latest.  One process writes ``params.msgpack``, ``ema.msgpack``,
  ``opt_state.msgpack`` (a sharded state gathered first) and
  ``meta.json``.  Several ranks write ``state.orbax`` as JAX's
  multi-process trainer does: each rank its own shards into
  ``ocdbt.process_<rank>/``, nothing gathered, and rank 0 the root that
  joins them (``utils/checkpoint.py::save_pytree_orbax``; with
  ``async_save``, ``AsyncOrbaxSaver``), then ``meta.json`` once the
  directory is committed, then the prune.  A sharded state resumes by
  region: each rank reads the chunks of ``state.orbax`` its shards overlap
  (a msgpack file whole, keeping its shards), so a checkpoint written at
  any topology resumes at any other, and in either package's
  single-process trainer;
- the sampling eval every ``sample_period`` steps: the serving DPM-Solver++
  rollout on the current parameters (K1), ``sample_mse`` and the
  state-norm-scaled ``sample_l2err``, summed over the data ranks (the
  global eval batch's);
- the metrics in ``training.jsonl``, written by rank 0.

The data stream's seed is the run's seed plus 9973 times the data rank
(JAX's process index; the model ranks of one data index draw alike) plus
31337 times the start step, so a resumed run draws new samples; the i-th
batch of a run is drawn from
generators seeded by (that seed, i) and batches are handed to the step in
order, so a seed fixes the stream whatever the number of prefetch threads
(the JAX trainer's free-running threads share one generator).

Weights start seeded random, or from an HF-layout ``rdt-1b`` file
(``--pretrained_model_name_or_path``) and HF SigLIP weights
(``--siglip_checkpoint``); ``--push_to_hub`` uploads the output directory
after the final checkpoint (``utils/hub.py``).  ``--data_format epc`` reads
the native episode caches ``data/pack_epc.py`` writes.  ``--scale_lr``
multiplies the rate by batch x accumulation x world size.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from vla_touch_tpu_torch.config import DataConfig, TrainConfig
from vla_touch_tpu_torch.data.consumer import VLAConsumerDataset, collate
from vla_touch_tpu_torch.data.pipeline import PrefetchLoader
from vla_touch_tpu_torch.models.encoders.vit import (SIGLIP_SO400M, SiglipVisionEncoder,
                                                     ViTConfig, init_vit)
from vla_touch_tpu_torch.models.rdt import runner as R
from vla_touch_tpu_torch.parallel import launch
from vla_touch_tpu_torch.parallel import mesh as mesh_lib
from vla_touch_tpu_torch.parallel.comm import all_reduce_sum
from vla_touch_tpu_torch.train import rdt_train as T
from vla_touch_tpu_torch.train.optim import float32_math
from vla_touch_tpu_torch.utils import checkpoint as ckpt
from vla_touch_tpu_torch.utils import ema as ema_lib
from vla_touch_tpu_torch.utils import from_flax as FF
from vla_touch_tpu_torch.utils.device import resolve_device
from vla_touch_tpu_torch.utils.image import siglip_normalize
from vla_touch_tpu_torch.utils.metrics import MetricsLogger

logger = logging.getLogger("rdt_loop")

# The tiny scale's image tower: rdt_tiny's 24 image tokens are 6 frames of
# 2 x 2 patches, 48 wide (So400m's 1152-wide tokens do not fit its adaptor).
TINY_VIT = ViTConfig(hidden_size=48, num_layers=1, num_heads=4, mlp_dim=96,
                     image_size=28, patch_size=14, use_cls_token=False,
                     use_layerscale=False, gelu_tanh=True)

_TREES = ("params", "ema", "opt_state")


@torch.no_grad()
def encode_images(vision, images, image_mask):
    """uint8 frames (B, F, S, S, 3) -> SigLIP tokens (B, F * N, D) in the
    tower's dtype, frozen; a masked frame is the background (0 after
    normalisation)."""
    B, F, S = images.shape[:3]
    x = siglip_normalize(images)
    x = torch.where(image_mask[:, :, None, None, None], x, torch.zeros_like(x))
    dtype = next(vision.parameters()).dtype
    tokens = vision(x.reshape(B * F, S, S, 3).to(dtype))
    return tokens.reshape(B, -1, tokens.shape[-1])


_SAMPLE_KEYS = ("lang_tokens", "lang_mask", "state_tokens", "action_gt", "action_mask",
                "ctrl_freqs", "state_norm")


@torch.no_grad()
def sample_metrics(rcfg: R.RDTRunnerConfig, module, batch: dict, img_tokens,
                   generator: Optional[torch.Generator] = None, init_noise=None,
                   group=None) -> dict:
    """The full-rollout eval: ``rdt_predict_action`` on ``module``'s current
    parameters (the serving path, K1), then ``sample_mse`` (the masked
    squared error over the masked entries) and ``sample_l2err`` (each
    row's error norm over the state norm).  ``batch``: device tensors.
    ``group``: the data ranks, whose rows make the global batch (the sums
    are taken over them)."""
    b = {k: batch[k] for k in _SAMPLE_KEYS}
    pred = R.rdt_predict_action(rcfg, module, b["lang_tokens"], b["lang_mask"], img_tokens,
                                b["state_tokens"], b["action_mask"], b["ctrl_freqs"],
                                init_noise=init_noise, generator=generator)
    gt, mask = b["action_gt"].float(), b["action_mask"].float()
    diff = (pred - gt) * mask
    norm = torch.clamp_min(torch.linalg.norm(b["state_norm"].float(), dim=-1, keepdim=True),
                           1e-6)
    se_sum = torch.sum(torch.square(diff))
    mask_sum = torch.sum(mask) * gt.shape[1]
    l2_sum = torch.sum(torch.linalg.norm(diff, dim=-1) / norm)
    rows = torch.tensor(float(gt.shape[0] * gt.shape[1]), device=diff.device)
    if group is not None:
        se_sum, mask_sum, l2_sum, rows = all_reduce_sum(
            torch.stack([se_sum, mask_sum, l2_sum, rows]), group)
    return {"sample_mse": float(se_sum / torch.clamp_min(mask_sum, 1.0)),
            "sample_l2err": float(l2_sum / torch.clamp_min(rows, 1.0))}


def device_batch(batch: dict, device) -> dict:
    """A collated host batch on ``device`` (the names list dropped)."""
    return {k: torch.as_tensor(np.asarray(v)).to(device, non_blocking=True)
            for k, v in batch.items() if k != "dataset_names"}


@dataclasses.dataclass
class RDTTrainer:
    rcfg: R.RDTRunnerConfig
    tcfg: TrainConfig
    dcfg: DataConfig
    output_dir: str
    vision_cfg: ViTConfig = SIGLIP_SO400M
    device: object = None
    # the (data, model) mesh of a multi-rank run (parallel/mesh.py); the
    # sharded step also runs without one (one rank) for tcfg.zero3
    mesh: object = None

    def __post_init__(self):
        os.makedirs(self.output_dir, exist_ok=True)
        self.device = resolve_device(self.device)
        self.metrics = MetricsLogger(self.output_dir)
        self.metrics_log = self.metrics.jsonl_path
        self.optimizer = None
        # a multi-rank run's generator of the rounding bits (train)
        self.shared_generator = None
        self._ckpt_thread = None
        self._ckpt_error = None
        self._async_saver = None
        # the chunks the last load_checkpoint read (state.orbax)
        self.load_stats = {}
        float32_math()

    # ---- checkpoint I/O ----

    def is_main(self) -> bool:
        return launch.process_index() == 0

    def save_checkpoint(self, state: T.TrainState, step: int) -> dict:
        """``checkpoint-<step>``: the state, then ``meta.json``, then the
        prune (with ``async_save``, on a thread after a snapshot to host
        memory: training goes on changing the state in place).  One
        process writes the three msgpack trees (a sharded state gathered
        first); several ranks write ``state.orbax``, each its own shards
        (collective: every rank calls this).  Returns {tree or
        "state.orbax": bytes this process wrote} (empty when the write
        runs on a thread)."""
        path = os.path.join(self.output_dir, f"checkpoint-{step}")
        if launch.process_count() > 1:
            return self._save_orbax(state, path, step)
        if state.plan is not None:
            full = T.gather_train_state(state)
            state = _Gathered(state.module, full["params"], full["opt_state"],
                              ema_lib.EmaState(full["shadow"], state.ema.num_updates),
                              state.step)
        trees = FF.rdt_train_state_to_flax(state, self.optimizer)
        trees["meta"]["step"] = step
        if not self.tcfg.async_save:
            return self._write(path, trees)
        self._wait_ckpt()
        host = {k: _to_host(trees[k]) for k in _TREES}
        host["meta"] = trees["meta"]

        def write():
            try:
                self._write(path, host)
            except BaseException as e:  # raised by _wait_ckpt
                self._ckpt_error = e

        self._ckpt_thread = threading.Thread(target=write, daemon=True)
        self._ckpt_thread.start()
        return {}

    def _write(self, path: str, trees: dict) -> dict:
        sizes = {k: ckpt.save_pytree(os.path.join(path, f"{k}.msgpack"), trees[k])
                 for k in _TREES}
        # meta lands after the data: resume never picks a partial checkpoint
        self._finish(path, trees["meta"])
        return sizes

    def _finish(self, path: str, meta: dict) -> None:
        if self.is_main():
            ckpt.save_json(os.path.join(path, "meta.json"), meta)
            ckpt.prune_checkpoints(self.output_dir, self.tcfg.checkpoints_total_limit)

    def _save_orbax(self, state: T.TrainState, path: str, step: int) -> dict:
        """Every rank's shards into ``path/state.orbax`` (JAX's
        multi-process layout), then rank 0's ``meta.json`` and prune; under
        ``async_save`` the write and then a finalize thread, in the order
        of the JAX trainer's."""
        trees = FF.rdt_train_state_shards(state, self.optimizer)
        meta = dict(trees.pop("meta"), step=step)
        trees["opt_state"] = self.optimizer.orbax_tree(trees["opt_state"])
        orbax = os.path.join(path, "state.orbax")
        mesh = self.mesh if state.plan is None else state.plan.mesh
        if not self.tcfg.async_save:
            try:
                nbytes = ckpt.save_pytree_orbax(orbax, trees, mesh=mesh)
            except BaseException:
                self._drop(path)
                raise
            self._finish(path, meta)
            return {"state.orbax": nbytes}
        if self._async_saver is None:
            self._async_saver = ckpt.AsyncOrbaxSaver()
        self._wait_ckpt()
        self._async_saver.save(orbax, trees, mesh=mesh)

        def finalize():
            # meta.json only once state.orbax is renamed into place
            try:
                self._async_saver.wait()
                self._finish(path, meta)
            except BaseException as e:  # raised by _wait_ckpt
                self._drop(path)
                self._ckpt_error = e

        self._ckpt_thread = threading.Thread(target=finalize, daemon=True)
        self._ckpt_thread.start()
        return {}

    def _drop(self, path: str) -> None:
        """A checkpoint whose write failed on some rank: rank 0 removes its
        directory (every rank has stopped writing), so resume never picks
        it."""
        if self.is_main():
            shutil.rmtree(path, ignore_errors=True)

    def _wait_ckpt(self):
        """Block until an in-flight checkpoint write has landed; re-raise its
        failure (at several ranks: any rank's, on every rank)."""
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None
        if self._async_saver is not None:
            self._async_saver.wait()
        if self._ckpt_error is not None:
            err, self._ckpt_error = self._ckpt_error, None
            raise RuntimeError("async checkpoint write failed") from err

    def load_checkpoint(self, state: T.TrainState, path: str) -> T.TrainState:
        """Read ``path`` (written by either package, at any topology) into
        ``state``: its ``state.orbax`` directory where there is one (JAX's
        multi-process runs and the port's several ranks write only that),
        else the msgpack files.  A sharded state takes its own regions: of
        ``state.orbax`` only the chunks they overlap are read (counted in
        ``self.load_stats``)."""
        self._wait_ckpt()
        regions = None
        if state.plan is not None:
            shards = FF.rdt_train_state_shards(state, self.optimizer)
            regions = {k: shards[k] for k in _TREES}
        orbax_path = os.path.join(path, "state.orbax")
        self.load_stats = {}
        if os.path.exists(orbax_path):
            trees = ckpt.load_pytree_orbax(orbax_path, regions=regions, stats=self.load_stats)
        else:
            trees = {k: ckpt.load_pytree(os.path.join(path, f"{k}.msgpack")) for k in _TREES}
            if regions is not None:
                trees = ckpt.take_regions(trees, regions)
        trees["meta"] = ckpt.load_json(os.path.join(path, "meta.json"))
        return FF.rdt_train_state_from_flax(trees, state, self.optimizer)

    # ---- main loop ----

    def train(self, file_paths=None, max_steps: Optional[int] = None,
              resume_from: Optional[str] = "latest", vision=None, seed: Optional[int] = None,
              init_module=None, on_step=None) -> T.TrainState:
        """Train to ``max_steps`` (``max_train_steps`` when None) from a
        fresh state (``init_module``'s weights, else seeded random) or the
        checkpoint ``resume_from`` ("latest": the newest under the output
        directory, if any); the final state is saved as
        ``checkpoint-<max_steps>``.  ``vision``: the frozen SigLIP tower
        (seeded random when None).  ``on_step(step, state, metrics)`` is
        called after each step."""
        tcfg, rcfg, dcfg = self.tcfg, self.rcfg, self.dcfg
        seed = tcfg.seed if seed is None else seed
        if vision is None:
            logger.warning("no SigLIP weights supplied: image conditioning uses a RANDOM "
                           "tower (--siglip_checkpoint loads the HF weights)")
            vision = init_vit(SiglipVisionEncoder, self.vision_cfg, seed + 1, self.device,
                              rcfg.model.compute_dtype)
        state = T.init_train_state(rcfg, tcfg, seed, self.device, module=init_module)
        self.optimizer = T.make_optimizer(tcfg, state.module)
        if self.mesh is not None or tcfg.zero3:
            # sharded before the resume: each rank reads its own regions
            _, plan = T.make_sharded_train_step(self.mesh, rcfg, tcfg)
            state = T.shard_train_state(self.mesh, state, plan)
        path = (ckpt.latest_checkpoint(self.output_dir) if resume_from == "latest"
                else resume_from)
        if path:
            state = self.load_checkpoint(state, path)
            logger.info("resumed from %s at step %d", path, state.step)
        start_step = state.step
        self.shared_generator = None
        if state.plan is not None and launch.process_count() > 1:
            # the rounding bits of replicated leaves: alike on every rank
            self.shared_generator = torch.Generator(device=self.device).manual_seed(
                seed + 31337 * start_step)
        # a resumed run draws new samples and new noise; each data rank its own
        data_seed = seed + 9973 * mesh_lib.data_index(self.mesh) + 31337 * start_step
        dataset = VLAConsumerDataset(dcfg, seed=data_seed, file_paths=file_paths)
        generator = torch.Generator(device=self.device).manual_seed(data_seed)
        max_steps = max_steps or tcfg.max_train_steps
        n = tcfg.batch_size * tcfg.grad_accum

        def make_batch(index):
            part = dataset.fork((data_seed, index))
            return collate([part.sample() for _ in range(n)],
                           max_lang_len=rcfg.model.max_lang_cond_len)

        loader = PrefetchLoader(make_batch, depth=2, workers=tcfg.prefetch_workers,
                                num_batches=max_steps - start_step)
        try:
            for step in range(start_step, max_steps):
                self._step(state, next(loader), vision, generator, step, on_step)
        finally:
            loader.close()
        self.save_checkpoint(state, max_steps)
        self._wait_ckpt()
        if launch.process_count() > 1:
            torch.distributed.barrier()
        return state

    def step(self, state, batch: dict, vision, generator=None):
        """One training step on a collated host batch: the SigLIP encode,
        then :func:`train.rdt_train.train_step` on the (grad_accum,
        batch_size, ...) device batch.  Returns (state, metrics, the flat
        device batch, its image tokens)."""
        flat = device_batch(batch, self.device)
        img_tokens = encode_images(vision, flat.pop("images"), flat.pop("image_mask"))
        shape = (self.tcfg.grad_accum, -1)
        dev = {k: v.reshape(shape + tuple(v.shape[1:]))
               for k, v in flat.items() if k != "state_norm"}
        dev["img_tokens"] = img_tokens.reshape(shape + tuple(img_tokens.shape[1:]))
        if state.plan is not None:
            state, metrics = T.sharded_train_step(
                state.plan, self.rcfg, self.tcfg, state, dev, generator=generator,
                shared_generator=self.shared_generator,
                optimizer=self.optimizer)
        else:
            state, metrics = T.train_step(self.rcfg, self.tcfg, state, dev,
                                          generator=generator, optimizer=self.optimizer)
        return state, metrics, flat, img_tokens

    def _step(self, state, batch, vision, generator, step, on_step):
        tcfg = self.tcfg
        state, metrics, flat, img_tokens = self.step(state, batch, vision, generator)
        if on_step is not None:
            on_step(step, state, metrics)
        if step % 10 == 0 and self.is_main():
            row = self.metrics.log(step, {"loss": float(metrics["loss"]),
                                          "grad_norm": float(metrics["grad_norm"])})
            logger.info("step %d loss %.4f", step, row["loss"])
        if (step + 1) % tcfg.checkpointing_period == 0:
            self.save_checkpoint(state, step + 1)
        if (step + 1) % tcfg.sample_period == 0:
            group = (None if state.plan is None
                     else mesh_lib.group(self.mesh, mesh_lib.DATA_AXIS))
            with T.full_parameters(state) as module:
                sm = sample_metrics(self.rcfg, module, flat, img_tokens, generator=generator,
                                    group=group)
            if self.is_main():
                self.metrics.log(step + 1, sm, kind="sample_eval")
                logger.info("sample eval @%d: %s", step + 1, sm)


@dataclasses.dataclass
class _Gathered:
    """A sharded state's full leaves on the host, as ``TrainState`` reads."""

    module: object
    params: dict
    opt_state: object
    ema: object
    step: int


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


# ---- command line ----


def build_parser():
    """The JAX package's flag surface, plus ``--device``."""
    import argparse

    p = argparse.ArgumentParser(
        description="Finetune RDT on one or more GPUs; the flag surface of the JAX "
                    "package's trainer")
    # multi-rank training: one process per GPU
    p.add_argument("--coordinator", default=None,
                   help="rank 0's host:port (or an init URL, e.g. file:///path); also "
                        "read from a launcher's MASTER_ADDR / RANK / WORLD_SIZE")
    p.add_argument("--num_processes", type=int, default=None, help="the world size")
    p.add_argument("--process_id", type=int, default=None, help="this process's rank")
    # data
    p.add_argument("--data_root", default="data/datasets")
    p.add_argument("--dataset_name", default="mango")
    p.add_argument("--output_dir", default="checkpoints/rdt")
    p.add_argument("--load_from_hdf5", action="store_true",
                   help="accepted for script compatibility; episodes are h5 or npz")
    p.add_argument("--data_format", default="h5", choices=("h5", "epc"),
                   help="'h5' reads h5 and npz episodes, 'epc' the native episode caches")
    p.add_argument("--cond_mask_prob", type=float, default=0.1)
    p.add_argument("--cam_ext_mask_prob", type=float, default=-1.0)
    p.add_argument("--state_noise_snr", type=float, default=None)
    p.add_argument("--image_aug", action="store_true")
    p.add_argument("--precomp_lang_embed", action="store_true",
                   help="accepted; precomputed T5 embeddings are the only language path")
    p.add_argument("--dataloader_num_workers", type=int, default=2,
                   help="host-side prefetch threads")
    # optimization
    p.add_argument("--batch_size", "--train_batch_size", dest="batch_size", type=int,
                   default=4)
    p.add_argument("--sample_batch_size", type=int, default=None,
                   help="accepted (the sampling eval reuses the train batch)")
    p.add_argument("--grad_accum", "--gradient_accumulation_steps", dest="grad_accum",
                   type=int, default=4)
    p.add_argument("--max_train_steps", type=int, default=40000)
    p.add_argument("--num_train_epochs", type=int, default=None,
                   help="accepted; sampling is infinite, cap with --max_train_steps")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--scale_lr", action="store_true",
                   help="scale the learning rate by the global batch (batch x "
                        "accumulation x world size)")
    p.add_argument("--lr_scheduler", default="constant",
                   choices=["constant", "linear", "cosine", "constant_with_warmup"])
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--lr_num_cycles", type=int, default=1)
    p.add_argument("--lr_power", type=float, default=1.0)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.95)
    p.add_argument("--adam_weight_decay", type=float, default=1e-3)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--use_8bit_adam", action="store_true")
    p.add_argument("--zero3", action="store_true",
                   help="shard the parameters and EMA over the data ranks (ZeRO-3)")
    p.add_argument("--accum_dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--ema_dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--param_dtype", choices=["float32", "bfloat16"], default="float32",
                   help="bfloat16 drops the float32 master (requires --use_8bit_adam)")
    p.add_argument("--alpha", type=float, default=None, help="accepted (unused)")
    p.add_argument("--seed", type=int, default=42)
    # checkpoint / eval
    p.add_argument("--checkpointing_period", type=int, default=1000)
    p.add_argument("--async_save", action="store_true",
                   help="write checkpoints on a thread (after a host snapshot)")
    p.add_argument("--checkpoints_total_limit", type=int, default=40)
    p.add_argument("--sample_period", type=int, default=100)
    p.add_argument("--num_sample_batches", type=int, default=2)
    p.add_argument("--resume_from_checkpoint", default="latest")
    # model / towers
    p.add_argument("--model_scale", choices=["1b", "170m", "tiny"], default="1b",
                   help="tiny pairs rdt_tiny with a 1-layer SigLIP at 28 x 28")
    p.add_argument("--pretrained_model_name_or_path", default=None,
                   help="HF-layout RDT checkpoint file (model.safetensors or "
                        "pytorch_model.bin) to start from")
    p.add_argument("--siglip_checkpoint", "--pretrained_vision_encoder_name_or_path",
                   dest="siglip_checkpoint", default=None,
                   help="HF SigLIP vision weights (.safetensors, or a torch pickle)")
    p.add_argument("--pretrained_text_encoder_name_or_path", default=None,
                   help="accepted; language embeddings are precomputed")
    p.add_argument("--push_to_hub", action="store_true",
                   help="upload the output directory after the final checkpoint "
                        "(needs huggingface_hub and the network)")
    p.add_argument("--hub_model_id", default=None)
    p.add_argument("--hub_token", default=None)
    for flag in ("--config_path", "--deepspeed", "--report_to", "--logging_dir",
                 "--mixed_precision"):
        p.add_argument(flag, default=None, help="accepted for script compatibility")
    for flag in ("--allow_tf32", "--set_grads_to_none"):
        p.add_argument(flag, action="store_true", help="accepted for script compatibility "
                       "(TF32 stays off: float32_math)")
    p.add_argument("--gradient_checkpointing", action="store_true",
                   help="recompute each RDT block in the backward pass")
    p.add_argument("--local_rank", type=int, default=-1,
                   help="this process's GPU (default LOCAL_RANK, else the rank)")
    p.add_argument("--device", default=None,
                   help="default CUDA; 'cpu' runs the process group over Gloo")
    return p


def load_pretrained_rdt(rcfg: R.RDTRunnerConfig, path: str, seed: int, device):
    """The float32 master-weight runner :func:`runner.init_rdt_train` makes,
    filled from an HF-layout checkpoint file (``utils/torch_port.py``)."""
    from vla_touch_tpu_torch.utils.torch_port import load_rdt_checkpoint

    module = R.init_rdt_train(rcfg, seed, device)
    depths = tuple(getattr(module, n).depth
                   for n in ("lang_adaptor", "img_adaptor", "state_adaptor"))
    tree = load_rdt_checkpoint(path, depth=rcfg.model.depth, adaptor_depths=depths)
    return FF.load_into(module, FF.rdt_runner(tree))


def load_siglip(vision_cfg: ViTConfig, path: str, device, dtype):
    """The frozen SigLIP tower from HF ``SiglipVisionModel`` weights: a
    ``.safetensors`` file (read by ``utils/safetensors_io.py``) or a torch
    pickle (``weights_only``)."""
    from vla_touch_tpu_torch.utils.torch_port import read_state_dict, siglip_from_hf

    vision = init_vit(SiglipVisionEncoder, vision_cfg, 0, device, dtype)
    tree = siglip_from_hf(read_state_dict(path), num_layers=vision_cfg.num_layers)
    return FF.load_into(vision, FF.vit(tree))


def main(argv=None):
    args = build_parser().parse_args(argv)
    started = not (torch.distributed.is_available() and torch.distributed.is_initialized())
    distributed = launch.initialize(args.coordinator, args.num_processes, args.process_id,
                                    device=args.device, local_rank=args.local_rank)
    try:
        return _main(args, distributed)
    finally:
        if distributed and started:
            launch.shutdown()


def _main(args, distributed: bool):
    from vla_touch_tpu_torch.config import NoiseSchedulerConfig, rdt_1b, rdt_170m, rdt_tiny

    mesh = device = None
    if distributed:
        device = launch.local_device()
        mesh = mesh_lib.make_mesh(n_data=launch.process_count(), n_model=1)
        logger.info("distributed: rank %d of %d on %s", launch.process_index(),
                    launch.process_count(), device)
    model_cfg = {"1b": rdt_1b, "170m": rdt_170m, "tiny": rdt_tiny}[args.model_scale]()
    if args.gradient_checkpointing:
        model_cfg = dataclasses.replace(model_cfg, remat_blocks=True)
    rcfg = R.RDTRunnerConfig(model=model_cfg, noise=NoiseSchedulerConfig())
    lr = args.learning_rate
    if args.scale_lr:
        lr *= args.batch_size * args.grad_accum * launch.process_count()
    tcfg = TrainConfig(
        batch_size=args.batch_size, grad_accum=args.grad_accum,
        max_train_steps=args.max_train_steps, learning_rate=lr,
        lr_scheduler=args.lr_scheduler, lr_warmup_steps=args.lr_warmup_steps,
        weight_decay=args.adam_weight_decay, adam_beta1=args.adam_beta1,
        adam_beta2=args.adam_beta2, adam_epsilon=args.adam_epsilon,
        max_grad_norm=args.max_grad_norm, use_8bit_adam=args.use_8bit_adam,
        zero3=args.zero3, accum_dtype=args.accum_dtype, ema_dtype=args.ema_dtype,
        param_dtype=args.param_dtype, checkpointing_period=args.checkpointing_period,
        async_save=args.async_save, checkpoints_total_limit=args.checkpoints_total_limit,
        sample_period=args.sample_period, seed=args.seed,
        prefetch_workers=args.dataloader_num_workers)
    vision_cfg = TINY_VIT if args.model_scale == "tiny" else SIGLIP_SO400M
    dcfg = DataConfig(data_root=args.data_root, dataset_names=(args.dataset_name,),
                      cond_mask_prob=args.cond_mask_prob,
                      cam_ext_mask_prob=args.cam_ext_mask_prob,
                      state_noise_snr=args.state_noise_snr, image_aug=args.image_aug,
                      chunk_size=model_cfg.horizon, image_size=vision_cfg.image_size,
                      data_format=args.data_format)
    logging.basicConfig(level=logging.INFO)
    trainer = RDTTrainer(rcfg, tcfg, dcfg, args.output_dir, vision_cfg=vision_cfg,
                         device=device or args.device, mesh=mesh)
    init_module = vision = None
    if args.pretrained_model_name_or_path:
        init_module = load_pretrained_rdt(rcfg, args.pretrained_model_name_or_path,
                                          args.seed, trainer.device)
    if args.siglip_checkpoint:
        vision = load_siglip(vision_cfg, args.siglip_checkpoint, trainer.device,
                             model_cfg.compute_dtype)
    state = trainer.train(resume_from=args.resume_from_checkpoint, vision=vision,
                          init_module=init_module)
    if args.push_to_hub and trainer.is_main():
        from vla_touch_tpu_torch.utils.hub import push_checkpoint_to_hub

        repo = push_checkpoint_to_hub(args.output_dir, hub_model_id=args.hub_model_id,
                                      token=args.hub_token,
                                      base_model=args.pretrained_model_name_or_path)
        logger.info("pushed to hub repo %s", repo)
    return state


if __name__ == "__main__":
    main()
