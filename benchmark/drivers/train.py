"""Finetuning cells: ``train/rdt_loop.py::RDTTrainer.step`` (the frozen
SigLIP encode, then ``train/rdt_train.py::train_step``: gradient
accumulation, clipping, AdamW on float32 masters, the EMA) on collated host
batches made from the seed.

Set-up builds one trainer and one train state from the seeded weights and
drives that same object through the first ``checked_steps`` steps, on
batches whose rows all differ, recording what ``correct`` compares: each
step's loss, the first step's gradients as the optimizer took them (its
first moment over 1 - beta1) and each parameter's change after the last of
these steps.  The window then runs whole steps on the same object, cycling
the mix's batches, and ends when the last step begun inside it ends.

After the window the program's state is freed and the plain reference
runs the same steps from the same weights, batches and draws (the
trainer's generator replayed from its seed).
"""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import harness as HN
from benchmark import traffic as TR
from benchmark.drivers import common as C
from benchmark.reference import model as M
from benchmark.reference import train as RT
from benchmark.trace import Tracer

# a leaf is left out of the change's comparison when its reference gradient
# is under this share of the median leaf's: it moves by round-off alone
GRAD_FLOOR = 1e-3


def configs(cell: dict):
    from vla_touch_tpu_torch.config import DataConfig, TrainConfig

    traffic = cell["traffic"]
    d = traffic["data"]
    dcfg = DataConfig(img_history_size=d["img_history_size"], num_cameras=d["num_cameras"],
                      chunk_size=d["chunk_size"], image_size=d["image_size"],
                      state_dim=d["state_dim"], cond_mask_prob=d["cond_mask_prob"],
                      control_freq=d["control_freq"], image_aug=d["image_aug"])
    return C.runner_config(cell["config"]), TrainConfig(**traffic["recipe"]), dcfg


def draws(noise_cfg: dict, seed: int, n_steps: int, shape, device) -> list:
    """The trainer's draws of its first steps, replayed from its seed: per
    step the noise of all rows, then their timesteps (``train_draws``'
    order)."""
    gen = torch.Generator(device=device).manual_seed(TR.sub_seed(seed, "draws"))
    out = []
    for _ in range(n_steps):
        noise = torch.randn(shape, generator=gen, device=device)
        t = torch.randint(0, noise_cfg["timesteps"], shape[:1], generator=gen, device=device,
                          dtype=torch.int32)
        out.append((noise, t))
    return out


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def run(cell: dict, seed: int, seconds: float, trace: bool, device="cuda") -> dict:
    from vla_touch_tpu_torch.data.consumer import collate
    from vla_touch_tpu_torch.models.rdt import runner as R
    from vla_touch_tpu_torch.train import rdt_train as T
    from vla_touch_tpu_torch.train.rdt_loop import RDTTrainer

    config, traffic = cell["config"], cell["traffic"]
    rcfg, tcfg, dcfg = configs(cell)
    module, vision, mapping = C.modules(config, seed, device, torch.float32)
    R.master_weights_(module, rcfg.model.compute_dtype).requires_grad_(True)
    out_dir = tempfile.mkdtemp(prefix="portbench_train_")
    try:
        trainer = RDTTrainer(rcfg, tcfg, dcfg, out_dir, vision_cfg=C.vision_config(config),
                             device=device)
        state = T.init_train_state(rcfg, tcfg, seed, device, module=module)
        trainer.optimizer = T.make_optimizer(tcfg, state.module)
        gen = torch.Generator(device=device).manual_seed(TR.sub_seed(seed, "draws"))
        batches = TR.train_batches(traffic, config, seed, collate)
        n_rows = tcfg.batch_size * tcfg.grad_accum
        b1 = tcfg.adam_beta1

        p0 = {n: p.detach().clone() for n, p in state.module.named_parameters()}
        losses, first = [], None
        for s in range(traffic["checked_steps"]):
            state, metrics, _, _ = trainer.step(state, batches[s % len(batches)], vision, gen)
            losses.append(float(metrics["loss"]))
            if first is None:
                first = norms({n: m / (1.0 - b1) for n, m in state.opt_state.mu.items()})
        change = norms({n: p.detach() - p0[n] for n, p in state.module.named_parameters()})
        del p0
        C.sync(device)

        tracer = Tracer() if trace else None
        timer = C.TowerTimer(vision) if trace else None
        trace_from, trace_n = 2, traffic["trace_steps"]
        setup_peak = C.memory_peak(device)
        if trace:
            torch.cuda.reset_peak_memory_stats()
        setup_s = HN.process_age_s()
        steps, k = 0, traffic["checked_steps"]
        traced, ends = [], []
        t_start = time.perf_counter()
        t_end = t_start + seconds
        while time.perf_counter() < t_end:
            if tracer is not None and steps == trace_from:
                C.sync(device)
                tracer.start()
            batch = batches[k % len(batches)]
            state, metrics, _, _ = trainer.step(state, batch, vision, gen)
            if tracer is not None and tracer.t0 is not None and not tracer.done:
                traced.append(batch["lang_mask"].sum(axis=1).tolist())
                if len(traced) == trace_n:
                    tracer.stop()
            steps += 1
            k += 1
            ends.append(time.perf_counter())
        C.sync(device)
        t_stop = time.perf_counter()
        if tracer is not None and tracer.t0 is not None and not tracer.done:
            tracer.stop()
        siglip_ms = timer.ms() if timer else []
        window_peak = C.memory_peak(device)
        peak = max(setup_peak, window_peak)
        e2e = {"setup_s": setup_s, "train_samples_per_s": steps * n_rows / (t_stop - t_start)}
        ctx = {"config": config, "traffic": traffic, "siglip_ms": siglip_ms,
               "peak_bytes": window_peak if trace else None,
               "trace": tracer.reduce() if tracer is not None and tracer.done else None,
               "traced_steps": traced, "micro_batch": tcfg.batch_size}
        if timer is not None:
            timer.remove()
        del trainer, state, module, vision, metrics, timer
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    C.free(device)
    program = {"loss": losses,
               "first_grads": {mapping[n][0]: v for n, v in first.items()},
               "change": {mapping[n][0]: v for n, v in change.items()}}
    numbers = check(config, traffic, seed, batches[:traffic["checked_steps"]], program,
                    n_rows, tcfg.batch_size, device)
    # each step's host time (a step waits on the one before at its batch's copy)
    numbers["_step_s"] = np.diff([t_start] + ends[:-1] + [t_stop]).round(4).tolist()
    return {"e2e": e2e, "ctx": ctx, "numbers": numbers, "attempted": steps, "failed": 0,
            "memory_peak": peak, "errors": []}


def device_batch(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()
            if k not in ("dataset_names", "state_norm")}


def reference_run(config, traffic, seed, batches, n_rows, micro_batch, device,
                  precision=None, rows=None) -> dict:
    """The reference's steps from the seeded weights: losses, first
    clipped gradients' norms and the parameters' change norms.  ``rows``
    keeps only those rows of every batch (a planted fault)."""
    M.float32_matmuls()
    cfg = config["rdt"]
    params = C.rdt_weights(config, seed, device, torch.float32)
    p0 = {k: v.clone() for k, v in params.items()}
    vision = M.Ref(C.siglip_weights(config, seed, device, C.DTYPES[config["vision"]["dtype"]]),
                   precision)
    dev_batches = [device_batch(b, device) for b in batches]
    d = draws({"timesteps": config["noise"]["num_train_timesteps"]}, seed, len(batches),
              (n_rows, cfg["horizon"], cfg["output_dim"]), device)
    if rows is not None:
        dev_batches = [{k: v[rows] for k, v in b.items()} for b in dev_batches]
        d = [(n[rows], t[rows]) for n, t in d]
    out = RT.train_steps(M.Ref(params, precision), vision, config, traffic["recipe"],
                         dev_batches, d, micro_batch)
    return {"loss": out["loss"], "first_grads": norms(out["first_grads"]),
            "change": norms({k: params[k] - p0[k] for k in params})}


def compare(program: dict, ref: dict) -> dict:
    """loss_gap: the largest relative gap of a step's loss; grad_gap and
    change_gap: the worst leaf's gap of norms (over the larger of the
    reference's norm of that leaf and of the median leaf), the change over
    the leaves whose reference gradient is not nought to rounding;
    grad_gap_own and change_gap_own: the same over those leaves, each
    against its own norm, so that a small leaf that moves wrongly shows."""
    median_g = float(np.median(list(ref["first_grads"].values())))
    moving = {k for k, v in ref["first_grads"].items() if v >= GRAD_FLOOR * median_g}
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(program["loss"], ref["loss"]))
    out = {"loss_gap": loss_gap}
    for key, keep, own in (("grad_gap", None, False), ("change_gap", moving, False),
                           ("grad_gap_own", moving, True), ("change_gap_own", moving, True)):
        leaves = "first_grads" if key.startswith("grad") else "change"
        out[key], out[f"_{key}_leaf"] = RT.worst_leaf_gap(program[leaves], ref[leaves], keep, own)
    out["_left_out"] = sorted(set(ref["first_grads"]) - moving)
    return out


def check(config, traffic, seed, batches, program, n_rows, micro_batch, device) -> dict:
    ref = reference_run(config, traffic, seed, batches, n_rows, micro_batch, device)
    return compare(program, ref)
