"""One rank of ``tests/test_torch_parallel.py``'s multi-rank scenarios: the
port over Gloo on the CPU (imports no JAX).

    python tests/torch_parallel_worker.py RANK WORLD DIR

``DIR/inputs.pt`` (written by the test) names the scenarios and holds
their inputs; the ranks meet through a file store in ``DIR`` and each
writes ``DIR/out<RANK>.pt``.
"""

import os
import sys

import torch
import torch.distributed as dist

from vla_touch_tpu_torch import config as TC
from vla_touch_tpu_torch.models.encoders import t5_native as T5
from vla_touch_tpu_torch.models.rdt import runner as R
from vla_touch_tpu_torch.parallel import launch
from vla_touch_tpu_torch.parallel import mesh as mesh_lib
from vla_touch_tpu_torch.parallel import tp as tp_lib
from vla_touch_tpu_torch.planning import llm as L
from vla_touch_tpu_torch.train import rdt_loop as RL
from vla_touch_tpu_torch.train import rdt_train as T
from vla_touch_tpu_torch.utils import from_flax as FF

RCFG = R.RDTRunnerConfig(model=TC.rdt_tiny())


def _np(t):
    return None if t is None else t.detach().float().numpy()


def _state(inp, tcfg):
    module = FF.load_into(R.init_rdt_train(RCFG, device="cpu"), inp["rdt"])
    return T.init_train_state(RCFG, tcfg, module=module)


def _local(mesh, batch, draws):
    """This rank's rows of a global (accumulation, rows, ...) batch and of
    the step's draws (the rounding bits stay whole)."""
    b = launch.host_local_batch(mesh, batch, spec=(None, "data"), device="cpu")
    d = launch.host_local_batch(mesh, {k: draws[k] for k in ("noise", "timesteps")},
                                spec=(None, "data"), device="cpu")
    d.update({k: v for k, v in draws.items() if k not in d})
    return b, d


def _steps(mesh, state, tcfg, steps, opt=None):
    step_fn, _ = T.make_sharded_train_step(mesh, RCFG, tcfg)
    opt = opt or T.make_optimizer(tcfg, state.module)
    metrics = []
    for batch, draws in steps:
        b, d = _local(mesh, batch, draws)
        state, m = step_fn(state, b, draws=d, optimizer=opt)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return state, metrics


def _gathered(state):
    full = T.gather_train_state(state)
    if full is None:
        return None
    st = full["opt_state"]
    opt = {k: {n: _np(v) if v.dtype.is_floating_point else v.numpy() for n, v in
               getattr(st, k).items()}
           for k in (("m_q", "m_s", "v_q", "v_s") if hasattr(st, "m_q") else ("mu", "nu"))}
    return {"params": {n: _np(v) for n, v in full["params"].items()},
            "shadow": {n: _np(v) for n, v in full["shadow"].items()}, "opt": opt}


def train_scenario(inp, spec):
    """A mesh, a recipe and steps: per-step (loss, grad norm), the gathered
    state, and which leaves the rank holds sharded."""
    mesh = mesh_lib.make_mesh(*spec["mesh"])
    tcfg = TC.TrainConfig(**spec["recipe"])
    state = _state(inp, tcfg)
    _, plan = T.make_sharded_train_step(mesh, RCFG, tcfg)
    state = T.shard_train_state(mesh, state, plan)
    local = {n: tuple(p.shape) for n, p in state.module.named_parameters()}
    shadow = {n: tuple(s.shape) for n, s in state.ema.shadow.items()}
    state, metrics = _steps(mesh, state, tcfg, inp["steps"][: spec["n_steps"]])
    return {"metrics": metrics, "state": _gathered(state), "local_shapes": local,
            "shadow_shapes": shadow}


def serve_tp(inp):
    mesh = mesh_lib.make_mesh(1, 2)
    module = FF.load_into(R.init_rdt(RCFG, device="cpu"), inp["rdt"])
    tp_lib.shard_rdt_tp_(module, mesh)
    a = inp["serve"]
    out = R.rdt_predict_action(RCFG, module, *[torch.as_tensor(a[k]) for k in (
        "lang", "lang_mask", "img", "state", "action_mask", "freqs")],
        init_noise=torch.as_tensor(a["noise"]))
    heads = module.model.blocks[0].attn.qkv.weight.shape[0] // (3 * RCFG.model.hidden_size
                                                                // RCFG.model.num_heads)
    return {"actions": out.numpy(), "heads": heads}


def llm_tp(inp):
    mesh = mesh_lib.make_mesh(1, 2)
    cfg = L.qwen2_tiny()
    tree = L.shard_llm_params(mesh, FF.llm(inp["llm"], cfg, device="cpu"))
    tok, ent, _ = L.greedy_generate(cfg, tree, torch.as_tensor(inp["llm_prompt"]),
                                    max_new_tokens=8, eos_id=-1)
    return {"tokens": tok.numpy(), "entropies": ent.numpy(),
            "embed_rows": tree.embed.shape[0]}


def t5_tp(inp):
    mesh = mesh_lib.make_mesh(1, 2)
    cfg = T5.t5_tiny()
    with torch.device("meta"):
        module = T5.T5Encoder(cfg)
    module = FF.load_into(module.to_empty(device="cpu"), FF.t5_encoder(inp["t5"]))
    T5.shard_t5_(module.eval().requires_grad_(False), mesh)
    ids, mask = (torch.as_tensor(inp["t5_ids"][k]) for k in ("ids", "mask"))
    return {"hidden": T5.t5_encode(cfg, module, ids, mask).numpy(),
            "q_rows": module.layers[0].q.weight.shape[0]}


def resume(inp, d):
    """Save at DP2 + ZeRO-3 after two steps and go on two more; then resume
    that checkpoint at DP1 x TP2 for the same two steps."""
    steps = inp["steps"]
    spec = inp["resume"]
    mesh = mesh_lib.make_mesh(2, 1)
    tcfg = TC.TrainConfig(**dict(spec["recipe"], zero3=True))
    out_dir = os.path.join(d, "resume")
    trainer = RL.RDTTrainer(RCFG, tcfg, TC.DataConfig(chunk_size=8, image_size=28), out_dir,
                            vision_cfg=RL.TINY_VIT, device="cpu", mesh=mesh)
    state = _state(inp, tcfg)
    trainer.optimizer = T.make_optimizer(tcfg, state.module)
    _, plan = T.make_sharded_train_step(mesh, RCFG, tcfg)
    state = T.shard_train_state(mesh, state, plan)
    state, first = _steps(mesh, state, tcfg, steps[:2], trainer.optimizer)
    trainer.save_checkpoint(state, 2)
    dist.barrier()
    state, after = _steps(mesh, state, tcfg, steps[2:4], trainer.optimizer)

    mesh_b = mesh_lib.make_mesh(1, 2)
    tcfg_b = TC.TrainConfig(**spec["recipe"])
    trainer_b = RL.RDTTrainer(RCFG, tcfg_b, trainer.dcfg, out_dir, vision_cfg=RL.TINY_VIT,
                              device="cpu", mesh=mesh_b)
    state_b = T.init_train_state(RCFG, tcfg_b, seed=9, device="cpu")
    trainer_b.optimizer = T.make_optimizer(tcfg_b, state_b.module)
    state_b = trainer_b.load_checkpoint(state_b, os.path.join(out_dir, "checkpoint-2"))
    _, plan_b = T.make_sharded_train_step(mesh_b, RCFG, tcfg_b)
    state_b = T.shard_train_state(mesh_b, state_b, plan_b)
    _, resumed = _steps(mesh_b, state_b, tcfg_b, steps[2:4], trainer_b.optimizer)
    return {"first": first, "after": after, "resumed_tp2": resumed, "dir": out_dir}


def cli(inp, d, rank, world):
    """rdt_loop.main on ``world`` ranks (its own process group): the
    sampling eval's inputs and metrics recorded on each rank."""
    launch.shutdown()
    seen = {}
    orig_sample, orig_noise = RL.sample_metrics, R.start_noise

    def sample(rcfg, module, batch, img_tokens, **kw):
        out = orig_sample(rcfg, module, batch, img_tokens, **kw)
        seen.update(batch={k: batch[k].numpy() for k in RL._SAMPLE_KEYS},
                    img_tokens=img_tokens.float().numpy(), metrics=out)
        return out

    def noise(*a, **kw):
        n = orig_noise(*a, **kw)
        seen["noise"] = n.numpy()
        return n

    RL.sample_metrics, R.start_noise = sample, noise
    try:
        state = RL.main(inp["cli_args"] + [
            "--coordinator", f"file://{os.path.join(d, 'cli_store')}",
            "--num_processes", str(world), "--process_id", str(rank), "--device", "cpu"])
    finally:
        RL.sample_metrics, R.start_noise = orig_sample, orig_noise
    seen["step"] = state.step
    seen["initialized_after"] = dist.is_initialized()
    return seen


def main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    launch.initialize(f"file://{os.path.join(d, 'store')}", world, rank, device="cpu")
    out = {"world": dist.get_world_size(), "backend": dist.get_backend()}
    for name in inp["scenarios"]:
        if name in inp["train"]:
            out[name] = train_scenario(inp, inp["train"][name])
        elif name == "serve_tp":
            out[name] = serve_tp(inp)
        elif name == "llm_tp":
            out[name] = llm_tp(inp)
        elif name == "t5_tp":
            out[name] = t5_tp(inp)
        elif name == "resume":
            out[name] = resume(inp, d)
        elif name == "cli":
            out[name] = cli(inp, d, rank, world)
        else:
            raise KeyError(name)
    launch.shutdown()
    torch.save(out, os.path.join(d, f"out{rank}.pt"))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
