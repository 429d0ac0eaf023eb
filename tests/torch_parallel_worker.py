"""One rank of ``tests/test_torch_parallel.py``'s multi-rank scenarios: the
port over Gloo on the CPU (imports no JAX).

    python tests/torch_parallel_worker.py RANK WORLD DIR

``DIR/inputs.pt`` (written by the test) names the scenarios and holds
their inputs; the ranks meet through a file store in ``DIR`` and each
writes ``DIR/out<RANK>.pt``.
"""

import dataclasses
import os
import sys
import threading

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
from vla_touch_tpu_torch.utils import checkpoint as ckpt
from vla_touch_tpu_torch.utils import ema as ema_lib
from vla_touch_tpu_torch.utils import from_flax as FF
from vla_touch_tpu_torch.utils import ocdbt

RCFG = R.RDTRunnerConfig(model=TC.rdt_tiny())
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _reading(fn):
    """(fn(), the sorted chunk keys it read from OCDBT databases)."""
    keys, get = [], ocdbt.Database.__getitem__

    def counted(db, key):
        if not key.endswith(b"/.zarray"):
            keys.append(key.decode())
        return get(db, key)

    ocdbt.Database.__getitem__ = counted
    try:
        out = fn()
    finally:
        ocdbt.Database.__getitem__ = get
    return out, sorted(keys)


def _flat(tree, prefix=()):
    """{"a/b/c": leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (str(k),)))
        else:
            out["/".join(prefix + (str(k),))] = v
    return out


def _regions(state, opt):
    """{"params/..." etc.: (region, local values)} of this rank's shards."""
    trees = FF.rdt_train_state_shards(state, opt)
    return {k: (v.region, _bits(v.local))
            for k, v in _flat({t: trees[t] for t in ("params", "ema", "opt_state")}).items()
            if isinstance(v, ckpt.Shard)}


def _trainer(out, tcfg, mesh, opt, rcfg=RCFG):
    trainer = RL.RDTTrainer(rcfg, tcfg, TC.DataConfig(chunk_size=8, image_size=28), out,
                            vision_cfg=RL.TINY_VIT, device="cpu", mesh=mesh)
    trainer.optimizer = opt
    return trainer


def _sharded(mesh, tcfg, state):
    _, plan = T.make_sharded_train_step(mesh, RCFG, tcfg)
    return T.shard_train_state(mesh, state, plan)


def resume(inp, d):
    """Save at DP2 + ZeRO-3 after two steps (state.orbax, every rank its
    shards) and go on two more; then resume that checkpoint at DP1 x TP2
    (each rank reading its regions) for the same two steps."""
    steps = inp["steps"]
    spec = inp["resume"]
    mesh = mesh_lib.make_mesh(2, 1)
    tcfg = TC.TrainConfig(**dict(spec["recipe"], zero3=True))
    out_dir = os.path.join(d, "resume")
    state = _state(inp, tcfg)
    trainer = _trainer(out_dir, tcfg, mesh, T.make_optimizer(tcfg, state.module))
    state = _sharded(mesh, tcfg, state)
    state, first = _steps(mesh, state, tcfg, steps[:2], trainer.optimizer)
    saved = trainer.save_checkpoint(state, 2)
    dist.barrier()
    state, after = _steps(mesh, state, tcfg, steps[2:4], trainer.optimizer)

    mesh_b = mesh_lib.make_mesh(1, 2)
    tcfg_b = TC.TrainConfig(**spec["recipe"])
    state_b = T.init_train_state(RCFG, tcfg_b, seed=9, device="cpu")
    trainer_b = _trainer(out_dir, tcfg_b, mesh_b, T.make_optimizer(tcfg_b, state_b.module))
    state_b = _sharded(mesh_b, tcfg_b, state_b)
    state_b, keys = _reading(lambda: trainer_b.load_checkpoint(
        state_b, os.path.join(out_dir, "checkpoint-2")))
    regions = {k: r for k, (r, _) in _regions(state_b, trainer_b.optimizer).items()}
    _, resumed = _steps(mesh_b, state_b, tcfg_b, steps[2:4], trainer_b.optimizer)
    return {"first": first, "after": after, "resumed_tp2": resumed, "dir": out_dir,
            "saved": saved, "keys_read": keys, "load_stats": trainer_b.load_stats,
            "regions_tp2": regions}


def _bits(v):
    """A leaf as numpy; bfloat16 as its bit patterns (uint16)."""
    t = torch.as_tensor(v).detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("uint16").copy()
    return t.numpy().copy()


def _gathered_flax(state, opt):
    """Rank 0: the sharded state gathered, as the checkpoint's flat JAX
    trees of numpy arrays (others: None)."""
    full = T.gather_train_state(state)
    if full is None:
        return None
    g = RL._Gathered(state.module, full["params"], full["opt_state"],
                     ema_lib.EmaState(full["shadow"], state.ema.num_updates), state.step)
    trees = FF.rdt_train_state_to_flax(g, opt)
    return {k: _bits(v)
            for k, v in _flat({t: trees[t] for t in ("params", "ema", "opt_state")}).items()}


def orbax_topologies(inp, d):
    """The 8-bit + bf16 recipe (moments by whole blocks: a one-block leaf
    leaves rank 1 nothing) after two DP2 steps, written as state.orbax;
    resumed at DP1 x TP2 (each rank its regions) and written again from
    there (a fused projection's head-aligned piece: three runs a rank);
    that resumed at DP2.  The gathered state at each stage."""
    recipe = inp["orbax"]["recipe_8bit"]
    mesh, mesh_tp = mesh_lib.make_mesh(2, 1), mesh_lib.make_mesh(1, 2)
    tcfg = TC.TrainConfig(**recipe)
    state = _state(inp, tcfg)
    opt = T.make_optimizer(tcfg, state.module)
    state = _sharded(mesh, tcfg, state)
    state, _ = _steps(mesh, state, tcfg, inp["steps"][:2], opt)
    dp2 = os.path.join(d, "topo_dp2")
    _trainer(dp2, tcfg, mesh, opt).save_checkpoint(state, 2)
    out = {"saved": _gathered_flax(state, opt), "dp2": os.path.join(dp2, "checkpoint-2")}
    dist.barrier()

    tp = T.init_train_state(RCFG, tcfg, seed=9, device="cpu")
    trainer = _trainer(os.path.join(d, "topo_tp2"), tcfg, mesh_tp,
                       T.make_optimizer(tcfg, tp.module))
    tp = _sharded(mesh_tp, tcfg, tp)
    tp = trainer.load_checkpoint(tp, out["dp2"])
    out["tp2_loaded"] = _gathered_flax(tp, trainer.optimizer)
    trainer.save_checkpoint(tp, 2)
    out["tp2"] = os.path.join(d, "topo_tp2", "checkpoint-2")
    dist.barrier()

    back = T.init_train_state(RCFG, tcfg, seed=10, device="cpu")
    trainer = _trainer(os.path.join(d, "topo_back"), tcfg, mesh,
                       T.make_optimizer(tcfg, back.module))
    back = _sharded(mesh, tcfg, back)
    back = trainer.load_checkpoint(back, out["tp2"])
    out["dp2_loaded"] = _gathered_flax(back, trainer.optimizer)
    out["dp2_regions"] = {k: r for k, (r, _) in _regions(back, trainer.optimizer).items()}
    return out


def orbax_save(inp, d):
    """DP2 + ZeRO-3 after two steps: state.orbax written synchronously, then
    the same state with async_save while the next step runs (the ranks'
    writes held back until it has run); the gathered state for the
    oracles."""
    mesh = mesh_lib.make_mesh(2, 1)
    tcfg = TC.TrainConfig(**dict(inp["orbax"]["recipe"], zero3=True))
    state = _state(inp, tcfg)
    opt = T.make_optimizer(tcfg, state.module)
    state = _sharded(mesh, tcfg, state)
    state, _ = _steps(mesh, state, tcfg, inp["steps"][:2], opt)
    sync_dir = os.path.join(d, "orbax_sync")
    saved = _trainer(sync_dir, tcfg, mesh, opt).save_checkpoint(state, 2)
    full = _gathered_flax(state, opt)
    dist.barrier()

    async_dir = os.path.join(d, "orbax_async")
    trainer = _trainer(async_dir, dataclasses.replace(tcfg, async_save=True), mesh, opt)
    ckpt_dir = os.path.join(async_dir, "checkpoint-2")
    gate, events = threading.Event(), []
    write, save_json = ckpt._RankWrite._write_rank, ckpt.save_json

    def held(job):
        gate.wait(120)
        return write(job)

    def meta_json(path, obj):
        events.append((os.path.basename(path), os.path.isdir(os.path.join(ckpt_dir,
                                                                          "state.orbax"))))
        return save_json(path, obj)

    ckpt._RankWrite._write_rank, ckpt.save_json = held, meta_json
    try:
        trainer.save_checkpoint(state, 2)
        in_flight = sorted(os.listdir(ckpt_dir)) if os.path.isdir(ckpt_dir) else []
        state, during = _steps(mesh, state, tcfg, inp["steps"][2:3], opt)
        gate.set()
        trainer._wait_ckpt()
    finally:
        ckpt._RankWrite._write_rank, ckpt.save_json = write, save_json
        gate.set()
    dist.barrier()
    return {"saved": saved, "gathered": full, "in_flight": in_flight, "during": during,
            "events": events, "sync": os.path.join(sync_dir, "checkpoint-2"),
            "async": ckpt_dir}


def orbax_fail(inp, d, rank):
    """An async_save whose write fails on rank 1: every rank's next wait."""
    mesh = mesh_lib.make_mesh(2, 1)
    tcfg = TC.TrainConfig(**dict(inp["orbax"]["recipe"], zero3=True, async_save=True))
    state = _state(inp, tcfg)
    opt = T.make_optimizer(tcfg, state.module)
    state = _sharded(mesh, tcfg, state)
    out = os.path.join(d, "orbax_fail")
    trainer = _trainer(out, tcfg, mesh, opt)
    write = ckpt._RankWrite._write_rank

    def fail(job):
        raise OSError("no space left on device (planted)")

    if rank == 1:
        ckpt._RankWrite._write_rank = fail
    try:
        trainer.save_checkpoint(state, 1)
        error = None
        try:
            trainer._wait_ckpt()
        except RuntimeError as e:
            causes, c = [], e.__cause__
            while c is not None:
                causes.append(repr(c))
                c = c.__cause__
            error = (type(e).__name__, str(e), " <- ".join(causes))
    finally:
        ckpt._RankWrite._write_rank = write
    dist.barrier()
    return {"error": error, "listing": sorted(os.listdir(out))}


def orbax_fixture(inp, d):
    """The committed two-process fixture (JAX's 4 x 2 mesh) resumed at DP2
    (ZeRO-2): the chunks each rank read and its regions' values."""
    rcfg = R.RDTRunnerConfig(model=TC.rdt_tiny(hidden_size=32, depth=1))
    tcfg = TC.TrainConfig(grad_accum=1, lr_warmup_steps=0, learning_rate=1e-3)
    mesh = mesh_lib.make_mesh(2, 1)
    state = T.init_train_state(rcfg, tcfg, seed=4, device="cpu")
    trainer = _trainer(os.path.join(d, "orbax_fixture"), tcfg, mesh,
                       T.make_optimizer(tcfg, state.module), rcfg)
    _, plan = T.make_sharded_train_step(mesh, rcfg, tcfg)
    state = T.shard_train_state(mesh, state, plan)
    path = os.path.join(ROOT, "tests", "fixtures", "orbax_2proc", "checkpoint-1")
    state, keys = _reading(lambda: trainer.load_checkpoint(state, path))
    return {"keys_read": keys, "load_stats": trainer.load_stats, "step": state.step,
            "shards": _regions(state, trainer.optimizer)}


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
        if name in inp.get("train", {}):
            out[name] = train_scenario(inp, inp["train"][name])
        elif name == "serve_tp":
            out[name] = serve_tp(inp)
        elif name == "llm_tp":
            out[name] = llm_tp(inp)
        elif name == "t5_tp":
            out[name] = t5_tp(inp)
        elif name == "resume":
            out[name] = resume(inp, d)
        elif name == "orbax_save":
            out[name] = orbax_save(inp, d)
        elif name == "orbax_fail":
            out[name] = orbax_fail(inp, d, rank)
        elif name == "orbax_fixture":
            out[name] = orbax_fixture(inp, d)
        elif name == "orbax_topologies":
            out[name] = orbax_topologies(inp, d)
        elif name == "cli":
            out[name] = cli(inp, d, rank, world)
        else:
            raise KeyError(name)
    launch.shutdown()
    torch.save(out, os.path.join(d, f"out{rank}.pt"))


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
