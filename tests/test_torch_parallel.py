"""PyTorch port, multi-device training and serving, against the JAX package
(CPU, Gloo): the sharding tables, the sharded RDT step (DP + ZeRO-2,
ZeRO-3, TP and ZeRO-3 + TP; 8-bit and bf16 recipes), TP serving, the
planner's TP decode, T5's TP encode, a checkpoint (state.orbax, every rank
its shards) resumed across topologies by region, and the multi-rank
trainer CLI.

One module fixture starts the ranks once (``tests/torch_parallel_worker.py``:
two processes, and four for the (2, 2) mesh), each meeting the others
through a file store in ``tmp_path`` (no TCP port to race for under
xdist), and computes the JAX and one-process sides while they run.  Each
test asserts its part.  Sizes: ``rdt_tiny`` (batch 2 x 4 rows), the
2-layer ``qwen2_tiny`` and ``t5_tiny``.  JAX's sides run on the 8 virtual
CPU devices of ``tests/conftest.py``.  Tolerances are stated per test.
"""

import itertools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
from jax.sharding import AbstractMesh

from vla_touch_tpu.config import TrainConfig as JTC
from vla_touch_tpu.config import rdt_tiny as j_rdt_tiny
from vla_touch_tpu.models.encoders import t5_native as JT5
from vla_touch_tpu.models.rdt import runner as JR
from vla_touch_tpu.parallel import mesh as JM
from vla_touch_tpu.planning import llm as JL
from vla_touch_tpu.train import rdt_train as JT
from vla_touch_tpu_torch import config as TC
from vla_touch_tpu_torch.data import episode as TE
from vla_touch_tpu_torch.models.encoders import t5_native as TT5
from vla_touch_tpu_torch.models.rdt import runner as TR
from vla_touch_tpu_torch.parallel import mesh as TM
from vla_touch_tpu_torch.planning import llm as TL
from vla_touch_tpu_torch.train import rdt_loop as TRL
from vla_touch_tpu_torch.train import rdt_train as TT
from vla_touch_tpu_torch.utils import from_flax as FF
from vla_touch_tpu_torch.utils import ocdbt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
A, B, LL = 2, 4, 7          # micro-batches, global rows of one, language tokens
RCFG = TR.RDTRunnerConfig(model=TC.rdt_tiny())
JRCFG = JR.RDTRunnerConfig(model=j_rdt_tiny())
LR = 1e-4
F32 = dict(batch_size=B, grad_accum=A, lr_warmup_steps=0, learning_rate=LR)
EIGHT = dict(F32, use_8bit_adam=True)
BF16 = dict(F32, use_8bit_adam=True, param_dtype="bfloat16", ema_dtype="bfloat16")
# name -> (mesh, recipe, steps) of the sharded-step scenarios
TRAIN = {"dp2_zero2": ((2, 1), F32, 2), "dp2_zero3": ((2, 1), dict(F32, zero3=True), 2),
         "tp2": ((1, 2), F32, 2), "dp2_8bit": ((2, 1), EIGHT, 2),
         "dp2_bf16": ((2, 1), BF16, 2)}
TRAIN4 = {"zero3_tp2": ((2, 2), dict(F32, zero3=True), 2),
          "zero3_tp2_8bit": ((2, 2), dict(EIGHT, zero3=True), 2)}
# JAX's multi-host loss tolerance; each parameter leaf within PARAM_TOL of its max |p|
LOSS_RTOL = 2e-5
PARAM_TOL = 1e-5


# ---- the spec tables -----------------------------------------------------------------


def _jax_rdt_tree():
    with torch.device("meta"):
        mod = TR.RDTRunnerModule(RCFG.model)
    shapes = jax.eval_shape(lambda k: JR.init_rdt(JRCFG, k), jax.random.PRNGKey(0))
    return mod, shapes, FF.flax_paths(mod)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _flat_specs(shardings):
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[keys] = tuple(sh.spec)
    return out


@pytest.mark.parametrize("n_data", [2, 4, 8])
@pytest.mark.parametrize("n_model", [1, 2])
def test_rdt_spec_tables_equal_jax(n_data, n_model):
    """rdt_param_shardings, fsdp_param_shardings and zero_sharding (AdamW's
    moments and the 8-bit blocks) give JAX's spec for every leaf, the
    Linear weights' transposed: exact."""
    mesh = AbstractMesh((n_data, n_model), ("data", "model"))
    mod, shapes, paths = _jax_rdt_tree()
    tp = _flat_specs(JM.rdt_param_shardings(mesh, shapes))
    fsdp = _flat_specs(JM.fsdp_param_shardings(mesh, shapes))
    got_tp = TM.rdt_param_shardings((n_data, n_model), mod)
    got_fsdp = TM.fsdp_param_shardings((n_data, n_model), mod)
    sizes = {n: tuple(p.shape) for n, p in mod.named_parameters()}
    transposed = {n for n, (_, t) in paths.items() if t}
    got_mu = TM.zero_sharding((n_data, n_model), sizes, transposed)
    mu = _flat_specs(JM.zero_sharding(mesh, shapes))      # AdamW's moments: params' shapes
    blocks = {n: (-(-int(np.prod(s)) // 256), 256) for n, s in sizes.items()}
    got_q = TM.zero_sharding((n_data, n_model), blocks)
    jq = _flat_specs(JM.zero_sharding(mesh, {n: jax.ShapeDtypeStruct(s, jnp.int8)
                                             for n, s in blocks.items()}))
    assert len(tp) == len(got_tp) == len(paths)
    for name, (path, t) in paths.items():
        assert TM.transpose_spec(got_tp[name], t) == tp[path], name
        assert TM.transpose_spec(got_fsdp[name], t) == fsdp[path], name
        assert TM.transpose_spec(got_mu[name], t) == mu[path], name
        assert got_q[name] == jq[(name,)], name
    if n_model == 2:
        assert got_tp["model.blocks.0.attn.qkv.weight"] == ("model", None)
        assert got_tp["model.blocks.0.ffn.fc2.weight"] == (None, "model")


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_llm_tp_spec_equals_jax(kind):
    """llm_param_specs on the float and the int8 tree: JAX's llm_tp_spec of
    every leaf (the float kernels transposed; quantized leaves but the q/k/v
    biases replicated)."""
    params = JL.init_llm(JL.qwen2_tiny(), jax.random.PRNGKey(0))
    if kind == "int8":
        params = JL.quantize_llm_params(params, "int8")
    want = {}
    for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]:
        keys = tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        want[keys] = tuple(JL.llm_tp_spec(path))
    tree = FF.llm(jax.tree.map(np.asarray, params), TL.qwen2_tiny(), device="cpu")
    got = TL.llm_param_specs(tree)
    assert len(got) == len(want)
    for name, spec in got.items():
        keys = name.split(".")
        linear = keys[-1] == "weight" and not keys[0] == "embed"
        path = tuple(keys[:-1]) + ("kernel" if linear else keys[-1],)
        assert (tuple(reversed(spec)) if linear and spec else spec) == want[path], name


def test_t5_tp_spec_equals_jax():
    """t5_tp_spec: JAX's spec of every leaf, the linears transposed."""
    cfg = JT5.t5_tiny()
    params = jax.tree.map(np.asarray, JT5.init_t5_encoder(cfg, jax.random.PRNGKey(3)))
    want = JT5.t5_tp_spec(params)
    with torch.device("meta"):
        mod = TT5.T5Encoder(TT5.t5_tiny())
    got = TT5.t5_tp_spec(mod)
    assert len(got) == len(jax.tree.leaves(params))
    for name, spec in got.items():
        keys = name.split(".")
        if keys[0] == "layers":
            w = tuple(want["layers"][int(keys[1])][keys[2]])
            assert (tuple(reversed(spec)) if keys[-1] == "weight" else spec) == w, name
        else:
            assert spec == tuple(want[keys[0]]), name


# ---- the ranks -----------------------------------------------------------------------


def _perturbed(rng):
    """The port's seeded rdt_tiny init, every leaf perturbed (so the
    zero-initialised head trains): a state dict and JAX's tree."""
    mod = TR.init_rdt_train(RCFG, seed=0, device="cpu")
    sd = {n: (p.detach().numpy() + 0.05 * rng.normal(size=p.shape)).astype(np.float32)
          for n, p in mod.named_parameters()}
    return sd, FF.to_flax(mod, {n: torch.as_tensor(v) for n, v in sd.items()})


def _batch(m, rng):
    lens = rng.integers(1, LL + 1, (A, B, 1))
    return dict(
        lang_tokens=rng.normal(size=(A, B, LL, m.lang_token_dim)).astype(np.float32),
        lang_mask=np.arange(LL) < lens,
        img_tokens=rng.normal(size=(A, B, m.img_cond_len, m.img_token_dim)).astype(np.float32),
        state_tokens=rng.normal(size=(A, B, 1, 128)).astype(np.float32),
        action_gt=rng.normal(size=(A, B, m.horizon, 128)).astype(np.float32),
        action_mask=(rng.random((A, B, 1, 128)) > 0.3).astype(np.float32),
        ctrl_freqs=rng.choice([0.0, 10.0, 25.0], (A, B)).astype(np.float32))


def _jax_draws(key, m):
    """The noise and timesteps JAX's train_step draws from ``key``."""
    key, _, _ = jax.random.split(key, 3)
    noise, ts = [], []
    for k in jax.random.split(key, A):
        k_noise, k_t = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k_noise, (B, m.horizon, 128), jnp.float32)))
        ts.append(np.asarray(jax.random.randint(k_t, (B,), 0, 1000)))
    return np.stack(noise), np.stack(ts)


def _spawn(world, d):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, WORKER, str(r), str(world), d], cwd=ROOT,
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(world)]


def _collect(procs, d):
    outs = []
    for p in procs:
        log, _ = p.communicate(timeout=600)
        outs.append(log)
    for r, (p, log) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} rc={p.returncode}\n{log[-6000:]}"
    return [torch.load(os.path.join(d, f"out{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def _one_process(inp, recipe, n_steps, steps=None, state=None):
    """The port's one-device train_step on the global batches."""
    tcfg = TC.TrainConfig(**recipe)
    if state is None:
        module = FF.load_into(TR.init_rdt_train(RCFG, device="cpu"), inp["rdt"])
        state = TT.init_train_state(RCFG, tcfg, module=module)
    opt = TT.make_optimizer(tcfg, state.module)
    metrics = []
    for batch, draws in (steps or inp["steps"])[:n_steps]:
        state, m = TT.train_step(RCFG, tcfg, state, {k: torch.as_tensor(v) for k, v in
                                                      batch.items()}, draws=draws,
                                 optimizer=opt)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return state, metrics


def _regrouped(batch, draws):
    """A (A, B) batch and its draws as (2A, B/2): each micro-batch's rows
    halved, in order."""
    def half(x):
        x = torch.as_tensor(x)
        return x.reshape((2 * x.shape[0], x.shape[1] // 2) + tuple(x.shape[2:]))
    d = dict(draws, noise=half(draws["noise"]), timesteps=half(draws["timesteps"]))
    return {k: half(v).numpy() for k, v in batch.items()}, d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    m = j_rdt_tiny()
    sd, jparams = _perturbed(rng)
    steps = []
    for i in range(4):
        noise, ts = _jax_draws(jax.random.PRNGKey(100 + i), m)
        bits = {n: torch.as_tensor(rng.integers(0, 1 << 16, v.shape)) for n, v in sd.items()}
        steps.append((_batch(m, rng), {"noise": torch.as_tensor(noise),
                                       "timesteps": torch.as_tensor(ts),
                                       "apply_bits": bits, "ema_bits": dict(bits)}))
    sv = dict(lang=rng.normal(size=(2, 6, m.lang_token_dim)).astype(np.float32),
              lang_mask=np.arange(6)[None].repeat(2, 0) < np.array([[6], [4]]),
              img=rng.normal(size=(2, m.img_cond_len, m.img_token_dim)).astype(np.float32),
              state=rng.normal(size=(2, 1, 128)).astype(np.float32),
              action_mask=(rng.random((2, 1, 128)) > 0.3).astype(np.float32),
              freqs=np.array([10.0, 25.0], np.float32),
              noise=rng.normal(size=(2, m.horizon, 128)).astype(np.float32))
    lcfg = JL.qwen2_tiny()
    lparams = JL.init_llm(lcfg, jax.random.PRNGKey(0))
    lparams["embed"] = lparams["embed"] * 50.0      # clear maxima for greedy decoding
    lparams = jax.tree.map(np.asarray, lparams)
    prompt = rng.normal(size=(2, 5, lcfg.hidden_size)).astype(np.float32)
    tcfg5 = JT5.t5_tiny()
    t5 = jax.tree.map(np.asarray, JT5.init_t5_encoder(tcfg5, jax.random.PRNGKey(3)))
    ids = rng.integers(0, tcfg5.vocab_size, size=(2, 17)).astype(np.int32)
    mask = np.ones((2, 17), np.int32)
    mask[1, 11:] = 0

    d2, d4 = (str(tmp_path_factory.mktemp(f"ranks{w}")) for w in (2, 4))
    data = os.path.join(d2, "data", "mango_hdf5_gelsight")
    TE.make_synthetic_dataset(data, n_episodes=2, num_steps=48, img_size=40, chunk=8,
                              lang_len=6, lang_dim=32)
    cli_args = ["--model_scale", "tiny", "--data_root", os.path.join(d2, "data"),
                "--output_dir", os.path.join(d2, "cli_out"), "--batch_size", "2",
                "--grad_accum", "2", "--lr_warmup_steps", "0", "--checkpointing_period", "2",
                "--sample_period", "2", "--max_train_steps", "2",
                "--dataloader_num_workers", "1"]
    base = dict(rdt=sd, steps=steps, serve=sv, llm=lparams, llm_prompt=prompt, t5=t5,
                t5_ids=dict(ids=ids, mask=mask), cli_args=cli_args,
                resume=dict(recipe=F32))
    train = {k: dict(mesh=v[0], recipe=v[1], n_steps=v[2]) for k, v in TRAIN.items()}
    torch.save(dict(base, train=train, scenarios=list(TRAIN) + [
        "serve_tp", "llm_tp", "t5_tp", "resume", "cli"]), os.path.join(d2, "inputs.pt"))
    train4 = {k: dict(mesh=v[0], recipe=v[1], n_steps=v[2]) for k, v in TRAIN4.items()}
    torch.save(dict(base, train=train4, scenarios=list(TRAIN4)), os.path.join(d4, "inputs.pt"))
    procs2, procs4 = _spawn(2, d2), _spawn(4, d4)

    # ---- meanwhile: JAX's sides and the port's one-process steps
    jt = JTC(**F32)
    jstate = JT.init_train_state(JRCFG, jt, jax.random.PRNGKey(1), params=jparams)
    jmesh = JM.make_mesh(n_data=2, n_model=1)
    jstep, jsh = JT.make_sharded_train_step(jmesh, JRCFG, jt)
    jstate = JT.shard_train_state(jmesh, jstate, jsh)
    jmetrics = []
    for i, (batch, _) in enumerate(steps[:2]):
        jstate, jm = jstep(jstate, jax.random.PRNGKey(100 + i),
                           {k: jnp.asarray(v) for k, v in batch.items()})
        jmetrics.append((float(jm["loss"]), float(jm["grad_norm"])))
    jax_side = dict(metrics=jmetrics, params=jax.tree.map(np.asarray, jstate.params))
    jax_side["serve"] = np.asarray(JR.rdt_predict_action(
        JRCFG, jparams, jax.random.PRNGKey(1), *[jnp.asarray(sv[k]) for k in (
            "lang", "lang_mask", "img", "state", "action_mask", "freqs")],
        init_noise=jnp.asarray(sv["noise"])))
    jt_, je_, _ = JL.greedy_generate(lcfg, lparams, jnp.asarray(prompt), max_new_tokens=8,
                                     eos_id=-1)
    jax_side["llm"] = (np.asarray(jt_), np.asarray(je_))
    jax_side["t5"] = np.asarray(JT5.t5_encode(tcfg5, t5, jnp.asarray(ids), jnp.asarray(mask)))
    one = {}
    for name, (_, recipe, n) in {**TRAIN, **TRAIN4}.items():
        state, metrics = _one_process(base, recipe, n)
        one[name] = dict(metrics=metrics, state=state)
    # the bf16 recipe's control: one process, each micro-batch's rows in two
    # micro-batches of half (each rank's share of DP2)
    one["bf16_regrouped"] = dict(zip(("state", "metrics"), _one_process(
        base, BF16, 2, steps=[_regrouped(b, d) for b, d in steps[:2]])))
    # the uninterrupted run's steps 3 and 4 from the checkpoint, on one device
    out2, out4 = _collect(procs2, d2), _collect(procs4, d4)
    return dict(inp=base, jax=jax_side, one=one, out=out2, out4=out4, jparams=jparams,
                d2=d2)


def _leaf_close(got: dict, want: dict, tol=PARAM_TOL):
    """Each leaf within ``tol`` of its max |value|: the worst share."""
    worst = 0.0
    for n, w in want.items():
        w = np.asarray(w, np.float64)
        err = np.abs(np.asarray(got[n], np.float64) - w).max() / max(np.abs(w).max(), 1e-30)
        worst = max(worst, err)
        assert err <= tol, (n, err)
    return worst


def test_ranks_ran_over_gloo(runs):
    for outs, world in ((runs["out"], 2), (runs["out4"], 4)):
        assert [(o["world"], o["backend"]) for o in outs] == [(world, "gloo")] * world


def test_dp2_zero2_step_matches_jax_sharded_step(runs):
    """Two ranks, mesh (2, 1), the float32 recipe (ZeRO-2: moments and
    shadow sharded over data) against JAX's make_sharded_train_step on its
    (2, 1) mesh, each rank given its rows of JAX's draws: every step's loss
    on both ranks to 2e-5 relative (JAX's multi-host tolerance), the grad
    norm likewise; after two steps each parameter leaf within 1e-5 of its
    max |p|."""
    outs, jx = runs["out"], runs["jax"]
    for o in outs:
        for (loss, gn), (jl, jg) in zip(o["dp2_zero2"]["metrics"], jx["metrics"]):
            assert abs(loss - jl) <= LOSS_RTOL * abs(jl)
            assert abs(gn - jg) <= LOSS_RTOL * abs(jg)
    paths = FF.flax_paths(TR.init_rdt_train(RCFG, device="cpu"))
    want = {n: (_at(jx["params"], p).T if t else _at(jx["params"], p))
            for n, (p, t) in paths.items()}
    _leaf_close(outs[0]["dp2_zero2"]["state"]["params"], want)
    assert outs[1]["dp2_zero2"]["state"] is None           # only rank 0 keeps the gather


def test_zero2_moments_and_shadow_live_sharded(runs):
    """The shadow holds this rank's half of each leaf with a divisible axis
    (qkv's 384 rows: 192), the parameters stay whole."""
    o = runs["out"][0]["dp2_zero2"]
    assert o["local_shapes"]["model.blocks.0.attn.qkv.weight"] == (384, 128)
    assert o["shadow_shapes"]["model.blocks.0.attn.qkv.weight"] == (192, 128)


@pytest.mark.parametrize("name", ["dp2_zero3", "tp2", "zero3_tp2"])
def test_sharded_step_matches_one_process(runs, name):
    """ZeRO-3 (mesh (2, 1)), TP2 (mesh (1, 2)) and ZeRO-3 + TP (mesh (2, 2),
    four ranks) against the port's one-process train_step (held to JAX in
    tests/test_torch_rdt_train.py) on the same global batches and draws:
    losses and grad norms to 2e-5 relative on every rank, parameters, EMA
    shadow and AdamW moments leaf by leaf within 1e-5 of their max."""
    outs = runs["out4"] if name in TRAIN4 else runs["out"]
    ref = runs["one"][name]
    for o in outs:
        for (loss, gn), (wl, wg) in zip(o[name]["metrics"], ref["metrics"]):
            assert abs(loss - wl) <= LOSS_RTOL * abs(wl)
            assert abs(gn - wg) <= LOSS_RTOL * abs(wg)
    st, got = ref["state"], outs[0][name]["state"]
    _leaf_close(got["params"], {n: p.detach().numpy() for n, p in st.params.items()})
    _leaf_close(got["shadow"], {n: s.numpy() for n, s in st.ema.shadow.items()})
    for k in ("mu", "nu"):
        _leaf_close(got["opt"][k], {n: v.numpy() for n, v in getattr(st.opt_state, k).items()},
                    tol=1e-4)
    local = outs[0][name]["local_shapes"]
    qkv = local["model.blocks.0.attn.qkv.weight"]
    assert qkv == {"dp2_zero3": (192, 128), "tp2": (192, 128), "zero3_tp2": (192, 64)}[name]


@pytest.mark.parametrize("name", ["dp2_8bit", "zero3_tp2_8bit"])
def test_8bit_recipe_matches_one_process(runs, name):
    """8-bit AdamW at DP2, and with ZeRO-3 + TP2 on (2, 2): its moments
    sharded by whole blocks of the full leaf's JAX layout, the block count
    padded to a multiple of 2 (every bias here, 128 values, is 1 block;
    qkv's 384 x 128 is 192), the same blocks on both model ranks.  Against
    one process: losses to 2e-5 relative; the int8 codes equal but for at
    most 0.1 %; every parameter within 2 lr, and all but one value (or
    0.01 %) of each leaf within 1e-5 of its max.  The gradient sums' order can move a
    value across a quantisation boundary, and a coordinate whose sqrt(v)
    code falls to 0 skips its update (measured on (2, 2): 3 values of 600k
    beyond 1e-5, the largest 1.04 lr; at DP2 none)."""
    outs = runs["out4"] if name in TRAIN4 else runs["out"]
    ref, o = runs["one"][name], outs[0][name]
    for (loss, _), (wl, _) in zip(o["metrics"], ref["metrics"]):
        assert abs(loss - wl) <= LOSS_RTOL * abs(wl)
    st = ref["state"]
    for n, p in st.params.items():
        w = p.detach().numpy().astype(np.float64)
        a = o["state"]["params"][n].astype(np.float64)
        assert np.abs(a - w).max() <= 2 * LR, n
        assert (np.abs(a - w) > PARAM_TOL * np.abs(w).max()).sum() <= 1e-4 * w.size + 1, n
    assert o["state"]["opt"]["m_q"]["model.blocks.0.ffn.fc1.bias"].shape == (1, 256)
    off = total = 0
    for k in ("m_q", "v_q"):
        for n, want in getattr(st.opt_state, k).items():
            got = o["state"]["opt"][k][n]
            assert got.shape == tuple(want.shape), n
            off += int((got != want.numpy()).sum())
            total += got.size
    assert off <= 1e-3 * total, off


def test_dp2_bf16_recipe_matches_one_process(runs):
    """The bf16-parameter recipe (bf16 parameters and EMA, 8-bit moments)
    at DP2 with the rounding bits given: each rank rounds its shard with
    its slice of the full leaf's bits.  Losses to 1e-4 relative of the
    one-process step.  A rank's parameter gradients are bf16 over its own
    rows, and 8-bit Adam's update of a near-zero gradient moves by several
    lr on a last-bit change, so the state is held to the one-process step
    on the same rows grouped as the ranks hold them (each micro-batch as
    two of half the rows): every parameter and EMA value within one bf16
    step, at most 0.01 % of them off (measured: 1 value of 43k; against
    the ungrouped step, the grouped one-process step itself is up to 34
    bf16 steps off on small values)."""
    ref, o = runs["one"]["dp2_bf16"], runs["out"][0]["dp2_bf16"]
    for (loss, _), (wl, _) in zip(o["metrics"], ref["metrics"]):
        assert abs(loss - wl) <= 1e-4 * abs(wl)
    st = runs["one"]["bf16_regrouped"]["state"]
    for key, want in (("params", st.params), ("shadow", st.ema.shadow)):
        off = total = 0
        for n, w in want.items():
            w = w.detach().float().numpy().astype(np.float64)
            a = o["state"][key][n].astype(np.float64)
            step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
            assert np.all(np.abs(a - w) <= step), (key, n)
            off, total = off + int((a != w).sum()), total + a.size
        assert off <= 1e-4 * total, (key, off)


def test_tp2_serving_matches_jax(runs):
    """rdt_predict_action over TP2 blocks (each rank 2 of the 4 heads; the
    condition K/V and K1's plain version on them) against JAX's
    single-device chunk with the same init_noise: atol / rtol 2e-5
    (JAX's TP serving test)."""
    for o in runs["out"]:
        assert o["serve_tp"]["heads"] == 2
        np.testing.assert_allclose(o["serve_tp"]["actions"], runs["jax"]["serve"],
                                   atol=2e-5, rtol=2e-5)


def test_planner_tp2_greedy_decode_matches_jax(runs):
    """The 2-layer LLM split over two ranks (vocabulary-split embedding and
    logits) decodes JAX's unsharded greedy tokens; entropies to 1e-4
    relative (atol 1e-5, JAX's TP decode test)."""
    jtok, jent = runs["jax"]["llm"]
    for o in runs["out"]:
        assert o["llm_tp"]["embed_rows"] == TL.qwen2_tiny().vocab_size // 2
        np.testing.assert_array_equal(o["llm_tp"]["tokens"], jtok)
        np.testing.assert_allclose(o["llm_tp"]["entropies"], jent, rtol=1e-4, atol=1e-5)


def test_t5_tp2_encode_matches_jax(runs):
    """t5_tiny over two ranks (2 heads each, the bucket table's columns for
    them) against JAX's t5_encode: float32 to 2e-5 on the valid positions
    (tests/test_torch_encoders.py's tolerance)."""
    want = runs["jax"]["t5"]
    for o in runs["out"]:
        got = o["t5_tp"]["hidden"]
        assert o["t5_tp"]["q_rows"] == TT5.t5_tiny().num_heads // 2 * TT5.t5_tiny().d_kv
        np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=0)
        np.testing.assert_allclose(got[1, :11], want[1, :11], atol=2e-5, rtol=0)


def test_checkpoint_resumes_across_topologies(runs):
    """Saved after two steps at DP2 + ZeRO-3 (state.orbax: each rank its
    own shards, nothing gathered), then resumed at DP1 x TP2 (each rank
    reading its regions) and on one device: the next two losses equal the
    uninterrupted run's to 1e-5 relative; JAX's single-process
    RDTTrainer.load_checkpoint reads the same directory (the parameters bit
    for bit)."""
    from vla_touch_tpu.train import rdt_loop as JRL

    r = runs["out"][0]["resume"]
    want = [loss for loss, _ in r["after"]]
    got_tp = [loss for loss, _ in r["resumed_tp2"]]
    assert runs["out"][1]["resume"]["resumed_tp2"] == r["resumed_tp2"]
    path = os.path.join(r["dir"], "checkpoint-2")
    tcfg = TC.TrainConfig(**F32)
    trainer = TRL.RDTTrainer(RCFG, tcfg, TC.DataConfig(chunk_size=8, image_size=28),
                             os.path.join(runs["d2"], "resume_one"), vision_cfg=TRL.TINY_VIT,
                             device="cpu")
    state = TT.init_train_state(RCFG, tcfg, seed=11, device="cpu")
    trainer.optimizer = TT.make_optimizer(tcfg, state.module)
    state = trainer.load_checkpoint(state, path)
    assert state.step == 2
    saved = {n: p.detach().numpy().copy() for n, p in state.params.items()}
    _, one = _one_process(runs["inp"], F32, 2, steps=runs["inp"]["steps"][2:4], state=state)
    for got in (got_tp, [loss for loss, _ in one]):
        for g, w in zip(got, want):
            assert abs(g - w) <= 1e-5 * abs(w), (got, want)
    jtrainer = JRL.RDTTrainer(JRCFG, JTC(**F32), None, os.path.join(runs["d2"], "jax"))
    jstate = JT.init_train_state(JRCFG, JTC(**F32), None, params=runs["jparams"])
    jstate = jtrainer.load_checkpoint(jstate, path)
    assert int(jstate.step) == 2
    for n, (p, t) in FF.flax_paths(state.module).items():
        w = saved[n]
        np.testing.assert_array_equal(np.asarray(_at(jstate.params, p)), w.T if t else w)


def _overlapped_keys(db, regions: dict) -> set:
    """The chunk keys of every array of ``db`` that ``regions`` (array
    name -> per-axis (start, stop) runs; absent: the whole array)
    overlap, from each array's .zarray."""
    keys = set()
    for k in db:
        if not k.endswith(b"/.zarray"):
            continue
        name = k.decode()[:-len("/.zarray")]
        meta = json.loads(db[k])
        region = regions.get(name, [[(0, n)] for n in meta["shape"]])
        axes = [sorted({i for a, b in runs for i in range(a // c, (b - 1) // c + 1)})
                for runs, c in zip(region, meta["chunks"])]
        keys |= {f"{name}/{'.'.join(map(str, i)) if i else '0'}"
                 for i in itertools.product(*axes)}
    return keys


def test_resume_reads_only_the_chunks_its_regions_overlap(runs):
    """Resuming the DP2 + ZeRO-3 state.orbax at DP1 x TP2, each rank reads
    (counted at the database, value by value) exactly the chunks its
    regions overlap, each once, and fewer than the checkpoint holds; the
    trainer's load_stats agree.  Each rank wrote its own part (bytes > 0)."""
    r0 = runs["out"][0]["resume"]
    path = os.path.join(r0["dir"], "checkpoint-2", "state.orbax")
    with ocdbt.Database(path) as db:
        total = sum(not k.endswith(b"/.zarray") for k in db)
        for o in runs["out"]:
            r = o["resume"]
            want = _overlapped_keys(db, {k.replace("/", "."): v
                                         for k, v in r["regions_tp2"].items()})
            assert r["keys_read"] == sorted(want)
            assert r["load_stats"] == {"chunks_read": len(want),
                                       "chunks_overlapped": len(want)}
            assert len(want) < total, (len(want), total)
            assert r["saved"]["state.orbax"] > 0


def test_cli_trains_on_two_ranks(runs):
    """rdt_loop.main with --coordinator / --num_processes 2 / --process_id
    / --device cpu on each rank: 2 steps, one checkpoint (state.orbax,
    written by both ranks, and meta.json), metrics logged by rank 0 only; the sampling eval's metrics equal on
    both ranks and equal to one process's on the global eval batch (the
    ranks' rows, image tokens and noise concatenated, the checkpoint's
    parameters) to 2e-4 relative (JAX's multi-host tolerance)."""
    a, b = (o["cli"] for o in runs["out"])
    assert a["step"] == b["step"] == 2 and not a["initialized_after"]
    assert a["metrics"] == b["metrics"]
    out = runs["inp"]["cli_args"][runs["inp"]["cli_args"].index("--output_dir") + 1]
    assert sorted(os.listdir(out)) == ["checkpoint-2", "training.jsonl"]
    assert sorted(os.listdir(os.path.join(out, "checkpoint-2"))) == ["meta.json",
                                                                     "state.orbax"]
    with open(os.path.join(out, "training.jsonl")) as f:
        rows = [json.loads(x) for x in f]
    assert [(r["step"], r.get("kind")) for r in rows] == [(0, None), (2, "sample_eval")]
    trainer = TRL.RDTTrainer(RCFG, TC.TrainConfig(batch_size=2, grad_accum=2),
                             TC.DataConfig(chunk_size=8, image_size=28),
                             os.path.join(runs["d2"], "cli_one"), vision_cfg=TRL.TINY_VIT,
                             device="cpu")
    state = TT.init_train_state(RCFG, trainer.tcfg, device="cpu")
    trainer.optimizer = TT.make_optimizer(trainer.tcfg, state.module)
    state = trainer.load_checkpoint(state, os.path.join(out, "checkpoint-2"))
    cat = {k: torch.as_tensor(np.concatenate([a["batch"][k], b["batch"][k]]))
           for k in a["batch"]}
    want = TRL.sample_metrics(RCFG, state.module, cat,
                              torch.as_tensor(np.concatenate([a["img_tokens"],
                                                              b["img_tokens"]])),
                              init_noise=torch.as_tensor(np.concatenate([a["noise"],
                                                                         b["noise"]])))
    for k in ("sample_mse", "sample_l2err"):
        assert abs(a["metrics"][k] - want[k]) <= 2e-4 * abs(want[k]), k
