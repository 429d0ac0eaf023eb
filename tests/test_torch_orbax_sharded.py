"""PyTorch port, multi-rank orbax checkpoints (CPU, Gloo): ``state.orbax``
as JAX's multi-process trainer writes it, each rank its own shards
(``utils/checkpoint.py::save_pytree_orbax`` / ``AsyncOrbaxSaver`` at
world > 1, ``utils/ocdbt.py::join``), held against the committed
two-process fixture's layout, JAX's spec tables, tensorstore and JAX's
single-process trainer; the asynchronous write's order and its failure on
one rank; JAX's fixture resumed by region; the 8-bit + bf16 recipe's state
round-tripped DP2 -> TP2 -> DP2; world 1 still writing msgpack.

One module fixture starts two ranks of ``tests/torch_parallel_worker.py``
(scenarios ``orbax_save``, ``orbax_fail``, ``orbax_fixture``,
``orbax_topologies``; a file store in ``tmp_path``) at ``rdt_tiny``: the
float32 recipe on a DP2 + ZeRO-3 mesh, and the 8-bit + bf16 recipe.
Comparisons are bit for bit.  The float32 resume at TP2 against the
uninterrupted run's losses, and its chunk reads, are in
``tests/test_torch_parallel.py``.
"""

import base64
import itertools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import tensorstore as ts
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
from jax.sharding import AbstractMesh

from vla_touch_tpu.config import TrainConfig as JTC
from vla_touch_tpu.config import rdt_tiny as j_rdt_tiny
from vla_touch_tpu.models.rdt import runner as JR
from vla_touch_tpu.parallel import mesh as JM
from vla_touch_tpu.train import rdt_loop as JRL
from vla_touch_tpu.train import rdt_train as JT
from vla_touch_tpu_torch import config as TC
from vla_touch_tpu_torch.models.rdt import runner as TR
from vla_touch_tpu_torch.parallel import launch
from vla_touch_tpu_torch.parallel import mesh as TM
from vla_touch_tpu_torch.train import rdt_loop as TRL
from vla_touch_tpu_torch.train import rdt_train as TT
from vla_touch_tpu_torch.utils import checkpoint as PCK
from vla_touch_tpu_torch.utils import from_flax as FF
from vla_touch_tpu_torch.utils import ocdbt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "orbax_2proc")
A, B, LL = 2, 4, 7          # micro-batches, global rows of one, language tokens
RCFG = TR.RDTRunnerConfig(model=TC.rdt_tiny())
JRCFG = JR.RDTRunnerConfig(model=j_rdt_tiny())
F32 = dict(batch_size=B, grad_accum=A, lr_warmup_steps=0, learning_rate=1e-4)
BF16 = dict(F32, use_8bit_adam=True, param_dtype="bfloat16", ema_dtype="bfloat16")


def _inputs(rng):
    """A perturbed rdt_tiny init (so every leaf trains), three global
    batches with their noise and timesteps."""
    mod = TR.init_rdt_train(RCFG, seed=0, device="cpu")
    sd = {n: (p.detach().numpy() + 0.05 * rng.normal(size=p.shape)).astype(np.float32)
          for n, p in mod.named_parameters()}
    m = RCFG.model
    steps = []
    for _ in range(3):
        lens = rng.integers(1, LL + 1, (A, B, 1))
        batch = dict(
            lang_tokens=rng.normal(size=(A, B, LL, m.lang_token_dim)).astype(np.float32),
            lang_mask=np.arange(LL) < lens,
            img_tokens=rng.normal(size=(A, B, m.img_cond_len, m.img_token_dim)).astype(
                np.float32),
            state_tokens=rng.normal(size=(A, B, 1, 128)).astype(np.float32),
            action_gt=rng.normal(size=(A, B, m.horizon, 128)).astype(np.float32),
            action_mask=(rng.random((A, B, 1, 128)) > 0.3).astype(np.float32),
            ctrl_freqs=rng.choice([0.0, 10.0, 25.0], (A, B)).astype(np.float32))
        bits = {n: torch.as_tensor(rng.integers(0, 1 << 16, v.shape)) for n, v in sd.items()}
        draws = {"noise": torch.as_tensor(rng.normal(size=(A, B, m.horizon, 128)).astype(
                     np.float32)),
                 "timesteps": torch.as_tensor(rng.integers(0, 1000, (A, B))),
                 "apply_bits": bits, "ema_bits": dict(bits)}
        steps.append((batch, draws))
    return sd, FF.to_flax(mod, {n: torch.as_tensor(v) for n, v in sd.items()}), steps


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    sd, jparams, steps = _inputs(np.random.default_rng(7))
    d = str(tmp_path_factory.mktemp("orbax_ranks"))
    torch.save(dict(rdt=sd, steps=steps, orbax=dict(recipe=F32, recipe_8bit=BF16),
                    scenarios=["orbax_save", "orbax_fail", "orbax_fixture",
                               "orbax_topologies"]),
               os.path.join(d, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), "2", d], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} rc={p.returncode}\n{log[-6000:]}"
    outs = [torch.load(os.path.join(d, f"out{r}.pt"), weights_only=False) for r in range(2)]
    return dict(out=outs, jparams=jparams, d=d)


def _arrays(db) -> list:
    return sorted(k.decode()[:-len("/.zarray")] for k in db if k.endswith(b"/.zarray"))


def _jax_specs() -> dict:
    """Array name -> JAX's spec of that leaf on the (2, 1) mesh: fsdp for
    the ZeRO-3 parameters, zero_sharding for the shadow and moments."""
    mesh = AbstractMesh((2, 1), ("data", "model"))
    shapes = jax.eval_shape(lambda k: JR.init_rdt(JRCFG, k), jax.random.PRNGKey(0))
    out = {}
    for tree, specs in (("params", JM.fsdp_param_shardings(mesh, shapes)),
                        ("ema", JM.zero_sharding(mesh, shapes)),
                        ("opt_state.1.0.mu", JM.zero_sharding(mesh, shapes)),
                        ("opt_state.1.0.nu", JM.zero_sharding(mesh, shapes))):
        for path, sh in jax.tree_util.tree_flatten_with_path(specs)[0]:
            out[".".join([tree] + [str(k.key) for k in path])] = tuple(sh.spec)
    out["opt_state.1.0.count"] = out["opt_state.1.2.count"] = ()
    return out


def test_layout_is_jax_two_process_layout(ranks):
    """The two ranks' state.orbax has the committed fixture's file set; each
    array's chunk (.zarray, _METADATA's write_shape, both ranks'
    array_metadatas) is its shard under JAX's spec tables for the (2, 1)
    mesh, and _sharding records that spec; each rank's database holds its
    own chunks (rank 1's some), the root refers into both."""
    sync = os.path.join(ranks["out"][0]["orbax_save"]["sync"], "state.orbax")
    fixture = os.path.join(FIXTURE, "checkpoint-1", "state.orbax")
    assert sorted(os.listdir(sync)) == sorted(os.listdir(fixture))
    assert sorted(os.listdir(os.path.join(sync, "array_metadatas"))) == ["process_0",
                                                                       "process_1"]
    specs = _jax_specs()
    meta = PCK.load_json(os.path.join(sync, PCK.ORBAX_METADATA))["tree_metadata"]
    write = {".".join(k["key"] for k in e["key_metadata"]): e["value_metadata"].get(
        "write_shape") for e in meta.values()}
    per_rank = [{a["array_metadata"]["param_name"]: a["array_metadata"] for a in
                 PCK.load_json(os.path.join(sync, "array_metadatas", f"process_{r}"))[
                     "array_metadatas"]} for r in range(2)]
    sharding = {base64.b64decode(k).decode(): json.loads(v) for k, v in
                PCK.load_json(os.path.join(sync, PCK.ORBAX_SHARDING)).items()}
    with ocdbt.Database(sync) as db:
        names = _arrays(db)
        assert names == sorted(specs)
        for name in names:
            z = json.loads(db[f"{name}/.zarray".encode()])
            spec = specs[name]
            shard = [n // 2 if i < len(spec) and spec[i] == "data" else n
                     for i, n in enumerate(z["shape"])]
            assert z["chunks"] == shard and write[name] == shard, name
            for r in range(2):
                assert per_rank[r][name]["chunk_shape"] == shard, (r, name)
            assert sharding[name]["partition_spec"] == list(spec), name
            assert sharding[name]["axis_names"] == ["data", "model"]
        files = {ref[0].split("/")[0] for _, ref in db.entries() if isinstance(ref, tuple)}
        assert files == {"ocdbt.process_0", "ocdbt.process_1"}
    parts = []
    for r in range(2):
        with ocdbt.Database(os.path.join(sync, f"ocdbt.process_{r}")) as db:
            parts.append({k for k in db})
    assert parts[0] and parts[1] and not parts[0] & parts[1]
    assert not [k for k in parts[1] if k.endswith(b"/.zarray")]
    saved = [o["orbax_save"]["saved"]["state.orbax"] for o in ranks["out"]]
    assert saved[0] > 0 and saved[1] > 0


def test_tensorstore_reads_the_gathered_state(ranks):
    """Tensorstore opens every zarr array of the root database (the merge's
    oracle) and gives the state the ranks gathered, bit for bit; the
    port's one-process reader gives it too."""
    o = ranks["out"][0]["orbax_save"]
    want = {k.replace("/", "."): v for k, v in o["gathered"].items()}
    sync = os.path.join(o["sync"], "state.orbax")
    with ocdbt.Database(sync) as db:
        assert _arrays(db) == sorted(want)
    for name, w in want.items():
        got = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt",
                                                     "base": f"file://{sync}/",
                                                     "path": f"{name}/"}}).result()
        a = got.read().result()
        assert a.dtype == w.dtype and a.shape == w.shape, name
        np.testing.assert_array_equal(a, w, err_msg=name)
    port = PCK.load_pytree_orbax(sync)
    for name, w in want.items():
        node = port
        for k in name.split("."):
            node = node[k]
        np.testing.assert_array_equal(node, w, err_msg=name)


def _jax_flat(tree, prefix) -> dict:
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                for k in path]
        out[".".join([prefix] + keys)] = np.asarray(v)
    return out


def test_jax_trainer_loads_the_gathered_state(ranks, tmp_path):
    """JAX's single-process RDTTrainer.load_checkpoint reads the ranks'
    checkpoint: params, EMA shadow and optimizer state equal the gathered
    state bit for bit, step and EMA count too."""
    o = ranks["out"][0]["orbax_save"]
    want = {k.replace("/", "."): v for k, v in o["gathered"].items()}
    jt = JTC(**F32)
    trainer = JRL.RDTTrainer(JRCFG, jt, None, str(tmp_path / "jax"))
    state = JT.init_train_state(JRCFG, jt, None, params=ranks["jparams"])
    state = trainer.load_checkpoint(state, o["sync"])
    assert int(state.step) == 2 and int(state.ema.num_updates) == 2
    got = {**_jax_flat(state.params, "params"), **_jax_flat(state.ema.shadow, "ema"),
           **_jax_flat(state.opt_state, "opt_state")}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_async_save_commits_before_meta_while_steps_go_on(ranks):
    """Under async_save at world 2 the call returns with nothing of the
    checkpoint in place (the ranks' writes held back), a step runs while
    the write is in flight, rank 0 writes meta.json only once state.orbax
    is renamed into place, and the checkpoint is the synchronous one of
    the same state, bit for bit (the step after the call did not reach
    it)."""
    outs = [o["orbax_save"] for o in ranks["out"]]
    for o in outs:
        assert "state.orbax" not in o["in_flight"] and "meta.json" not in o["in_flight"]
        assert np.isfinite(o["during"][0][0])
    assert outs[0]["events"] == [("meta.json", True)] and outs[1]["events"] == []
    assert sorted(os.listdir(outs[0]["async"])) == ["meta.json", "state.orbax"]
    assert PCK.load_json(os.path.join(outs[0]["async"], "meta.json"))["step"] == 2
    a = PCK.load_pytree_orbax(os.path.join(outs[0]["async"], "state.orbax"))
    s = PCK.load_pytree_orbax(os.path.join(outs[0]["sync"], "state.orbax"))

    def same(x, y, path=""):
        if isinstance(y, dict):
            assert sorted(x) == sorted(y), path
            for k in y:
                same(x[k], y[k], f"{path}/{k}")
        elif y is None:
            assert x is None, path
        else:
            assert x.dtype == y.dtype, path
            np.testing.assert_array_equal(x, y, err_msg=path)

    same(a, s)


def test_a_write_failed_on_one_rank_raises_on_both(ranks):
    """An async write made to fail on rank 1 raises RuntimeError on both
    ranks' next wait (rank 0's naming rank 1's error); nothing is left to
    resume from: no checkpoint directory, no temporary one."""
    errors = [o["orbax_fail"]["error"] for o in ranks["out"]]
    for e in errors:
        assert e is not None and e[0] == "RuntimeError", e
        assert "planted" in e[2], e
    assert "rank 1" in errors[0][2]
    for o in ranks["out"]:
        assert not [n for n in o["orbax_fail"]["listing"]
                    if n.startswith("checkpoint") or "tmp" in n], o["orbax_fail"]["listing"]


def _region_of(arr, region):
    for axis, runs in enumerate(region):
        arr = np.concatenate([arr[(slice(None),) * axis + (slice(a, b),)] for a, b in runs],
                             axis) if runs else arr[(slice(None),) * axis + (slice(0, 0),)]
    return arr


def test_fixture_resumes_by_region_at_dp2(ranks):
    """The committed fixture (two JAX processes, a 4 x 2 mesh) resumed by
    the port's two ranks at DP2: each rank reads exactly the chunks its
    regions overlap (counted at the database), fewer than the fixture
    holds, and its slices equal expected.npz's, bit for bit."""
    with np.load(os.path.join(FIXTURE, "expected.npz")) as z:
        expected = {k: z[k] for k in z.files}
    path = os.path.join(FIXTURE, "checkpoint-1", "state.orbax")
    with ocdbt.Database(path) as db:
        total = sum(not k.endswith(b"/.zarray") for k in db)
        chunks = {n: json.loads(db[f"{n}/.zarray".encode()]) for n in _arrays(db)}
    for o in ranks["out"]:
        r = o["orbax_fixture"]
        assert r["step"] == 1
        regions = {k.replace("/", "."): reg for k, (reg, _) in r["shards"].items()}
        want = set()
        for name, z in chunks.items():
            region = regions.get(name, [[(0, n)] for n in z["shape"]])
            axes = [sorted({i for a, b in runs for i in range(a // c, (b - 1) // c + 1)})
                    for runs, c in zip(region, z["chunks"])]
            want |= {f"{name}/{'.'.join(map(str, i)) if i else '0'}"
                     for i in itertools.product(*axes)}
        assert r["keys_read"] == sorted(want)
        assert len(want) < total
        assert r["load_stats"]["chunks_read"] == len(want)
        for key, (region, local) in r["shards"].items():
            w = _region_of(expected[key], region)
            assert local.dtype == w.dtype, key
            np.testing.assert_array_equal(local, w, err_msg=key)


def _bits(x):
    a = np.asarray(x.view(torch.int16).numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.uint16) if a.dtype.name in ("bfloat16", "int16") else a


def _same_flat(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = _bits(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_8bit_bf16_state_round_trips_across_topologies(ranks):
    """The 8-bit + bf16 recipe's DP2 state (moments by whole blocks of the
    JAX layout; a one-block leaf leaves rank 1 an empty region) written as
    state.orbax, resumed at DP1 x TP2, written there (head-aligned pieces:
    three runs a rank, each its own chunk) and resumed at DP2: every
    stage's gathered state equals the first, bit for bit, and both
    checkpoints read whole in one process give it too.  The TP2 write's
    qkv kernel is chunked by a head segment's part."""
    o = ranks["out"][0]["orbax_topologies"]
    saved = o["saved"]
    _same_flat(o["tp2_loaded"], saved)
    _same_flat(o["dp2_loaded"], saved)
    for path in (o["dp2"], o["tp2"]):
        tree = PCK.load_pytree_orbax(os.path.join(path, "state.orbax"))
        flat = {k: v for t in ("params", "ema", "opt_state")
                for k, v in _flat_tree(tree[t], (t,)).items()}
        _same_flat(flat, saved)
    regions = ranks["out"][1]["orbax_topologies"]["dp2_regions"]
    assert regions["opt_state/1/m_q/model/final_ffn/fc1/bias"][0] == ()
    with ocdbt.Database(os.path.join(o["tp2"], "state.orbax")) as db:
        z = json.loads(db[b"params.model.block0.attn.qkv.kernel/.zarray"])
    hidden = RCFG.model.hidden_size
    assert z["shape"] == [hidden, 3 * hidden] and z["chunks"] == [hidden, hidden // 2]


def _flat_tree(tree, prefix) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, prefix + (k,)))
        elif v is not None:
            out["/".join(prefix + (k,))] = v
    return out


def test_jax_trainer_loads_the_8bit_bf16_state(ranks, tmp_path):
    """JAX's single-process trainer, 8-bit AdamW with bf16 parameters and
    EMA, reads the DP2 state.orbax: every leaf of params, EMA and the
    8-bit state (codes, scales, count) equal the gathered state, bit for
    bit."""
    o = ranks["out"][0]["orbax_topologies"]
    want = {k.replace("/", "."): v for k, v in o["saved"].items()}
    jt = JTC(**BF16)
    trainer = JRL.RDTTrainer(JRCFG, jt, None, str(tmp_path / "jax"))
    state = JT.init_train_state(JRCFG, jt, None, params=ranks["jparams"])
    state = trainer.load_checkpoint(state, o["dp2"])
    assert int(state.step) == 2
    got = {**_jax_flat(state.params, "params"), **_jax_flat(state.ema.shadow, "ema"),
           **_jax_flat(state.opt_state, "opt_state")}
    _same_flat(got, want)


def test_world_one_still_writes_msgpack(tmp_path):
    """A process group of one (the sharded ZeRO-3 step on a (1, 1) mesh)
    writes the three msgpack trees and meta.json, as the JAX trainer does
    at one process."""
    launch.initialize(f"file://{tmp_path / 'store'}", 1, 0, device="cpu")
    try:
        mesh = TM.make_mesh(1, 1)
        tcfg = TC.TrainConfig(**dict(F32, zero3=True))
        trainer = TRL.RDTTrainer(RCFG, tcfg, TC.DataConfig(chunk_size=8, image_size=28),
                                 str(tmp_path / "out"), vision_cfg=TRL.TINY_VIT,
                                 device="cpu", mesh=mesh)
        state = TT.init_train_state(RCFG, tcfg, seed=3, device="cpu")
        trainer.optimizer = TT.make_optimizer(tcfg, state.module)
        _, plan = TT.make_sharded_train_step(mesh, RCFG, tcfg)
        state = TT.shard_train_state(mesh, state, plan)
        sizes = trainer.save_checkpoint(state, 1)
    finally:
        launch.shutdown()
    assert sorted(sizes) == ["ema", "opt_state", "params"]
    assert sorted(os.listdir(tmp_path / "out" / "checkpoint-1")) == [
        "ema.msgpack", "meta.json", "opt_state.msgpack", "params.msgpack"]
