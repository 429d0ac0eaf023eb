"""PyTorch port, orbax checkpoints, against JAX's orbax and tensorstore
(CPU): the OCDBT database (``utils/ocdbt.py``), zarr v2 arrays
(``utils/zarr2.py``), libzstd through ``ctypes`` (``utils/zstd.py``),
``save_pytree_orbax`` / ``load_pytree_orbax`` / ``AsyncOrbaxSaver``
(``utils/checkpoint.py``), ``RDTTrainer.load_checkpoint`` from
``state.orbax``, the committed two-process fixture
(``tests/fixtures/orbax_2proc``, written by ``tests/make_orbax_fixture.py``),
``compute_minmax_stats`` and ``lstm_step_test.test``.

Data is made from seeds with numpy; JAX's sides run on the 8 virtual CPU
devices of ``tests/conftest.py``.  Every comparison is bit for bit (dtype
included), unless a test says otherwise.
"""

import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import torch_threads  # noqa: F401  (caps torch's threads under xdist)
from vla_touch_tpu.utils import checkpoint as JCK
from vla_touch_tpu_torch import config as TC
from vla_touch_tpu_torch.models.rdt import runner as TR
from vla_touch_tpu_torch.train import rdt_loop as TRL
from vla_touch_tpu_torch.train import rdt_train as TT
from vla_touch_tpu_torch.utils import checkpoint as PCK
from vla_touch_tpu_torch.utils import from_flax as FF
from vla_touch_tpu_torch.utils import ocdbt, zarr2, zstd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "orbax_2proc")


# ---- helpers ---------------------------------------------------------------------


def _np(x):
    """A leaf as numpy; bfloat16 as its bit patterns (uint16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 \
            else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _flat_port(tree, prefix=()):
    """{key path: leaf} of a nested dict tree; empty dicts and None left out."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_port(v, prefix + (k,)))
        elif v is not None:
            out[prefix + (k,)] = v
    return out


def _state_dict(tree):
    """A tree of dicts / lists / tuples in load_pytree's nested form."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return tree


def _spec(x):
    """A zero JAX array of ``x``'s shape and dtype (JAX's restore target)."""
    dtype = jnp.bfloat16 if isinstance(x, torch.Tensor) else _np(x).dtype
    return jnp.zeros(tuple(x.shape), dtype)


def _key(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _flat_jax(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(_key(k) for k in path): v for path, v in leaves}


def _assert_same(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k in want:
        a, b = _np(got[k]), _np(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=str(k))


def _jax_tree(rng):
    """Every dtype the trainers write, a 0-d array, a None, nested lists,
    tuples and dicts, an all-zero array and an array sharded over the
    8-device mesh (eight chunks, each above the inline limit)."""
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("d", "m"))
    sharded = jax.device_put(rng.standard_normal((64, 48)).astype(np.float32),
                             NamedSharding(mesh, P("d", "m")))
    return {
        "f32": sharded,
        "bf16": jnp.asarray(rng.standard_normal((7, 5)), jnp.bfloat16),
        "nested": {"i32": jnp.asarray(rng.integers(-9, 9, (3, 4)), jnp.int32),
                   "list": [jnp.asarray(rng.integers(-128, 127, (6,)), jnp.int8),
                            (jnp.asarray(rng.integers(0, 255, (2, 3)), jnp.uint8),
                             jnp.asarray(rng.random(11) > 0.5)), None],
                   "zeros": jnp.zeros((300,), jnp.float32)},
        "count": jnp.asarray(7, jnp.int32),
        "big": jnp.asarray(rng.standard_normal(5000), jnp.float32),
        "none": None,
    }


def _port_tree(rng):
    return {"f32": rng.standard_normal((33, 17)).astype(np.float32),
            "bf16": torch.from_numpy(rng.standard_normal((9, 4)).astype(np.float32)).to(
                torch.bfloat16),
            "ints": {"i32": rng.integers(-5, 5, (4,)).astype(np.int32),
                     "i8": rng.integers(-128, 127, (5, 2)).astype(np.int8),
                     "u8": rng.integers(0, 255, (3,)).astype(np.uint8),
                     "b": rng.random(10) > 0.5},
            "count": np.asarray(3, np.int32),
            "list": [np.zeros((4, 4), np.float32), None, {}],
            "big": rng.standard_normal((600, 300)).astype(np.float32)}


# ---- (a), (b), (c): trees both ways ---------------------------------------------------


def test_port_reads_jax_orbax_tree(tmp_path):
    """(a) A tree JAX's save_pytree_orbax writes reads back through the port
    to JAX's arrays; None stays None; sequences become "0", "1" keys."""
    tree = _jax_tree(np.random.default_rng(0))
    path = str(tmp_path / "jax.orbax")
    JCK.save_pytree_orbax(path, tree)
    got = PCK.load_pytree_orbax(path)
    assert got["none"] is None and got["nested"]["list"]["2"] is None
    assert isinstance(got["bf16"], torch.Tensor) and got["bf16"].dtype == torch.bfloat16
    _assert_same(_flat_port(got), _flat_jax(tree))
    # the sharded array lies in several out-of-line chunks
    with ocdbt.Database(path) as db:
        keys = [k for k in db if k.startswith(b"f32/") and not k.endswith(b".zarray")]
        assert len(keys) == 8 and all(len(db[k]) > db.max_inline_value_bytes for k in keys)


def test_jax_reads_port_orbax_tree(tmp_path):
    """(b) JAX's load_pytree_orbax reads the port's save_pytree_orbax, and
    tensorstore's kvstore lists the keys the port's reader lists, each with
    the same value."""
    tree = _port_tree(np.random.default_rng(1))
    path = str(tmp_path / "port.orbax")
    nbytes = PCK.save_pytree_orbax(path, tree)
    assert nbytes > 0 and not [n for n in os.listdir(tmp_path) if "tmp" in n]
    got = JCK.load_pytree_orbax(path, jax.tree.map(_spec, tree))
    _assert_same(_flat_jax(got), _flat_jax(tree))
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()
    listed = sorted(kv.list().result())
    with ocdbt.Database(path) as db:
        assert listed == list(db)
        for k in listed:
            assert kv.read(k).result().value == db[k], k


def test_port_round_trip_and_async_saver(tmp_path, monkeypatch):
    """(c) The port's write then read gives the tree back (restricted to a
    target's keys, shapes checked): as one chunk per array, and with arrays
    cut into chunks of two rows (an edge chunk cropped) read by JAX too.  AsyncOrbaxSaver writes a snapshot: the tree
    changed after ``save`` does not reach the file."""
    tree = _port_tree(np.random.default_rng(2))
    PCK.save_pytree_orbax(str(tmp_path / "a"), tree)
    back = PCK.load_pytree_orbax(str(tmp_path / "a"))
    assert back["list"]["1"] is None and back["list"]["2"] == {}
    _assert_same(_flat_port(back), _flat_port(_state_dict(tree)))
    part = PCK.load_pytree_orbax(str(tmp_path / "a"), {"ints": {"u8": np.zeros(3)}})
    assert list(part) == ["ints"] and list(part["ints"]) == ["u8"]
    with pytest.raises(ValueError, match=r"f32: shape \(33, 17\) != \(17, 33\)"):
        PCK.load_pytree_orbax(str(tmp_path / "a"), {"f32": np.zeros((17, 33))})

    monkeypatch.setattr(zarr2, "CHUNK_BYTES", 2 * 17 * 4)
    PCK.save_pytree_orbax(str(tmp_path / "b"), {"f32": tree["f32"]})
    with ocdbt.Database(str(tmp_path / "b")) as db:
        assert sum(k.startswith(b"f32/") for k in db) == 1 + 17   # 33 rows in 2-row chunks
    np.testing.assert_array_equal(PCK.load_pytree_orbax(str(tmp_path / "b"))["f32"],
                                  tree["f32"])
    got = JCK.load_pytree_orbax(str(tmp_path / "b"), {"f32": jnp.zeros((33, 17))})
    np.testing.assert_array_equal(np.asarray(got["f32"]), tree["f32"])

    saver = PCK.AsyncOrbaxSaver()
    live = {"w": torch.arange(12, dtype=torch.float32)}
    saver.save(str(tmp_path / "c"), live)
    live["w"].add_(100.0)
    saver.save(str(tmp_path / "d"), live)
    saver.close()
    np.testing.assert_array_equal(PCK.load_pytree_orbax(str(tmp_path / "c"))["w"],
                                  np.arange(12, dtype=np.float32))
    np.testing.assert_array_equal(PCK.load_pytree_orbax(str(tmp_path / "d"))["w"],
                                  np.arange(12, dtype=np.float32) + 100)


def test_async_saver_reraises_a_failed_write(tmp_path):
    """A write that fails on the saver's thread raises on the next wait."""
    (tmp_path / "file").write_text("")
    saver = PCK.AsyncOrbaxSaver()
    saver.save(str(tmp_path / "file" / "under_a_file"), {"w": np.zeros(3)})
    with pytest.raises(RuntimeError, match="async orbax checkpoint write failed"):
        saver.wait()
    saver.close()


# ---- the database alone -------------------------------------------------------------


def _ts_write(root, mode):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": {"max_decoded_node_bytes": 600}}).result()
    want = {}
    if mode == "generations":      # 40 commits: the manifest refers to version tree nodes
        for i in range(40):
            want[b"k%03d" % i] = b"v%d" % i
            kv.write(b"k%03d" % i, want[b"k%03d" % i]).result()
    elif mode == "interior":       # one commit of 300 keys: interior nodes, prefixes cut
        with ts.Transaction() as txn:
            for i in range(300):
                want[b"key/%05d/abc" % i] = b"val%d" % i * 3
                kv.with_transaction(txn).write(b"key/%05d/abc" % i, want[b"key/%05d/abc" % i]
                                               ).result()
        want[b"key/00150/zz"] = b"q" * 200
        kv.write(b"key/00150/zz", want[b"key/00150/zz"]).result()
    else:                          # values out of line, in several data files
        for i, n in enumerate((10, 2048, 3000)):
            want[b"v/%d" % i] = bytes(range(256)) * (n // 256) + b"x" * (n % 256)
            kv.write(b"v/%d" % i, want[b"v/%d" % i]).result()
    return want


@pytest.mark.parametrize("mode", ["generations", "interior", "out_of_line"])
def test_ocdbt_reader_reads_tensorstore_layouts(tmp_path, mode):
    """Every key as tensorstore wrote it, and the generation tensorstore
    says it committed last (a transaction may commit as more than one
    generation under load, so the number is read, not fixed)."""
    want = _ts_write(str(tmp_path), mode)
    dump = ts.ocdbt.dump(ts.KvStore.open(f"file://{tmp_path}/").result()).result()
    with ocdbt.Database(str(tmp_path)) as db:
        assert dict(db.items()) == want
        assert db.height > 0 or mode != "interior"
        assert db.generation == dump["versions"][-1]["generation_number"]
        assert db.generation >= (41 if mode == "generations" else
                                 3 if mode == "interior" else 4)


@pytest.mark.parametrize("layout", ["one_leaf", "interior_nodes", "several_data_files",
                                    "empty"])
def test_ocdbt_writer_is_read_by_tensorstore(tmp_path, monkeypatch, layout):
    """The port's writer read by tensorstore (and by the port) as written;
    tensorstore then commits a new generation on top, which the port's
    reader reads as the newest."""
    config = {"interior_nodes": dict(MAX_DECODED_NODE_BYTES=600, MAX_INLINE_VALUE_BYTES=100),
              "several_data_files": dict(DATA_FILE_BYTES=3000)}.get(layout, {})
    for name, value in config.items():
        monkeypatch.setattr(ocdbt, name, value)
    rng = np.random.default_rng(3)
    n = 0 if layout == "empty" else 400 if layout == "interior_nodes" else 40
    root = str(tmp_path / "db")
    w = ocdbt.Writer(root)
    want = {}
    for i in rng.permutation(n):
        k = b"p.%d/%d" % (i % 7, i)
        want[k] = rng.bytes(int(rng.integers(0, 2500)))
        w.put(k, want[k])
    assert w.commit() > 0
    n_files = len(os.listdir(os.path.join(root, "d")))
    assert n_files == 0 if layout == "empty" else n_files > 1 if \
        layout == "several_data_files" else n_files == 1
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/"}).result()
    keys = sorted(kv.list().result())
    assert keys == sorted(want)
    for k in keys:
        assert kv.read(k).result().value == want[k]
    with ocdbt.Database(root) as db:
        assert dict(db.items()) == want and db.generation == 1
        assert (db.height > 0) == (layout == "interior_nodes")
    kv.write(b"zz", b"new").result()
    with ocdbt.Database(root) as db:
        assert db[b"zz"] == b"new" and len(db) == n + 1 and db.generation == 2


ZARR_CASES = {
    "f8_F_nan_missing_chunks": dict(dtype="<f8", shape=[5, 7], chunks=[2, 3], order="F",
                                    compressor={"id": "zstd", "level": 3}, fill_value="NaN"),
    "i8_raw_fill": dict(dtype="<i8", shape=[4], chunks=[3], order="C", compressor=None,
                        fill_value=-7),
    "bf16_edges": dict(dtype="bfloat16", shape=[3, 5], chunks=[2, 2], order="C",
                       compressor={"id": "zstd", "level": 1}, fill_value=1.5),
    "b1_F": dict(dtype="|b1", shape=[3, 4], chunks=[2, 4], order="F", compressor=None,
                 fill_value=True),
}


@pytest.mark.parametrize("case", sorted(ZARR_CASES))
def test_zarr_arrays_tensorstore_writes(tmp_path, case):
    """zarr v2 arrays tensorstore writes into OCDBT, beyond orbax's own
    (F order, raw chunks, a fill value, chunks never written, edge chunks):
    the port's reader gives tensorstore's array."""
    kv = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    meta = ZARR_CASES[case]
    t = ts.open({"driver": "zarr", "kvstore": kv, "path": "x", "metadata": meta,
                 "create": True}).result()
    rng = np.random.default_rng(6)
    region = tuple(slice(0, max(1, n - 1)) for n in meta["shape"])   # the last row/col unwritten
    shape = tuple(r.stop for r in region)
    values = rng.normal(size=shape) * 100 if meta["dtype"] != "|b1" else rng.random(shape) > 0.5
    t[region] = values.astype(t.dtype.numpy_dtype)
    want = np.asarray(t.read().result())
    with ocdbt.Database(str(tmp_path)) as db:
        got = zarr2.read_array(db, "x")
    _assert_same({"x": got}, {"x": want})


# ---- (d), (e): the trainer ---------------------------------------------------------------


def _port_trainer(out, **kw):
    tcfg = TC.TrainConfig(**dict(dict(grad_accum=2, batch_size=2, lr_warmup_steps=0,
                                      learning_rate=1e-4), **kw))
    rcfg = TR.RDTRunnerConfig(model=TC.rdt_tiny(hidden_size=32, depth=1))
    trainer = TRL.RDTTrainer(rcfg, tcfg, TC.DataConfig(), out, device="cpu")
    state = TT.init_train_state(rcfg, tcfg, seed=4, device="cpu")
    trainer.optimizer = TT.make_optimizer(tcfg, state.module)
    return trainer, state


def _port_batch(m, rng):
    lead = (2, 2)
    return {k: torch.as_tensor(v) for k, v in dict(
        lang_tokens=rng.normal(size=lead + (6, m.lang_token_dim)).astype(np.float32),
        lang_mask=np.ones(lead + (6,), bool),
        img_tokens=rng.normal(size=lead + (m.img_cond_len, m.img_token_dim)).astype(
            np.float32),
        state_tokens=rng.normal(size=lead + (1, m.state_token_dim)).astype(np.float32),
        action_gt=rng.normal(size=lead + (m.horizon, m.output_dim)).astype(np.float32),
        action_mask=np.ones(lead + (1, m.output_dim), np.float32),
        ctrl_freqs=np.full(lead, 10.0, np.float32)).items()}


def _trees(trainer, state):
    return FF.rdt_train_state_to_flax(state, trainer.optimizer)


def test_trainer_resumes_jax_state_orbax_as_msgpack(tmp_path):
    """(d) A tiny JAX train state, DP8 ZeRO-3 sharded as
    tests/test_sharded_train.py's topology A saves it (every leaf moved off
    its init, the moments non-zero, by one jitted map into the same
    shardings), saved as state.orbax + meta.json and, beside it, as the
    msgpack files: the port's RDTTrainer.load_checkpoint gives the same
    state from both (JAX's parameters), and one step from each gives the
    same loss and state."""
    from functools import partial

    from vla_touch_tpu.config import NoiseSchedulerConfig, TrainConfig, rdt_tiny
    from vla_touch_tpu.models.rdt import runner as JR
    from vla_touch_tpu.parallel import mesh as mesh_lib
    from vla_touch_tpu.train import rdt_train as JT

    jrcfg = JR.RDTRunnerConfig(model=rdt_tiny(hidden_size=32, depth=1),
                               noise=NoiseSchedulerConfig())
    tcfg = TrainConfig(grad_accum=2, lr_warmup_steps=0, learning_rate=1e-4, zero3=True)
    _, sh = JT.make_sharded_train_step(mesh_lib.make_mesh(n_data=8, n_model=1), jrcfg, tcfg)

    def moved(x):
        if not jnp.issubdtype(x.dtype, jnp.floating):
            return x + 3
        return jnp.sin(x * 7.0 + jnp.arange(x.size, dtype=x.dtype).reshape(x.shape)) * 0.5

    init = partial(JT.init_train_state, jrcfg, tcfg)
    state = jax.jit(lambda k: jax.tree.map(moved, init(k)), out_shardings=sh)(
        jax.random.PRNGKey(0))
    assert all(x.sharding.is_equivalent_to(want, x.ndim)
               for x, want in zip(jax.tree.leaves(state), jax.tree.leaves(sh)))
    assert any(not x.sharding.is_fully_replicated for x in jax.tree.leaves(state.params))
    trees = {"params": state.params, "ema": state.ema.shadow, "opt_state": state.opt_state}
    meta = {"step": 3, "ema_num_updates": int(state.ema.num_updates)}
    orbax_dir, mp_dir = tmp_path / "orbax" / "checkpoint-3", tmp_path / "mp" / "checkpoint-3"
    JCK.save_pytree_orbax(str(orbax_dir / "state.orbax"), trees)
    for name, tree in trees.items():
        JCK.save_pytree(str(mp_dir / f"{name}.msgpack"), tree)
    for d in (orbax_dir, mp_dir):
        JCK.save_json(str(d / "meta.json"), meta)

    loaded = []
    for d in (orbax_dir, mp_dir):
        trainer, pstate = _port_trainer(str(tmp_path / "out"))
        pstate = trainer.load_checkpoint(pstate, str(d))
        loaded.append((trainer, pstate))
    (ta, sa), (tb, sb) = loaded
    assert sa.step == sb.step == 3 and int(sa.ema.num_updates) == meta["ema_num_updates"]
    _assert_same(_flat_port(_trees(ta, sa)), _flat_port(_trees(tb, sb)))
    # the loaded parameters are JAX's
    _assert_same(_flat_port(_trees(ta, sa)["params"]),
                 {k: np.asarray(v) for k, v in _flat_jax(state.params).items()})

    pb = _port_batch(TC.rdt_tiny(hidden_size=32, depth=1), np.random.default_rng(9))
    out = []
    for trainer, s in loaded:
        s, metrics = TT.train_step(trainer.rcfg, trainer.tcfg, s, dict(pb),
                                   generator=torch.Generator().manual_seed(5),
                                   optimizer=trainer.optimizer)
        out.append((float(metrics["loss"]), _flat_port(_trees(trainer, s))))
    assert out[0][0] == out[1][0] and np.isfinite(out[0][0])
    _assert_same(out[0][1], out[1][1])


def _expected():
    with np.load(os.path.join(FIXTURE, "expected.npz")) as z:
        return {tuple(k.split("/")): z[k] for k in z.files}


def test_committed_two_process_fixture_reads_to_its_npz():
    """(e) The committed fixture (two JAX processes, 4 x 2 mesh: the root
    database refers into ocdbt.process_0/ and ocdbt.process_1/) reads to
    the npz of JAX's restore, leaf for leaf; optax's empty states are None."""
    path = os.path.join(FIXTURE, "checkpoint-1", "state.orbax")
    got = PCK.load_pytree_orbax(path)
    assert got["opt_state"]["0"] is None and got["opt_state"]["1"]["1"] is None
    _assert_same(_flat_port(got), _expected())
    with ocdbt.Database(path) as db:
        files = {ref[0] for ref in db._index.values() if isinstance(ref, tuple)}
    assert {f.split("/")[0] for f in files} == {"ocdbt.process_0", "ocdbt.process_1"}


def test_trainer_resumes_the_committed_fixture(tmp_path):
    """(e) The fixture's checkpoint directory resumes through the port's
    RDTTrainer.load_checkpoint: its state equals the npz, and one step from
    it is finite."""
    trainer, state = _port_trainer(str(tmp_path / "out"), grad_accum=1)
    state = trainer.load_checkpoint(state, os.path.join(FIXTURE, "checkpoint-1"))
    assert state.step == 1
    trees = _trees(trainer, state)
    got = {(name,) + k: v for name in ("params", "ema", "opt_state")
           for k, v in _flat_port(trees[name]).items()}
    _assert_same(got, _expected())
    batch = {k: v[:1] for k, v in _port_batch(trainer.rcfg.model,
                                               np.random.default_rng(2)).items()}
    _, metrics = TT.train_step(trainer.rcfg, trainer.tcfg, state, batch,
                               generator=torch.Generator().manual_seed(1),
                               optimizer=trainer.optimizer)
    assert np.isfinite(float(metrics["loss"]))


# ---- (f): faults -----------------------------------------------------------------------


@pytest.mark.parametrize("where", ["node", "manifest"])
def test_a_flipped_byte_raises_naming_the_file(tmp_path, where):
    path = str(tmp_path / "state.orbax")
    shutil.copytree(os.path.join(FIXTURE, "checkpoint-1", "state.orbax"), path)
    if where == "node":
        (name,) = os.listdir(os.path.join(path, "d"))
        bad = os.path.join(path, "d", name)
    else:
        bad = os.path.join(path, ocdbt.MANIFEST_NAME)
    data = bytearray(open(bad, "rb").read())
    data[len(data) // 2] ^= 0x10
    open(bad, "wb").write(bytes(data))
    with pytest.raises(ocdbt.FormatError, match=f"{bad}.*CRC-32C mismatch"):
        PCK.load_pytree_orbax(path)


def test_missing_libzstd_raises_naming_it(monkeypatch):
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(zstd, "find_library", lambda: "libzstd-absent.so.9")
    path = os.path.join(FIXTURE, "checkpoint-1", "state.orbax")
    with pytest.raises(OSError, match=f"libzstd.so.1 is needed to read {path}"):
        PCK.load_pytree_orbax(path)


def _without_content_size(frame: bytes) -> bytes:
    """The same zstd frame with its header's content size taken out (a
    window descriptor in its place), as a streaming compressor writes."""
    fhd = frame[4]
    single, fcs_flag, dict_flag = (fhd >> 5) & 1, fhd >> 6, fhd & 3
    assert dict_flag == 0
    head = 5 + (0 if single else 1) + [single, 2, 4, 8][fcs_flag]
    return frame[:4] + bytes([fhd & 0x04, 0x50]) + frame[head:]


def test_zstd_frames_with_and_without_their_size():
    rng = np.random.default_rng(4)
    data = rng.bytes(3000) + bytes(200000)
    frame = bytes(zstd.compress(data))
    assert zstd.decompress(frame) == data
    into = np.empty(len(data), np.uint8)
    zstd.decompress(frame, into=into)
    assert into.tobytes() == data
    bare = _without_content_size(frame)
    assert len(bare) == len(frame) - 3   # the 4-byte size out, a window byte in
    assert zstd.decompress(bare) == data
    with pytest.raises(ValueError, match="not a zstd frame"):
        zstd.decompress(b"\0" * 16)
    with pytest.raises(ValueError, match="holds 203000 bytes, buffer 5"):
        zstd.decompress(frame, into=bytearray(5))
    assert zstd.version_number() >= 10400


# ---- (g): A12's functions ------------------------------------------------------------------


def test_compute_minmax_stats_matches_jax(rng):
    from vla_touch_tpu.utils import normalization as JN
    from vla_touch_tpu_torch.utils import normalization as TN

    ea = rng.normal(size=(5, 8, 7)).astype(np.float32)
    va = rng.normal(size=(40, 7)).astype(np.float64)
    va[:, 3] = 2.0   # a constant dimension: range 0, not floored
    want, got = JN.compute_minmax_stats(ea, va), TN.compute_minmax_stats(ea, va)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["vla_range"][3] == 0.0


def test_lstm_step_test_entry_reaches_main(monkeypatch):
    from vla_touch_tpu_torch.eval import lstm_step_test as L

    seen = []
    monkeypatch.setattr(L, "main", lambda argv=None, device=None: seen.append(argv))
    assert L.test(["--ckpt_path", "c", "--data_dir", "d"]) is None
    assert seen == [["--ckpt_path", "c", "--data_dir", "d"]]


# ---- imports ---------------------------------------------------------------------------------


def test_orbax_modules_import_none_of_jax_orbax_or_tensorstore():
    """In a fresh interpreter, the new modules read the fixture and write a
    tree with none of jax, flax, orbax, tensorstore, zstandard or the JAX
    package in sys.modules."""
    code = (
        "import sys, tempfile, os\n"
        "from vla_touch_tpu_torch.utils import zstd, ocdbt, zarr2, checkpoint, normalization\n"
        "from vla_touch_tpu_torch.train import rdt_loop\n"
        "from vla_touch_tpu_torch.eval import lstm_step_test\n"
        f"t = checkpoint.load_pytree_orbax({os.path.join(FIXTURE, 'checkpoint-1', 'state.orbax')!r})\n"
        "d = tempfile.mkdtemp()\n"
        "checkpoint.save_pytree_orbax(os.path.join(d, 's'), t['params'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'orbax',\n"
        "       'tensorstore', 'zstandard', 'vla_touch_tpu')]\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout, out.stdout
