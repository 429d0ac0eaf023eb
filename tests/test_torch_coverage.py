"""PyTorch port, the last gaps against the JAX package, on the CPU: K1 at
head dims off the kernel's 8-column piece and above 128, K2 at time axes
above 32 steps (the 64-step chunk and past it) and at a width past one SM,
BRIDGeR at horizons 64 and 128, ``sde_sample(record_traj=True)``,
``EpisodeFile.get``, ``build_library(force=True)``,
``record_vla_actions_for_episode(batch_hint=)`` and an orbax directory
whose OCDBT database has a numbered manifest.  The kernels themselves run
only on the card (``tests/test_torch_cuda.py``); here each wrapper computes
its plain version, held against JAX's default path and its Pallas kernel
in interpret mode.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
from torch_controllers_common import BKW, _np_tree, _port_bridge, _sde_noise, _stats, _t

from vla_touch_tpu.config import BridgeControllerConfig as JBC
from vla_touch_tpu.models.controllers import bridge as JB
from vla_touch_tpu_torch import config as TC
from vla_touch_tpu_torch.models.controllers import bridge as TB
from vla_touch_tpu_torch.ops import flash_attention as FA
from vla_touch_tpu_torch.ops import unet_kernels as UK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUMBERED = os.path.join(ROOT, "tests", "fixtures", "orbax_numbered")


# ---- K1 at any head dim ------------------------------------------------------


@pytest.mark.parametrize("D", [12, 20, 160, 200, 256])
def test_k1_at_a_head_dim_off_the_column_piece_matches_jax(D):
    """The port's K1 wrapper (its plain version on the CPU) at D 12 and 20,
    and above 128 (160, 200, 256: the kernel's 128-column pieces of V)
    against JAX's default attention (the einsum) to 1e-5 x max|jax|, and
    against JAX's Pallas kernel in interpret mode (it pads D to 128 lanes,
    rounds p and the output to bf16) to 2e-2 x max|jax|; a ragged mask on
    row 0.  The kernel's own route, the operands padded with zero columns
    to the next multiple of 8 at the true D's scale and cut back to D,
    equals the unpadded attention to float32 rounding."""
    from jax.experimental.pallas import tpu as pltpu

    from vla_touch_tpu.ops import attention as JA
    from vla_touch_tpu.ops import pallas_attention as pa

    rng = np.random.default_rng(D)
    B, Lq, Lkv, H = 2, 19, 150, 3
    q, k, v = (rng.normal(size=(B, L, H, D)).astype(np.float32) for L in (Lq, Lkv, Lkv))
    mask = np.ones((B, Lkv), bool)
    mask[0, 70:] = False
    tq, tk, tv, tmask = _t(q), _t(k), _t(v), torch.from_numpy(mask)
    before = FA.flash_attention.launches
    got = FA.flash_attention(tq, tk, tv, kv_mask=tmask)
    assert FA.flash_attention.launches == before            # CPU: plain, no launch
    want = np.asarray(JA.dot_product_attention(*map(jnp.asarray, (q, k, v)),
                                               kv_mask=jnp.asarray(mask)))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    with pltpu.force_tpu_interpret_mode():
        want_k = np.asarray(pa.flash_cross_attention(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
            kv_mask=jnp.asarray(mask)).astype(jnp.float32))
    got_bf = FA.flash_attention(*(a.to(torch.bfloat16) for a in (tq, tk, tv)), kv_mask=tmask)
    assert np.abs(got_bf.float().numpy() - want_k).max() <= 2e-2 * np.abs(want_k).max()
    padded = FA.pad_head_dim(tq, tk, tv)
    assert all(t.shape[-1] == -(-D // 8) * 8 for t in padded)
    via_pad = FA.attention_plain(*padded, kv_mask=tmask, scale=D ** -0.5)[..., :D]
    assert float((via_pad - got).abs().max()) <= 1e-6 * float(got.abs().max())


# ---- K2 above 32 time steps -------------------------------------------------


def _block_case(seed, S, B, T, Cin, C, G):
    """A flax ConditionalResidualBlock1D's parameters for each of S
    networks, stacked (JAX), and the port's kernel layout of the same."""
    from vla_touch_tpu.models.controllers.unet1d import ConditionalResidualBlock1D as JBlock
    from vla_touch_tpu_torch.models.controllers import unet1d as TU
    from vla_touch_tpu_torch.models.controllers import unet1d_serve as US
    from vla_touch_tpu_torch.utils import from_flax as FF

    r = np.random.default_rng(seed)
    x = r.normal(size=(S, B, T, Cin)).astype(np.float32)
    cond = r.normal(size=(S, B, G)).astype(np.float32)
    block = JBlock(C, kernel_size=5)
    plist = [block.init(jax.random.PRNGKey(seed + s), jnp.asarray(x[s]),
                        jnp.asarray(cond[s]))["params"] for s in range(S)]
    stacked_j = jax.tree.map(lambda *a: jnp.stack(a), *plist)
    leaves = []
    for p in plist:
        tb = TU.ConditionalResidualBlock1D(Cin, C, G, kernel_size=5)
        tb.load_state_dict({k: torch.as_tensor(np.array(v))
                            for k, v in FF.to_state_dict(p).items()})
        leaves.append(US._resblock_leaves(tb))
    stacked_t = {k: torch.stack([leaf[k] for leaf in leaves]).detach() for k in leaves[0]}
    return x, cond, stacked_j, stacked_t


@pytest.mark.parametrize("T,Cin,C", [(48, 10, 32), (64, 16, 32), (64, 64, 64), (96, 10, 32),
                                     (128, 16, 32), (256, 16, 32), (64, 1024, 1024)])
def test_k2_at_long_time_axes_matches_pallas_interpret(T, Cin, C):
    """K2's wrapper (plain on the CPU) at T 48 and 64, past the kernel's
    64-step time chunk (96, 128, 256) and at a block too wide for one SM
    as it is (Cin = C = 1024 at T 64) against JAX's Pallas block in
    interpret mode (bf16 matmul operands: 2e-2, as the JAX package's own
    kernel test) and its float32 reference (1e-5): GroupNorm's statistics
    over the whole (group, T) slab."""
    from vla_touch_tpu.ops.pallas_unet import resblock_fused as j_fused
    from vla_touch_tpu.ops.pallas_unet import resblock_ref as j_ref

    x, cond, pj, pt = _block_case(T + Cin, 2, 1, T, Cin, C, 24)
    before = UK.resblock_fused.launches
    got = UK.resblock_fused(_t(x), _t(cond), pt)
    assert UK.resblock_fused.launches == before and got.shape == (2, 1, T, C)
    want_k = np.asarray(j_fused(jnp.asarray(x), jnp.asarray(cond), pj, interpret=True,
                                out_dtype=jnp.float32))
    np.testing.assert_allclose(got.numpy(), want_k, atol=2e-2, rtol=2e-2)
    want = np.asarray(j_ref(jnp.asarray(x), jnp.asarray(cond), pj))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("Cin,C,k,S,n_ctas,has_res,cap", [
    (1024, 1024, 5, 2, 264, False, 16), (512, 1024, 5, 2, 264, True, 16),
    (1024, 512, 5, 1, 132, True, 16), (2048, 2048, 3, 2, 264, False, 16),
    (256, 512, 5, 2, 264, True, 0)])
def test_k2_plan_keeps_each_split_within_the_staged_width(Cin, C, k, S, n_ctas, has_res, cap):
    """``k2_plan(max_chunks=cap)``: the splits of every product (conv0,
    FiLM, the residual, conv1) cover every mma step once, in ranges that span at most
    ``cap`` 16-channel chunks of input (the kernel's staged A of a block too
    wide for one SM); with no cap the plan is the one it was."""
    plan = UK.k2_plan(Cin, C, 512, k, S, n_ctas, has_res, cap)
    assert plan == UK.k2_plan(Cin, C, 512, k, S, n_ctas, has_res) or cap
    steps = UK.k2_steps(Cin, C, 512, k, has_res)
    for job, taps, rci in (("conv0", k, Cin), ("film", 1, 512), ("res", 1, Cin),
                           ("conv1", k, C)):
        if job not in plan:
            continue
        n, splits = steps[job][0], plan[job]
        ranges = [UK.k2_split_steps(n, splits, z) for z in range(splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(b0 < e0 == b1 for (b0, e0), (b1, _) in zip(ranges, ranges[1:]))
        if cap:
            assert UK.k2_split_chunks(-(-rci // 16), taps, splits) <= cap
            for b, e in ranges:
                assert (e - 1) // taps + 1 - b // taps <= cap


@pytest.mark.parametrize("horizon", [64, 128])
def test_bridge_predict_at_the_64_step_chunk_matches_jax(horizon):
    """BRIDGeR at horizon 64 (its first UNet level four m16 tiles of K2,
    the second two; horizon 48's three are held block by block above) and
    128 (the first level two of K2's 64-step time chunks): the
    port's stacked v/s serving UNet (float32, K2's
    plain version on the CPU) against JAX's ``bridge_predict`` on its
    default path (flax taps), the same ``noise_seq``: atol 1e-4 / rtol
    1e-4."""
    kw = dict(BKW, horizon=horizon)
    jcfg, tcfg = JBC(**kw), TC.BridgeControllerConfig(**kw)
    z = jnp.zeros
    H, D = horizon, 10
    params = jax.jit(JB.BridgeControllerModule(jcfg).init)(
        jax.random.PRNGKey(3), z((1, D)), z((1, H, D)), cam1_feat=z((1, 384)),
        cam2_feat=z((1, 384)), forces=z((1, 3)))["params"]
    from vla_touch_tpu_torch.utils import ema as TE
    from vla_touch_tpu_torch.utils import from_flax as FF

    shadow = {k: _t(v) for k, v in FF.unet_bundle(_np_tree(params["si"])).items()}
    st = TB.BridgeControllerState(cfg=tcfg, module=_port_bridge(params, tcfg),
                                  ema=TE.EmaState(shadow=shadow, num_updates=torch.tensor(0)))
    rng = np.random.default_rng(horizon)
    B = 2
    state = rng.normal(size=(B, D)).astype(np.float32)
    vla = rng.normal(size=(B, H, D)).astype(np.float32)
    f1, f2 = (rng.normal(size=(B, 384)).astype(np.float32) for _ in range(2))
    forces = rng.normal(size=(B, 3)).astype(np.float32)
    stats = _stats()
    key = jax.random.PRNGKey(horizon)
    want = JB.bridge_predict(jcfg, params, params["si"], stats, key, state, vla, f1, f2, forces)
    got = TB.bridge_predict(tcfg, TB.deployable(st), stats, _t(state), _t(vla), _t(f1),
                            _t(f2), _t(forces),
                            noise_seq=_sde_noise(key, jcfg.interpolant.diffusion_steps,
                                                 (B, H, D)))
    assert got.shape == (B, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


# ---- sde_sample's trajectory -------------------------------------------------


@pytest.mark.parametrize("sde_type", ["vs", "bs"])
def test_sde_sample_records_the_trajectory_as_jax(sde_type):
    """``record_traj=True`` returns (x_final, traj), traj (n + 1, ...) from
    x0 to x_final, equal to JAX's scan output with the same ``noise_seq``
    (float32, 1e-6); without it, x_final alone, the same bits."""
    from vla_touch_tpu.config import InterpolantConfig as JIC
    from vla_touch_tpu.models.controllers import interpolants as JI
    from vla_touch_tpu_torch.models.controllers import interpolants as TI

    jcfg, tcfg = JIC(sde_type=sde_type), TC.InterpolantConfig(sde_type=sde_type)
    rng = np.random.default_rng(5)
    x0 = rng.normal(size=(3, 8, 4)).astype(np.float32)
    cond = rng.normal(size=(3, 4)).astype(np.float32)
    n = 6
    noise = rng.normal(size=(n,) + x0.shape).astype(np.float32)
    drift = "v" if sde_type == "vs" else "b"

    def nets(lib):
        tanh = jnp.tanh if lib is jnp else torch.tanh
        return {drift: lambda x, t, c: tanh(x) * 0.5 - c[:, None, :] * t[:, None, None],
                "s": lambda x, t, c: -x * 0.3 + c[:, None, :]}

    jx, jtraj = JI.sde_sample(jcfg, nets(jnp), jnp.asarray(x0), jnp.asarray(cond),
                              jax.random.PRNGKey(0), diffuse_steps=n, record_traj=True,
                              noise_seq=jnp.asarray(noise))
    tx, ttraj = TI.sde_sample(tcfg, nets(torch), _t(x0), _t(cond), diffuse_steps=n,
                              noise_seq=noise, record_traj=True)
    assert ttraj.shape == (n + 1,) + x0.shape
    np.testing.assert_array_equal(ttraj[0].numpy(), x0)
    assert torch.equal(ttraj[-1], tx)
    np.testing.assert_allclose(ttraj.numpy(), np.asarray(jtraj), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6, rtol=1e-6)
    alone = TI.sde_sample(tcfg, nets(torch), _t(x0), _t(cond), diffuse_steps=n,
                          noise_seq=noise)
    assert torch.equal(alone, tx)


# ---- EpisodeFile.get -----------------------------------------------------------


KEYS = ("camera1/camera1", "camera2/camera2", "ee_poses", "gripper_pos",
        "gelsight_force/forces", "gelsight_force/displacement", "instruct_embeddings",
        "vla_action")


@pytest.mark.parametrize("fmt", ["h5", "npz"])
def test_episode_file_get_reads_what_jax_reads(tmp_path, fmt):
    """``EpisodeFile.get`` by h5-style key over an h5 episode (JAX's
    writer) and an npz episode (the port's, the same draws) gives JAX's
    ``get``'s arrays exactly, and a missing key raises KeyError in both."""
    from vla_touch_tpu.data import episode as JEp
    from vla_touch_tpu_torch.data import episode as TEp

    kw = dict(num_steps=12, img_size=16, chunk=4, lang_len=2, lang_dim=8, seed=3,
              resized_size=16)
    path = str(tmp_path / f"ep.{fmt}")
    (JEp if fmt == "h5" else TEp).write_synthetic_episode(path, **kw)
    with JEp.EpisodeFile(path) as jf, TEp.EpisodeFile(path) as tf:
        for key in KEYS:
            np.testing.assert_array_equal(np.asarray(tf.get(key)), np.asarray(jf.get(key)))
            np.testing.assert_array_equal(np.asarray(tf[key]), np.asarray(jf.get(key)))
        for f in (jf, tf):
            with pytest.raises(KeyError):
                f.get("camera9/camera9")


def test_episode_file_get_on_an_epc_cache(tmp_path):
    """``get`` on a raw ``.epc`` cache packed from the npz episode gives the
    npz's cameras, forces and instruction exactly (in the cache's dtype:
    float32 records)."""
    from vla_touch_tpu_torch.data import episode as TEp
    from vla_touch_tpu_torch.runtime import native_loader as TN

    npz = str(tmp_path / "ep.npz")
    TEp.write_synthetic_episode(npz, num_steps=12, img_size=16, chunk=4, lang_len=2,
                                lang_dim=8, seed=4, resized_size=16)
    epc = TN.pack_episode(npz, str(tmp_path / "ep.epc"), codec="raw")
    with TEp.EpisodeFile(npz) as a, TEp.EpisodeFile(epc) as b:
        for key in ("camera1/camera1", "gelsight_force/forces", "instruct_embeddings"):
            got = np.asarray(b.get(key)[:])
            np.testing.assert_array_equal(got, np.asarray(a.get(key)).astype(got.dtype))
        with pytest.raises(KeyError):
            b.get("camera9/camera9")


# ---- build_library(force=True), batch_hint -------------------------------------


def test_build_library_force_rebuilds(tmp_path):
    """A second build returns the existing library untouched; ``force``
    compiles it again into the same path (a new file put in place)."""
    from vla_touch_tpu_torch.runtime import native_loader as TN

    path = TN.build_library(libjpeg=False, build_dir=tmp_path)
    first = os.stat(path)
    assert TN.build_library(libjpeg=False, build_dir=tmp_path) == path
    assert os.stat(path).st_ino == first.st_ino and os.stat(path).st_mtime_ns == first.st_mtime_ns
    assert TN.build_library(force=True, libjpeg=False, build_dir=tmp_path) == path
    again = os.stat(path)
    assert (again.st_ino, again.st_mtime_ns) != (first.st_ino, first.st_mtime_ns)
    lib = TN.load_library(path)
    assert lib.ec_have_libjpeg() == 0


def test_record_vla_actions_takes_batch_hint_and_ignores_it(tmp_path):
    """``batch_hint`` is accepted and unused, as in JAX: the episode
    written with it equals the one written without, array for array."""
    from vla_touch_tpu_torch.data import distill as TD
    from vla_touch_tpu_torch.data import episode as TEp

    src = str(tmp_path / "in.npz")
    TEp.write_synthetic_episode(src, num_steps=6, img_size=16, chunk=4, lang_len=2,
                                lang_dim=8, seed=1, with_vla=False, resized_size=16)

    def step(proprio, images, text):
        return np.full((1, 4, 10), float(np.sum(proprio)), np.float32)

    outs = [TD.record_vla_actions_for_episode(src, str(tmp_path / f"o{h}.npz"), step,
                                              image_size=16, **({"batch_hint": h} if h else {}))
            for h in (0, 8)]
    with np.load(outs[0]) as a, np.load(outs[1]) as b:
        assert sorted(a.files) == sorted(b.files) and "vla_action" in a.files
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])


# ---- orbax over a numbered manifest --------------------------------------------


def _tensorstore_read(root: str, name: str) -> np.ndarray:
    import tensorstore as ts

    arr = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{root}/",
                                                 "path": f"{name}/"}}).result()
    return arr.read().result()


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.uint16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def test_numbered_manifest_fixture_reads_as_tensorstore_reads_it():
    """The committed fixture (tensorstore's OCDBT with ``manifest_kind:
    numbered``, two committed saves of one tree): ``manifest.ocdbt`` holds
    the config alone; the port reads the newest numbered manifest, and
    every leaf of ``load_pytree_orbax`` (a bf16 leaf, a float32 leaf in 4
    chunks, a vector, a scalar) equals tensorstore's read bit for bit, the
    second save's values."""
    from vla_touch_tpu_torch.utils import checkpoint as TCK
    from vla_touch_tpu_torch.utils import ocdbt

    names = sorted(n for n in os.listdir(NUMBERED) if n.startswith("manifest.0"))
    assert len(names) >= 2
    with ocdbt.Database(NUMBERED) as db:
        assert db.manifest_kind == ocdbt.MANIFEST_NUMBERED
        assert db.generation == int(names[-1].split(".")[1], 16)
        assert b"params.w_sharded/3.0" in db             # the leaf spans 4 chunks
    tree = TCK.load_pytree_orbax(NUMBERED)
    leaves = {"params.w_bf16": tree["params"]["w_bf16"],
              "params.w_sharded": tree["params"]["w_sharded"],
              "params.bias": tree["params"]["bias"], "step": tree["step"]}
    assert leaves["params.w_bf16"].dtype == torch.bfloat16
    for name, got in leaves.items():
        want = _tensorstore_read(NUMBERED, name)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert int(np.asarray(leaves["step"])) == 2


def test_numbered_manifest_reader_skips_a_half_written_newest(tmp_path):
    """A newest numbered manifest cut short (a writer caught mid-commit) is
    passed over for the one before it; with every numbered manifest cut,
    the reader names the file."""
    from vla_touch_tpu_torch.utils import ocdbt

    root = str(tmp_path / "db")
    shutil.copytree(NUMBERED, root)
    names = sorted(n for n in os.listdir(root) if n.startswith("manifest.0"))
    with ocdbt.Database(root) as db:
        newest = db.generation
    for i, name in enumerate(reversed(names)):
        path = os.path.join(root, name)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 3)
        if i + 1 < len(names):
            with ocdbt.Database(root) as db:
                assert db.generation == newest - i - 1
    with pytest.raises(ocdbt.FormatError, match="manifest.0"):
        ocdbt.Database(root)


def test_single_and_numbered_kinds_read_alike(tmp_path):
    """A tree the port writes (a single-file manifest, as orbax writes) and
    the same keys copied by tensorstore into a numbered database read to
    the same bytes."""
    import tensorstore as ts

    from vla_touch_tpu_torch.utils import checkpoint as TCK

    tree = {"a": np.arange(300, dtype=np.float32).reshape(20, 15),
            "b": {"c": torch.arange(40, dtype=torch.float32).to(torch.bfloat16)}}
    single = str(tmp_path / "single")
    TCK.save_pytree_orbax(single, tree)
    numbered = tmp_path / "numbered"
    src = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{single}/"}).result()
    dst = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{numbered}/",
                           "config": {"manifest_kind": "numbered"}}).result()
    for key in src.list().result():
        dst.write(key, src.read(key).result().value).result()
    for name in os.listdir(single):
        if name not in ("manifest.ocdbt", "d") and not name.startswith("ocdbt.process"):
            p = os.path.join(single, name)
            (shutil.copytree if os.path.isdir(p) else shutil.copy)(p, numbered / name)
    a, b = TCK.load_pytree_orbax(single), TCK.load_pytree_orbax(str(numbered))
    np.testing.assert_array_equal(a["a"], b["a"])
    assert torch.equal(a["b"]["c"], b["b"]["c"]) and torch.equal(b["b"]["c"], tree["b"]["c"])
