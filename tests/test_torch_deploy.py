"""PyTorch port, the deployment entry points against the JAX package on the
same weights, inputs and noise (CPU, float32 unless stated):

- the multi-robot serving pool (``runtime/serving_pool.py``);
- ``EpisodeReplay`` and the replay CLI with its stage timers
  (``runtime/control_loop.py``, ``runtime/replay_cli.py``,
  ``utils/profiling.py``);
- the HF-layout converters and checkpoint files (``utils/torch_port.py``),
  the safetensors reader and writer (``utils/safetensors_io.py``, held to
  the ``safetensors`` package) and the manifest validator
  (``utils/checkpoint_manifest.py``);
- the ROS adapter's gate and action interpolation.

Small widths throughout: ``rdt_tiny`` (float32, 3 solver steps), a one-block
SigLIP at 28^2, DinoV2-small shrunk to one layer, BRIDGeR at down_dims
(16, 32) and horizon 8, the LSTM at hidden 32.  The noise JAX draws from its
keys is passed to the port.  Tolerance atol 1e-5 / rtol 1e-4 unless stated
(float32 in another order of operations).
"""

import argparse
import dataclasses
import filecmp
import json
import os
import re
import struct
import threading
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_touch_tpu.config import BridgeControllerConfig as JBC
from vla_touch_tpu.config import LSTMControllerConfig as JLC
from vla_touch_tpu.config import NoiseSchedulerConfig, rdt_tiny
from vla_touch_tpu.models.controllers import bridge as JB
from vla_touch_tpu.models.controllers import lstm as JL
from vla_touch_tpu.models.encoders import dinov2_runtime as JD
from vla_touch_tpu.models.encoders import vit as JV
from vla_touch_tpu.models.rdt import runner as JR
from vla_touch_tpu.runtime import control_loop as JCL
from vla_touch_tpu.runtime import policy as JP
from vla_touch_tpu.runtime import replay_cli as JRC
from vla_touch_tpu.runtime import serving_pool as JSP
from vla_touch_tpu.utils import ema as JE
from vla_touch_tpu.utils import profiling as JPR
from vla_touch_tpu.utils import torch_port as JTP
from vla_touch_tpu_torch import config as TC
from vla_touch_tpu_torch.models.controllers import bridge as TB
from vla_touch_tpu_torch.models.encoders import clip_text as TCT
from vla_touch_tpu_torch.models.encoders import dinov2_runtime as TD
from vla_touch_tpu_torch.models.encoders import vit as TV
from vla_touch_tpu_torch.models.rdt import runner as TR
from vla_touch_tpu_torch.runtime import control_loop as TCL
from vla_touch_tpu_torch.runtime import policy as TP
from vla_touch_tpu_torch.runtime import replay_cli as TRC
from vla_touch_tpu_torch.runtime import ros_adapter as TROS
from vla_touch_tpu_torch.runtime import serving_pool as TSP
from vla_touch_tpu_torch.utils import checkpoint_manifest as TM
from vla_touch_tpu_torch.utils import from_flax as FF
from vla_touch_tpu_torch.utils import profiling as TPR
from vla_touch_tpu_torch.utils import safetensors_io as ST
from vla_touch_tpu_torch.utils import torch_port as TTP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-4)
VIT_KW = dict(hidden_size=48, num_layers=1, num_heads=4, mlp_dim=96, image_size=28,
              patch_size=14, use_cls_token=False, use_layerscale=False, gelu_tanh=True)
DINO_KW = dict(hidden_size=384, num_layers=1, num_heads=6, mlp_dim=64, image_size=28,
               patch_size=14)
BKW = dict(hidden_dim=32, horizon=8, unet_down_dims=(16, 32))
LKW = dict(hidden_dim=32)
H = 8                                   # rdt_tiny's horizon


def _t(a):
    return torch.as_tensor(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _jnoise(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _step_noise(key_seed, calls):
    """The noise JAX's ``step`` draws on each of ``calls`` calls: the second
    half of each split of the model key."""
    key, out = jax.random.PRNGKey(key_seed), []
    for _ in range(calls):
        key, k = jax.random.split(key)
        out.append(_jnoise(k, (1, H, 128)))
    return out


def _sde_noise(key, n, shape):
    """The Brownian draws of the JAX ``sde_sample`` scan for ``key``."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(_jnoise(sub, shape))
    return np.stack(out)


def _stats(seed=7):
    r = np.random.default_rng(seed)
    return {"vla_mins": r.normal(size=10).astype(np.float32) - 1,
            "vla_maxs": r.normal(size=10).astype(np.float32) + 1,
            "action_mins": r.normal(size=10).astype(np.float32) - 1,
            "action_maxs": r.normal(size=10).astype(np.float32) + 1}


JPolicyConfig, TPolicyConfig = JP.PolicyConfig, TP.PolicyConfig


def _jcfg():
    return JPolicyConfig(
        rdt=JR.RDTRunnerConfig(model=rdt_tiny(),
                               noise=NoiseSchedulerConfig(num_inference_timesteps=3)),
        vision=JV.ViTConfig(**VIT_KW), image_size=28)


def _tcfg():
    return TPolicyConfig(
        rdt=TR.RDTRunnerConfig(model=TC.rdt_tiny(),
                               noise=TC.NoiseSchedulerConfig(num_inference_timesteps=3)),
        vision=TV.ViTConfig(**VIT_KW), image_size=28)


@pytest.fixture(scope="module")
def policy():
    """The JAX tiny policy (a nonzero head, so chunks are not 0) and the
    port's runner and tower on the same weights."""
    jmodel = JP.create_model(_jcfg(), seed=0, cache_frames=False)
    fc2 = jmodel.rdt_params["model"]["final_ffn"]["fc2"]
    fc2["kernel"] = jnp.asarray(np.random.default_rng(1).normal(size=fc2["kernel"].shape)
                                * 0.05, jnp.float32)
    tcfg = _tcfg()
    rdt = FF.load_into(TR.RDTRunnerModule(tcfg.rdt.model),
                       FF.rdt_runner(_np_tree(jmodel.rdt_params))).eval().requires_grad_(False)
    vision = FF.load_into(TV.SiglipVisionEncoder(tcfg.vision),
                          FF.vit(_np_tree(jmodel.vision_params))).eval().requires_grad_(False)
    return jmodel, tcfg, rdt, vision


def _request(rng, L=4):
    return {"proprio": rng.normal(size=(10,)).astype(np.float32),
            "images": rng.integers(0, 255, (6, 28, 28, 3)).astype(np.uint8),
            "image_mask": np.ones((6,), bool),
            "text_embeds": rng.normal(size=(L, 32)).astype(np.float32),
            "text_mask": np.ones((L,), bool)}


def _stack(reqs, bucket, pad_len=None):
    return {k: TSP._pad_rows([r[k] for r in reqs], bucket,
                             pad_len if k.startswith("text") else None)
            for k in reqs[0]}


def _recording_step(tcfg, rdt, vision, calls, noise):
    """A batched port step that records each dispatched batch size and
    starts from fixed noise rows."""
    def step(proprio, images, image_mask, text_embeds, text_mask):
        calls.append(proprio.shape[0])
        return TP.policy_step(tcfg, rdt, vision, *map(_t, (proprio, images, image_mask,
                                                           text_embeds, text_mask)),
                              init_noise=_t(noise[:proprio.shape[0]]))
    return step


# ---- (a) the serving pool ---------------------------------------------------------


def test_pool_rows_match_direct_batched_call_and_jax(rng, policy):
    """3 requests coalesce into one bucket-4 dispatch whose rows equal the
    port's direct ``policy_step`` on the same padded batch and noise bit for
    bit, and JAX's ``policy_step`` on its real rows; the zero pad row
    (every frame and language key masked) is finite.  JAX's default
    attention gives a fully masked row mean(V), the port 0 (ROADMAP C), so
    the pad row is not compared."""
    jmodel, tcfg, rdt, vision = policy
    calls = []
    key = jax.random.PRNGKey(11)
    noise = _jnoise(key, (4, H, 128))
    reqs = [_request(rng) for _ in range(3)]
    with TSP.PolicyServingPool(_recording_step(tcfg, rdt, vision, calls, noise),
                               max_batch=8, max_wait_ms=200, buckets=(1, 2, 4, 8)) as pool:
        futs = [pool.submit(**r) for r in reqs]
        rows = [f.result(timeout=120) for f in futs]
    assert calls == [4]
    batch = _stack(reqs, 4)
    direct = TP.policy_step(tcfg, rdt, vision, *map(_t, batch.values()),
                            init_noise=_t(noise)).numpy()
    assert np.isfinite(direct).all()
    want = np.asarray(JP.policy_step(jmodel.cfg, jmodel.rdt_params, jmodel.vision_params, key,
                                     *batch.values()))
    for i, row in enumerate(rows):
        np.testing.assert_array_equal(row, direct[i])
        np.testing.assert_allclose(row, want[i], **TOL)


def test_pool_pads_ragged_text_lengths(rng, policy):
    _, tcfg, rdt, vision = policy
    calls = []
    noise = _jnoise(jax.random.PRNGKey(12), (2, H, 128))
    r_short, r_long = _request(rng, L=2), _request(rng, L=5)
    with TSP.PolicyServingPool(_recording_step(tcfg, rdt, vision, calls, noise),
                               max_batch=2, max_wait_ms=200, buckets=(1, 2)) as pool:
        f1, f2 = pool.submit(**r_short), pool.submit(**r_long)
        a, b = f1.result(timeout=120), f2.result(timeout=120)
    assert calls == [2]
    # oracle: the short row zero-padded to L = 5, its mask False there
    text = np.zeros((2, 5, 32), np.float32)
    text[0, :2], text[1] = r_short["text_embeds"], r_long["text_embeds"]
    tmask = np.zeros((2, 5), bool)
    tmask[0, :2] = tmask[1] = True
    direct = TP.policy_step(
        tcfg, rdt, vision, _t(np.stack([r_short["proprio"], r_long["proprio"]])),
        _t(np.stack([r_short["images"], r_long["images"]])),
        _t(np.stack([r_short["image_mask"], r_long["image_mask"]])), _t(text), _t(tmask),
        init_noise=_t(noise)).numpy()
    np.testing.assert_array_equal(a, direct[0])
    np.testing.assert_array_equal(b, direct[1])


def test_pool_serves_lone_request_after_timeout(rng, policy):
    _, tcfg, rdt, vision = policy
    calls = []
    noise = _jnoise(jax.random.PRNGKey(13), (1, H, 128))
    with TSP.PolicyServingPool(_recording_step(tcfg, rdt, vision, calls, noise),
                               max_batch=8, max_wait_ms=5, buckets=(1, 2, 4, 8)) as pool:
        chunk = pool.submit(**_request(rng)).result(timeout=120)
    assert calls == [1]
    assert chunk.shape == (H, 10)


def test_pool_concurrent_sessions_deterministic(rng, policy):
    """Robot threads submit at once: every request resolves, and the seeded
    noise stream of ``from_policy`` makes two pools' rows equal bit for
    bit."""
    _, tcfg, rdt, vision = policy
    reqs = [_request(rng) for _ in range(6)]

    def run_once():
        out = [None] * len(reqs)
        # max_batch == len(reqs): both runs dispatch one full batch
        pool = TSP.from_policy(tcfg, rdt, vision, seed=3, max_batch=6, max_wait_ms=2000,
                               buckets=(6,), device="cpu")
        with pool:
            futs = [None] * len(reqs)

            def robot(i):
                futs[i] = pool.submit(**reqs[i])
            threads = [threading.Thread(target=robot, args=(i,)) for i in range(len(reqs))]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            for i, f in enumerate(futs):
                out[i] = f.result(timeout=120)
        return out

    a, b = run_once(), run_once()
    for x, y in zip(a, b):
        assert x.shape == (H, 10) and np.isfinite(x).all()
        np.testing.assert_array_equal(x, y)


def test_pool_routes_every_row_back_to_its_request_under_thread_stress(rng):
    """More robot threads than cores, a switch interval of 1 us: every
    future gets its own request's row (the step echoes each row's proprio)
    and each batch fits a bucket."""
    import sys

    sizes = []

    def step(proprio, *a):
        sizes.append(proprio.shape[0])
        return torch.as_tensor(proprio)[:, None, :].repeat(1, 4, 1)

    req = _request(rng)
    n_threads, per_thread = 24, 5
    out, errors = {}, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with TSP.PolicyServingPool(step, max_batch=8, max_wait_ms=0.5,
                                   buckets=(1, 2, 4, 8)) as pool:
            def robot(r):
                try:
                    for k in range(per_thread):
                        tag = np.full(10, r * per_thread + k, np.float32)
                        out[(r, k)] = pool.submit(**dict(req, proprio=tag)).result(timeout=30)
                except Exception as e:             # noqa: BLE001
                    errors.append(e)
            threads = [threading.Thread(target=robot, args=(r,)) for r in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors and len(out) == n_threads * per_thread
    for (r, k), row in out.items():
        assert row.shape == (4, 10) and (row == r * per_thread + k).all()
    assert set(sizes) <= {1, 2, 4, 8}


def test_pool_fixed_text_pad_keeps_one_shape_per_bucket(rng):
    """With ``text_pad_len`` set, every dispatched batch has the same text
    shape whatever the instruction lengths; a request past it fails."""
    shapes = []

    def step(proprio, images, image_mask, text_embeds, text_mask):
        shapes.append(text_embeds.shape)
        return torch.zeros((proprio.shape[0], 4, 10))

    with TSP.PolicyServingPool(step, max_batch=2, max_wait_ms=5, buckets=(1, 2),
                               text_pad_len=8) as pool:
        pool.submit(**_request(rng, L=2)).result(timeout=30)
        pool.submit(**_request(rng, L=5)).result(timeout=30)
        assert [s[1] for s in shapes] == [8, 8]
        with pytest.raises(ValueError, match="exceeds"):
            pool.submit(**_request(rng, L=9)).result(timeout=30)


def test_pool_close_is_idempotent_and_strands_no_future(rng):
    done = threading.Event()

    def step(proprio, *a):
        done.wait(5)
        return np.zeros((proprio.shape[0], 4, 10), np.float32)

    pool = TSP.PolicyServingPool(step, max_batch=1, max_wait_ms=1, buckets=(1,))
    fut = pool.submit(**_request(rng))
    done.set()
    fut.result(timeout=30)
    pool.close()
    pool.close()                       # a second close is a no-op
    with pytest.raises(RuntimeError):
        pool.submit(**_request(rng))


def test_pool_propagates_errors(rng):
    def bad_step(*a):
        raise RuntimeError("boom")

    with TSP.PolicyServingPool(bad_step, max_batch=2, max_wait_ms=5, buckets=(1, 2)) as pool:
        fut = pool.submit(**_request(rng))
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=30)


def test_pool_rejects_after_close(rng):
    def step(*a):
        raise AssertionError("should not run")

    pool = TSP.PolicyServingPool(step, max_batch=2, max_wait_ms=5, buckets=(1, 2))
    pool.close()
    with pytest.raises(RuntimeError):
        pool.submit(**_request(rng))


def test_from_policy_pads_text_to_the_models_length_and_draws_per_batch(rng, policy):
    """``from_policy`` pads text to ``max_lang_cond_len`` (16 in rdt_tiny),
    rejects a longer pad, and draws one (bucket, horizon, 128) noise per
    dispatched batch from its seeded generator: a lone request's row is the
    direct call on the first draw."""
    _, tcfg, rdt, vision = policy
    with pytest.raises(ValueError, match="max_lang_cond_len"):
        TSP.from_policy(tcfg, rdt, vision, text_pad_len=17, device="cpu")
    req = _request(rng, L=3)
    with TSP.from_policy(tcfg, rdt, vision, seed=5, max_wait_ms=1, device="cpu") as pool:
        row = pool.submit(**req).result(timeout=120)
    noise = torch.randn((1, H, 128), generator=torch.Generator().manual_seed(5))
    batch = _stack([req], 1, pad_len=16)
    assert batch["text_embeds"].shape == (1, 16, 32)
    direct = TP.policy_step(tcfg, rdt, vision, *map(_t, batch.values()), init_noise=noise)
    np.testing.assert_array_equal(row, direct[0].numpy())


# ---- (b) EpisodeReplay ------------------------------------------------------------


def _oracle(replay):
    """A planner that returns the recorded future states: exact tracking."""
    def plan_fn(window):
        idx = np.minimum(np.arange(plan_fn.t + 1, plan_fn.t + 9), replay.T - 1)
        plan_fn.t += 4
        return replay.qpos[idx]
    plan_fn.t = 0
    return plan_fn


@pytest.fixture(scope="module")
def episode(tmp_path_factory):
    """One synthetic episode, as h5 (the JAX writer) and npz (the port's
    writer, the same draws for the same seed), at 28^2 with a 32-wide
    instruction."""
    from vla_touch_tpu.data.episode import write_synthetic_episode as jwrite
    from vla_touch_tpu_torch.data.episode import write_synthetic_episode as twrite

    d = tmp_path_factory.mktemp("episode")
    kw = dict(num_steps=24, img_size=28, chunk=8, lang_dim=32, with_vla=False)
    jwrite(str(d / "ep.h5"), **kw)
    twrite(str(d / "ep.npz"), **kw)
    return str(d / "ep.h5"), str(d / "ep.npz")


def test_episode_replay_matches_jax_and_npz_equals_h5(episode):
    """The oracle planner through the port's scheduler on the h5 episode
    gives JAX's actions and tracking MSE (0), and the npz episode replays
    identically."""
    h5, npz = episode
    cfg = dict(chunk_size=8, replan_interval=4, gripper_deadband=0.0)
    jrep = JCL.EpisodeReplay(h5)
    want = jrep.run(JCL.ChunkScheduler(JCL.ControlLoopConfig(**cfg), _oracle(jrep)), steps=20)
    got = {}
    for path in (h5, npz):
        rep = TCL.EpisodeReplay(path)
        assert rep.T == 24
        np.testing.assert_array_equal(rep.observation(3).images[0], jrep.observation(3).images[0])
        assert rep.observation(3).images[2] is None
        got[path] = rep.run(TCL.ChunkScheduler(TCL.ControlLoopConfig(**cfg), _oracle(rep)),
                            steps=20)
    np.testing.assert_array_equal(got[h5]["actions"], want["actions"])
    assert got[h5]["tracking_mse"] == want["tracking_mse"] < 1e-9
    np.testing.assert_array_equal(got[npz]["actions"], got[h5]["actions"])
    np.testing.assert_array_equal(TCL.EpisodeReplay(npz).instruction(),
                                  TCL.EpisodeReplay(h5).instruction())


# ---- (c) the replay CLI -----------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory, policy):
    """Checkpoints the JAX package writes: the tiny runner in the HF
    safetensors layout, a BRIDGeR and an LSTM controller, each with a
    persisted one-layer DinoV2.  The controllers' and DinoV2's weights are
    seeded on the port's side (a JAX init compiles for longer than the
    whole test) and written by the JAX package's savers."""
    from vla_touch_tpu_torch.models.controllers import lstm as TL

    jmodel = policy[0]
    d = tmp_path_factory.mktemp("ckpt")
    rdt_path = JTP.save_rdt_checkpoint(str(d / "rdt.safetensors"), _np_tree(jmodel.rdt_params))
    with torch.device("meta"):
        dino = TD.DinoV2Encoder(TV.ViTConfig(**DINO_KW))
    dino = FF.to_flax(_seeded(dino))
    bst = TB.init_bridge_controller(TC.BridgeControllerConfig(**BKW), seed=2, device="cpu")
    params = FF.to_flax(bst.module)
    shadow = jax.tree.map(lambda a: a * 0.5 - 0.02, params["si"])
    JB.save_bridge_controller(str(d / "bridge"), JB.BridgeControllerState(
        cfg=JBC(**BKW), params=params, stats=_stats(),
        ema=JE.EmaState(shadow=shadow, num_updates=jnp.asarray(7, jnp.int32))))
    lst = TL.init_lstm_controller(TC.LSTMControllerConfig(**LKW), seed=3, device="cpu")
    JL.save_lstm_controller(str(d / "lstm"), JL.LSTMControllerState(
        cfg=JLC(**LKW), params=FF.to_flax(lst.module), stats=_stats(4)))
    for sub in ("bridge", "lstm"):
        JD.save_params(str(d / sub), "dinov2-small", dino)
    trees = dict(bridge=params, lstm=FF.to_flax(lst.module), dino=dino)
    return rdt_path, str(d / "bridge"), str(d / "lstm"), trees


def _seeded(meta_module, seed=5):
    from vla_touch_tpu_torch.utils.random_init import init_module_

    return init_module_(meta_module.to_empty(device="cpu"), seed)


@pytest.fixture
def tiny_deploy(monkeypatch, policy, checkpoints):
    """Both packages' replay CLIs on the tiny policy config, the same SigLIP
    weights (a checkpoint holds the runner only), DinoV2 shrunk to one
    layer, and the port fed JAX's draws: each ``step`` the next split of
    the JAX model's key (``PRNGKey(0)``), each refine the SDE draws of
    ``PRNGKey(0)``.  JAX's checkpoint loaders take the structure they read
    into from the seeded trees, not from a JAX init."""
    jmodel, tcfg, _, vision = policy
    trees = checkpoints[3]
    monkeypatch.setattr(JB, "init_bridge_controller", lambda cfg, key: JB.BridgeControllerState(
        cfg=cfg, params=trees["bridge"], stats=None,
        ema=JE.EmaState(shadow=trees["bridge"]["si"], num_updates=jnp.asarray(0, jnp.int32))))
    monkeypatch.setattr(JL, "init_lstm_controller", lambda cfg, key: JL.LSTMControllerState(
        cfg=cfg, params=trees["lstm"]))
    monkeypatch.setattr(JD, "init_params", lambda name, key: trees["dino"])
    monkeypatch.setattr(JP, "PolicyConfig", _jcfg)
    monkeypatch.setattr(TP, "PolicyConfig", _tcfg)
    monkeypatch.setitem(JD._CONFIGS, "dinov2-small", JV.ViTConfig(**DINO_KW))
    monkeypatch.setitem(TD._CONFIGS, "dinov2-small", TV.ViTConfig(**DINO_KW))
    jcreate = JP.RoboticDiffusionTransformerModel.create.__func__
    tcreate = TP.RoboticDiffusionTransformerModel.create.__func__
    monkeypatch.setattr(JP.RoboticDiffusionTransformerModel, "create", classmethod(
        lambda cls, cfg, **kw: jcreate(cls, cfg, vision_params=jmodel.vision_params, **kw)))
    monkeypatch.setattr(TP.RoboticDiffusionTransformerModel, "create", classmethod(
        lambda cls, cfg, **kw: tcreate(cls, cfg, vision=vision, **kw)))
    noise = iter(_step_noise(0, 16))
    tstep = TP.RoboticDiffusionTransformerModel.step
    monkeypatch.setattr(TP.RoboticDiffusionTransformerModel, "step",
                        lambda self, *a, **kw: tstep(self, *a, init_noise=_t(next(noise)), **kw))
    sde = _sde_noise(jax.random.PRNGKey(0), JBC().interpolant.diffusion_steps, (1, 8, 10))
    tpredict = TB.bridge_predict

    def predict(*a, generator=None, **kw):
        return tpredict(*a, noise_seq=_t(sde), **kw)
    monkeypatch.setattr(TB, "bridge_predict", predict)


@pytest.mark.parametrize("refiner,extra", [("none", []), ("bridge", ["--warm_skip", "1"]),
                                           ("lstm", [])])
def test_replay_cli_matches_jax(episode, checkpoints, tiny_deploy, refiner, extra):
    """A whole replay (12 steps, a replan every 4) through each refiner,
    the runner and the controllers loaded from the JAX package's files:
    the port's report has JAX's keys and stage counts, and its tracking MSE
    is JAX's (rtol 1e-4)."""
    rdt_path, bridge_dir, lstm_dir, _ = checkpoints
    argv = ["--episode", episode[0], "--rdt_checkpoint", rdt_path, "--refiner", refiner,
            "--bridge_ckpt", bridge_dir, "--lstm_ckpt", lstm_dir, "--replan_interval", "4",
            "--refine_horizon", "8", "--gripper_deadband", "0", "--steps", "12", *extra]
    JPR.reset_stages()
    want = JRC.main(argv)
    got = TRC.main(argv + ["--device", "cpu"])
    assert set(got) == set(want) == {"steps", "tracking_mse", "stages"}
    assert got["steps"] == want["steps"] == 12
    assert {k: v["count"] for k, v in got["stages"].items()} == {
        k: v["count"] for k, v in want["stages"].items()}
    assert set(got["stages"]["vla_plan"]) == {"count", "mean_ms", "p50_ms", "p95_ms"}
    np.testing.assert_allclose(got["tracking_mse"], want["tracking_mse"], rtol=1e-4)


def test_build_scheduler_wiring(episode, tiny_deploy):
    """``--warm_skip`` wires a ``plan_warm_fn``; without a checkpoint the
    runner is random (a warning); the refiner flags wire their functions."""
    replay = TCL.EpisodeReplay(episode[1])
    args = argparse.Namespace(rdt_checkpoint=None, refiner="none", bridge_ckpt=None,
                              lstm_ckpt=None, replan_interval=4, refine_horizon=4,
                              gripper_deadband=0.0, warm_skip=1, device="cpu")
    sched = TRC.build_scheduler(args, replay)
    assert sched.plan_warm_fn is not None and sched.bridge_refine_fn is None
    assert sched.cfg.chunk_size == H and sched.cfg.replan_interval == 4
    result = replay.run(sched, steps=6)
    assert result["actions"].shape == (6, 10) and np.isfinite(result["actions"]).all()
    args.warm_skip = 0
    assert TRC.build_scheduler(args, replay).plan_warm_fn is None


# ---- (d) the HF-layout converters -------------------------------------------------


def _assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert np.array_equal(g[k], w[k]), k


class _Generative(dict):
    """A state dict with every key: each a seeded array whose rank its name
    implies (1-D biases and norm weights, 2-D linears, 3-D convs)."""

    def __contains__(self, k):
        return True

    def __missing__(self, k):
        if k.endswith("bias") or ".block.1." in k:
            shape = (5,)
        elif re.search(r"(cond_encoder|diffusion_step_encoder|weight_[ih]h_l)", k):
            shape = (6, 5)
        else:
            shape = (6, 5, 3)
        self[k] = np.random.default_rng(zlib.crc32(k.encode())).normal(
            size=shape).astype(np.float32)
        return self[k]

    def get(self, k, default=None):
        return self[k]


def _small_from_manifest(name, layers):
    """The manifest's keys of its first ``layers`` layers, each a seeded
    array of the key's rank with every dimension cut to at most 5."""
    man = json.load(open(os.path.join(ROOT, "vla_touch_tpu", "data", "hf_manifests",
                                      f"{name}.json")))
    r = np.random.default_rng(zlib.crc32(name.encode()))
    out = {}
    for k, shape in man.items():
        m = re.search(r"layers?\.(\d+)\.", k)
        if m and int(m.group(1)) >= layers:
            continue
        out[k] = r.normal(size=[min(d, 5) for d in shape]).astype(np.float32)
    return out


@pytest.mark.parametrize("conv,args", [
    ("dinov2_from_hf", ("dinov2_small", dict(num_layers=2))),
    ("siglip_from_hf", ("siglip_so400m", dict(num_layers=2))),
    ("clip_vision_from_hf", ("clip_vit_b16_vision", dict(num_layers=2))),
])
def test_vit_converters_equal_jax_bit_for_bit(conv, args):
    name, kw = args
    sd = _small_from_manifest(name, kw["num_layers"])
    _assert_trees_equal(getattr(TTP, conv)(sd, **kw), getattr(JTP, conv)(sd, **kw))


def test_unet_lstm_mlp_converters_equal_jax_bit_for_bit():
    _assert_trees_equal(TTP.unet1d(_Generative(), num_levels=3),
                        JTP.unet1d(_Generative(), num_levels=3))
    _assert_trees_equal(TTP.unet1d(_Generative(), num_levels=2, use_timestep=False),
                        JTP.unet1d(_Generative(), num_levels=2, use_timestep=False))
    _assert_trees_equal(TTP.lstm(_Generative(), 2, prefix="lstm."),
                        JTP.lstm(_Generative(), 2, prefix="lstm."))
    _assert_trees_equal(TTP.mlp(_Generative(), "ffn."), JTP.mlp(_Generative(), "ffn."))
    ct = _Generative()
    assert np.array_equal(TTP.conv_transpose1d(ct["w"])["kernel"],
                          JTP.conv_transpose1d(ct["w"])["kernel"])


def test_rdt_converters_equal_jax_and_round_trip(policy, tmp_path):
    """``rdt_runner`` on the HF state dict of the tiny runner equals JAX's
    bit for bit and gives the tree back; ``rdt_runner_to_torch`` equals
    JAX's.  The port's checkpoint file, read by JAX's loader (the
    ``safetensors`` package) and by the port's, gives the tree back, and
    ``load_rdt_runner`` the module's weights."""
    jmodel, tcfg, rdt, _ = policy
    tree = _np_tree(jmodel.rdt_params)
    sd = JTP.rdt_runner_to_torch(tree)
    tsd = TTP.rdt_runner_to_torch(tree)
    assert sd.keys() == tsd.keys()
    for k in sd:
        assert np.array_equal(sd[k], tsd[k]), k
    _assert_trees_equal(TTP.rdt_runner(sd, depth=2), JTP.rdt_runner(sd, depth=2))
    _assert_trees_equal(TTP.rdt_runner(sd, depth=2), tree)
    path = TTP.save_rdt_checkpoint(str(tmp_path / "rdt.safetensors"), rdt)
    _assert_trees_equal(JTP.load_rdt_checkpoint(path, depth=2), tree)
    _assert_trees_equal(TTP.load_rdt_checkpoint(path, depth=2), tree)
    loaded = TTP.load_rdt_runner(path, tcfg.rdt, device="cpu")
    for (n, a), (m, b) in zip(loaded.state_dict().items(), rdt.state_dict().items()):
        assert n == m and torch.equal(a, b), n
    # a torch pickle, and a bf16 file read back exactly widened
    torch.save({k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in sd.items()},
               str(tmp_path / "rdt.bin"))
    _assert_trees_equal(TTP.load_rdt_checkpoint(str(tmp_path / "rdt.bin"), depth=2), tree)
    bf = {k: torch.as_tensor(np.ascontiguousarray(v)).to(torch.bfloat16) for k, v in sd.items()}
    ST.save_file(bf, str(tmp_path / "rdt_bf16.safetensors"))
    got = TTP.read_state_dict(str(tmp_path / "rdt_bf16.safetensors"))
    for k in bf:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], bf[k].float().numpy()), k


# ---- (e) safetensors files --------------------------------------------------------


def _all_dtypes():
    g = torch.Generator().manual_seed(0)
    return {"f32": torch.randn(3, 5, generator=g), "bf16": torch.randn(7, generator=g).bfloat16(),
            "f16": torch.randn(2, 2, generator=g).half(), "f64": torch.tensor(3.5, dtype=torch.float64),
            "bool": torch.tensor([True, False, True]), "u8": torch.arange(5, dtype=torch.uint8),
            "i8": torch.randint(-100, 100, (9,), generator=g, dtype=torch.int8),
            "i16": torch.arange(-3, 4, dtype=torch.int16), "i32": torch.arange(4, dtype=torch.int32),
            "i64": torch.arange(5, dtype=torch.int64), "empty": torch.zeros(0, 3)}


def test_safetensors_reads_the_packages_files_bit_for_bit(tmp_path):
    """A file the ``safetensors`` package writes (every dtype, metadata, a
    header it pads with spaces) reads back bit for bit, from the map and
    as copies onto a device, and its header reads without data."""
    from safetensors.torch import save_file

    tensors = _all_dtypes()
    path = str(tmp_path / "pkg.safetensors")
    save_file(tensors, path, metadata={"format": "pt", "note": "x"})
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
    assert n % 8 == 0
    for device in (None, "cpu"):
        got = ST.load_file(path, device=device)
        assert got.keys() == tensors.keys()
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
            assert torch.equal(got[k], t), k
    head = ST.read_header(path)
    assert head["__metadata__"] == {"format": "pt", "note": "x"}
    assert head["bf16"]["dtype"] == "BF16" and head["f32"]["shape"] == [3, 5]


def test_safetensors_writes_files_the_package_reads(tmp_path):
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file as torch_load
    from safetensors import safe_open

    tensors = _all_dtypes()
    path = str(tmp_path / "port.safetensors")
    size = ST.save_file(tensors, path, metadata={"k": "v"})
    assert size == os.path.getsize(path)
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        blob = f.read(n)
    assert n % 8 == 0 and blob.decode().rstrip(" ").endswith("}")
    for e in json.loads(blob).values():       # each tensor aligned to its item size
        if "dtype" in e:
            assert (8 + n + e["data_offsets"][0]) % ST.DTYPES[e["dtype"]][0].itemsize == 0
    got = torch_load(path)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"k": "v"}
    arrays = {k: t.numpy() for k, t in tensors.items() if k != "bf16"}
    ST.save_file(arrays, str(tmp_path / "np.safetensors"))
    back = np_load(str(tmp_path / "np.safetensors"))
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype and back[k].shape == a.shape
        assert np.array_equal(back[k], a), k


def _raw_file(path, header: dict, data: bytes, pad=True):
    blob = json.dumps(header).encode()
    if pad:
        blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob + data)
    return path


@pytest.mark.parametrize("case,match", [
    ("overlap", "overlaps"), ("gap", "gap"), ("past_end", "run past"),
    ("unknown_dtype", "unknown dtype"), ("wrong_size", "needs"),
    ("header_past_end", "header length"), ("not_json", "not JSON"),
])
def test_safetensors_rejects_a_bad_header(tmp_path, case, match):
    a = {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}
    b = {"dtype": "F32", "shape": [2], "data_offsets": [8, 16]}
    header, data = {"a": a, "b": b}, bytes(16)
    if case == "overlap":
        b["data_offsets"] = [4, 12]
        data = bytes(12)
    elif case == "gap":
        b["data_offsets"] = [12, 20]
        data = bytes(20)
    elif case == "past_end":
        data = bytes(12)
    elif case == "unknown_dtype":
        b["dtype"] = "F7"
    elif case == "wrong_size":
        b["shape"] = [3]
    path = _raw_file(str(tmp_path / "bad.safetensors"), header, data)
    if case == "header_past_end":
        with open(path, "r+b") as f:
            f.write(struct.pack("<Q", 10 ** 6))
    elif case == "not_json":
        with open(path, "r+b") as f:
            f.seek(8)
            f.write(b"[[[")
    with pytest.raises(ValueError, match=match):
        ST.load_file(path)
    with pytest.raises(ValueError, match=match):
        ST.read_header(path)


def test_safetensors_reads_an_unpadded_header(tmp_path):
    a = np.arange(3, dtype=np.float32)
    path = _raw_file(str(tmp_path / "np.safetensors"),
                     {"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 12]}},
                     a.tobytes(), pad=False)
    assert np.array_equal(ST.load_file(path)["a"].numpy(), a)


# ---- (f) manifests ----------------------------------------------------------------


class Recorder:
    """Manifest-backed state dict of zero-byte arrays of each key's shape
    (a dtype of no fields: nothing is allocated at full size), recording
    every key read."""

    def __init__(self, manifest):
        self.manifest = manifest
        self.counts: dict = {}

    def __contains__(self, k):
        return k in self.manifest

    def __getitem__(self, k):
        self.counts[k] = self.counts.get(k, 0) + 1
        return np.zeros(self.manifest[k], np.dtype([]))

    def get(self, k, default=None):
        return self[k] if k in self.manifest else default

    def assert_consumed(self, exceptions=()):
        missed = set(self.manifest) - set(self.counts) - set(exceptions)
        assert not missed, f"unconsumed checkpoint keys: {sorted(missed)[:8]}"
        multi = {k: c for k, c in self.counts.items() if c > 1}
        assert not multi, f"keys consumed more than once: {multi}"


def _meta_shapes(factory):
    with torch.device("meta"):
        m = factory()
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


@pytest.mark.parametrize("name", ["rdt_1b", "siglip_so400m", "dinov2_small",
                                  "clip_vit_b16_vision", "clip_vit_b16_text"])
def test_manifest_keys_load_into_the_ports_modules(name):
    """Each converter consumes every key of its manifest once (the
    documented exceptions apart) and its tree lands on the port module's
    parameters, names and shapes, built on the meta device."""
    from vla_touch_tpu_torch.planning.encoder import CLIPVisionPooled

    sd = Recorder(TM.load_manifest(name))
    if name == "rdt_1b":
        tree, want = TTP.rdt_runner(sd, depth=28), _meta_shapes(
            lambda: TR.RDTRunnerModule(TC.rdt_1b()))
        sd.assert_consumed()
        # and the writer's inverse gives the manifest's key space back
        assert {k: v.shape for k, v in TTP.rdt_runner_to_torch(tree).items()} == sd.manifest
    elif name == "siglip_so400m":
        tree, want = TTP.siglip_from_hf(sd, num_layers=27), _meta_shapes(
            lambda: TV.SiglipVisionEncoder(TV.SIGLIP_SO400M))
        head = [k for k in sd.manifest if k.startswith("vision_model.head.")]
        assert len(head) == 11
        sd.assert_consumed(exceptions=head)
    elif name == "dinov2_small":
        tree, want = TTP.dinov2_from_hf(sd, num_layers=12), _meta_shapes(
            lambda: TV.DinoV2Encoder(TV.DINOV2_SMALL))
        sd.assert_consumed(exceptions=TM.OPTIONAL["dinov2_small"])
    elif name == "clip_vit_b16_vision":
        tree, want = TTP.clip_vision_from_hf(sd, num_layers=12), _meta_shapes(
            lambda: CLIPVisionPooled(TV.CLIP_VIT_B16))
        sd.assert_consumed()
    else:
        # the text tower at full width (CLIP_TEXT_B16), shapes only
        tree, want = TCT.clip_text_from_hf(sd, num_layers=12), _meta_shapes(
            lambda: TCT.CLIPTextTower(TCT.CLIP_TEXT_B16))
        sd.assert_consumed()
    got = {k: v.shape for k, v in FF.to_state_dict(tree, lists=("block",)).items()}
    assert got == want


def test_manifest_copies_equal_the_jax_files_and_the_rest_raise():
    for name in TM.KNOWN:
        assert filecmp.cmp(os.path.join(TM.MANIFEST_DIR, f"{name}.json"),
                           os.path.join(ROOT, "vla_touch_tpu", "data", "hf_manifests",
                                        f"{name}.json"), shallow=False), name
    assert set(TM.PENDING) == {"t5_v1_1_xxl"}
    for name, item in TM.PENDING.items():
        assert os.path.exists(os.path.join(ROOT, "vla_touch_tpu", "data", "hf_manifests",
                                           f"{name}.json"))
        with pytest.raises(NotImplementedError, match=re.escape(item.split()[0])):
            TM.load_manifest(name)
    with pytest.raises(FileNotFoundError):
        TM.load_manifest("no_such_model")


def test_validator_diffs_and_reads_headers_as_jax_does(policy, tmp_path, capsys):
    """``diff_keys`` finds missing, extra, sibling and mis-shaped keys as
    JAX's; ``read_checkpoint_shapes`` reads a file's header (and a
    directory of shards) as JAX's does; the CLI exits 1 on a mismatch."""
    from vla_touch_tpu.utils import checkpoint_manifest as JM

    man = TM.load_manifest("siglip_so400m")
    actual = dict(man)
    first = sorted(actual)[0]
    del actual[first]
    second = sorted(actual)[0]
    actual[second] = (1,)
    actual["text_model.x"] = (2,)
    actual["stray"] = (3,)
    got, want = TM.diff_keys(actual, "siglip_so400m"), JM.diff_keys(actual, "siglip_so400m")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert not got.ok and got.sibling == ["text_model.x"] and got.extra == ["stray"]
    assert TM.diff_keys(dict(man), "siglip_so400m").ok
    sd = JTP.rdt_runner_to_torch(_np_tree(policy[0].rdt_params))
    path = str(tmp_path / "m.safetensors")
    ST.save_file(sd, path)
    half = sorted(sd)[: len(sd) // 2]
    os.makedirs(tmp_path / "shards")
    ST.save_file({k: sd[k] for k in half}, str(tmp_path / "shards" / "a.safetensors"))
    ST.save_file({k: sd[k] for k in sd if k not in half},
                 str(tmp_path / "shards" / "b.safetensors"))
    for p in (path, str(tmp_path / "shards")):
        assert TM.read_checkpoint_shapes(p) == JM.read_checkpoint_shapes(p)
    assert not TM.validate_checkpoint(path, "rdt_1b").ok
    assert TM.main(["rdt_1b", path]) == 1
    assert "MISMATCH" in capsys.readouterr().out
    assert TM.main(["--list"]) == 0


# ---- (g) stage timers and the ROS adapter -----------------------------------------


def test_stage_stats_match_jax_on_the_same_spans():
    spans = np.random.default_rng(3).uniform(1e-4, 2e-2, size=(2, 9))
    TPR.reset_stages()
    JPR.reset_stages()
    for name, vals in zip(("a", "b"), spans):
        for v in vals:
            TPR.record(name, float(v))
            JPR.record(name, float(v))
    assert TPR.stage_stats() == JPR.stage_stats()
    with TPR.stage("c", block_on=[torch.zeros(2)]):
        pass
    stats = TPR.stage_stats(reset=True)
    assert stats["c"]["count"] == 1 and set(stats["c"]) == {"count", "mean_ms", "p50_ms",
                                                            "p95_ms"}
    assert TPR.stage_stats() == {}
    JPR.reset_stages()


def test_trace_writes_a_chrome_trace(tmp_path):
    with TPR.trace(str(tmp_path / "tr")):
        torch.ones(4) @ torch.ones(4)
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_ros_adapter_is_gated_and_interpolates_as_jax():
    from vla_touch_tpu.runtime import ros_adapter as JROS

    with pytest.raises(RuntimeError, match="rospy"):
        TROS.RosOperator()
    assert TROS.RosTopics() == TROS.RosTopics(**dataclasses.asdict(JROS.RosTopics()))
    r = np.random.default_rng(4)
    prev, target = r.normal(size=14), r.normal(size=14) * 3
    step = np.abs(r.normal(size=14)) * 0.5
    np.testing.assert_array_equal(TROS.interpolate_action(prev, target, step),
                                  JROS.interpolate_action(prev, target, step))


# ---- (h) imports and devices ------------------------------------------------------


def test_deploy_modules_import_no_jax_h5py_or_safetensors():
    """The new modules import neither JAX, the JAX package, ``safetensors``
    nor (at import) ``h5py``."""
    files = ["runtime/serving_pool.py", "runtime/replay_cli.py", "runtime/ros_adapter.py",
             "runtime/control_loop.py", "utils/profiling.py", "utils/safetensors_io.py",
             "utils/torch_port.py", "utils/checkpoint_manifest.py"]
    pat = re.compile(r"^\s*(import jax|from jax|.*vla_touch_tpu\.|.*\bsafetensors\b import"
                     r"|import safetensors|from safetensors)", re.M)
    for f in files:
        src = open(os.path.join(ROOT, "vla_touch_tpu_torch", f)).read()
        assert not pat.search(src), f
        top = src.split("\ndef ", 1)[0].split("\nclass ", 1)[0]
        assert "h5py" not in re.sub(r'""".*?"""', "", top, flags=re.S), f


def test_deploy_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch, policy, episode):
    _, tcfg, rdt, vision = policy
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSP.from_policy(tcfg, rdt, vision)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TRC.main(["--episode", episode[1]])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TTP.load_rdt_runner("unused.safetensors", tcfg.rdt)
    TSP.from_policy(tcfg, rdt, vision, device="cpu").close()
