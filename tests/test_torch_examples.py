"""PyTorch port, the README's full walkthrough
(``examples/torch_full_pipeline.py``) against the JAX package's
(``examples/full_pipeline.py``) on the CPU.

Each stage of the port is held against the JAX function the JAX
walkthrough calls, at its configurations, on the same data, with JAX's
weights carried across by the converter (``utils/from_flax.py``) and JAX's
noise passed in (torch cannot replay ``jax.random``): the dataset
statistics, the distillation's ``vla_action``, both controllers' first
training batch (features and losses), both evaluations' metrics and the
replay's tracking MSE.  Then the port's full walkthrough runs end to end;
the walkthroughs and the root ``torch_*.py`` scripts import no JAX.  The
planning walkthrough: ``tests/test_torch_examples_planning.py``.
"""

import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from vla_touch_tpu.config import (
    BridgeControllerConfig as JBC, BridgeTrainConfig as JBTC, DataConfig as JDC,
    InterpolantConfig as JIC, LSTMControllerConfig as JLC, LSTMTrainConfig as JLTC,
    NoiseSchedulerConfig as JNS, rdt_tiny as j_rdt_tiny)
from vla_touch_tpu.data import episode as JE
from vla_touch_tpu.models.encoders import dinov2_runtime as JD
from vla_touch_tpu.models.encoders.vit import ViTConfig as JViT
from vla_touch_tpu.models.rdt import runner as JR
from vla_touch_tpu.runtime import policy as JP
from vla_touch_tpu_torch import config as TC
from vla_touch_tpu_torch.data import episode as TE
from vla_touch_tpu_torch.models.encoders import dinov2_runtime as TD
from vla_touch_tpu_torch.models.encoders import vit as TV
from vla_touch_tpu_torch.models.rdt import runner as TR
from vla_touch_tpu_torch.runtime import policy as TP
from vla_touch_tpu_torch.utils import from_flax as FF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
# the walkthrough's configurations (examples/full_pipeline.py)
DINO_KW = dict(hidden_size=384, num_layers=1, num_heads=4, mlp_dim=64, image_size=28,
               patch_size=14)
VIT_KW = dict(hidden_size=48, num_layers=1, num_heads=4, mlp_dim=96, image_size=28,
              patch_size=14, use_cls_token=False, use_layerscale=False, gelu_tanh=True)
EPISODES = dict(n_episodes=3, num_steps=40, img_size=28, chunk=8, lang_dim=16,
                with_vla=False, resized_size=28)
BKW = dict(hidden_dim=32, horizon=8, unet_down_dims=(16, 32))
LKW = dict(hidden_dim=32, num_layers=1)
TRAIN_KW = dict(horizon=8, batch_size=16, epochs=3, val_ratio=0.34)
TOL = dict(atol=1e-5, rtol=1e-4)        # the tick's tolerance (float32)


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax_noises(key, n: int, shape) -> list:
    """The starting noise of each of ``n`` JAX ``step`` calls from ``key``:
    the second half of each split."""
    out = []
    for _ in range(n):
        key, k = jax.random.split(key)
        out.append(_t(jax.random.normal(k, shape, jnp.float32)))
    return out


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    """The full walkthrough's data and models in both packages: episodes
    (JAX's h5, the port's npz, the same draws), DinoV2 shrunk as the
    walkthrough shrinks it, the tiny policy (JAX's init, ``final_ffn.fc2``
    drawn so that the chunk is not all zeros) and the port's copy, and the
    JAX distillation of every episode (the controllers' data)."""
    root = tmp_path_factory.mktemp("walk")
    saved = JD._CONFIGS["dinov2-small"], TD._CONFIGS["dinov2-small"]
    JD._CONFIGS["dinov2-small"], TD._CONFIGS["dinov2-small"] = JViT(**DINO_KW), TV.ViTConfig(
        **DINO_KW)
    try:
        raw_h5, raw_npz, aug = (str(root / d) for d in ("raw_h5", "raw_npz", "aug"))
        JE.make_synthetic_dataset(raw_h5, **EPISODES)
        TE.make_synthetic_dataset(raw_npz, **EPISODES)
        jcfg = JP.PolicyConfig(rdt=JR.RDTRunnerConfig(model=j_rdt_tiny(lang_token_dim=16),
                                                      noise=JNS(num_inference_timesteps=2)),
                               vision=JViT(**VIT_KW), image_size=28)
        jmodel = JP.create_model(jcfg, seed=0)
        fc2 = jmodel.rdt_params["model"]["final_ffn"]["fc2"]
        fc2["kernel"] = jnp.asarray(np.random.default_rng(1).normal(size=fc2["kernel"].shape)
                                    * 0.05, jnp.float32)
        tcfg = TP.PolicyConfig(rdt=TR.RDTRunnerConfig(model=TC.rdt_tiny(lang_token_dim=16),
                                                      noise=TC.NoiseSchedulerConfig(
                                                          num_inference_timesteps=2)),
                               vision=TV.ViTConfig(**VIT_KW), image_size=28)
        rdt = FF.load_into(TR.RDTRunnerModule(tcfg.rdt.model), FF.rdt_runner(jmodel.rdt_params))
        vision = FF.load_into(TV.SiglipVisionEncoder(tcfg.vision), FF.vit(jmodel.vision_params))
        tmodel = TP.RoboticDiffusionTransformerModel(tcfg, rdt.eval().requires_grad_(False),
                                                     vision.eval().requires_grad_(False))
        text = np.random.default_rng(0).normal(size=(4, 16)).astype(np.float32)
        from vla_touch_tpu.data.distill import record_vla_actions_for_dataset

        jmodel._key = jax.random.PRNGKey(99)
        record_vla_actions_for_dataset(raw_h5, aug, lambda p, im, _text: jmodel.step(p, im, text),
                                       image_size=28)
        jdino = jax.jit(lambda k: JD.init_params("dinov2-small", k))(jax.random.PRNGKey(5))
        tdino = FF.load_into(TD.DinoV2Encoder(TD.config_for("dinov2-small")),
                             FF.dinov2_runtime(jax.tree.map(np.asarray, jdino)))
        yield dict(root=root, raw_h5=raw_h5, raw_npz=raw_npz, aug=aug, jcfg=jcfg,
                   jmodel=jmodel, tmodel=tmodel, text=text, jdino=jdino,
                   tdino=tdino.eval().requires_grad_(False))
    finally:
        JD._CONFIGS["dinov2-small"], TD._CONFIGS["dinov2-small"] = saved


def test_dataset_statistics_equal_jax(full):
    """Stage 2: ``process_dataset`` over the port's npz episodes equals
    JAX's over its h5 episodes (the same draws) to 1e-6 relative."""
    from vla_touch_tpu.data.stats import process_dataset as j_stats
    from vla_touch_tpu_torch.data.stats import process_dataset as t_stats

    want = j_stats(JDC(chunk_size=8), str(full["root"] / "jstat.json"),
                   file_paths=JE.list_episode_files(full["raw_h5"]))
    got = t_stats(TC.DataConfig(chunk_size=8), str(full["root"] / "tstat.json"),
                  file_paths=TE.list_episode_files(full["raw_npz"], pattern=(".npz",)))
    assert set(got) == set(want) == {"mango"}
    assert set(got["mango"]) == set(want["mango"])
    for k, v in want["mango"].items():
        np.testing.assert_allclose(np.asarray(got["mango"][k], np.float64),
                                   np.asarray(v, np.float64), rtol=1e-6, atol=1e-12, err_msg=k)


def test_distillation_writes_jax_vla_actions(full):
    """Stage 3: the port's distillation of the first npz episode with the
    port's policy (JAX's noise for each of its 40 steps) writes JAX's
    ``vla_action`` within the tick's tolerance (atol 1e-5, rtol 1e-4)."""
    from vla_touch_tpu_torch.data.distill import record_vla_actions_for_episode

    m = full["jcfg"].rdt.model
    noises = iter(_jax_noises(jax.random.PRNGKey(99), 40, (1, m.horizon, m.output_dim)))
    tmodel, text = full["tmodel"], full["text"]
    tmodel.reset()
    out = record_vla_actions_for_episode(
        os.path.join(full["raw_npz"], "episode_0.npz"), str(full["root"] / "port_ep0.npz"),
        lambda p, im, _text: tmodel.step(p, im, text, init_noise=next(noises)), image_size=28)
    with TE.EpisodeFile(out) as f, TE.EpisodeFile(os.path.join(full["aug"], "episode_0.h5")) as j:
        got, want = np.asarray(f.get("vla_action")), np.asarray(j.get("vla_action"))
        assert got.shape == want.shape == (40, 8, 10) and np.abs(want).max() > 0.1
        np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def controllers(full):
    """Stage 4's trainers in both packages on JAX's distilled episodes, at
    the walkthrough's configurations, the port's holding JAX's initial
    controller weights and DinoV2; each data module's first training
    batch (the trainer's shuffle, seed 42)."""
    from vla_touch_tpu.data.controller_dataset import ControllerDataModule as JDM
    from vla_touch_tpu.models.controllers import bridge as JB
    from vla_touch_tpu.models.controllers import lstm as JL
    from vla_touch_tpu.train import bridge_train as JBT
    from vla_touch_tpu.train import lstm_train as JLT
    from vla_touch_tpu_torch.data.controller_dataset import ControllerDataModule as TDM
    from vla_touch_tpu_torch.models.controllers import bridge as TB
    from vla_touch_tpu_torch.models.controllers import lstm as TL
    from vla_touch_tpu_torch.train import bridge_train as TBT
    from vla_touch_tpu_torch.train import lstm_train as TLT
    from vla_touch_tpu_torch.utils import ema as TEMA

    bj, bt = JBC(**BKW, interpolant=JIC(diffusion_steps=5)), TC.BridgeControllerConfig(
        **BKW, interpolant=TC.InterpolantConfig(diffusion_steps=5))
    lj, lt = JLC(**LKW), TC.LSTMControllerConfig(**LKW)
    aug, root = full["aug"], full["root"]
    jdm = JDM(aug, context_frames=bj.context_frames, horizon=8, use_images=True, val_ratio=0.34,
              seed=42)
    tdm = TDM(aug, context_frames=bt.context_frames, horizon=8, use_images=True, val_ratio=0.34,
              seed=42)
    jbt = JBT.DiffusionControllerTrainer(bj, JBTC(**TRAIN_KW), str(root / "jb"), stats=jdm.stats,
                                         image_encoder_params=full["jdino"])
    jlt = JLT.LSTMControllerTrainer(lj, JLTC(**TRAIN_KW), str(root / "jl"), stats=jdm.stats,
                                    image_encoder_params=full["jdino"])
    tbt = TBT.DiffusionControllerTrainer(bt, TC.BridgeTrainConfig(**TRAIN_KW), str(root / "tb"),
                                         stats=tdm.stats, image_encoder=full["tdino"],
                                         device="cpu")
    tlt = TLT.LSTMControllerTrainer(lt, TC.LSTMTrainConfig(**TRAIN_KW), str(root / "tl"),
                                    stats=tdm.stats, image_encoder=full["tdino"], device="cpu")
    np_tree = lambda tree: jax.tree.map(np.asarray, tree)           # noqa: E731
    FF.load_into(tbt.state.module, FF.bridge_controller_full(np_tree(jbt.state.params)))
    tbt.state.ema = TEMA.init(tbt.state.module.si)
    FF.load_into(tlt.state.module, FF.lstm_controller(np_tree(jlt.state.params)))
    batch = next(iter(jdm.train_dataset.batches(16, np.random.default_rng(42))))
    tbatch = next(iter(tdm.train_dataset.batches(16, np.random.default_rng(42))))
    for k, v in batch.items():
        np.testing.assert_array_equal(np.asarray(tbatch[k]), np.asarray(v), err_msg=k)
    return dict(bj=bj, bt=bt, lj=lj, lt=lt, jbt=jbt, jlt=jlt, tbt=tbt, tlt=tlt, batch=batch,
                JB=JB, JL=JL, TB=TB, TL=TL, JLT=JLT, TLT=TLT, JBT=JBT)


def test_controllers_first_batch_and_losses_match_jax(controllers):
    """Stage 4: each trainer's prepared first batch (normalised actions,
    DinoV2 features of both cameras) within 1e-5 of JAX's; BRIDGeR's loss
    on it with JAX's draws (t, z from the step's key) and the LSTM's loss
    (no dropout: JAX's ``_eval_loss``) 1e-5 relative."""
    c = controllers
    for jt, tt in ((c["jbt"], c["tbt"]), (c["jlt"], c["tlt"])):
        jb, tb = jt.prepare_batch(c["batch"]), tt.prepare_batch(c["batch"])
        for k, v in jb.items():
            np.testing.assert_allclose(tb[k].numpy(), np.asarray(v), atol=1e-5, rtol=1e-5,
                                       err_msg=k)
    jb = c["jbt"].prepare_batch(c["batch"])
    key = jax.random.PRNGKey(17)
    want, _ = jax.jit(lambda p, k, b: c["JB"].bridge_loss(c["bj"], p, k, b))(
        c["jbt"].state.params, key, jb)
    k_t, k_z, _, _ = jax.random.split(key, 4)
    shape = jb["vla_act"].shape
    draws = {"t": _t(jax.random.uniform(k_t, (shape[0],), jnp.float32)),
             "z": _t(jax.random.normal(k_z, shape, jnp.float32))}
    with torch.no_grad():
        got, _ = c["TB"].bridge_loss(c["bt"], c["tbt"].state.module,
                                     c["tbt"].prepare_batch(c["batch"]), draws)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    jl = c["jlt"].prepare_batch(c["batch"])
    want = c["JLT"]._eval_loss(c["lj"], c["jlt"].state.params, jl)
    with torch.no_grad():
        got = c["TLT"]._loss_with_obs(c["lt"], c["tlt"].state.module,
                                      c["tlt"].prepare_batch(c["batch"]))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_evaluations_match_jax(full, controllers):
    """Stage 5: ``test_diffusion_controller`` (12 samples, JAX's Brownian
    draws for its key) and ``test_lstm_controller`` (horizon 8) on each
    trainer's controller (the port's holding JAX's weights; the JAX
    package's own checkpoints are read by the port in
    ``tests/test_torch_controllers_entry.py``), with the same DinoV2: every
    metric 1e-4 relative."""
    from vla_touch_tpu.eval.bridge_test import test_diffusion_controller as j_bridge
    from vla_touch_tpu.eval.lstm_step_test import test_lstm_controller as j_lstm
    from vla_touch_tpu_torch.eval.bridge_test import test_diffusion_controller as t_bridge
    from vla_touch_tpu_torch.eval.lstm_step_test import test_lstm_controller as t_lstm

    c, aug = controllers, full["aug"]
    want = j_bridge(None, aug, num_samples=12, image_encoder_params=full["jdino"],
                    state=c["jbt"].state)
    key, noise = jax.random.PRNGKey(0), []
    for _ in range(5):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(sub, (12, 8, 10), jnp.float32)))
    got = t_bridge(None, aug, num_samples=12, image_encoder=full["tdino"],
                   state=c["tbt"].state, noise_seq=np.stack(noise), device="cpu")
    wl = j_lstm(None, aug, num_samples=12, horizon=8, image_encoder_params=full["jdino"],
                state=c["jlt"].state)
    gl = t_lstm(None, aug, num_samples=12, horizon=8, image_encoder=full["tdino"],
                state=c["tlt"].state, device="cpu")
    for g, w in ((got, want), (gl, wl)):
        assert g["num_samples"] == w["num_samples"] == 12
        for k in ("action_mse", "vla_mse", "improvement_pct"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)


def test_replay_tracking_matches_jax(full):
    """Stage 6: the closed-loop replay of the first distilled episode
    through the chunk scheduler (chunk 8, replan 4, 12 steps: 3 replans,
    JAX's noise for each) gives JAX's actions and tracking MSE (1e-4)."""
    from vla_touch_tpu.runtime import control_loop as JCL
    from vla_touch_tpu_torch.runtime import control_loop as TCL

    path = os.path.join(full["aug"], "episode_0.h5")
    jmodel, tmodel, text = full["jmodel"], full["tmodel"], full["text"]
    jmodel._key = jax.random.PRNGKey(7)
    m = full["jcfg"].rdt.model
    noises = iter(_jax_noises(jax.random.PRNGKey(7), 3, (1, m.horizon, m.output_dim)))
    tmodel.reset()
    jmodel.reset()
    jsched = JCL.ChunkScheduler(JCL.ControlLoopConfig(chunk_size=8, replan_interval=4,
                                                      gripper_deadband=0.0),
                                lambda w: jmodel.step(w.current.state, w.image_sequence(),
                                                      text)[0])
    tsched = TCL.ChunkScheduler(TCL.ControlLoopConfig(chunk_size=8, replan_interval=4,
                                                      gripper_deadband=0.0),
                                lambda w: tmodel.step(w.current.state, w.image_sequence(), text,
                                                      init_noise=next(noises))[0])
    want = JCL.EpisodeReplay(path).run(jsched, steps=12)
    got = TCL.EpisodeReplay(path).run(tsched, steps=12)
    assert got["steps"] == want["steps"] == 12
    np.testing.assert_allclose(got["actions"], np.asarray(want["actions"]), **TOL)
    np.testing.assert_allclose(got["tracking_mse"], want["tracking_mse"], rtol=1e-4)


# ---- the walkthroughs end to end --------------------------------------------------------


def _example(name):
    sys.path.insert(0, EXAMPLES)
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def test_full_walkthrough_runs_end_to_end_on_the_cpu(tmp_path):
    """``examples/torch_full_pipeline.py`` with ``device="cpu"``: every
    stage runs and ``summary.json`` holds the JAX walkthrough's keys, every
    number finite, 12 replay steps and 12 samples per evaluation."""
    saved = TD._CONFIGS["dinov2-small"]
    try:
        summary = _example("torch_full_pipeline").main(str(tmp_path / "demo"), device="cpu")
    finally:
        TD._CONFIGS["dinov2-small"] = saved
    with open(tmp_path / "demo" / "summary.json") as f:
        assert json.load(f) == json.loads(json.dumps(summary))
    assert set(summary) == {"bridge_eval", "lstm_eval", "replay_tracking_mse", "replay_steps"}
    assert summary["replay_steps"] == 12
    for ev in ("bridge_eval", "lstm_eval"):
        assert summary[ev]["num_samples"] == 12
        assert all(np.isfinite(v) for v in summary[ev].values() if isinstance(v, float))
    assert np.isfinite(summary["replay_tracking_mse"])


def test_walkthroughs_and_root_scripts_import_no_jax():
    """The port's walkthroughs and root entry scripts import neither JAX nor
    the JAX package, and each root script wraps the port's ``main`` of its
    JAX counterpart's module."""
    pat = re.compile(r"^\s*(import (jax|flax)|from (jax|flax)|.*\bvla_touch_tpu\.)", re.M)
    scripts = {"bridge_train": "train.bridge_train", "bridger_test": "eval.bridge_test",
               "lstm_train": "train.lstm_train", "lstm_step_test": "eval.lstm_step_test"}
    files = [os.path.join(EXAMPLES, f"torch_{n}.py") for n in ("full_pipeline",
                                                                "planning_pipeline")]
    for name, mod in scripts.items():
        path = os.path.join(ROOT, f"torch_{name}.py")
        files.append(path)
        with open(os.path.join(ROOT, f"{name}.py")) as f:
            assert f"vla_touch_tpu.{mod} import main" in f.read()
        with open(path) as f:
            assert f"from vla_touch_tpu_torch.{mod} import main" in f.read()
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path
