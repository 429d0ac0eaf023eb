"""PyTorch port, the residual controllers against the JAX package (CPU,
float32), part 2: the LSTM controller, the DinoV2 runtime, the controller
dataset and checkpoints across the two packages.  Sizes, helpers and
fixtures: ``tests/torch_controllers_common.py``; tolerances are stated per
test (see ``tests/test_torch_controllers.py``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from vla_touch_tpu.config import LSTMControllerConfig as JLC
from vla_touch_tpu.models.controllers import bridge as JB
from vla_touch_tpu.models.controllers import lstm as JL
from vla_touch_tpu.models.encoders import dinov2_runtime as JD
from vla_touch_tpu.utils import ema as JE
from vla_touch_tpu_torch import config as TC
from vla_touch_tpu_torch.models.controllers import bridge as TB
from vla_touch_tpu_torch.models.controllers import lstm as TL
from vla_touch_tpu_torch.models.encoders import dinov2_runtime as TD
from vla_touch_tpu_torch.train import bridge_train as TBT
from vla_touch_tpu_torch.train import lstm_train as TLT
from vla_touch_tpu_torch.train.optim import AdamW
from vla_touch_tpu_torch.utils import ema as TE
from vla_touch_tpu_torch.utils import from_flax as FF

from torch_controllers_common import (  # noqa: F401
    B, D, H, ROOT, TOL, _batch, _get, _leaves, _np_tree, _port_bridge, _sde_noise, _stats,
    _t, bridge, episodes, lstm, small_dino,
)


# ---- LSTM -------------------------------------------------------------------------


def test_lstm_sequence_step_and_loss_match_jax(rng, lstm, monkeypatch):
    """The LSTM controller's sequence mode, its step-by-step rollout
    (``lstm_predict_sequence``) and the loss under one dropout mask (JAX's
    ``bernoulli`` made to return it), with the observation encoder inside
    the differentiated loss, and the loss's gradient: atol 1e-5 / rtol 1e-4;
    gradients within 1e-4 of each leaf's largest entry."""
    jcfg, tcfg, params, m = lstm
    h = jcfg.hidden_dim
    state = rng.normal(size=(B, D)).astype(np.float32)
    f1, f2 = (rng.normal(size=(B, 384)).astype(np.float32) for _ in range(2))
    vla_n = rng.normal(size=(B, H, D)).astype(np.float32)
    force = rng.normal(size=(B, H, 3)).astype(np.float32)
    expert = rng.normal(size=(B, H, D)).astype(np.float32)
    stats = _stats(3)

    jm = JL.LSTMControllerModule(jcfg)
    obs_j = JL.lstm_encode_obs(jcfg, params, state, f1, f2)
    obs_t = TL.lstm_encode_obs(tcfg, m, _t(state), _t(f1), _t(f2))
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), **TOL)
    seq_j = jm.apply({"params": params}, obs_j, vla_n, force)
    seq_t = m(obs_t, _t(vla_n), _t(force))
    np.testing.assert_allclose(seq_t.detach().numpy(), np.asarray(seq_j), **TOL)

    raw = vla_n * 0.3 + 0.1
    roll_j = JL.lstm_predict_sequence(jcfg, params, stats, obs_j, raw, force)
    roll_t = TL.lstm_predict_sequence(tcfg, m, stats, obs_t, _t(raw), _t(force))
    np.testing.assert_allclose(roll_t.numpy(), np.asarray(roll_j), **TOL)
    carry, one = TL.lstm_step_predict(tcfg, m, stats, m.init_carry(B), obs_t,
                                      TL.normalize_actions(_t(raw[:, 0]), stats, "vla"),
                                      _t(force[:, 0]))
    np.testing.assert_allclose(one.numpy(), roll_t[:, 0].numpy(), rtol=0, atol=0)

    keep = rng.random((B, H, h)) < 0.9
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.asarray(keep).reshape(shape))
    from vla_touch_tpu.train import lstm_train as JLT

    batch = {"state": state, "cam1_feat": f1, "cam2_feat": f2, "vla_act": vla_n,
             "forces": force, "expert_act": expert}
    want, grads = jax.value_and_grad(
        lambda p: JLT._loss_with_obs(jcfg, p, batch, dropout_key=jax.random.PRNGKey(0)))(params)
    mg = m.requires_grad_(True)
    got = TLT._loss_with_obs(tcfg, mg, {k: _t(v) for k, v in batch.items()}, _t(keep))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    tgrad = FF.to_flax(mg, {n: p.grad for n, p in mg.named_parameters()})
    for path, w in _leaves(_np_tree(grads)):
        np.testing.assert_allclose(_get(tgrad, path), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-6),
                                   err_msg="/".join(path))
    mg.requires_grad_(False).zero_grad(set_to_none=True)
    no_drop = JL.lstm_loss(jcfg, params, {"obs_cond": obs_j, "vla_act": vla_n,
                                          "forces": force, "expert_act": expert})
    np.testing.assert_allclose(
        float(TL.lstm_loss(tcfg, m, {"obs_cond": obs_t, "vla_act": _t(vla_n),
                                     "forces": _t(force), "expert_act": _t(expert)})),
        float(no_drop), rtol=1e-5)


def test_lstm_full_config_matches_the_golden_sequence():
    """The port's LSTM controller at the full config (hidden 256, 2 layers)
    on the reference torch controller's weights (through the JAX package's
    port of them and ``from_flax.lstm_controller``) reproduces the frozen
    ``golden/lstm_full.npz`` sequence to the JAX package's own bound (MSE <
    1e-4; both read 2.6e-6: the reference's torch LayerNorm takes epsilon
    1e-5 where flax's takes 1e-6), and the JAX package's sequence to atol
    1e-5 / rtol 1e-4."""
    from tests.test_lstm_controller import TorchLSTMController, _port_params

    fx = np.load(os.path.join(ROOT, "tests", "fixtures", "golden", "lstm_full.npz"))
    jcfg, tcfg = JLC(), TC.LSTMControllerConfig()
    torch.manual_seed(int(fx["torch_seed"]))
    ref = TorchLSTMController(jcfg).eval()
    with torch.device("meta"):
        m = TL.LSTMControllerModule(tcfg)
    m = FF.load_into(m.to_empty(device="cpu"),
                     FF.lstm_controller(_np_tree(_port_params(ref, jcfg))))
    r = np.random.default_rng(int(fx["input_seed"]))
    raw_obs = r.normal(size=(2, tcfg.obs_dim)).astype(np.float32)
    vla = r.normal(size=(2, 16, tcfg.state_dim)).astype(np.float32)
    force = r.normal(size=(2, 16, tcfg.force_dim)).astype(np.float32)
    v = tcfg.visual_dim
    with torch.no_grad():
        obs = m.encode_obs(_t(raw_obs[:, 2 * v:]), _t(raw_obs[:, :v]), _t(raw_obs[:, v:2 * v]))
        out = m(obs, _t(vla), _t(force)).numpy()
    assert float(np.mean((out - fx["sequence"]) ** 2)) < 1e-4
    params = _port_params(ref, jcfg)
    obs_j = JL.lstm_encode_obs(jcfg, params, raw_obs[:, 2 * v:], raw_obs[:, :v],
                               raw_obs[:, v:2 * v])
    want = JL.LSTMControllerModule(jcfg).apply({"params": params}, obs_j, vla, force)
    np.testing.assert_allclose(out, np.asarray(want), **TOL)


# ---- DinoV2 runtime ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["uint8", "unit", "normalised"])
def test_encode_images_matches_jax(small_dino, kind):
    """``encode_images`` on uint8 frames, [0, 1] floats and ImageNet-normalised
    floats (a time axis on the first): the batch-global /255 and
    normalisation heuristics, then the encoder; atol 1e-5 / rtol 1e-4.  One
    batch mixes a dark and a bright frame, so a per-image heuristic would
    differ."""
    params, enc = small_dino
    r = np.random.default_rng(6)
    frames = r.integers(0, 256, (3, 28, 28, 3)).astype(np.uint8)
    frames[0] //= 8
    if kind == "uint8":
        x = np.stack([frames, frames], axis=1)
    elif kind == "unit":
        x = frames.astype(np.float32) / 255.0
    else:
        x = ((frames / 255.0 - [0.485, 0.456, 0.406]) / [0.229, 0.224, 0.225]).astype(np.float32)
    want = JD.encode_images(JD.config_for("dinov2-small"), params, jnp.asarray(x))
    got = TD.encode_images(enc, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dinov2_params_round_trip_through_the_jax_format(tmp_path, small_dino):
    """The port's ``save_params`` writes the JAX package's file (JAX's
    ``load_params`` reads it bit for bit) and the port reads JAX's, the
    legacy name included."""
    params, enc = small_dino
    TD.save_params(str(tmp_path), "dinov2-small", enc)
    back = JD.load_params(str(tmp_path), "dinov2-small")
    for path, w in _leaves(_np_tree(params)):
        assert np.array_equal(_get(back, path), w), path
    JD.save_params(str(tmp_path / "j"), "dinov2-small", params)
    os.rename(tmp_path / "j" / "image_encoder_dinov2-small.msgpack",
              tmp_path / "j" / "image_encoder.msgpack")
    enc2 = TD.load_params(str(tmp_path / "j"), "dinov2-small", device="cpu",
                          dtype=torch.float32)
    for (n, a), (_, b) in zip(enc.state_dict().items(), enc2.state_dict().items()):
        assert torch.equal(a, b), n
    assert TD.load_params(str(tmp_path / "none"), "dinov2-small", device="cpu") is None


# ---- data ---------------------------------------------------------------------------


def test_controller_dataset_matches_jax(episodes):
    """``ControllerDataset`` items, stats and shuffled batches, and the
    data module's split, on episodes the JAX package writes: float32
    rounding of the 6-D rotation code apart (rtol 1e-6 / atol 1e-6), equal."""
    from vla_touch_tpu.data import controller_dataset as JCD
    from vla_touch_tpu_torch.data import controller_dataset as TCD
    from vla_touch_tpu_torch.data.episode import motion_onset_index, qpos_from_episode, EpisodeFile

    jd = JCD.ControllerDataset(episodes, horizon=H, stride=2)
    td = TCD.ControllerDataset(episodes, horizon=H, stride=2)
    assert td.episode_indices == jd.episode_indices and len(td) > 8
    for k in jd.stats:
        np.testing.assert_allclose(td.stats[k], jd.stats[k], rtol=1e-6, atol=1e-6)
    for i in (0, len(td) // 2, len(td) - 1):
        a, b = td[i], jd[i]
        assert set(a) == set(b)
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6, err_msg=k)
    got = list(td.batches(3, np.random.default_rng(5), workers=2))
    want = list(jd.batches(3, np.random.default_rng(5)))
    assert len(got) == len(want) == len(td) // 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["expert_actions"], b["expert_actions"], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(a["images_cam2"], b["images_cam2"])
    jm = JCD.ControllerDataModule(episodes, horizon=H)
    tm = TCD.ControllerDataModule(episodes, horizon=H)
    assert tm.train_files == jm.train_files and tm.val_files == jm.val_files
    from vla_touch_tpu.data import episode as JEP

    with EpisodeFile(tm.train_files[0]) as f:
        q = qpos_from_episode(f)
        assert motion_onset_index(q) == JEP.motion_onset_index(q) > 0
        assert motion_onset_index(q[:1].repeat(5, 0)) is None


# ---- checkpoints across the two packages --------------------------------------------


def test_jax_checkpoints_load_into_the_port_and_refine_as_jax(tmp_path, rng, bridge, lstm):
    """A BRIDGeR and an LSTM controller saved by the JAX package load into
    the port bit for bit (parameters, EMA, counter, stats, config), and
    refine as JAX does ('vs', float32, one ``noise_seq``; the LSTM rollout):
    atol 1e-5 / rtol 1e-4."""
    jcfg, tcfg, params = bridge
    shadow = jax.tree.map(lambda a: a * 0.5 - 0.02, params["si"])
    jst = JB.BridgeControllerState(cfg=jcfg, params=params,
                                   ema=JE.EmaState(shadow=shadow,
                                                   num_updates=jnp.asarray(7, jnp.int32)),
                                   stats=_stats())
    JB.save_bridge_controller(str(tmp_path / "b"), jst)
    st = TB.load_bridge_controller(str(tmp_path / "b"), device="cpu")
    assert st.cfg == tcfg and int(st.ema.num_updates) == 7
    for path, w in _leaves(_np_tree(params)):
        assert np.array_equal(_get(FF.to_flax(st.module), path), w), path
    for path, w in _leaves(_np_tree(shadow)):
        assert np.array_equal(_get(FF.to_flax(st.module.si, st.ema.shadow), path), w), path
    batch = _batch(rng)
    key = jax.random.PRNGKey(8)
    want = JB.bridge_predict(jcfg, params, shadow, jst.stats, key, batch["state"],
                             batch["vla_act"], batch["cam1_feat"], batch["cam2_feat"],
                             batch["forces"])
    got = TB.bridge_predict(tcfg, TB.deployable(st), st.stats, _t(batch["state"]),
                            _t(batch["vla_act"]), _t(batch["cam1_feat"]),
                            _t(batch["cam2_feat"]), _t(batch["forces"]),
                            noise_seq=_sde_noise(key, 10, (B, H, D)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)

    ljcfg, ltcfg, lparams, _ = lstm
    JL.save_lstm_controller(str(tmp_path / "l"),
                            JL.LSTMControllerState(cfg=ljcfg, params=lparams, stats=_stats(4)))
    lst = TL.load_lstm_controller(str(tmp_path / "l"), device="cpu")
    assert lst.cfg == ltcfg
    for path, w in _leaves(_np_tree(lparams)):
        assert np.array_equal(_get(FF.to_flax(lst.module), path), w), path
    obs = rng.normal(size=(B, ljcfg.hidden_dim)).astype(np.float32)
    raw = rng.normal(size=(B, H, D)).astype(np.float32)
    force = rng.normal(size=(B, H, 3)).astype(np.float32)
    np.testing.assert_allclose(
        TL.lstm_predict_sequence(ltcfg, lst.module, lst.stats, _t(obs), _t(raw),
                                 _t(force)).numpy(),
        np.asarray(JL.lstm_predict_sequence(ljcfg, lparams, lst.stats, obs, raw, force)), **TOL)


def test_port_checkpoints_load_in_the_jax_package_bit_for_bit(tmp_path, bridge, lstm):
    """Controllers the port saves (after a training step, so the EMA and the
    counter differ from the init) load through the JAX package's
    ``load_bridge_controller`` / ``load_lstm_controller`` bit for bit, and the
    port reads its own files back bit for bit."""
    jcfg, tcfg, params = bridge
    st = TB.BridgeControllerState(cfg=tcfg, module=_port_bridge(params, tcfg).requires_grad_(True),
                                  ema=None, stats=_stats())
    st.ema = TE.init(st.module.si)
    opt = AdamW(st.module.parameters(), weight_decay=1e-6)
    gen = torch.Generator().manual_seed(0)
    TBT._train_step(tcfg, st, opt, {k: _t(v) for k, v in _batch(np.random.default_rng(1)).items()},
                    1e-3, generator=gen)
    TB.save_bridge_controller(str(tmp_path / "b"), st)
    j = JB.load_bridge_controller(str(tmp_path / "b"))
    assert j.cfg == jcfg and int(j.ema.num_updates) == 1
    for path, w in _leaves(FF.to_flax(st.module)):
        assert np.array_equal(_get(j.params, path), w), path
    for path, w in _leaves(FF.to_flax(st.module.si, st.ema.shadow)):
        assert np.array_equal(_get(j.ema.shadow, path), w), path
    for k, v in st.stats.items():
        assert np.array_equal(j.stats[k], v)
    back = TB.load_bridge_controller(str(tmp_path / "b"), device="cpu")
    for (n, a), b in zip(st.module.state_dict().items(), back.module.state_dict().values()):
        assert torch.equal(a, b), n
    for n, a in st.ema.shadow.items():
        assert torch.equal(a, back.ema.shadow[n]), n

    ljcfg, ltcfg, _, lm = lstm
    TL.save_lstm_controller(str(tmp_path / "l"), TL.LSTMControllerState(ltcfg, lm, _stats(2)))
    lj = JL.load_lstm_controller(str(tmp_path / "l"))
    assert lj.cfg == ljcfg
    for path, w in _leaves(FF.to_flax(lm)):
        assert np.array_equal(_get(lj.params, path), w), path


def test_converters_check_key_coverage(bridge, lstm):
    """The full-tree converters refuse a tree with a leaf they do not know
    or without one they need; the deployable one still drops the decoder."""
    jcfg, tcfg, params = bridge
    p = _np_tree(params)
    with pytest.raises(KeyError):
        FF.bridge_controller_full({**p, "extra": {"kernel": np.zeros((1, 1))}})
    with pytest.raises(KeyError):
        FF.bridge_controller_full({k: v for k, v in p.items() if k != "fd_fc2"})
    with pytest.raises(KeyError):
        FF.lstm_controller({k: v for k, v in _np_tree(lstm[2]).items() if k != "head_norm"})
    with pytest.raises(KeyError):
        FF.dinov2_runtime({"vit": {}, "x": {}})
    assert not any(k.startswith("fd_fc") for k in FF.bridge_controller(p, p["si"]))
