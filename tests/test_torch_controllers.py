"""PyTorch port, the residual controllers trained and evaluated, against the
JAX package on the same inputs (CPU, float32).

Small widths throughout: BRIDGeR ``unet_down_dims`` (16, 32), hidden 32,
horizon 8, batch 4; the LSTM at hidden 32; DinoV2 at one layer and 28^2
(both packages' ``dinov2_runtime._CONFIGS`` shrunk for the test).  The
draws JAX makes from its keys (t, z, the Brownian increments, the dropout
mask) are passed to the port.  Tolerances are stated per test: float32
rounding of the same arithmetic in another order (XLA's fusions against
torch's kernels) is 1e-6 relative and grows through the UNets' depth.
"""

import dataclasses
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_touch_tpu.config import BridgeControllerConfig as JBC
from vla_touch_tpu.config import BridgeTrainConfig as JBTC
from vla_touch_tpu.config import InterpolantConfig as JIC
from vla_touch_tpu.config import LSTMControllerConfig as JLC
from vla_touch_tpu.models.controllers import bridge as JB
from vla_touch_tpu.models.controllers import interpolants as JI
from vla_touch_tpu.models.controllers import lstm as JL
from vla_touch_tpu.models.encoders import dinov2_runtime as JD
from vla_touch_tpu.models.encoders.vit import ViTConfig as JViT
from vla_touch_tpu.train import bridge_train as JBT
from vla_touch_tpu.utils import ema as JE
from vla_touch_tpu_torch import config as TC
from vla_touch_tpu_torch.models.controllers import bridge as TB
from vla_touch_tpu_torch.models.controllers import interpolants as TI
from vla_touch_tpu_torch.models.controllers import lstm as TL
from vla_touch_tpu_torch.models.encoders import dinov2_runtime as TD
from vla_touch_tpu_torch.models.encoders.vit import ViTConfig as TViT
from vla_touch_tpu_torch.train import bridge_train as TBT
from vla_touch_tpu_torch.train import lstm_train as TLT
from vla_touch_tpu_torch.train.optim import AdamW
from vla_touch_tpu_torch.utils import checkpoint as TCK
from vla_touch_tpu_torch.utils import ema as TE
from vla_touch_tpu_torch.utils import from_flax as FF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BKW = dict(hidden_dim=32, horizon=8, unet_down_dims=(16, 32))
B, H, D = 4, 8, 10
DINO_KW = dict(hidden_size=384, num_layers=1, num_heads=6, mlp_dim=64, image_size=28,
               patch_size=14)
TOL = dict(rtol=1e-4, atol=1e-5)


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


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _jax_draws(key, shape):
    """The t and z that ``si_training_loss`` draws from ``key``."""
    k_t, k_z, _, _ = jax.random.split(key, 4)
    return {"t": _t(jax.random.uniform(k_t, (shape[0],), jnp.float32)),
            "z": _t(jax.random.normal(k_z, shape, jnp.float32))}


def _sde_noise(key, n, shape):
    """The Brownian draws of the JAX ``sde_sample`` scan for ``key``."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


def _stats(seed=7):
    r = np.random.default_rng(seed)
    return {"vla_mins": r.normal(size=10).astype(np.float32) - 1,
            "vla_maxs": r.normal(size=10).astype(np.float32) + 1,
            "action_mins": r.normal(size=10).astype(np.float32) - 1,
            "action_maxs": r.normal(size=10).astype(np.float32) + 1}


def _batch(rng):
    out = {"state": rng.normal(size=(B, D)), "vla_act": rng.normal(size=(B, H, D)),
           "expert_act": rng.normal(size=(B, H, D)), "forces": rng.normal(size=(B, 3)),
           "cam1_feat": rng.normal(size=(B, 384)), "cam2_feat": rng.normal(size=(B, 384))}
    return {k: v.astype(np.float32) for k, v in out.items()}


def _port_bridge(params, cfg):
    with torch.device("meta"):
        m = TB.BridgeControllerModule(cfg, force_decoder=True)
    m = m.to_empty(device="cpu")
    return FF.load_into(m, FF.bridge_controller_full(_np_tree(params)))


@pytest.fixture(scope="module")
def bridge():
    """A small BRIDGeR (force and visual on) in both frameworks on the same
    parameters."""
    jcfg, tcfg = JBC(**BKW), TC.BridgeControllerConfig(**BKW)
    z = jnp.zeros
    params = jax.jit(JB.BridgeControllerModule(jcfg).init)(
        jax.random.PRNGKey(0), z((1, D)), z((1, H, D)), cam1_feat=z((1, 384)),
        cam2_feat=z((1, 384)), forces=z((1, 3)))["params"]
    return jcfg, tcfg, params


@pytest.fixture
def small_dino(monkeypatch):
    """DinoV2-small shrunk to one layer at 28^2 in both packages, and the
    same weights in each (the port's in float32)."""
    monkeypatch.setitem(JD._CONFIGS, "dinov2-small", JViT(**DINO_KW))
    monkeypatch.setitem(TD._CONFIGS, "dinov2-small", TViT(**DINO_KW))
    params = jax.jit(lambda k: JD.init_params("dinov2-small", k))(jax.random.PRNGKey(5))
    with torch.device("meta"):
        enc = TD.DinoV2Encoder(TD.config_for("dinov2-small"))
    enc = FF.load_into(enc.to_empty(device="cpu"), FF.dinov2_runtime(_np_tree(params)))
    return params, enc.eval().requires_grad_(False)


# ---- checkpoint codec -------------------------------------------------------------


def test_checkpoint_codec_writes_flax_bytes_and_reads_them(tmp_path):
    """The port's writer gives the bytes ``flax.serialization.to_bytes``
    gives for the numpy tree ``save_pytree`` makes (keys sorted, 0-d leaves,
    long keys, many-entry maps); the reader takes flax's bytes back, numpy
    scalars (ext 3) included, and refuses a chunked leaf."""
    from flax import serialization

    r = np.random.default_rng(0)
    tree = {"b": {"kernel": r.normal(size=(3, 4)).astype(np.float32),
                  "bias": np.zeros(4, np.float32)},
            "a": np.asarray(jnp.zeros((), jnp.int32)),
            "k" * 40: {str(i): r.normal(size=(70,)).astype(np.float32) for i in range(20)},
            "n": np.arange(300, dtype=np.int64).reshape(3, 100)}
    want = serialization.to_bytes(jax.tree.map(np.asarray, tree))
    path = str(tmp_path / "t.msgpack")
    # torch leaves are written as their numpy arrays
    TCK.save_pytree(path, dict(tree, b={k: torch.as_tensor(v) for k, v in tree["b"].items()}))
    assert open(path, "rb").read() == want
    back = TCK.load_pytree(path, target=tree)
    for p, v in _leaves(tree):
        g = _get(back, p)
        assert g.dtype == v.dtype and np.array_equal(g, v), p
    scal = TCK.unpackb(serialization.msgpack_serialize({"s": np.float32(1.5), "i": np.int32(-7)}))
    assert scal["s"] == np.float32(1.5) and scal["i"] == np.int32(-7)
    chunked = serialization.msgpack_serialize(
        {"x": {"__msgpack_chunked_array__": True, "shape": {"0": 2},
               "chunks": {"0": np.zeros(2, np.float32)}}})
    open(path, "wb").write(chunked)
    with pytest.raises(ValueError, match="chunked"):
        TCK.load_pytree(path)


# ---- gelu, EMA, rounding --------------------------------------------------------


def test_gelu_erf_gradient_matches_jax_grad():
    """``gelu_erf``'s backward against ``jax.grad`` of ``jax.nn.gelu(x,
    approximate=False)`` weighted by a random cotangent: within 2 float32
    ulps of 1 (the exponential is torch's, not XLA's)."""
    from vla_touch_tpu_torch.ops.nn import gelu_erf

    r = np.random.default_rng(1)
    x = np.concatenate([r.normal(size=20000) * 4, np.linspace(-12, 12, 2001)]).astype(np.float32)
    g = r.normal(size=x.shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jax.nn.gelu(v, approximate=False) * g))(x))
    xt = _t(x).requires_grad_(True)
    (gelu_erf(xt) * _t(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0, atol=2.5e-7)


def test_update_torch_ema_and_decays_match_jax():
    """Six ``update_torch_ema`` steps (the counter moving before the decay)
    against JAX, rtol 1e-6; the decay schedules to the float32 ulp."""
    r = np.random.default_rng(2)
    p0 = {"w": r.normal(size=(5, 7)).astype(np.float32), "b": r.normal(size=7).astype(np.float32)}
    js, ts = JE.init(p0), TE.init({k: _t(v) for k, v in p0.items()})
    for i in range(6):
        p = {k: (v + r.normal(size=v.shape) * 0.1).astype(np.float32) for k, v in p0.items()}
        js = JE.update_torch_ema(js, p, 0.75)
        ts = TE.update_torch_ema(ts, {k: _t(v) for k, v in p.items()}, 0.75)
        for k in p0:
            np.testing.assert_allclose(ts.shadow[k].numpy(), np.asarray(js.shadow[k]),
                                       rtol=1e-6, atol=1e-7)
    assert int(ts.num_updates) == int(js.num_updates) == 6
    for n in (0, 1, 5, 100):
        assert TE.torch_ema_decay(0.75, n) == np.float32(JE.torch_ema_decay(0.75, jnp.int32(n)))
        np.testing.assert_allclose(TE.rdt_ema_decay(n, 2), JE.rdt_ema_decay(jnp.int32(n), 2),
                                   rtol=2e-7)


def test_stochastic_round_bf16_bit_for_bit():
    """Given JAX's 16 noise bits, the port rounds to the same bf16 bits,
    and the bf16 EMA shadow's update matches JAX's with those bits."""
    r = np.random.default_rng(3)
    x = (r.normal(size=(64, 33)) * 10.0 ** r.integers(-8, 8, (64, 33))).astype(np.float32)
    key = jax.random.PRNGKey(4)
    noise = np.asarray(jax.random.randint(key, x.shape, 0, 1 << 16, dtype=jnp.uint32))
    want = np.asarray(JE.stochastic_round_bf16(key, jnp.asarray(x))).view(np.uint16)
    got = TE.stochastic_round_bf16(_t(x), noise=_t(noise.astype(np.int64)))
    assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16), want)

    shadow = {"w": x[:8].astype(jnp.bfloat16)}
    js = JE.EmaState(shadow={"w": jnp.asarray(shadow["w"])}, num_updates=jnp.zeros((), jnp.int32))
    p = {"w": x[8:16]}
    k2 = jax.random.PRNGKey(9)
    leaf_key = jax.random.split(k2, 1)[0]
    bits = np.asarray(jax.random.randint(leaf_key, (8, 33), 0, 1 << 16, dtype=jnp.uint32))
    jn = JE.update(js, p, jnp.float32(0.9), key=k2)
    ts = TE.EmaState(shadow={"w": _t(np.asarray(shadow["w"], np.float32)).to(torch.bfloat16)},
                     num_updates=torch.zeros((), dtype=torch.int32))
    tn = TE.update(ts, {"w": _t(p["w"])}, np.float32(0.9),
                   noise={"w": _t(bits.astype(np.int64))})
    assert np.array_equal(tn.shadow["w"].view(torch.int16).numpy().view(np.uint16),
                          np.asarray(jn.shadow["w"]).view(np.uint16))


# ---- interpolants -----------------------------------------------------------------

INTERPOLANTS = ("linear", "reverse_power3", "reverse_power4", "power3", "power4",
                "gaussian_encode_decode", "reverse_linear")


@pytest.mark.parametrize("kind", INTERPOLANTS)
def test_interpolant_weights_and_derivative_match_jax(kind):
    """(w0, w1) and d/dt x_t of each interpolant type on t across [0, 1]
    (both sides of the 0.5 switch), and ``q_sample`` from the same z:
    rtol 1e-6 / atol 1e-6."""
    r = np.random.default_rng(4)
    t = np.concatenate([np.linspace(0.0, 1.0, 11), [0.5, 0.4999, 0.5001]]).astype(np.float32)
    tb = t[:, None, None]
    x0, x1 = (r.normal(size=(len(t), 3, 2)).astype(np.float32) for _ in range(2))
    jc, tc = JIC(interpolant_type=kind), TC.InterpolantConfig(interpolant_type=kind)
    for g, w in zip(TI.interpolant_weights(tc, _t(tb)), JI.interpolant_weights(jc, jnp.asarray(tb))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(TI.interpolant_dev(tc, _t(x0), _t(x1), _t(tb)).numpy(),
                               np.asarray(JI.interpolant_dev(jc, x0, x1, tb)),
                               rtol=1e-6, atol=1e-6)
    key = jax.random.PRNGKey(2)
    xt_j, z_j = JI.q_sample(jc, key, jnp.asarray(t), x0, x1)
    z = _t(jax.random.normal(key, x0.shape, jnp.float32))
    xt_t, z_t = TI.q_sample(tc, _t(t), _t(x0), _t(x1), z)
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=1e-7)
    np.testing.assert_allclose(xt_t.numpy(), np.asarray(xt_j), rtol=1e-6, atol=1e-6)


# ---- BRIDGeR loss, trainer, predict ------------------------------------------------


@pytest.mark.parametrize("prior", ["vla", "gaussian"])
def test_bridge_loss_and_gradients_match_jax(rng, bridge, prior):
    """``bridge_loss`` (and the trainer's loss with the force term) and its
    gradient in every parameter, against ``jax.value_and_grad`` on the same
    parameters and batch, with JAX's draws t, z (and the Gaussian prior
    x0) passed to the port.  Losses rtol 1e-5; each leaf's gradient within
    1e-4 of that leaf's largest entry."""
    jcfg, tcfg, params = bridge
    batch = _batch(rng)
    if prior == "gaussian":
        del batch["vla_act"]
    key = jax.random.PRNGKey(3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        total, parts = JB.bridge_loss(jcfg, p, key, jb)
        obs = JB.BridgeControllerModule(jcfg).apply(
            {"params": p}, jb["state"], jb["cam1_feat"], jb["cam2_feat"], jb["forces"],
            method=JB.BridgeControllerModule.encode_obs)
        force = JB.bridge_force_reconstruction_loss(jcfg, p, obs, jb["forces"])
        return total + force, (total, parts)

    (want, (want_si, parts)), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    draws = _jax_draws(key, (B, H, D))
    if prior == "gaussian":
        draws["x0"] = _t(jax.random.normal(jax.random.split(key, 4)[2], (B, H, D), jnp.float32))
    module = _port_bridge(params, tcfg)
    tb = {k: _t(v) for k, v in batch.items()}
    si_total, tparts = TB.bridge_loss(tcfg, module, tb, draws)
    got, _ = TB.bridge_train_loss(tcfg, module, dict(tb, current_force=tb["forces"]), draws)
    got.backward()
    np.testing.assert_allclose(float(si_total.detach()), float(want_si), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for a, b in zip(tparts[1:], parts[1:]):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-6)
    tgrad = FF.to_flax(module, {n: p.grad for n, p in module.named_parameters()})
    n = 0
    for path, w in _leaves(_np_tree(grads)):
        g = _get(tgrad, path)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-6),
                                   err_msg="/".join(path))
        n += 1
    assert n == len(list(module.parameters()))


def test_bridge_trainer_three_steps_match_jax(rng, bridge):
    """Three steps of the trainer (AdamW, the cosine learning rate, the EMA
    of ``si``) against the JAX trainer's jitted ``_train_step`` from the same
    parameters, batches and draws.  Losses rtol 1e-4; the EMA shadow and the
    parameters rtol 1e-4 / atol 1e-6, except elements whose gradient is 0
    up to rounding in both frameworks (the conv biases that GroupNorm
    cancels, and others near 0): Adam moves such an element by up to lr a
    step in a direction that rounding sets, so at most 0.01 % of the elements
    may differ, by at most 2 lr a step."""
    jcfg, tcfg, params = bridge
    jt = JBTC(learning_rate=1e-3, weight_decay=1e-6)
    tt = TC.BridgeTrainConfig(learning_rate=1e-3, weight_decay=1e-6)
    lrs = [TBT.DiffusionControllerTrainer._lr(types.SimpleNamespace(tcfg=tt), s, 10)
           for s in range(3)]
    assert lrs == [JBT.DiffusionControllerTrainer._lr(types.SimpleNamespace(tcfg=jt), s, 10)
                   for s in range(3)]
    import optax

    jp = jax.tree.map(jnp.array, params)
    opt_state = optax.adamw(1e-3, weight_decay=1e-6).init(jp)
    ema = JE.init(jp["si"])
    module = _port_bridge(params, tcfg).requires_grad_(True)
    st = TB.BridgeControllerState(cfg=tcfg, module=module, ema=TE.init(module.si))
    opt = AdamW(module.parameters(), weight_decay=1e-6)
    for i, lr in enumerate(lrs):
        batch = _batch(rng)
        key = jax.random.PRNGKey(20 + i)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jb["current_force"] = jb["forces"]
        jp, opt_state, ema, jm = JBT._train_step(jcfg, jp, opt_state, ema, key, jb,
                                                 {"lr": lr, "wd": 1e-6})
        tb = {k: _t(v) for k, v in batch.items()}
        tb["current_force"] = tb["forces"]
        tm = TBT._train_step(tcfg, st, opt, tb, lr, draws=_jax_draws(key, (B, H, D)))
        for k in ("loss", "v_loss", "s_loss", "b_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6)
    assert int(st.ema.num_updates) == int(ema.num_updates) == 3
    got = {"params": FF.to_flax(module), "ema": FF.to_flax(module.si, st.ema.shadow)}
    want = {"params": _np_tree(jp), "ema": _np_tree(ema.shadow)}
    total = off = 0
    for path, w in _leaves(want):
        g = _get(got, path)
        bad = ~np.isclose(g, w, rtol=1e-4, atol=1e-6)
        total += w.size
        off += int(bad.sum())
        assert np.all(np.abs(g - w)[bad] <= 2 * 1e-3 * 3), "/".join(path)
    print(f"elements off the tight tolerance: {off} of {total}")
    assert off <= 1e-4 * total, (off, total)


def test_bs_bridge_predict_matches_jax(rng, bridge):
    """The 'bs' SDE through the port's stacked b/s serving UNet (float32,
    the plain path of K2 on the CPU) against JAX's ``bridge_predict`` with
    sde_type 'bs', the EMA shadow distinct from the live nets, one
    ``noise_seq`` from JAX's key: atol 1e-5 / rtol 1e-4."""
    jcfg, tcfg, params = bridge
    interp = dict(sde_type="bs")
    jc = dataclasses.replace(jcfg, interpolant=JIC(**interp))
    tc = dataclasses.replace(tcfg, interpolant=TC.InterpolantConfig(**interp))
    shadow = jax.tree.map(lambda a: a * 0.9 + 0.01, params["si"])
    st = TB.BridgeControllerState(
        cfg=tc, module=_port_bridge(params, tc),
        ema=TE.EmaState(shadow=FF.unet_bundle(_np_tree(shadow)), num_updates=torch.tensor(3)))
    st.ema.shadow = {k: _t(v) for k, v in st.ema.shadow.items()}
    batch = _batch(rng)
    stats = _stats()
    key = jax.random.PRNGKey(12)
    want = JB.bridge_predict(jc, params, shadow, stats, key, batch["state"], batch["vla_act"],
                             batch["cam1_feat"], batch["cam2_feat"], batch["forces"])
    got = TB.bridge_predict(tc, TB.deployable(st), stats, _t(batch["state"]),
                            _t(batch["vla_act"]), _t(batch["cam1_feat"]),
                            _t(batch["cam2_feat"]), _t(batch["forces"]),
                            noise_seq=_sde_noise(key, 10, (B, H, D)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


# ---- LSTM -------------------------------------------------------------------------

LKW = dict(hidden_dim=32)


@pytest.fixture(scope="module")
def lstm():
    jcfg, tcfg = JLC(**LKW), TC.LSTMControllerConfig(**LKW)
    st = JL.init_lstm_controller(jcfg, jax.random.PRNGKey(1))
    with torch.device("meta"):
        m = TL.LSTMControllerModule(tcfg)
    m = FF.load_into(m.to_empty(device="cpu"), FF.lstm_controller(_np_tree(st.params)))
    return jcfg, tcfg, st.params, m


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


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    from vla_touch_tpu.data.episode import make_synthetic_dataset

    root = str(tmp_path_factory.mktemp("episodes"))
    make_synthetic_dataset(root, n_episodes=4, num_steps=30, img_size=28, chunk=8,
                           lang_len=2, lang_dim=8, resized_size=28)
    return root


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


# ---- the entry points, end to end ------------------------------------------------------


def test_trainers_and_evaluations_run_end_to_end_on_the_cpu(tmp_path, episodes, small_dino):
    """Both trainers through their dataset entry points (two epochs, best,
    periodic with pruning, final checkpoints, the jsonl log), then both
    evaluations from the final checkpoints ('vs' and 'bs'); the losses fall,
    and the evaluation of a port-trained BRIDGeR in the JAX package reads
    the same checkpoint."""
    import json

    from vla_touch_tpu_torch.eval import bridge_test as TBE
    from vla_touch_tpu_torch.eval import lstm_step_test as TLE

    ccfg = TC.BridgeControllerConfig(**BKW)
    tcfg = TC.BridgeTrainConfig(horizon=H, batch_size=8, epochs=3, learning_rate=1e-3,
                                val_ratio=0.25)
    out = str(tmp_path / "bridge")
    trainer = TBT.DiffusionControllerTrainer(ccfg, tcfg, out, stats=None, device="cpu")
    from vla_touch_tpu_torch.data.controller_dataset import ControllerDataModule

    dm = ControllerDataModule(episodes, horizon=H, val_ratio=0.25)
    trainer.state.stats = dm.stats
    trainer.train(dm, num_epochs=3, save_interval=1, log_every=1)
    rows = [json.loads(x) for x in open(trainer.metrics_log)]
    assert rows[-1]["loss"] < rows[0]["loss"]
    assert {"best", "checkpoint-1", "checkpoint-2", "checkpoint-3", "final",
            "training.jsonl"} <= set(os.listdir(out))
    final = os.path.join(out, "final")
    assert os.path.exists(os.path.join(final, "image_encoder_dinov2-small.msgpack"))
    st = TB.load_bridge_controller(final, device="cpu")
    for sde in ("vs", "bs"):
        cfg = dataclasses.replace(st.cfg, interpolant=dataclasses.replace(st.cfg.interpolant,
                                                                          sde_type=sde))
        res = TBE.test_diffusion_controller(final, episodes, num_samples=6,
                                            state=dataclasses.replace(st, cfg=cfg), device="cpu")
        assert np.isfinite(res["action_mse"]) and res["num_samples"] == 6
        assert res["inference_dtype"] == "float32"   # the checkpoint's own, on the CPU
    assert JB.load_bridge_controller(final).stats is not None

    lt = TC.LSTMTrainConfig(horizon=H, batch_size=8, epochs=2, learning_rate=1e-3,
                            eval_period_epochs=1, val_ratio=0.25)
    _, ltr = TLT.train_lstm_controller_with_dataset(
        episodes, str(tmp_path / "lstm"), TC.LSTMControllerConfig(**LKW), lt, device="cpu")
    rows = [json.loads(x) for x in open(ltr.metrics_log)]
    assert np.isfinite(rows[-1]["loss"])
    res = TLE.test_lstm_controller(str(tmp_path / "lstm" / "final"), episodes, num_samples=5,
                                   horizon=H, device="cpu")
    assert np.isfinite(res["improvement_pct"])


def test_trainers_turn_tf32_off(tmp_path, small_dino):
    """Both trainers run float32 math: constructing one turns TF32 off for
    CUDA matmuls and cuDNN convolutions (PyTorch's default lets cuDNN's
    convolutions take TF32), whatever the process had set."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    makers = (lambda: TBT.DiffusionControllerTrainer(
                  TC.BridgeControllerConfig(**BKW), TC.BridgeTrainConfig(horizon=H),
                  str(tmp_path / "b"), stats=None, device="cpu"),
              lambda: TLT.LSTMControllerTrainer(
                  TC.LSTMControllerConfig(**LKW), TC.LSTMTrainConfig(horizon=H),
                  str(tmp_path / "l"), stats=None, device="cpu"))
    try:
        for make in makers:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            make()
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_controller_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch, tmp_path,
                                                                     episodes):
    """Without CUDA the trainers, the evaluations and the loaders raise;
    ``device="cpu"`` runs them.  The ``.epc`` cache and ``visualize_dir``
    raise until their modules are ported."""
    from vla_touch_tpu_torch.eval import bridge_test as TBE
    from vla_touch_tpu_torch.eval import lstm_step_test as TLE

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--data_dir", episodes, "--output_dir", str(tmp_path / "o"), "--horizon", str(H)]
    for fn in (TBT.main, TLT.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(argv)
    for fn in (TBE.main, TLE.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(["--ckpt_path", str(tmp_path), "--data_dir", episodes])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TB.init_bridge_controller(TC.BridgeControllerConfig(**BKW))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TL.load_lstm_controller(str(tmp_path))
    st = TB.init_bridge_controller(TC.BridgeControllerConfig(**BKW), device="cpu")
    assert st.module.se_fc1.weight.device.type == "cpu" and st.module.fd_fc1.weight.requires_grad
    with pytest.raises(NotImplementedError):
        TBT.main(argv + ["--data_format", "epc"], device="cpu")
    with pytest.raises(NotImplementedError):
        TBE.test_diffusion_controller(str(tmp_path), episodes, visualize_dir=str(tmp_path),
                                      device="cpu")


def test_controller_modules_import_no_jax():
    """The modules this slice adds import neither JAX, flax, msgpack nor the
    JAX package, and neither does any other module of the port."""
    pat = re.compile(r"^\s*(import (jax|flax|msgpack)|from (jax|flax|msgpack)"
                     r"|.*vla_touch_tpu\.)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "vla_touch_tpu_torch")):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    for f in files:
        assert not pat.search(open(f).read()), f
    rel = {os.path.relpath(f, ROOT) for f in files}
    assert {f"vla_touch_tpu_torch/{m}.py" for m in (
        "utils/checkpoint", "utils/metrics", "utils/ema", "utils/geometry", "data/episode",
        "data/controller_dataset", "models/controllers/lstm", "models/encoders/dinov2_runtime",
        "train/optim", "train/bridge_train", "train/lstm_train", "eval/bridge_test",
        "eval/lstm_step_test")} <= rel
