"""PyTorch port, the residual controllers trained and evaluated, against the
JAX package on the same inputs (CPU, float32).

Small widths throughout: BRIDGeR ``unet_down_dims`` (16, 32), hidden 32,
horizon 8, batch 4; the LSTM at hidden 32; DinoV2 at one layer and 28^2
(both packages' ``dinov2_runtime._CONFIGS`` shrunk for the test).  The
draws JAX makes from its keys (t, z, the Brownian increments, the dropout
mask) are passed to the port.  Tolerances are stated per test: float32
rounding of the same arithmetic in another order (XLA's fusions against
torch's kernels) is 1e-6 relative and grows through the UNets' depth.

This file: the checkpoint codec, GELU / EMA / rounding, the interpolants
and BRIDGeR.  The LSTM, DinoV2, the dataset and the checkpoints across the
packages are in ``test_torch_controllers_lstm.py``, the entry points in
``test_torch_controllers_entry.py`` (split so that xdist's loadfile spreads
them); what they share is ``torch_controllers_common.py``.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from vla_touch_tpu.config import BridgeTrainConfig as JBTC
from vla_touch_tpu.config import InterpolantConfig as JIC
from vla_touch_tpu.models.controllers import bridge as JB
from vla_touch_tpu.models.controllers import interpolants as JI
from vla_touch_tpu.train import bridge_train as JBT
from vla_touch_tpu.utils import ema as JE
from vla_touch_tpu_torch import config as TC
from vla_touch_tpu_torch.models.controllers import bridge as TB
from vla_touch_tpu_torch.models.controllers import interpolants as TI
from vla_touch_tpu_torch.train import bridge_train as TBT
from vla_touch_tpu_torch.train.optim import AdamW
from vla_touch_tpu_torch.utils import checkpoint as TCK
from vla_touch_tpu_torch.utils import ema as TE
from vla_touch_tpu_torch.utils import from_flax as FF

from torch_controllers_common import (  # noqa: F401
    B, D, H, _batch, _get, _jax_draws, _leaves, _np_tree, _port_bridge, _sde_noise, _stats,
    _t, bridge,
)


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
