"""PyTorch port, op level: each module of ``vla_touch_tpu_torch/ops`` and
``utils`` against its JAX counterpart on the same numpy inputs (CPU, f32;
JAX matmuls at ``highest`` precision, set by conftest).

Default tolerance atol 1e-5 / rtol 1e-4; looser ones say why.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_touch_tpu.ops import nn as jnn
from vla_touch_tpu_torch.ops import nn as tnn
from vla_touch_tpu_torch.utils import from_flax as FF

ATOL, RTOL = 1e-5, 1e-4


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol, rtol=rtol)


def _t(a):
    return torch.as_tensor(np.array(a))


def _port(module, flax_params):
    return FF.load_into(module, FF.to_state_dict(flax_params)).eval().requires_grad_(False)


# ------------------------------------------------------------ utils -------

def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_configs_equal_jax_field_for_field():
    """The port's dataclasses hold the JAX package's values, field for
    field (the RDT training and data configurations included)."""
    from vla_touch_tpu import config as JC
    from vla_touch_tpu.models.encoders import vit as JV
    from vla_touch_tpu.runtime import policy as JP
    from vla_touch_tpu_torch import config as TC
    from vla_touch_tpu_torch.models.encoders import vit as TV
    from vla_touch_tpu_torch.runtime import policy as TP

    def same(t, j, left_out=()):
        tf, jf = _fields(t), _fields(j)
        assert set(jf) - set(tf) == set(left_out)
        for name, value in tf.items():
            if dataclasses.is_dataclass(value):
                continue
            assert value == jf[name], name

    for make in ("rdt_1b", "rdt_170m", "rdt_tiny"):
        t, j = getattr(TC, make)(), getattr(JC, make)()
        same(t, j)
        assert t.compute_dtype == getattr(torch, jnp.dtype(j.compute_dtype).name)
    same(TC.NoiseSchedulerConfig(), JC.NoiseSchedulerConfig())
    same(TC.TrainConfig(), JC.TrainConfig())
    same(TC.DataConfig(), JC.DataConfig())
    same(TC.InterpolantConfig(), JC.InterpolantConfig())
    for kw in ({}, {"inference_dtype": "bfloat16"}):
        t, j = TC.BridgeControllerConfig(**kw), JC.BridgeControllerConfig(**kw)
        same(t, j)
        same(t.interpolant, j.interpolant)
        assert t.raw_obs_dim == j.raw_obs_dim and t.visual_dim == j.visual_dim
    for name in ("DINOV2_SMALL", "SIGLIP_SO400M", "CLIP_VIT_B16"):
        same(getattr(TV, name), getattr(JV, name))
    t, j = TP.franka_eef_policy_config(), JP.franka_eef_policy_config()
    same(t, j)
    same(t.rdt.model, j.rdt.model)
    same(t.rdt.noise, j.rdt.noise)


def test_state_vec_and_normalization(rng):
    from vla_touch_tpu.utils import normalization as JN
    from vla_touch_tpu.utils import state_vec as JS
    from vla_touch_tpu_torch.utils import normalization as TN
    from vla_touch_tpu_torch.utils import state_vec as TS

    assert TS.STATE_VEC_IDX_MAPPING == JS.STATE_VEC_IDX_MAPPING
    assert TS.FRANKA_EEF_STATE_INDICES == JS.FRANKA_EEF_STATE_INDICES
    v = rng.normal(size=(3, 10)).astype(np.float32)
    np.testing.assert_array_equal(TS.fill_in_state(v), JS.fill_in_state(v))
    np.testing.assert_array_equal(TS.extract_state(TS.fill_in_state(v)), v)

    stats = {"action_mins": rng.normal(size=10).astype(np.float32) - 1,
             "action_maxs": rng.normal(size=10).astype(np.float32) + 1,
             "vla_mins": np.zeros(10, np.float32), "vla_maxs": np.ones(10, np.float32)}
    stats["vla_maxs"][3] = 0.0      # zero range -> safe range 1
    a = rng.normal(size=(2, 16, 10)).astype(np.float32)
    for kind in ("expert", "vla"):
        n = TN.normalize_actions(_t(a), stats, kind)
        _close(n, JN.normalize_actions(jnp.asarray(a), stats, kind))
        _close(TN.denormalize_actions(n, stats, kind), a)


def test_image_helpers(rng):
    from vla_touch_tpu.utils import image as JI
    from vla_touch_tpu_torch.utils import image as TI

    img = rng.integers(0, 256, size=(2, 3, 20, 20, 3)).astype(np.uint8)
    _close(TI.siglip_normalize(_t(img)), JI.siglip_normalize(jnp.asarray(img)))
    _close(TI.imagenet_normalize(_t(img)), JI.imagenet_normalize(jnp.asarray(img)))
    # non-square frame: pad + INTER_AREA resize (exact, uint8)
    frame = rng.integers(0, 256, size=(30, 42, 3)).astype(np.uint8)
    np.testing.assert_array_equal(TI.pad_and_resize_for_siglip(frame, 28),
                                  JI.pad_and_resize_for_siglip(frame, 28))
    # already square at the target size: an exact copy, no resize
    sq = rng.integers(0, 256, size=(28, 28, 3)).astype(np.uint8)
    np.testing.assert_array_equal(TI.pad_and_resize_for_siglip(sq, 28), sq)


# ------------------------------------------------------- schedulers -------

@pytest.mark.parametrize("schedule", ["squaredcos_cap_v2", "linear",
                                      "scaled_linear"])
def test_scheduler_tables_f64(schedule):
    """The numpy schedule tables are float64 on both sides: 1e-10; the
    float32 solver tables are the same float32 values (1e-10 too)."""
    from vla_touch_tpu.ops import schedulers as JSch
    from vla_touch_tpu_torch.ops import schedulers as TSch

    np.testing.assert_allclose(TSch.make_betas(1000, schedule),
                               JSch.make_betas(1000, schedule), atol=1e-10, rtol=0)
    js = JSch.DiffusionSchedule.create(1000, schedule)
    ts = TSch.DiffusionSchedule.create(1000, schedule)
    np.testing.assert_allclose(ts.alphas_cumprod_np(), js.alphas_cumprod_np(),
                               atol=1e-10, rtol=0)
    np.testing.assert_allclose(ts.alphas_cumprod, np.asarray(js.alphas_cumprod),
                               atol=1e-10, rtol=0)
    for steps in (3, 5, 25):
        jt = JSch.make_dpm_tables(js, steps)
        tt = TSch.make_dpm_tables(ts, steps)
        for f in ("timesteps", "alpha_t", "sigma_t", "lambda_t", "use_first_order"):
            np.testing.assert_allclose(np.asarray(getattr(tt, f), np.float64),
                                       np.asarray(getattr(jt, f), np.float64),
                                       atol=1e-10, rtol=0)


def test_dpm_solver_step_f64(rng):
    """The solver update on float64 states with float64 tables (the same
    table values on both sides): 1e-10.  At float32 the two frameworks'
    expm1 differ by a few ulps, which the float32 loop test below covers."""
    import dataclasses

    from vla_touch_tpu.ops import schedulers as JSch
    from vla_touch_tpu_torch.ops import schedulers as TSch

    t32 = TSch.make_dpm_tables(TSch.DiffusionSchedule.create(), 5)
    tables_t = dataclasses.replace(
        t32, alpha_t=t32.alpha_t.astype(np.float64),
        sigma_t=t32.sigma_t.astype(np.float64),
        lambda_t=t32.lambda_t.astype(np.float64))
    x, x0, x0p = (rng.normal(size=(2, 8, 4)) for _ in range(3))
    for i in range(5):
        with jax.enable_x64(True):
            tables_j = JSch.DPMSolverTables(
                timesteps=jnp.asarray(tables_t.timesteps),
                alpha_t=jnp.asarray(tables_t.alpha_t),
                sigma_t=jnp.asarray(tables_t.sigma_t),
                lambda_t=jnp.asarray(tables_t.lambda_t),
                use_first_order=jnp.asarray(tables_t.use_first_order))
            want = np.asarray(JSch.dpm_solver_step(
                jnp.asarray(x), jnp.asarray(x0), jnp.asarray(x0p), i, tables_j))
        got = TSch.dpm_solver_step(_t(x), _t(x0), _t(x0p), i, tables_t)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, atol=1e-10, rtol=1e-10)


@pytest.mark.parametrize("prediction_type", ["sample", "epsilon"])
def test_sample_dpm_solver_matches_jax(rng, prediction_type):
    """Whole loop with a fixed nonlinear model_fn (the JAX scan carries
    float32, so the port runs float32 too)."""
    from vla_touch_tpu.ops import schedulers as JSch
    from vla_touch_tpu_torch.ops import schedulers as TSch

    w = rng.normal(size=(4, 4)).astype(np.float32) * 0.3
    x_init = rng.normal(size=(2, 6, 4)).astype(np.float32)

    def jfn(x, t):
        return jnp.tanh(x @ w) * (t[:, None, None] / 1000.0)

    def tfn(x, t):
        return torch.tanh(x @ _t(w)) * (t[:, None, None].float() / 1000.0)

    want = JSch.sample_dpm_solver(jfn, jnp.asarray(x_init),
                                  JSch.DiffusionSchedule.create(), 5,
                                  prediction_type=prediction_type)
    got = TSch.sample_dpm_solver(tfn, _t(x_init), TSch.DiffusionSchedule.create(),
                                 5, prediction_type=prediction_type)
    _close(got, want)


# ---------------------------------------------------------- pos embed -----

def test_pos_embed_matches_jax():
    from collections import OrderedDict

    from vla_touch_tpu.ops import pos_embed as JP
    from vla_touch_tpu_torch.ops import pos_embed as TP

    for lens, mod in [(OrderedDict([("timestep", 1), ("ctrl_freq", 1),
                                     ("state", 1), ("action", 8)]), True),
                      (OrderedDict([("lang", -16)]), False),
                      (OrderedDict([("image", (2, -3, 9))]), False)]:
        np.testing.assert_allclose(TP.get_multimodal_cond_pos_embed(64, lens, mod),
                                   JP.get_multimodal_cond_pos_embed(64, lens, mod),
                                   atol=1e-12)
    t = np.array([0.0, 3.0, 517.0, 999.0], np.float32)
    _close(TP.timestep_embedding(_t(t), 256), JP.timestep_embedding(jnp.asarray(t), 256))
    _close(TP.timestep_embedding(_t(t), 33), JP.timestep_embedding(jnp.asarray(t), 33))
    s = np.array([0.1, 0.5, 0.999], np.float32)
    _close(TP.sinusoidal_pos_emb(_t(s), 256), JP.sinusoidal_pos_emb(jnp.asarray(s), 256))


# ------------------------------------------------------------- nn ---------

def test_rmsnorm_mlp_mish(rng):
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    jm = jnn.RmsNorm()
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    p = {"weight": np.asarray(rng.normal(size=64), np.float32)}
    _close(_port(tnn.RmsNorm(64), p)(_t(x)), jm.apply({"params": p}, jnp.asarray(x)))

    jm = jnn.Mlp(hidden_features=96, out_features=32)
    p = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    _close(_port(tnn.Mlp(64, 96, 32), p)(_t(x)), jm.apply({"params": p}, jnp.asarray(x)))
    _close(tnn.mish(_t(x)), jnn.mish(jnp.asarray(x)))
    _close(tnn.gelu_tanh(_t(x)), jnn.gelu_tanh(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["silu", "gelu_tanh", "quick_gelu"])
def test_bf16_activations_match_jax_bit_for_bit(rng, name):
    """On bf16 the port's activations equal JAX's jitted ones bit for bit:
    XLA rounds each operation to bf16, so the port writes the operations
    out.  The single-rounding torch forms (F.silu, F.gelu, torch.sigmoid)
    differ on these inputs, so the test sees the fault it guards."""
    import torch.nn.functional as F

    jfn = {"silu": jax.nn.silu, "gelu_tanh": lambda h: jax.nn.gelu(h, approximate=True),
           "quick_gelu": lambda h: h * jax.nn.sigmoid(1.702 * h)}[name]
    once = {"silu": F.silu, "gelu_tanh": lambda h: F.gelu(h, approximate="tanh"),
            "quick_gelu": lambda h: h * torch.sigmoid(1.702 * h)}[name]
    x = jnp.asarray(rng.normal(size=(64, 512)) * 3, jnp.bfloat16)
    want = np.asarray(jax.jit(jfn)(x).astype(jnp.float32))
    xt = _t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    np.testing.assert_array_equal(getattr(tnn, name)(xt).float().numpy(), want)
    assert (once(xt).float().numpy() != want).mean() > 0.1


_jax_gelu = jax.jit(lambda h: jax.nn.gelu(h, approximate=False))
_jax_exp = jax.jit(jnp.exp)


def _xla_exp(t):
    """XLA:CPU's float32 exp, the one operation gelu_erf writes otherwise."""
    return _t(np.asarray(_jax_exp(t.numpy())))


def _ulps(a, b):
    """float32 ulps between a and b of one sign (0 where they are equal)."""
    d = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))
    return np.where(a == b, 0, d)


def test_gelu_erf_bf16_matches_jax_jit_bit_for_bit(rng):
    """On bf16, ``gelu_erf`` equals the jitted ``jax.nn.gelu(approximate=False)``
    on every one of the 65536 bf16 values (NaN where JAX gives NaN), both
    through its table and through the program it is built from with XLA's
    exp passed in; and on 200 000 N(0, 9) samples.  F.gelu, the
    single-rounding form, leaves more than 10 % of the samples unlike, so
    the test sees the fault it guards."""
    import torch.nn.functional as F

    every = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    sample = _t((rng.normal(size=200_000) * 3).astype(np.float32)).to(torch.bfloat16)
    for xt in (every, sample):
        want = np.asarray(_jax_gelu(jnp.asarray(xt.float().numpy(), jnp.bfloat16))
                          .astype(jnp.float32))
        np.testing.assert_array_equal(tnn.gelu_erf(xt).float().numpy(), want)
        np.testing.assert_array_equal(tnn._gelu_erf_program(xt, _xla_exp).float().numpy(), want)
    assert (F.gelu(sample).float().numpy() != want).mean() > 0.1


def test_gelu_erf_float32_matches_jax_jit(rng):
    """On float32 (the planning encoder, the splice projector, BRIDGeR's
    observation encoder), ``gelu_erf`` is XLA:CPU's program: written out
    with XLA's exp, bit for bit over |x| up to 20 (both erfc branches, the
    underflow select and flushed denormals).  With torch's exp, as
    ``gelu_erf`` runs, about 2 % of outputs differ, each by at most 4
    float32 ulps."""
    x = np.concatenate([rng.normal(size=100_000) * 3,
                        rng.uniform(-20, 20, size=20_000)]).astype(np.float32)
    want = np.asarray(_jax_gelu(jnp.asarray(x)))
    np.testing.assert_array_equal(tnn._gelu_erf_program(_t(x), _xla_exp).numpy(), want)
    got = tnn.gelu_erf(_t(x)).numpy()
    unlike = got != want
    assert unlike.mean() < 0.05
    assert _ulps(got[unlike], want[unlike]).max() <= 4
    with pytest.raises(TypeError):
        tnn.gelu_erf(_t(x).half())


def _gelu_site(site):
    """(JAX function of x, port module, port module's home, x, number of
    exact GELUs per call) of one exact-GELU site at its own dtype, the port
    module holding the converted flax weights."""
    r = np.random.default_rng(11)
    if site == "dinov2_mlp":
        from vla_touch_tpu.models.encoders import vit as JV
        from vla_touch_tpu_torch.models.encoders import vit as TV

        kw = dict(hidden_size=48, num_layers=1, num_heads=6, mlp_dim=192, patch_size=14)
        x = jnp.asarray(r.normal(size=(2, 17, 48)), jnp.bfloat16)
        jm = JV.ViTBlock(JV.ViTConfig(**kw), dtype=jnp.bfloat16)
        p = jm.init(jax.random.PRNGKey(3), x)["params"]
        return (lambda x: jm.apply({"params": p}, x), _port(TV.ViTBlock(TV.ViTConfig(**kw)), p)
                .to(torch.bfloat16), TV, x, 1)
    if site in ("adapter_align", "projector"):
        from vla_touch_tpu.planning import encoder as JE
        from vla_touch_tpu.planning import llm_splice as JS
        from vla_touch_tpu_torch.planning import encoder as TE
        from vla_touch_tpu_torch.planning import llm_splice as TS

        x = jnp.asarray(r.normal(size=(3, 64)), jnp.float32)
        if site == "adapter_align":
            jm, tm, home, n = JE.Adapter(64, 40), TE.Adapter(64, 40), TE, 2
        else:
            jm, tm, home, n = JS.TactileProjector(96), TS.TactileProjector(64, 96), TS, 1
        p = jm.init(jax.random.PRNGKey(4), x)["params"]
        # spread the near-identity adapter kernels so the GELUs see O(1) inputs
        p = jax.tree.map(lambda a: a * 300 if a.ndim == 2 and site == "adapter_align" else a, p)
        return lambda x: jm.apply({"params": p}, x), _port(tm, p), home, x, n
    from vla_touch_tpu.config import BridgeControllerConfig as JBC
    from vla_touch_tpu.models.controllers import bridge as JB
    from vla_touch_tpu_torch.config import BridgeControllerConfig as TBC
    from vla_touch_tpu_torch.models.controllers import bridge as TB

    kw = dict(hidden_dim=32, horizon=8, unet_down_dims=(32, 64, 64))
    parts = [jnp.asarray(r.normal(size=(2, n)), jnp.float32) for n in (384, 384, 10, 3)]
    jm = JB.BridgeControllerModule(JBC(**kw))
    p = jm.init(jax.random.PRNGKey(6), *parts, method=JB.BridgeControllerModule.encode_obs)
    tm = TB.BridgeControllerModule(TBC(**kw)).eval().requires_grad_(False)
    sd = FF.to_state_dict(p["params"])
    with torch.no_grad():
        for name, a in sd.items():
            tm.get_parameter(name).copy_(_t(a))
    return (lambda x: jm.apply(p, *x, method=JB.BridgeControllerModule.encode_obs),
            lambda x: tm.encode_obs(*x), TB, parts, 2)


@pytest.mark.parametrize("site", ["dinov2_mlp", "adapter_align", "projector", "bridge_se"])
def test_exact_gelu_sites_match_jax(site, monkeypatch):
    """Every exact-GELU site of the port runs ``gelu_erf`` at the dtype of
    its JAX counterpart: DinoV2's MLP (bf16; models/encoders/vit.py), the
    tactile adapter's rfc and align GELUs (planning/encoder.py), the splice
    projector (planning/llm_splice.py) and BRIDGeR's observation encoder
    (models/controllers/bridge.py), all float32.  The module's output
    matches the jitted flax module's (bf16: 2e-2 x max|jax|, the bf16
    LayerNorm and Linear round elsewhere; float32: 1e-5), and each GELU's
    output equals the jitted ``jax.nn.gelu`` on the same input: bit for bit
    on bf16, and on float32 with XLA's exp passed in."""
    jfn, tfn, home, x, n_gelu = _gelu_site(site)
    want = np.asarray(jax.jit(jfn)(x).astype(jnp.float32))
    seen = []

    def recording(h):
        out = tnn.gelu_erf(h)
        seen.append((h, out))
        return out

    monkeypatch.setattr(home, "gelu_erf", recording)
    xt = [_t(np.asarray(a.astype(jnp.float32))).to(a.dtype == jnp.bfloat16 and torch.bfloat16
                                                    or torch.float32)
          for a in (x if isinstance(x, list) else [x])]
    got = tfn(xt if isinstance(x, list) else xt[0]).float().numpy()
    assert len(seen) == n_gelu
    dtype = torch.bfloat16 if site == "dinov2_mlp" else torch.float32
    if dtype == torch.bfloat16:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    else:
        _close(got, want)
    for h, out in seen:
        assert h.dtype == out.dtype == dtype
        jh = jnp.asarray(h.float().numpy(), jnp.bfloat16 if dtype == torch.bfloat16 else None)
        ref = np.asarray(_jax_gelu(jh).astype(jnp.float32))
        if dtype == torch.bfloat16:
            np.testing.assert_array_equal(out.float().numpy(), ref)
        else:
            np.testing.assert_array_equal(tnn._gelu_erf_program(h, _xla_exp).numpy(), ref)
            assert _ulps(out.numpy(), ref).max() <= 4


@pytest.mark.parametrize("name", ["siglip_normalize", "imagenet_normalize"])
def test_image_normalize_matches_jax_jit_bit_for_bit(rng, name):
    """Every uint8 value, channels-last, bit for bit against the JAX
    function under jit (where it runs: XLA multiplies by the float32
    reciprocal and fuses the subtraction into an FMA).  Dividing as torch
    does (x / 255.0 ...) differs."""
    from vla_touch_tpu.utils import image as JI
    from vla_touch_tpu_torch.utils import image as TI

    img = np.concatenate([np.arange(256, dtype=np.uint8).repeat(3).reshape(1, 16, 16, 3),
                          rng.integers(0, 256, size=(1, 16, 16, 3)).astype(np.uint8)])
    want = np.asarray(jax.jit(getattr(JI, name))(jnp.asarray(img)))
    np.testing.assert_array_equal(getattr(TI, name)(_t(img)).numpy(), want)
    x = _t(img).float() / 255.0
    if name == "siglip_normalize":
        divided = (x - 0.5) / 0.5
    else:
        divided = (x - torch.tensor([0.485, 0.456, 0.406])) / torch.tensor([0.229, 0.224, 0.225])
    assert (divided.numpy() != want).mean() > 0.1


def test_self_and_cross_attention_modules(rng):
    B, N, L, C, H = 2, 7, 19, 64, 4
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    c = rng.normal(size=(B, L, C)).astype(np.float32)
    mask = np.ones((B, L), bool)
    mask[1, 11:] = False
    jm = jnn.SelfAttention(num_heads=H)
    p = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    _close(_port(tnn.SelfAttention(C, H), p)(_t(x)),
           jm.apply({"params": p}, jnp.asarray(x)))
    jm = jnn.CrossAttention(num_heads=H)
    p = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(c))["params"]
    _close(_port(tnn.CrossAttention(C, H), p)(_t(x), _t(c), _t(mask)),
           jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(c), jnp.asarray(mask)))


def test_groupnorm_and_convs(rng):
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    jm = jnn.GroupNorm(num_groups=8)
    p = {"weight": rng.normal(size=32).astype(np.float32),
         "bias": rng.normal(size=32).astype(np.float32)}
    _close(_port(tnn.GroupNorm(32, 8), p)(_t(x)), jm.apply({"params": p}, jnp.asarray(x)))
    for k, s, pad in [(5, 1, 2), (3, 2, 1), (1, 1, 0)]:
        jm = jnn.Conv1d(24, k, stride=s, padding=pad)
        p = jm.init(jax.random.PRNGKey(k), jnp.asarray(x))["params"]
        _close(_port(tnn.Conv1d(32, 24, k, stride=s, padding=pad),
                     {"conv": p["conv"]})(_t(x)),
               jm.apply({"params": p}, jnp.asarray(x)))
    # the transposed conv: flax's unflipped kernel -> torch's flipped weight
    jm = jnn.ConvTranspose1d(24, 4, stride=2, padding=1)
    p = jm.init(jax.random.PRNGKey(7), jnp.asarray(x))["params"]
    sd = {k.split(".", 1)[1]: v
          for k, v in FF.to_state_dict({"up0_up": p}).items()}
    got = FF.load_into(tnn.ConvTranspose1d(32, 24, 4), sd).requires_grad_(False)(_t(x))
    want = jm.apply({"params": p}, jnp.asarray(x))
    assert got.shape == want.shape == (2, 32, 24)
    _close(got, want)


# ------------------------------------------------------- attention (K1) ---

def _attention_inputs(rng, B, Lq, Lkv, H, D, mask_kind):
    q = rng.normal(size=(B, Lq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Lkv, H, D)).astype(np.float32)
    v = rng.normal(size=(B, Lkv, H, D)).astype(np.float32)
    mask = None
    if mask_kind != "none":
        mask = np.ones((B, Lkv), bool)
        mask[0, Lkv // 3:] = False             # ragged
        if mask_kind == "fully_masked":
            mask[-1, :] = False                # every key of batch B-1 masked
    return q, k, v, mask


@pytest.mark.parametrize("B,Lq,Lkv,H,D,mask_kind", [
    (2, 35, 300, 4, 72, "ragged"),        # SigLIP head dim, ragged mask
    (2, 67, 130, 2, 64, "fully_masked"),  # Lq > 64 (two q tiles), empty row
    (1, 9, 64, 3, 16, "none"),
])
def test_attention_plain_matches_pallas_interpret(rng, B, Lq, Lkv, H, D, mask_kind):
    """The port's plain K1 (what CPU tensors compute) against the TPU
    kernel in interpret mode; fully masked rows are 0 in both.  Tolerance
    2e-5 as the JAX package's own kernel test (online vs dense softmax)."""
    from jax.experimental.pallas import tpu as pltpu

    from vla_touch_tpu.ops import pallas_attention as pa
    from vla_touch_tpu_torch.ops import attention as TA
    from vla_touch_tpu_torch.ops import flash_attention as FA

    q, k, v, mask = _attention_inputs(rng, B, Lq, Lkv, H, D, mask_kind)
    jmask = None if mask is None else jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        want = pa.flash_cross_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), kv_mask=jmask, block_kv=128)
    tmask = None if mask is None else _t(mask)
    before = FA.flash_attention.launches
    got = TA.dot_product_attention(_t(q), _t(k), _t(v), kv_mask=tmask)
    assert FA.flash_attention.launches == before      # CPU: plain, no launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    if mask_kind == "fully_masked":
        assert np.all(got.numpy()[-1] == 0.0)
    # and the XLA einsum path on the rows that have valid keys
    from vla_touch_tpu.ops.attention import _attention_xla_dense

    ref = np.asarray(_attention_xla_dense(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), kv_mask=jmask))
    rows = slice(None) if mask_kind != "fully_masked" else slice(0, B - 1)
    _close(got.numpy()[rows], ref[rows])


def test_flash_attention_refuses_other_devices():
    from vla_touch_tpu_torch.ops.flash_attention import flash_attention

    q = torch.zeros((1, 2, 1, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)


# ---------------------------------------------------- marker tracking -----

def test_marker_tracking_matches_jax(rng):
    from vla_touch_tpu.ops import marker_tracking as JM
    from vla_touch_tpu_torch.ops import marker_tracking as TM

    H, W = 70, 90
    base = rng.integers(0, 256, size=(H, W)).astype(np.float32)
    frame = np.roll(base, 2, axis=1)
    rgb = rng.integers(0, 256, size=(H, W, 3)).astype(np.float32)
    _close(TM.gaussian_blur(_t(base), 5), JM.gaussian_blur(jnp.asarray(base), 5),
           atol=1e-3, rtol=1e-5)              # pixel scale 255: ~1e-5 relative
    for img in (base, rgb):
        np.testing.assert_array_equal(
            TM.marker_mask(_t(img), TM.TrackerConfig()).numpy(),
            np.asarray(JM.marker_mask(jnp.asarray(img), JM.TrackerConfig())))
    jb = JM.calibrate(jnp.asarray(base), JM.TrackerConfig())
    tb = TM.calibrate(_t(base), TM.TrackerConfig())
    _close(tb["centroids"], jb["centroids"])
    np.testing.assert_array_equal(tb["valid"].numpy(), np.asarray(jb["valid"]))
    jf = JM.estimate_force(jnp.asarray(frame), jb, JM.TrackerConfig())
    tf = TM.estimate_force(_t(frame), tb, TM.TrackerConfig())
    for key in ("displacement", "mean_disp", "magnitude", "direction", "force"):
        _close(tf[key], jf[key])
