"""PyTorch port, the steady-state control tick against the JAX package on
the same weights and noise (CPU, float32 unless stated):

- the DPM-Solver++ tail (``start_index``) and ``dpm_renoise``;
- the warm-started chunk of the bf16 runner and of the int8 twin in every
  ``kv_cache`` tier (the JAX Pallas kernels in interpret mode), and the
  reference-style chunk that re-runs the full model every step;
- the warm policy entry points and the four branches of ``step``, the
  franka-joint and ALOHA configs, the prior pack;
- the SigLIP / DinoV2 serving twin (``vit_serve``) and its dispatch;
- the chunk scheduler, observation window, gripper smoother and
  instruction store, and a closed loop through the port's warm ``step``.

Tolerance atol 1e-5 / rtol 1e-4 unless stated.  The noise is passed in
explicitly (torch cannot replay ``jax.random`` streams).
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vla_touch_tpu.config import NoiseSchedulerConfig, rdt_tiny
from vla_touch_tpu.models.encoders import vit as JV
from vla_touch_tpu.models.encoders import vit_serve as JVS
from vla_touch_tpu.models.rdt import quant_serve as JQS
from vla_touch_tpu.models.rdt import runner as JR
from vla_touch_tpu.ops import schedulers as JS
from vla_touch_tpu.runtime import policy as JP
from vla_touch_tpu_torch import config as TC
from vla_touch_tpu_torch.models.encoders import vit as TV
from vla_touch_tpu_torch.models.encoders import vit_serve as TVS
from vla_touch_tpu_torch.models.rdt import quant_serve as TQS
from vla_touch_tpu_torch.models.rdt import runner as TR
from vla_touch_tpu_torch.ops import quant as TQ
from vla_touch_tpu_torch.ops import schedulers as TS
from vla_touch_tpu_torch.runtime import control_loop as CL
from vla_touch_tpu_torch.runtime import policy as TP
from vla_touch_tpu_torch.utils import from_flax as FF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-5, rtol=1e-4)
STEPS = 5
JCFG = JR.RDTRunnerConfig(model=rdt_tiny(dtype="float32"),
                          noise=NoiseSchedulerConfig(num_inference_timesteps=STEPS))
TCFG = TR.RDTRunnerConfig(model=TC.rdt_tiny(dtype="float32"),
                          noise=TC.NoiseSchedulerConfig(num_inference_timesteps=STEPS))
VIT_KW = dict(hidden_size=48, num_layers=1, num_heads=4, mlp_dim=96, image_size=28,
              patch_size=14, use_cls_token=False, use_layerscale=False, gelu_tanh=True)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(a):
    return np.asarray(a, np.float32)


def _jnoise(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))


# ---- the solver tail -------------------------------------------------------------

@pytest.mark.parametrize("start", range(STEPS))
def test_solver_tail_matches_jax(start):
    """``sample_dpm_solver(start_index=k)`` on the JAX tests' tanh model
    function; the first executed step is first order on both sides."""
    x = np.random.default_rng(start).normal(size=(2, 8, 4)).astype(np.float32)
    js = JS.DiffusionSchedule.create(1000, "squaredcos_cap_v2")
    ts = TS.DiffusionSchedule.create(1000, "squaredcos_cap_v2")
    want = JS.sample_dpm_solver(lambda xt, t: jnp.tanh(xt) * 0.3, jnp.asarray(x), js,
                                STEPS, start_index=start)
    got = TS.sample_dpm_solver(lambda xt, t: torch.tanh(xt) * 0.3, _t(x), ts, STEPS,
                               start_index=start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("start", range(STEPS))
def test_renoise_matches_jax_jit_bit_for_bit(start):
    """``dpm_renoise`` as XLA runs it inside the jitted chunk: one FMA."""
    r = np.random.default_rng(10 + start)
    x0, eps = (r.normal(size=(3, 64, 128)).astype(np.float32) for _ in range(2))
    js = JS.DiffusionSchedule.create(1000, "squaredcos_cap_v2")
    ts = TS.DiffusionSchedule.create(1000, "squaredcos_cap_v2")
    want = jax.jit(lambda a, b: JS.dpm_renoise(a, b, js, STEPS, start))(x0, eps)
    got = TS.dpm_renoise(_t(x0), _t(eps), ts, STEPS, start)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_solver_rejects_an_empty_tail():
    ts = TS.DiffusionSchedule.create(1000, "squaredcos_cap_v2")
    x = torch.zeros(1, 2, 2)
    for bad in (-1, STEPS):
        with pytest.raises(ValueError, match="start_index"):
            TS.sample_dpm_solver(lambda xt, t: xt, x, ts, STEPS, start_index=bad)


# ---- the warm chunk --------------------------------------------------------------

@pytest.fixture(scope="module")
def runners():
    """The JAX tiny float32 runner (final projection non-zero) and the
    port's copy of it."""
    params = JR.init_rdt(JCFG, jax.random.PRNGKey(0))
    fc2 = params["model"]["final_ffn"]["fc2"]
    fc2["kernel"] = jnp.asarray(np.random.default_rng(0).normal(size=fc2["kernel"].shape)
                                * 0.05, jnp.float32)
    port = FF.load_into(TR.RDTRunnerModule(TCFG.model), FF.rdt_runner(params))
    return params, port.eval().requires_grad_(False)


def _chunk_args(seed=1):
    m = JCFG.model
    r = np.random.default_rng(seed)
    B, Ll = 1, 6
    lang_mask = np.ones((B, Ll), bool)
    lang_mask[0, 4:] = False
    return (r.normal(size=(B, Ll, m.lang_token_dim)).astype(np.float32), lang_mask,
            r.normal(size=(B, m.img_cond_len, m.img_token_dim)).astype(np.float32),
            r.normal(size=(B, 1, m.state_token_dim)).astype(np.float32),
            np.ones((B, 1, m.output_dim), np.float32), np.asarray([10.0], np.float32))


def _shape():
    return (1, JCFG.model.horizon, JCFG.model.output_dim)


def _cold(runners, noise):
    params, port = runners
    args = _chunk_args()
    want = JR.rdt_predict_action(JCFG, params, None, *args, init_noise=noise)
    got = TR.rdt_predict_action(TCFG, port, *map(_t, args), init_noise=_t(noise))
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("skip", [1, 2, 3])
def test_warm_chunk_matches_jax(runners, skip):
    """The warm chunk from a prior (the cold chunk shifted by 4 of its 8
    ticks and padded, with one action dim masked off so ``mask_h`` shows) and the
    re-noising noise, against JAX's ``rdt_predict_action``."""
    params, port = runners
    args = list(_chunk_args())
    args[4] = args[4].copy()
    args[4][..., 5] = 0.0
    cold, _ = _cold(runners, _jnoise(2, _shape()))
    prior = CL.shift_prior(cold[0], 4)[None] + 0.1
    noise = _jnoise(3, _shape())
    want = JR.rdt_predict_action(JCFG, params, None, *args, init_noise=noise,
                                 prior_chunk=prior, skip_steps=skip)
    got = TR.rdt_predict_action(TCFG, port, *map(_t, args), init_noise=_t(noise),
                                prior_chunk=_t(prior), skip_steps=skip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[..., 5] == 0)


def test_warm_skip0_equals_the_cold_chunk_bit_for_bit(runners):
    _, port = runners
    args = [_t(a) for a in _chunk_args()]
    noise = _t(_jnoise(2, _shape()))
    cold = TR.rdt_predict_action(TCFG, port, *args, init_noise=noise)
    warm0 = TR.rdt_predict_action_warm(TCFG, port, *args, prior_chunk=noise * 3,
                                       skip_steps=0, init_noise=noise)
    assert torch.equal(cold, warm0)
    want, got = _cold(runners, noise.numpy())
    np.testing.assert_allclose(got, want, **TOL)


def test_warm_self_consistency(runners):
    """Re-denoising a chunk the model made (3 of 5 steps skipped, fresh
    noise) stays close to it and is not a no-op: the JAX test's property
    and bounds (``tests/test_warm_start.py``)."""
    _, port = runners
    args = [_t(a) for a in _chunk_args()]
    full = TR.rdt_predict_action(TCFG, port, *args, init_noise=_t(_jnoise(7, _shape())))
    warm = TR.rdt_predict_action_warm(TCFG, port, *args, prior_chunk=full, skip_steps=3,
                                      init_noise=_t(_jnoise(8, _shape())))
    a, b = full.numpy(), warm.numpy()
    assert np.abs(a - b).max() / max(float(np.abs(a).max()), 1e-6) < 0.35
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.97
    assert np.abs(a - b).max() > 0


def test_warm_chunk_rejects_a_bad_skip(runners):
    _, port = runners
    args = [_t(a) for a in _chunk_args()]
    prior = torch.zeros(_shape())
    for bad in (-1, STEPS):
        with pytest.raises(ValueError, match="skip_steps"):
            TR.rdt_predict_action(TCFG, port, *args, prior_chunk=prior, skip_steps=bad)
    with pytest.raises(ValueError, match="prior_chunk"):
        TR.rdt_predict_action(TCFG, port, *args, skip_steps=2)


def test_reference_style_chunk_matches_jax_and_the_cached_path(runners):
    """The reference's sampler (full model, K/V recomputed every step)
    against JAX's and against the condition-K/V-cached chunk."""
    params, port = runners
    args = _chunk_args()
    noise = _jnoise(4, _shape())
    want = JR.rdt_predict_action_reference_style(JCFG, params, None, *args,
                                                 init_noise=noise)
    got = TR.rdt_predict_action_reference_style(TCFG, port, *map(_t, args),
                                                init_noise=_t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    cached = TR.rdt_predict_action(TCFG, port, *map(_t, args), init_noise=_t(noise))
    np.testing.assert_allclose(got.numpy(), cached.numpy(), **TOL)


# ---- the warm int8 twin ------------------------------------------------------------

@pytest.mark.parametrize("kv_cache,kv_proj", [("bf16", "bf16"), ("int8", "bf16"),
                                              ("int8t", "bf16"), ("int8x", "bf16"),
                                              ("int8", "int8")])
def test_warm_twin_matches_jax(runners, kv_cache, kv_proj):
    """The int8 twin's warm chunk at skip 2 against JAX's
    ``rdt_predict_action_quant`` (Pallas kernels in interpret mode), the
    cold twin chunk as the prior.  Gate as the cold twin chunk's in
    ``tests/test_torch_quant.py``: <= 5e-2 x max|jax| and corr > 0.999 (the
    per-token int8 quantization turns last-bit differences into whole
    codes)."""
    params, port = runners
    jqp = JQS.quantize_rdt_params(params, weights="int8", kv_proj=kv_proj)
    tqp = TQS.quantize_rdt_params(port, weights="int8", kv_proj=kv_proj)
    args = _chunk_args()
    cold = TQS.rdt_predict_action_quant(TCFG, tqp, *map(_t, args), kv_cache=kv_cache,
                                        init_noise=_t(_jnoise(2, _shape())))
    prior = CL.shift_prior(cold.numpy()[0], 4)[None]
    noise = _jnoise(5, _shape())
    with pltpu.force_tpu_interpret_mode():
        want = _np(JQS.rdt_predict_action_quant(JCFG, jqp, None, *args, kv_cache=kv_cache,
                                                init_noise=noise, prior_chunk=prior,
                                                skip_steps=2))
    got = TQS.rdt_predict_action_quant(TCFG, tqp, *map(_t, args), kv_cache=kv_cache,
                                       init_noise=_t(noise), prior_chunk=_t(prior),
                                       skip_steps=2).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999
    warm0 = TQS.rdt_predict_action_quant(TCFG, tqp, *map(_t, args), kv_cache=kv_cache,
                                         init_noise=_t(_jnoise(2, _shape())),
                                         prior_chunk=_t(prior), skip_steps=0)
    assert torch.equal(warm0, cold)


# ---- the policy ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def policy():
    """The JAX golden-config policy (tiny ViT, rdt_tiny float32, 3 steps)
    and the port's on the same weights."""
    cfg = JP.PolicyConfig(
        rdt=JR.RDTRunnerConfig(model=rdt_tiny(dtype="float32"),
                               noise=NoiseSchedulerConfig(num_inference_timesteps=3)),
        vision=JV.ViTConfig(**VIT_KW), image_size=28)
    jmodel = JP.create_model(cfg, seed=0)
    fc2 = jmodel.rdt_params["model"]["final_ffn"]["fc2"]
    fc2["kernel"] = jnp.asarray(np.random.default_rng(1).normal(size=fc2["kernel"].shape)
                                * 0.05, jnp.float32)
    tcfg = TP.PolicyConfig(
        rdt=TR.RDTRunnerConfig(model=TC.rdt_tiny(dtype="float32"),
                               noise=TC.NoiseSchedulerConfig(num_inference_timesteps=3)),
        vision=TV.ViTConfig(**VIT_KW), image_size=28)
    rdt = FF.load_into(TR.RDTRunnerModule(tcfg.rdt.model),
                       FF.rdt_runner(jmodel.rdt_params)).eval().requires_grad_(False)
    vision = FF.load_into(TV.SiglipVisionEncoder(tcfg.vision),
                          FF.vit(jmodel.vision_params)).eval().requires_grad_(False)
    return cfg, jmodel, tcfg, rdt, vision


def _policy_inputs(seed=2):
    r = np.random.default_rng(seed)
    return dict(proprio=r.normal(size=(1, 10)).astype(np.float32),
                images=r.integers(0, 255, size=(1, 6, 28, 28, 3)).astype(np.uint8),
                image_mask=np.ones((1, 6), bool),
                text=r.normal(size=(1, 6, 32)).astype(np.float32),
                text_mask=np.ones((1, 6), bool))


def test_policy_step_warm_matches_jax(policy):
    cfg, jmodel, tcfg, rdt, vision = policy
    d = _policy_inputs()
    noise = _jnoise(9, (1, 8, 128))
    prior = np.random.default_rng(3).normal(size=(1, 8, 10)).astype(np.float32) * 2
    jargs = (cfg, jmodel.rdt_params, jmodel.vision_params)
    want = JP.policy_step_warm(*jargs, jax.random.PRNGKey(9), d["proprio"], d["images"],
                               d["image_mask"], d["text"], d["text_mask"], prior, 2)
    got = TP.policy_step_warm(tcfg, rdt, vision, _t(d["proprio"]), _t(d["images"]),
                              _t(d["image_mask"]), _t(d["text"]), _t(d["text_mask"]),
                              _t(prior), 2, init_noise=_t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_policy_step_cached_warm_matches_jax(policy):
    """The steady-state entry: the t-1 tokens from ``encode_frames``, the
    3 new frames encoded, ``(actions, cur_tokens)`` back."""
    cfg, jmodel, tcfg, rdt, vision = policy
    d = _policy_inputs(4)
    noise = _jnoise(10, (1, 8, 128))
    prior = np.random.default_rng(5).normal(size=(1, 8, 10)).astype(np.float32)
    jprev = JP.encode_frames(cfg, jmodel.vision_params, d["images"][:, :3],
                             d["image_mask"][:, :3])
    tprev = TP.encode_frames(tcfg, vision, _t(d["images"][:, :3]),
                             _t(d["image_mask"][:, :3]))
    np.testing.assert_allclose(tprev.numpy(), np.asarray(jprev), **TOL)
    want, wcur = JP.policy_step_cached_warm(
        cfg, jmodel.rdt_params, jmodel.vision_params, jax.random.PRNGKey(10), d["proprio"],
        d["images"][:, 3:], d["image_mask"][:, 3:], jprev, d["text"], d["text_mask"],
        prior, 1)
    got, cur = TP.policy_step_cached_warm(
        tcfg, rdt, vision, _t(d["proprio"]), _t(d["images"][:, 3:]),
        _t(d["image_mask"][:, 3:]), tprev, _t(d["text"]), _t(d["text_mask"]), _t(prior), 1,
        init_noise=_t(noise))
    np.testing.assert_allclose(cur.numpy(), np.asarray(wcur), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _step_noise(key_seed, calls):
    """The noise JAX's ``step`` draws on each of ``calls`` calls: the second
    half of each split of the model key."""
    key, out = jax.random.PRNGKey(key_seed), []
    for _ in range(calls):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k, (1, 8, 128), jnp.float32)))
    return out


@pytest.mark.parametrize("cache_frames,absent", [(True, ()), (False, ()), (True, (2,)),
                                                 (False, (2,))])
def test_step_four_branches_match_jax(policy, cache_frames, absent):
    """``step`` cold, then warm (skip 2) from the first chunk shifted by 4
    ticks, then cold again: with the frame-token cache (the warm call hits
    it), without (``policy_step_warm``), and with the left wrist camera
    absent (background tokens spliced, ``_absent(3)`` / ``_absent(6)``)."""
    cfg, jmodel, tcfg, rdt, vision = policy
    jm = JP.RoboticDiffusionTransformerModel(cfg, jmodel.rdt_params, jmodel.vision_params,
                                             cache_frames=cache_frames,
                                             absent_cameras=absent)
    jm._key = jax.random.PRNGKey(31)
    tm = TP.RoboticDiffusionTransformerModel(tcfg, rdt, vision, cache_frames=cache_frames,
                                             absent_cameras=absent)
    r = np.random.default_rng(6)
    frames = [r.integers(0, 255, size=(28, 28, 3)).astype(np.uint8) for _ in range(9)]
    if absent:
        frames[2] = frames[5] = frames[8] = None
    proprio = r.normal(size=10).astype(np.float32)
    text = r.normal(size=(6, 32)).astype(np.float32)
    noise = _step_noise(31, 3)
    windows = [frames[:6], frames[3:9], frames[3:9]]
    got, want = [], []
    for i, imgs in enumerate(windows):
        kw = {}
        if i == 1:
            prior = CL.shift_prior(want[0][0], 4)
            kw = dict(prior_actions=prior, skip_steps=2)
        want.append(np.asarray(jm.step(proprio, imgs, text, **kw)))
        got.append(tm.step(proprio, imgs, text, init_noise=_t(noise[i]), **kw))
        np.testing.assert_allclose(got[-1], want[-1], **TOL)
    assert not np.allclose(got[1], got[2])


def test_prior_pack_matches_jax_jit_bit_for_bit(policy, monkeypatch):
    """The warm prior (raw actions / action scale, scattered into the
    128-wide chunk) at ``franka_joint``, whose gripper scale 13.9231 has an
    inexact reciprocal: XLA multiplies by the float32 reciprocal, and so
    does the port.  The RDT call is replaced by one that returns the packed
    prior, so the output is the prior packed and unpacked."""
    cfg, jmodel, tcfg, _, _ = policy
    jcfg = dataclasses.replace(JP.franka_joint_policy_config(), rdt=cfg.rdt)
    tcfg_j = dataclasses.replace(TP.franka_joint_policy_config(), rdt=tcfg.rdt)
    r = np.random.default_rng(8)
    prior = r.normal(size=(64, 8, 8)).astype(np.float32)
    prior[..., -1] = r.uniform(0, 14, size=(64, 8)).astype(np.float32)
    monkeypatch.setattr(JP.R, "rdt_predict_action", lambda *a, **kw: kw["prior_chunk"])
    monkeypatch.setattr(TP.R, "rdt_predict_action", lambda *a, **kw: kw["prior_chunk"])
    m = jcfg.rdt.model
    proprio = np.zeros((64, 8), np.float32)
    img = np.zeros((64, 2, m.img_token_dim), np.float32)
    txt = np.zeros((64, 3, m.lang_token_dim), np.float32)
    tmask = np.ones((64, 3), bool)
    want = np.asarray(jax.jit(JP._predict_from_tokens, static_argnames=("cfg", "skip_steps"))(
        jcfg, {}, jax.random.PRNGKey(0), proprio, img, txt, tmask, prior_actions=prior,
        skip_steps=1))
    got = TP._predict_from_tokens(tcfg_j, None, _t(proprio), _t(img), _t(txt), _t(tmask),
                                  prior_actions=_t(prior), skip_steps=1).numpy()
    np.testing.assert_array_equal(got, want)
    scale = np.asarray(jcfg.action_scale, np.float32)
    assert np.any((prior / scale) * scale != want)          # torch's division differs


@pytest.mark.parametrize("variant,dims", [("franka_joint", 8), ("aloha", 14)])
def test_policy_variants_match_jax(policy, variant, dims):
    """The joint-space Franka and ALOHA configs: index tables, scales and
    control frequency field for field, and a cold then a warm ``step``
    (no cameras, ``tests/test_policy_variants.py``'s inputs) against JAX."""
    cfg, jmodel, tcfg, rdt, vision = policy
    jbase = getattr(JP, f"{variant}_policy_config")()
    tbase = getattr(TP, f"{variant}_policy_config")()
    for f in ("state_indices", "state_scale", "action_scale", "control_frequency"):
        assert getattr(jbase, f) == getattr(tbase, f), f
    jcfg = dataclasses.replace(jbase, rdt=cfg.rdt, vision=cfg.vision, image_size=28)
    tcfg_v = dataclasses.replace(tbase, rdt=tcfg.rdt, vision=tcfg.vision, image_size=28)
    jm = JP.RoboticDiffusionTransformerModel(jcfg, jmodel.rdt_params, jmodel.vision_params)
    jm._key = jax.random.PRNGKey(41)
    tm = TP.RoboticDiffusionTransformerModel(tcfg_v, rdt, vision)
    r = np.random.default_rng(0)
    proprio = r.normal(size=dims).astype(np.float32)
    text = r.normal(size=(4, 32)).astype(np.float32)
    noise = _step_noise(41, 2)
    want = np.asarray(jm.step(proprio, [None] * 6, text))
    got = tm.step(proprio, [None] * 6, text, init_noise=_t(noise[0]))
    assert got.shape == (1, 8, dims)
    np.testing.assert_allclose(got, want, **TOL)
    prior = CL.shift_prior(want[0], 2)
    want = np.asarray(jm.step(proprio, [None] * 6, text, prior_actions=prior, skip_steps=1))
    got = tm.step(proprio, [None] * 6, text, prior_actions=prior, skip_steps=1,
                  init_noise=_t(noise[1]))
    np.testing.assert_allclose(got, want, **TOL)


def test_step_passes_the_models_kv_cache_to_the_twin(policy):
    """A model built on the int8 twin with ``kv_cache='int8'`` serves its
    warm ``step`` through that condition cache: equal to
    ``policy_step_warm(kv_cache='int8')`` on the same inputs, and unlike
    the bf16 cache's chunk; an unknown cache raises."""
    cfg, jmodel, tcfg, rdt, vision = policy
    q = TQS.quantize_rdt_params(rdt, "int8")
    d = _policy_inputs(15)
    prior = np.random.default_rng(16).normal(size=(8, 10)).astype(np.float32)
    noise = _t(_jnoise(17, (1, 8, 128)))
    frames = [d["images"][0, i] for i in range(6)]
    outs = {}
    for kv in ("int8", "bf16"):
        tm = TP.create_model(tcfg, rdt=q, vision=vision, cache_frames=False, kv_cache=kv,
                             device="cpu")
        outs[kv] = tm.step(d["proprio"][0], frames, d["text"][0], prior_actions=prior,
                           skip_steps=2, init_noise=noise)
    want = TP.policy_step_warm(tcfg, q, vision, _t(d["proprio"]), _t(d["images"]),
                               _t(d["image_mask"]), _t(d["text"]), _t(d["text_mask"]),
                               _t(prior[None]), 2, init_noise=noise, kv_cache="int8")
    np.testing.assert_array_equal(outs["int8"], want.numpy())
    assert not np.array_equal(outs["int8"], outs["bf16"])
    with pytest.raises(ValueError, match="kv_cache"):
        TP.create_model(tcfg, rdt=q, vision=vision, kv_cache="fp8", device="cpu")


# ---- the ViT serving twin ------------------------------------------------------------

def _vit_kw(**kw):
    base = dict(hidden_size=64, num_layers=3, num_heads=4, mlp_dim=128, image_size=56,
                patch_size=14, use_cls_token=False, use_layerscale=False, gelu_tanh=True)
    base.update(kw)
    return base


VIT_CLASSES = {"siglip": _vit_kw(),
               "dinov2": _vit_kw(use_cls_token=True, use_layerscale=True, gelu_tanh=False),
               "clip": _vit_kw(use_pre_norm=True, quick_gelu=True, gelu_tanh=False)}


@pytest.fixture(scope="module")
def vit_towers():
    """Per ViT class: the JAX flax params (layer scales made non-trivial),
    the port's float32 tower on them, the configs and the pixels."""
    out = {}
    for i, (name, kw) in enumerate(VIT_CLASSES.items()):
        jcfg, tcfg = JV.ViTConfig(**kw), TV.ViTConfig(**kw)
        x = np.random.default_rng(i).normal(size=(2, 56, 56, 3)).astype(np.float32)
        params = JV.SiglipVisionEncoder(jcfg).init(jax.random.PRNGKey(i), jnp.asarray(x))
        params = jax.tree.map(np.asarray, params["params"])
        if jcfg.use_layerscale:
            for b in range(jcfg.num_layers):
                blk = params["vit"][f"block{b}"]
                blk["layerscale1"] = blk["layerscale1"] * 0.5 + 0.1
                blk["layerscale2"] = blk["layerscale2"] * 0.7
        tower = FF.load_into(TV.SiglipVisionEncoder(tcfg), FF.vit(params))
        out[name] = (jcfg, tcfg, params, tower.eval().requires_grad_(False), x)
    return out


@pytest.mark.parametrize("cls", list(VIT_CLASSES))
@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_vit_serve_tiers_match_jax(vit_towers, cls, tier):
    """Each tier of the twin, converted from JAX's serving tree, against
    JAX's jitted ``vit_encode_serve`` in bf16 (SigLIP, DinoV2 and CLIP
    classes), and the port's own ``quantize_vit_params`` of the same tower
    giving the same twin.  Under jit XLA keeps some bf16 intermediates
    (casts to bf16 and back) in float32, which the port rounds as the
    unjitted JAX function does (equal to it bit for bit at SigLIP's class);
    in the int8 tier a one-step bf16 difference moves a whole int8 code.
    Gate: <= 3e-2 x max|jax| and corr > 0.9998 (read: at most 2.1e-2,
    DinoV2 int8, and at least 0.99987)."""
    jcfg, tcfg, params, tower, x = vit_towers[cls]
    jtree = JVS.quantize_vit_params(params, weights=tier)
    want = _np(jax.jit(lambda p, px: JVS.vit_encode_serve(jcfg, p, px))(jtree, jnp.asarray(x)))
    twin = FF.vit_serve(jtree, tcfg, device="cpu")
    assert TVS.is_vit_serve_tree(twin) and not TVS.is_vit_serve_tree(tower)
    got = TVS.vit_encode_serve(twin, _t(x)).float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9998
    own = TVS.quantize_vit_params(tower, weights=tier)
    assert torch.equal(TVS.vit_encode_serve(own, _t(x)), TVS.vit_encode_serve(twin, _t(x)))


@pytest.mark.parametrize("keep", [0, 1])
def test_vit_serve_int8_codes_and_scales_equal_jax(vit_towers, keep):
    """The port's int8 tier holds JAX's codes and scales, bit for bit: the
    fused qkv's per-channel scales concatenated, the last ``keep`` blocks
    bf16."""
    jcfg, tcfg, params, tower, x = vit_towers["siglip"]
    jtree = JVS.quantize_vit_params(params, weights="int8", keep_bf16_last=keep)
    own = TVS.quantize_vit_params(tower, weights="int8", keep_bf16_last=keep)
    n = 0
    for i, blk in enumerate(own.blocks):
        jb = jtree["vit"][f"block{i}"]
        for name, leaf in (("qkv", blk.qkv), ("output", blk.output), ("fc1", blk.fc1),
                           ("fc2", blk.fc2)):
            jl = jb["attention"][name] if name in ("qkv", "output") else jb[name]
            if i >= jcfg.num_layers - keep:
                assert isinstance(leaf, TQ.BF16Linear) and "kernel" in jl
                np.testing.assert_array_equal(leaf.weight.float().numpy(),
                                              np.asarray(jl["kernel"], np.float32).T)
                continue
            np.testing.assert_array_equal(leaf.w_i8.numpy(), np.asarray(jl["w_i8"]).T)
            np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(jl["scale"]))
            np.testing.assert_array_equal(leaf.bias.numpy(), np.asarray(jl["bias"]))
            n += 1
    assert n == 4 * (jcfg.num_layers - keep)


def test_vit_serve_keeping_every_block_bf16_is_the_bf16_tier(vit_towers):
    """``keep_bf16_last >= n_blocks`` gives a serving twin equal to the bf16
    tier (the JAX tree would carry no marker and route to the flax
    module)."""
    jcfg, tcfg, params, tower, x = vit_towers["siglip"]
    all_kept = TVS.quantize_vit_params(tower, weights="int8", keep_bf16_last=5)
    bf16 = TVS.quantize_vit_params(tower, weights="bf16")
    assert TVS.is_vit_serve_tree(all_kept)
    assert not any(hasattr(b.qkv, "w_i8") for b in all_kept.blocks)
    assert torch.equal(TVS.vit_encode_serve(all_kept, _t(x)), TVS.vit_encode_serve(bf16, _t(x)))
    assert not JVS.is_vit_serve_tree(
        JVS.quantize_vit_params(params, weights="int8", keep_bf16_last=5))


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_policy_dispatches_the_vit_twin(policy, tier):
    """``policy_step_cached_warm`` with a serving twin as ``vision`` against
    JAX's with its serving tree (structure dispatch on both sides), and
    ``step`` with the left wrist absent (background tokens through the
    twin).  The golden config runs SigLIP in float32; the twin's int8
    linears give bf16 as K6 does, where JAX's give float32: that tier is
    held to 2e-2 x max|jax| and corr > 0.9999 (read: 1.5e-3 and
    0.99999997), the bf16 tier to TOL."""
    cfg, jmodel, tcfg, rdt, vision = policy
    jtree = JVS.quantize_vit_params(jmodel.vision_params, weights=tier)
    twin = TVS.quantize_vit_params(vision, weights=tier)
    d = _policy_inputs(12)
    prior = np.random.default_rng(13).normal(size=(1, 8, 10)).astype(np.float32)
    noise = _jnoise(14, (1, 8, 128))
    jprev = JP.encode_frames(cfg, jtree, d["images"][:, :3], d["image_mask"][:, :3])
    tprev = TP.encode_frames(tcfg, twin, _t(d["images"][:, :3]), _t(d["image_mask"][:, :3]))
    want, _ = JP.policy_step_cached_warm(
        cfg, jmodel.rdt_params, jtree, jax.random.PRNGKey(14), d["proprio"],
        d["images"][:, 3:], d["image_mask"][:, 3:], jprev, d["text"], d["text_mask"], prior, 2)
    got, _ = TP.policy_step_cached_warm(
        tcfg, rdt, twin, _t(d["proprio"]), _t(d["images"][:, 3:]), _t(d["image_mask"][:, 3:]),
        tprev, _t(d["text"]), _t(d["text_mask"]), _t(prior), 2, init_noise=_t(noise))
    got, want = got.numpy(), np.asarray(want)
    if tier == "bf16":
        np.testing.assert_allclose(tprev.numpy(), np.asarray(jprev), **TOL)
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
        assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999
    tm = TP.RoboticDiffusionTransformerModel(tcfg, rdt, twin, absent_cameras=(2,))
    images = [np.zeros((28, 28, 3), np.uint8)] * 6
    images[2] = images[5] = None
    out = tm.step(d["proprio"][0], images, d["text"][0], init_noise=_t(noise))
    assert out.shape == (1, 8, 10) and np.all(np.isfinite(out))


# ---- the control loop ---------------------------------------------------------------

def test_observation_window_and_smoother():
    w = CL.ObservationWindow(2)
    o1 = CL.Observation(state=np.zeros(10), images=["a", "b"])
    o2 = CL.Observation(state=np.ones(10), images=["c", "d"])
    w.update(o1)
    assert w.image_sequence() == ["a", "b", None, "a", "b", None]
    w.update(o2)
    assert w.image_sequence() == ["a", "b", None, "c", "d", None]
    assert w.current is o2
    s = CL.GripperSmoother(deadband=2.0)
    assert s(100.0) == 100.0
    assert s(101.0) == 100.0
    assert s(103.0) == 103.0


def test_chunk_scheduler_replans_and_refines():
    """The cases of ``tests/test_runtime.py``: replans every interval, the
    bridge refiner once per replan, the LSTM refiner per tick with a fresh
    carry at each replan."""
    cfg = CL.ControlLoopConfig(chunk_size=8, replan_interval=4, refiner="none",
                               gripper_deadband=0.0)
    plans = []

    def plan_fn(window):
        plans.append(window.current.state.copy())
        return np.full((8, 10), float(len(plans)))

    sched = CL.ChunkScheduler(cfg, plan_fn)
    outs = [sched.tick(CL.Observation(state=np.full(10, t), images=[None] * 3))
            for t in range(10)]
    assert len(plans) == 3
    assert outs[0][0] == 1.0 and outs[4][0] == 2.0 and outs[8][0] == 3.0

    calls = []

    def refine_fn(obs, window):
        calls.append(window.copy())
        return window + 100.0

    sched = CL.ChunkScheduler(dataclasses.replace(cfg, refiner="bridge", refine_horizon=2),
                              plan_fn, bridge_refine_fn=refine_fn)
    outs = [sched.tick(CL.Observation(state=np.zeros(10), images=[None] * 3))
            for _ in range(4)]
    assert len(calls) == 1 and calls[0].shape == (2, 10)
    assert outs[0][0] > 100 and outs[1][0] > 100 and outs[2][0] < 100

    carries = []

    def lstm_fn(carry, obs, action, first):
        carries.append((carry, first))
        return (0 if carry is None else carry) + 1, action + 1.0

    sched = CL.ChunkScheduler(dataclasses.replace(cfg, refiner="lstm"), plan_fn,
                              lstm_step_fn=lstm_fn)
    for _ in range(5):
        sched.tick(CL.Observation(state=np.zeros(10), images=[None] * 3))
    assert carries[0] == (None, True)
    assert carries[1][0] == 1 and carries[1][1] is False
    assert carries[4] == (None, True)


def test_chunk_scheduler_warm_replan_prior():
    """``tests/test_warm_start.py``'s wiring case, and the JAX scheduler's
    priors equal the port's on the same plans."""
    from vla_touch_tpu.runtime import control_loop as JCL

    def run(mod):
        calls = {"plain": 0, "warm": []}

        def plan_fn(window):
            calls["plain"] += 1
            return np.tile(np.arange(8, dtype=np.float32)[:, None], (1, 3))

        def plan_warm_fn(window, prior):
            calls["warm"].append(np.array(prior))
            return prior + 1.0

        cfg = mod.ControlLoopConfig(chunk_size=8, replan_interval=4, gripper_deadband=0.0)
        sched = mod.ChunkScheduler(cfg, plan_fn, plan_warm_fn=plan_warm_fn)
        obs = mod.Observation(state=np.zeros(3), images=[None, None, None])
        acts = [sched.tick(obs) for _ in range(9)]
        return calls, acts

    calls, acts = run(CL)
    assert calls["plain"] == 1 and len(calls["warm"]) == 2
    prior0 = calls["warm"][0]
    assert prior0.shape == (8, 3)
    np.testing.assert_array_equal(prior0[:4, 0], [4, 5, 6, 7])
    np.testing.assert_array_equal(prior0[4:, 0], [7, 7, 7, 7])
    jcalls, jacts = run(JCL)
    for a, b in zip(calls["warm"], jcalls["warm"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.stack(acts), np.stack(jacts))


def test_instruction_store_switch_replans():
    """``tests/test_instruction_switch.py``'s case; an unknown name raises
    KeyError."""
    d = {"all_instructions": ["wipe the table", "grab the cup"],
         "wipe the table": np.ones((3, 8)), "grab the cup": np.zeros((3, 8))}
    store = CL.InstructionStore(d)
    assert store.current == "wipe the table" and store.embedding.sum() == 24
    plans = []

    def plan_fn(window):
        plans.append(store.current)
        return np.zeros((8, 10))

    cfg = CL.ControlLoopConfig(chunk_size=8, replan_interval=8, gripper_deadband=0.0)
    sched = CL.ChunkScheduler(cfg, plan_fn, instructions=store)
    obs = CL.Observation(state=np.zeros(10), images=[None] * 3)
    sched.tick(obs)
    sched.tick(obs)
    assert store.switch(1) == "grab the cup"
    sched.tick(obs)
    assert plans == ["wipe the table", "grab the cup"]
    store.switch("wipe the table")
    sched.tick(obs)
    assert plans[2] == "wipe the table"
    with pytest.raises(KeyError):
        store.switch("unknown instruction")


def test_closed_loop_through_the_warm_step(policy):
    """The scheduler driving the port's ``step``: a cold plan, then warm
    replans (skip 2) from the shifted chunk, every call against the JAX
    model's ``step`` driven by the JAX scheduler on the same observations
    and noise."""
    from vla_touch_tpu.runtime import control_loop as JCL

    cfg, jmodel, tcfg, rdt, vision = policy
    r = np.random.default_rng(21)
    text = r.normal(size=(6, 32)).astype(np.float32)
    obs_seq = [dict(state=r.normal(size=10).astype(np.float32),
                    images=[r.integers(0, 255, (28, 28, 3)).astype(np.uint8)
                            for _ in range(3)]) for _ in range(9)]
    noise = iter(_step_noise(51, 3))
    tm = TP.RoboticDiffusionTransformerModel(tcfg, rdt, vision)
    jm = JP.RoboticDiffusionTransformerModel(cfg, jmodel.rdt_params, jmodel.vision_params)
    jm._key = jax.random.PRNGKey(51)
    chunks = {"port": [], "jax": []}

    def plans(model, key, kw):
        def plan(window):
            out = model.step(window.current.state, window.image_sequence(), text, **kw())[0]
            chunks[key].append(out)
            return out

        def plan_warm(window, prior):
            out = model.step(window.current.state, window.image_sequence(), text,
                             prior_actions=prior, skip_steps=2, **kw())[0]
            chunks[key].append(out)
            return out
        return plan, plan_warm

    tplan, tplan_warm = plans(tm, "port", lambda: dict(init_noise=_t(next(noise))))
    jplan, jplan_warm = plans(jm, "jax", dict)
    tsched = CL.ChunkScheduler(CL.ControlLoopConfig(chunk_size=8, replan_interval=4,
                                                    gripper_deadband=0.0),
                               tplan, plan_warm_fn=tplan_warm)
    jsched = JCL.ChunkScheduler(JCL.ControlLoopConfig(chunk_size=8, replan_interval=4,
                                                      gripper_deadband=0.0),
                                jplan, plan_warm_fn=jplan_warm)
    for o in obs_seq:
        a = tsched.tick(CL.Observation(**o))
        b = jsched.tick(JCL.Observation(**o))
        np.testing.assert_allclose(a, b, **TOL)
    assert len(chunks["port"]) == len(chunks["jax"]) == 3
    for a, b in zip(chunks["port"], chunks["jax"]):
        np.testing.assert_allclose(a, b, **TOL)


def test_port_modules_import_no_jax():
    """Every module of the port and ``chip_smoke.py`` import neither JAX nor
    the JAX package (the new modules of the steady-state tick, of the
    deployment entry points, of the tactile encoder's training and of the
    planner's LLM training included)."""
    pat = re.compile(r"^\s*(import jax|from jax|.*vla_touch_tpu\.)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "vla_touch_tpu_torch")):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    for f in files:
        assert not pat.search(open(f).read()), f
    rel = {os.path.relpath(f, ROOT) for f in files}
    assert {"vla_touch_tpu_torch/runtime/control_loop.py",
            "vla_touch_tpu_torch/models/encoders/vit_serve.py",
            "vla_touch_tpu_torch/runtime/serving_pool.py",
            "vla_touch_tpu_torch/runtime/replay_cli.py",
            "vla_touch_tpu_torch/runtime/ros_adapter.py",
            "vla_touch_tpu_torch/utils/profiling.py",
            "vla_touch_tpu_torch/utils/safetensors_io.py",
            "vla_touch_tpu_torch/utils/torch_port.py",
            "vla_touch_tpu_torch/utils/checkpoint_manifest.py",
            "vla_touch_tpu_torch/models/encoders/clip_text.py",
            "vla_touch_tpu_torch/planning/eval.py",
            "vla_touch_tpu_torch/planning/physiclear.py",
            "vla_touch_tpu_torch/planning/process_datasets.py",
            "vla_touch_tpu_torch/planning/train_encoder.py",
            "vla_touch_tpu_torch/planning/run_llm.py",
            "vla_touch_tpu_torch/ops/quant_matmul.py",
            "vla_touch_tpu_torch/ops/w4_fused.py",
            "vla_touch_tpu_torch/csrc/build.py"} <= rel
    # the planner's LLM training (K8's autograd Function, the trainers)
    assert "class W4A8MatmulFn" in open(os.path.join(
        ROOT, "vla_touch_tpu_torch", "ops", "quant_matmul.py")).read()
    assert "def train_projection_and_lora" in open(os.path.join(
        ROOT, "vla_touch_tpu_torch", "planning", "run_llm.py")).read()


def test_warm_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch, vit_towers):
    """Without CUDA the entry points raise unless the caller asks for the
    CPU: ``create_model`` (whose ``step`` takes the prior), the twin
    converter and the wrappers' device resolution."""
    _, tcfg, params, tower, _ = vit_towers["siglip"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pcfg = TP.PolicyConfig(rdt=TCFG, vision=TV.ViTConfig(**VIT_KW), image_size=28)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TP.create_model(pcfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FF.vit_serve(JVS.quantize_vit_params(params, weights="bf16"), tcfg)
    model = TP.create_model(pcfg, device="cpu")
    assert model.device.type == "cpu"
    twin = TVS.quantize_vit_params(tower, weights="int8")
    assert all(b.device.type == "cpu" for b in twin.buffers())
