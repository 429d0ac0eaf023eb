"""PyTorch port, whole slice: the cold control tick through the port's
entry points against the JAX package on the same weights and noise.

- ``create_model(cfg).step`` at the golden policy config (tiny ViT,
  ``rdt_tiny`` float32, 3 solver steps), the starting noise taken from the
  JAX model's key and passed as ``init_noise``; and the frozen
  ``policy_chunk.npz`` anchor (MSE < 1e-6);
- BRIDGeR's observation encoder and its stacked EMA v/s serving UNet;
- the refine: DinoV2 at a non-native size (bicubic pos-embed resize), the
  GelSight marker force, then ``bridge_predict`` fed the Brownian draws of
  ``sde_sample``'s key splits as ``noise_seq``.

CPU float32, tolerance atol 1e-5 / rtol 1e-4 unless stated.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from vla_touch_tpu_torch.utils import from_flax as FF

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")


def _t(a):
    return torch.as_tensor(np.array(a))


def _port(module, state):
    return FF.load_into(module, state).eval().requires_grad_(False)


@pytest.fixture(scope="module")
def golden_policy():
    """The JAX golden-config policy and its port on the same weights."""
    from vla_touch_tpu.config import NoiseSchedulerConfig, rdt_tiny
    from vla_touch_tpu.models.encoders.vit import ViTConfig
    from vla_touch_tpu.models.rdt import runner as R
    from vla_touch_tpu.runtime import policy as P
    from vla_touch_tpu_torch import config as TC
    from vla_touch_tpu_torch.models.encoders import vit as TV
    from vla_touch_tpu_torch.models.rdt import runner as TR
    from vla_touch_tpu_torch.runtime import policy as TP

    fx = np.load(os.path.join(GOLDEN, "policy_chunk.npz"))
    vit_kw = dict(hidden_size=48, num_layers=1, num_heads=4, mlp_dim=96,
                  image_size=28, patch_size=14, use_cls_token=False,
                  use_layerscale=False, gelu_tanh=True)
    cfg = P.PolicyConfig(
        rdt=R.RDTRunnerConfig(model=rdt_tiny(dtype="float32"),
                              noise=NoiseSchedulerConfig(num_inference_timesteps=3)),
        vision=ViTConfig(**vit_kw), image_size=28)
    jmodel = P.create_model(cfg, seed=0)
    rng = np.random.default_rng(int(fx["input_seed"]))
    jmodel.rdt_params["model"]["final_ffn"]["fc2"]["kernel"] = jnp.asarray(
        rng.normal(size=jmodel.rdt_params["model"]["final_ffn"]["fc2"][
            "kernel"].shape) * 0.05, jnp.float32)
    jmodel._key = jax.random.PRNGKey(99)
    inputs = dict(proprio=rng.normal(size=(1, 10)).astype(np.float32),
                  images=[rng.integers(0, 255, size=(28, 28, 3)).astype(np.uint8)
                          for _ in range(6)],
                  text=rng.normal(size=(1, 6, cfg.rdt.model.lang_token_dim)).astype(
                      np.float32))
    # the noise the JAX step draws: its first split of the model key
    _, k = jax.random.split(jax.random.PRNGKey(99))
    noise = np.asarray(jax.random.normal(
        k, (1, cfg.rdt.model.horizon, cfg.rdt.model.output_dim), jnp.float32))

    tcfg = TP.PolicyConfig(
        rdt=TR.RDTRunnerConfig(model=TC.rdt_tiny(dtype="float32"),
                               noise=TC.NoiseSchedulerConfig(num_inference_timesteps=3)),
        vision=TV.ViTConfig(**vit_kw), image_size=28)
    rdt = _port(TR.RDTRunnerModule(tcfg.rdt.model), FF.rdt_runner(jmodel.rdt_params))
    vision = _port(TV.SiglipVisionEncoder(tcfg.vision), FF.vit(jmodel.vision_params))
    tmodel = TP.RoboticDiffusionTransformerModel(tcfg, rdt, vision)
    return fx, jmodel, tmodel, inputs, noise


def test_policy_step_matches_jax(golden_policy):
    fx, jmodel, tmodel, d, noise = golden_policy
    want = jmodel.step(d["proprio"], d["images"], d["text"])
    got = tmodel.step(d["proprio"], d["images"], d["text"], init_noise=_t(noise))
    assert got.shape == want.shape == (1, 8, 10)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-4)


def test_state_pack_matches_jax_jit_bit_for_bit(golden_policy, monkeypatch):
    """The float32 packed state (proprio / state_scale, scattered into the
    128-wide state token) of ``_predict_from_tokens`` equals the JAX one
    under jit, bit for bit: XLA multiplies by the scale's float32
    reciprocal, and so does the port.  The RDT call is replaced by one that
    returns the state token, and the action scale by ones, so the chunk is
    the packed state itself.  Torch's division differs at the gripper."""
    import dataclasses

    from vla_touch_tpu.runtime import policy as P
    from vla_touch_tpu_torch.runtime import policy as TP

    _, jmodel, tmodel, _, _ = golden_policy
    rng = np.random.default_rng(5)
    proprio = rng.normal(size=(64, 10)).astype(np.float32)
    proprio[:, -1] = rng.uniform(0, 255, size=64).astype(np.float32)
    ones = (1.0,) * 10
    jcfg = dataclasses.replace(jmodel.cfg, action_scale=ones)
    tcfg = dataclasses.replace(tmodel.cfg, action_scale=ones)
    monkeypatch.setattr(P.R, "rdt_predict_action", lambda *a, **kw: a[6])
    monkeypatch.setattr(TP.R, "rdt_predict_action", lambda *a, **kw: a[5])
    m = jcfg.rdt.model
    img = np.zeros((64, 2, m.img_token_dim), np.float32)
    txt = np.zeros((64, 3, m.lang_token_dim), np.float32)
    tmask = np.ones((64, 3), bool)
    want = jax.jit(P._predict_from_tokens, static_argnames=("cfg",))(
        jcfg, {}, jax.random.PRNGKey(0), proprio, img, txt, tmask)
    got = TP._predict_from_tokens(tcfg, None, _t(proprio), _t(img), _t(txt), _t(tmask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.any(proprio[:, -1] / np.float32(255) != np.asarray(want)[:, 0, -1])


def test_policy_chunk_golden_anchor(golden_policy):
    """The port reproduces the frozen recorded chunk (MSE < 1e-6)."""
    fx, _, tmodel, d, noise = golden_policy
    tmodel.reset()
    got = tmodel.step(d["proprio"], d["images"], d["text"], init_noise=_t(noise))
    mse = float(np.mean(np.square(got.astype(np.float64) - fx["chunk"])))
    assert mse < 1e-6, mse


def test_policy_uncached_and_absent_camera_paths_agree(golden_policy):
    """policy_step (6 frames at once) and the absent-camera splice give the
    cached step's chunk."""
    from vla_touch_tpu_torch.runtime import policy as TP

    _, _, tmodel, d, noise = golden_policy
    tmodel.reset()
    want = tmodel.step(d["proprio"], d["images"], d["text"], init_noise=_t(noise))
    flat = TP.RoboticDiffusionTransformerModel(tmodel.cfg, tmodel.rdt, tmodel.vision,
                                               cache_frames=False)
    got = flat.step(d["proprio"], d["images"], d["text"], init_noise=_t(noise))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    images = list(d["images"])
    images[2] = images[5] = None                 # left wrist never present
    full = flat.step(d["proprio"], images, d["text"], init_noise=_t(noise))
    absent = TP.RoboticDiffusionTransformerModel(tmodel.cfg, tmodel.rdt, tmodel.vision,
                                                 cache_frames=False, absent_cameras=(2,))
    got = absent.step(d["proprio"], images, d["text"], init_noise=_t(noise))
    np.testing.assert_allclose(got, full, atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def bridge():
    """A small BRIDGeR in both frameworks with the same EMA weights (its
    JAX init is the slow part, so the module's tests share one)."""
    from vla_touch_tpu.config import BridgeControllerConfig as JBC
    from vla_touch_tpu.models.controllers import bridge as JB
    from vla_touch_tpu_torch.config import BridgeControllerConfig as TBC
    from vla_touch_tpu_torch.models.controllers import bridge as TB

    kw = dict(hidden_dim=32, horizon=8, unet_down_dims=(32, 64, 64),
              inference_dtype="float32")
    jcfg, tcfg = JBC(**kw), TBC(**kw)
    st = JB.init_bridge_controller(jcfg, jax.random.PRNGKey(6))
    # a distinct EMA shadow, so the tests see the EMA weights are used
    shadow = jax.tree.map(lambda a: a * 0.9 + 0.01, st.ema.shadow)
    module = _port(TB.BridgeControllerModule(tcfg),
                   FF.bridge_controller(st.params, shadow))
    r = np.random.default_rng(7)
    stats = {"vla_mins": r.normal(size=10).astype(np.float32) - 1,
             "vla_maxs": r.normal(size=10).astype(np.float32) + 1,
             "action_mins": r.normal(size=10).astype(np.float32) - 1,
             "action_maxs": r.normal(size=10).astype(np.float32) + 1}
    return jcfg, st.params, shadow, tcfg, module, stats


def test_bridge_encode_obs_and_stacked_ema_match_jax(rng, bridge):
    """The exact-GELU observation encoder, and the stacked serving UNet of
    the converted EMA v/s nets against the flax UNet on the EMA shadow."""
    from vla_touch_tpu.models.controllers import bridge as JB
    from vla_touch_tpu.models.controllers.unet1d import ConditionalUnet1D as JU
    from vla_touch_tpu_torch.models.controllers import bridge as TB
    from vla_touch_tpu_torch.models.controllers import unet1d_serve as US

    jcfg, params, shadow, tcfg, module, stats = bridge
    B = 2
    state = rng.normal(size=(B, 10)).astype(np.float32)
    f1, f2 = (rng.normal(size=(B, 384)).astype(np.float32) for _ in range(2))
    force = rng.normal(size=(B, 3)).astype(np.float32)
    jm = JB.BridgeControllerModule(jcfg)
    want_obs = jax.jit(lambda p: jm.apply({"params": p}, state, f1, f2, force,
                                          method=JB.BridgeControllerModule.encode_obs))(params)
    obs = module.encode_obs(_t(state), _t(f1), _t(f2), _t(force))
    np.testing.assert_allclose(obs.numpy(), np.asarray(want_obs), atol=1e-5, rtol=1e-4)

    x = rng.normal(size=(B, 8, 10)).astype(np.float32)
    t = np.array([0.2, 0.9], np.float32)
    ju = jax.jit(JU(input_dim=10, down_dims=(32, 64, 64)).apply)
    want = np.stack([ju({"params": shadow[n]}, x, t, np.asarray(want_obs))
                     for n in ("v_net", "s_net")])
    # float32 inference: the stack keeps float32
    got = US.unet_forward_stacked(TB.stacked_vs(module), _t(x), _t(t), obs,
                                  down_dims=tuple(tcfg.unet_down_dims))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)


def test_refine_stage_matches_jax(rng, bridge):
    """DinoV2 pair (non-native size) + marker force + bridge_predict."""
    from tests.test_torch_models import _sde_noise
    from vla_touch_tpu.models.controllers import bridge as JB
    from vla_touch_tpu.models.encoders import vit as JV
    from vla_touch_tpu.ops import marker_tracking as JM
    from vla_touch_tpu.utils.image import imagenet_normalize as j_norm
    from vla_touch_tpu_torch.models.controllers import bridge as TB
    from vla_touch_tpu_torch.models.encoders import vit as TV
    from vla_touch_tpu_torch.ops import marker_tracking as TM
    from vla_touch_tpu_torch.utils.image import imagenet_normalize as t_norm

    kw = dict(hidden_size=384, num_layers=1, num_heads=6, mlp_dim=64, patch_size=14)
    frames = rng.integers(0, 256, size=(2, 42, 42, 3)).astype(np.uint8)
    jd = JV.DinoV2Encoder(JV.ViTConfig(image_size=56, **kw))
    dparams = jax.jit(jd.init)(jax.random.PRNGKey(3), j_norm(jnp.asarray(frames)))["params"]
    feats_j = jax.jit(jd.apply)({"params": dparams}, j_norm(jnp.asarray(frames)))
    td = _port(TV.DinoV2Encoder(TV.ViTConfig(image_size=56, **kw)), FF.vit(dparams))
    feats_t = td(t_norm(_t(frames)))
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j), atol=1e-5, rtol=1e-4)

    gel0 = rng.integers(0, 256, size=(70, 90)).astype(np.float32)
    gel = np.roll(gel0, 1, axis=0)
    force_j = JM.estimate_force(jnp.asarray(gel), JM.calibrate(jnp.asarray(gel0)))["force"]
    force_t = TM.estimate_force(_t(gel), TM.calibrate(_t(gel0)))["force"]
    np.testing.assert_allclose(force_t.numpy(), np.asarray(force_j), atol=1e-5)

    jcfg, params, shadow, tcfg, module, stats = bridge
    state = rng.normal(size=(1, 10)).astype(np.float32)
    vla = rng.normal(size=(1, 8, 10)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    want = JB.bridge_predict(jcfg, params, shadow, stats, key, jnp.asarray(state),
                             jnp.asarray(vla), feats_j[:1], feats_j[1:],
                             force_j[None])
    got = TB.bridge_predict(tcfg, module, stats, _t(state), _t(vla), feats_t[:1],
                            feats_t[1:], force_t[None],
                            noise_seq=_sde_noise(key, 10, vla.shape))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


def test_entry_points_do_not_fall_back_to_cpu(monkeypatch):
    """Without CUDA the entry points raise unless the caller asks for the
    CPU; on the CPU they build and run."""
    from vla_touch_tpu_torch import config as TC
    from vla_touch_tpu_torch.models.rdt import runner as TR
    from vla_touch_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TR.init_rdt(TR.RDTRunnerConfig(model=TC.rdt_tiny()))
    module = TR.init_rdt(TR.RDTRunnerConfig(model=TC.rdt_tiny()), seed=3, device="cpu")
    p = dict(module.named_parameters())
    assert p["model.final_ffn.fc2.weight"].abs().max() == 0      # zero-init head
    assert p["model.blocks.0.norm1.weight"].eq(1).all()
    assert float(p["model.blocks.0.attn.qkv.weight"].std()) > 0
