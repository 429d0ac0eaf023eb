"""PyTorch port, model level: RDT, the ViT encoders, the UNet-1D and its
serving form (with K2's plain version against the TPU kernel in interpret
mode) and the interpolant SDE — each against the JAX package on the same
weights (converted with ``utils.from_flax``) and inputs.  BRIDGeR is held
against JAX in ``test_torch_slice.py``, beside the refine stage.

CPU, float32; default tolerance atol 1e-5 / rtol 1e-4, looser ones say why.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_touch_tpu_torch.utils import from_flax as FF

ATOL, RTOL = 1e-5, 1e-4


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=atol, rtol=rtol)


def _t(a):
    return torch.as_tensor(np.array(a))


def _port(module, state):
    return FF.load_into(module, state).eval().requires_grad_(False)


# ---------------------------------------------------------------- RDT -----

def _rdt_setup(rng):
    from vla_touch_tpu.config import rdt_tiny
    from vla_touch_tpu.models.rdt import runner as JR
    from vla_touch_tpu_torch import config as TC
    from vla_touch_tpu_torch.models.rdt import runner as TR

    m = rdt_tiny()
    rcfg = JR.RDTRunnerConfig(model=m)
    params = JR.init_rdt(rcfg, jax.random.PRNGKey(0))
    params["model"]["final_ffn"]["fc2"]["kernel"] = jnp.asarray(
        rng.normal(size=params["model"]["final_ffn"]["fc2"]["kernel"].shape) * 0.05,
        jnp.float32)
    tcfg = TR.RDTRunnerConfig(model=TC.rdt_tiny())
    module = _port(TR.RDTRunnerModule(tcfg.model), FF.rdt_runner(params))
    B, Ll = 2, 7
    inputs = dict(
        lang=rng.normal(size=(B, Ll, m.lang_token_dim)).astype(np.float32),
        lang_mask=np.arange(Ll)[None, :] < np.array([[Ll], [4]]),
        img=rng.normal(size=(B, m.img_cond_len, m.img_token_dim)).astype(np.float32),
        state=rng.normal(size=(B, 1, m.state_token_dim)).astype(np.float32),
        amask=(rng.random(size=(B, 1, m.output_dim)) > 0.5).astype(np.float32),
        freqs=np.array([10.0, 25.0], np.float32),
        noise=rng.normal(size=(B, m.horizon, m.output_dim)).astype(np.float32))
    return rcfg, params, tcfg, module, inputs


def test_rdt_forward_cached_matches_jax(rng):
    from vla_touch_tpu.models.rdt import runner as JR

    rcfg, params, tcfg, module, d = _rdt_setup(rng)
    jm = JR.RDTRunnerModule(rcfg.model)
    state_in = np.concatenate([d["state"], d["amask"]], axis=2)
    t = jnp.asarray([17, 611], jnp.int32)

    @jax.jit
    def jax_forward(params):
        lc, ic, st = jm.apply({"params": params}, d["lang"], d["img"], state_in,
                              method=JR.RDTRunnerModule.adapt_conditions)
        kv = jm.apply({"params": params}, lc, ic,
                      method=JR.RDTRunnerModule.compute_cond_kv)
        x = jnp.concatenate([st, st[:, :1].repeat(rcfg.model.horizon, 1)], axis=1)
        out = jm.apply({"params": params}, x, d["freqs"], t, kv, d["lang_mask"],
                       method=JR.RDTRunnerModule.forward_cached)
        return lc, st, kv, x, out

    lc, st, kv, x, want = jax_forward(params)

    tlc, tic, tst = module.adapt_conditions(_t(d["lang"]), _t(d["img"]), _t(state_in))
    _close(tlc, lc)
    _close(tst, st)
    tkv = module.compute_cond_kv(tlc, tic)
    for (k1, v1), (k2, v2) in zip(tkv, kv):
        _close(k1, k2)
        _close(v1, v2)
    got = module.forward_cached(_t(np.asarray(x)), _t(d["freqs"]), _t(np.asarray(t)),
                                tkv, _t(d["lang_mask"]))
    _close(got, want)


def test_rdt_predict_action_matches_jax(rng):
    from vla_touch_tpu.models.rdt import runner as JR
    from vla_touch_tpu_torch.models.rdt import runner as TR

    rcfg, params, tcfg, module, d = _rdt_setup(rng)
    args = [d["lang"], d["lang_mask"], d["img"], d["state"], d["amask"], d["freqs"]]
    want = JR.rdt_predict_action(rcfg, params, jax.random.PRNGKey(1),
                                 *[jnp.asarray(a) for a in args],
                                 init_noise=d["noise"])
    got = TR.rdt_predict_action(tcfg, module, *[_t(a) for a in args],
                                init_noise=_t(d["noise"]))
    _close(got, want)


# ---------------------------------------------------------------- ViT -----

@pytest.mark.parametrize("old,new", [(37, 27), (4, 3), (3, 5)])
def test_bicubic_pos_resize_matches_jax_image_resize(rng, old, new):
    """jax.image.resize bicubic (antialiased Keys a = -0.5) as separable
    numpy weights; 37 -> 27 is DinoV2's 518 px grid at 384 px."""
    from vla_touch_tpu_torch.models.encoders.vit import interpolate_pos_embed

    D = 8
    pos = rng.normal(size=(1, 1 + old * old, D)).astype(np.float32)
    grid = jnp.asarray(pos[:, 1:].reshape(1, old, old, D))
    want = jax.image.resize(grid, (1, new, new, D), method="bicubic")
    got = interpolate_pos_embed(_t(pos), new, old, has_cls=True)
    _close(got[:, :1], pos[:, :1], atol=0, rtol=0)
    _close(got[:, 1:].reshape(1, new, new, D), want)


def _vit_pair(rng, cfg_kw, image_size, px, dino):
    from vla_touch_tpu.models.encoders import vit as JV
    from vla_touch_tpu_torch.models.encoders import vit as TV

    jcfg = JV.ViTConfig(image_size=image_size, **cfg_kw)
    tcfg = TV.ViTConfig(image_size=image_size, **cfg_kw)
    jcls = JV.DinoV2Encoder if dino else JV.SiglipVisionEncoder
    tcls = TV.DinoV2Encoder if dino else TV.SiglipVisionEncoder
    pixels = rng.normal(size=(2, px, px, 3)).astype(np.float32)
    params = jax.jit(jcls(jcfg).init)(jax.random.PRNGKey(5), jnp.asarray(pixels))["params"]
    want = jax.jit(jcls(jcfg).apply)({"params": params}, jnp.asarray(pixels))
    got = _port(tcls(tcfg), FF.vit(params))(_t(pixels))
    return got, want


def test_siglip_encoder_matches_jax(rng):
    kw = dict(hidden_size=48, num_layers=2, num_heads=4, mlp_dim=96,
              patch_size=14, use_cls_token=False, use_layerscale=False,
              gelu_tanh=True)
    got, want = _vit_pair(rng, kw, 28, 30, dino=False)   # 30 px: VALID patchify
    assert got.shape == (2, 4, 48)
    _close(got, want)


def test_dinov2_encoder_non_native_size_matches_jax(rng):
    """Native grid 4 (56 px) run at 42 px: the bicubic pos-embed resize."""
    kw = dict(hidden_size=48, num_layers=2, num_heads=6, mlp_dim=64,
              patch_size=14)
    got, want = _vit_pair(rng, kw, 56, 42, dino=True)
    assert got.shape == (2, 48)
    _close(got, want)


def test_vit_additive_mask_attention_matches_jax(rng):
    from vla_touch_tpu.models.encoders import vit as JV
    from vla_touch_tpu_torch.models.encoders import vit as TV

    cfg_kw = dict(hidden_size=32, num_layers=1, num_heads=4, mlp_dim=64)
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    mask = np.where(np.tril(np.ones((6, 6), bool)), 0.0, -1e9)[None, None]
    jm = JV.ViTSelfAttention(JV.ViTConfig(**cfg_kw))
    p = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), jnp.asarray(mask))["params"]
    got = _port(TV.ViTSelfAttention(TV.ViTConfig(**cfg_kw)),
                FF.to_state_dict(p))(_t(x), _t(mask))
    _close(got, jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask)))


# --------------------------------------------------------------- UNet -----

def _unet_pair(seed, input_dim=10, down_dims=(32, 64, 64), G=24, B=2, T=16):
    from vla_touch_tpu.models.controllers.unet1d import ConditionalUnet1D as JU
    from vla_touch_tpu_torch.models.controllers.unet1d import ConditionalUnet1D as TU

    r = np.random.default_rng(seed)
    x = r.normal(size=(B, T, input_dim)).astype(np.float32)
    t = np.array([0.3, 0.7], np.float32)[:B]
    cond = r.normal(size=(B, G)).astype(np.float32)
    ju = JU(input_dim=input_dim, down_dims=down_dims)
    params = jax.jit(ju.init)(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(cond))["params"]
    tu = _port(TU(input_dim, G, down_dims=down_dims), FF.unet1d(params))
    return ju, params, tu, (x, t, cond)


def test_unet1d_matches_jax():
    ju, params, tu, (x, t, cond) = _unet_pair(0)
    want = jax.jit(ju.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t),
                             jnp.asarray(cond))
    _close(tu(_t(x), _t(t), _t(cond)), want)


def _block_case(seed, S, B, T, Cin, C, G):
    """Flax block params (stacked over S) -> the port's kernel layout."""
    from vla_touch_tpu.models.controllers.unet1d import ConditionalResidualBlock1D as JB
    from vla_touch_tpu_torch.models.controllers import unet1d as TU
    from vla_touch_tpu_torch.models.controllers import unet1d_serve as US

    r = np.random.default_rng(seed)
    x = r.normal(size=(S, B, T, Cin)).astype(np.float32)
    cond = r.normal(size=(S, B, G)).astype(np.float32)
    block = JB(C, kernel_size=5)
    plist = [block.init(jax.random.PRNGKey(seed + s), jnp.asarray(x[s]),
                        jnp.asarray(cond[s]))["params"] for s in range(S)]
    stacked_j = jax.tree.map(lambda *a: jnp.stack(a), *plist)
    leaves = []
    for p in plist:
        tb = _port(TU.ConditionalResidualBlock1D(Cin, C, G, kernel_size=5),
                   FF.to_state_dict(p))
        leaves.append(US._resblock_leaves(tb))
    stacked_t = {k: torch.stack([l[k] for l in leaves]) for k in leaves[0]}
    return x, cond, stacked_j, stacked_t


@pytest.mark.parametrize("S,B,T,Cin,C,G", [
    (2, 1, 16, 48, 64, 32),     # stacked v/s, Cin != C (1x1 residual conv)
    (1, 2, 16, 10, 32, 24),     # the Cin = 10 first block
    (2, 1, 4, 64, 64, 32),      # identity residual
    (2, 1, 8, 128, 64, 32),     # T 8, Cin = 2C: the up path's concatenation
])
def test_resblock_ref_matches_pallas_interpret(S, B, T, Cin, C, G):
    """K2's plain version against the TPU kernel in interpret mode (which
    rounds its matmul operands to bf16: tolerance 2e-2, as the JAX package's
    own kernel test) and against the flax block math (1e-5)."""
    from vla_touch_tpu.ops.pallas_unet import resblock_fused as j_fused
    from vla_touch_tpu.ops.pallas_unet import resblock_ref as j_ref
    from vla_touch_tpu_torch.ops import unet_kernels as UK

    x, cond, pj, pt = _block_case(11 * C + Cin, S, B, T, Cin, C, G)
    before = UK.resblock_fused.launches
    got = UK.resblock_fused(_t(x), _t(cond), pt)
    assert UK.resblock_fused.launches == before      # CPU: plain, no launch
    assert got.shape == (S, B, T, C)
    want_k = j_fused(jnp.asarray(x), jnp.asarray(cond), pj, interpret=True,
                     out_dtype=jnp.float32)
    _close(got, want_k, atol=2e-2, rtol=2e-2)
    _close(got, j_ref(jnp.asarray(x), jnp.asarray(cond), pj))


# (T, Cin, C) of the 12 blocks of one BRIDGeR UNet pass, and two narrow ones
K2_PLAN_CASES = [(16, 10, 256), (16, 256, 256), (8, 256, 512), (8, 512, 512), (4, 512, 512),
                 (4, 1024, 512), (8, 1024, 256), (8, 256, 256), (16, 48, 64), (4, 64, 64)]


@pytest.mark.parametrize("n_ctas", [264, 132, 16])
@pytest.mark.parametrize("T,Cin,C", K2_PLAN_CASES)
def test_k2_plan_covers_every_reduction_row_once(T, Cin, C, n_ctas):
    """K2's plan for a grid of ``n_ctas`` blocks: each product's splits
    cover its mma steps exactly once and each non-empty, so every reduction
    row (tap, input channel) of every column tile is summed exactly once
    (the channels past Cin of the last 16-row step are the kernel's zero
    fill); the items of each phase fit the grid unless every split is
    already one; the scratch holds every split's partial."""
    from vla_touch_tpu_torch.ops import unet_kernels as UK

    S, G, k = 2, 512, 5
    has_res = Cin != C
    plan = UK.k2_plan(Cin, C, G, k, S, n_ctas, has_res)
    steps = UK.k2_steps(Cin, C, G, k, has_res)
    assert set(plan) == set(steps)
    rci = {"conv0": Cin, "film": G, "res": Cin, "conv1": C}
    taps = {"conv0": k, "film": 1, "res": 1, "conv1": k}
    for job, (n_steps, tiles) in steps.items():
        splits = plan[job]
        assert 1 <= splits <= n_steps
        rows = np.zeros((taps[job], -(-rci[job] // 16) * 16), int)
        for z in range(splits):
            st0, st1 = UK.k2_split_steps(n_steps, splits, z)
            assert st1 > st0
            for st in range(st0, st1):
                c16, d = divmod(st, taps[job])
                rows[d, 16 * c16: 16 * c16 + 16] += 1
        assert np.all(rows == 1)
        assert tiles * UK.K2_COLS >= (2 * C if job == "film" else C) > (tiles - 1) * UK.K2_COLS
    for phase in ([j for j in steps if j != "conv1"], ["conv1"]):
        items = S * sum(steps[j][1] * plan[j] for j in phase)
        assert items <= n_ctas or all(plan[j] == 1 for j in phase)
    tc = S * T * C
    want = 4 * (tc * (plan["conv0"] + plan.get("res", 0) + plan["conv1"])
                + S * 2 * C * plan["film"]) + 2 * tc
    assert UK.k2_scratch_bytes(S, 1, T, C, plan) == want


def test_unet_forward_stacked_matches_flax():
    from vla_touch_tpu_torch.models.controllers import unet1d_serve as US

    ju, p1, tu1, (x, t, cond) = _unet_pair(1)
    _, p2, tu2, _ = _unet_pair(2)
    apply = jax.jit(ju.apply)
    want = np.stack([apply({"params": p}, jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(cond)) for p in (p1, p2)])
    stacked = US.stack_unets([tu1, tu2], dtype=torch.float32)
    got = US.unet_forward_stacked(stacked, _t(x), _t(t), _t(cond),
                                  down_dims=(32, 64, 64))
    _close(got, want)


# ----------------------------------------------------- SDE + BRIDGeR ------

def _sde_noise(key, n, shape):
    """The Brownian draws of the JAX sde_sample scan for ``key``."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


def test_interpolant_schedules_and_sde_match_jax(rng):
    from vla_touch_tpu.config import InterpolantConfig as JIC
    from vla_touch_tpu.models.controllers import interpolants as JI
    from vla_touch_tpu_torch.config import InterpolantConfig as TIC
    from vla_touch_tpu_torch.models.controllers import interpolants as TI

    t = np.linspace(0.001, 0.999, 9).astype(np.float32)
    for g in ("(2t(t-1))^0.5", "2^0.5*t(t-1)", "(1-t)^2(2t)^0.5"):
        jc, tc = JIC(gamma_type=g), TIC(gamma_type=g)
        for f in ("gamma", "gamma_der", "gamma_inv"):
            _close(getattr(TI, f)(tc, _t(t)), getattr(JI, f)(jc, jnp.asarray(t)))
    for e in ("t(t-1)", "1-t", "1-sqrt(t)", "1-t^2", "0"):
        _close(TI.epsilon(TIC(epsilon_type=e), _t(t)),
               JI.epsilon(JIC(epsilon_type=e), jnp.asarray(t)))

    w = rng.normal(size=(4, 4)).astype(np.float32) * 0.5
    x0 = rng.normal(size=(2, 8, 4)).astype(np.float32)
    cond = rng.normal(size=(2, 4)).astype(np.float32)
    jnets = {"v": lambda x, tt, c: jnp.tanh(x @ w) + c[:, None] * tt[:, None, None],
             "s": lambda x, tt, c: jnp.sin(x) * 0.1}
    tnets = {"v": lambda x, tt, c: torch.tanh(x @ _t(w)) + c[:, None] * tt[:, None, None],
             "s": lambda x, tt, c: torch.sin(x) * 0.1}
    key = jax.random.PRNGKey(4)
    want = JI.sde_sample(JIC(), jnets, jnp.asarray(x0), jnp.asarray(cond), key)
    got = TI.sde_sample(TIC(), tnets, _t(x0), _t(cond),
                        noise_seq=_sde_noise(key, 10, x0.shape))
    _close(got, want)
