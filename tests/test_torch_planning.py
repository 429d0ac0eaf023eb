"""PyTorch port, the planning level against the JAX package on the CPU: the
Qwen2-architecture decoder (configs, norm, RoPE, GQA attention, forward on
float / int8 / int4 / fused trees, greedy and sampled decoding with JAX's
Gumbel noise replayed, LoRA), the plain versions and dispatch of K9 (w4
SwiGLU) and K10 (w4 post-attention) against the Pallas kernels in
interpret mode, the megakernel decode route against JAX's on a forced TPU
backend in interpret mode, the tactile encoder, projector and splice, the
serving entry points and ``reason_llm`` end to end, the tree converters
and the port's import hygiene.

Inputs come from numpy seeds and go to both; JAX trees convert through
``utils/from_flax.py``.  Tolerances are stated per test.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
from jax.experimental.pallas import tpu as pltpu
from PIL import Image

from vla_touch_tpu.models.encoders import vit as JV
from vla_touch_tpu.ops import pallas_matmul as JPM
from vla_touch_tpu.ops.quant import quantize_linear_w4 as jq_w4
from vla_touch_tpu.planning import encoder as JE
from vla_touch_tpu.planning import llm as JL
from vla_touch_tpu.planning import llm_splice as JS
from vla_touch_tpu.planning import run_llm as JR
from vla_touch_tpu.planning import serving as JSV
from vla_touch_tpu_torch.models.encoders import vit as TV
from vla_touch_tpu_torch.ops import w4_fused as W4F
from vla_touch_tpu_torch.planning import datasets as TD
from vla_touch_tpu_torch.planning import encoder as TE
from vla_touch_tpu_torch.planning import llm as TL
from vla_touch_tpu_torch.planning import llm_splice as TS
from vla_touch_tpu_torch.planning import run_llm as TR
from vla_touch_tpu_torch.planning import serving as TSV
from vla_touch_tpu_torch.utils import from_flax as FF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = JL.qwen2_tiny()
TCFG = TL.qwen2_tiny()
CLIP_KW = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128, patch_size=16,
               image_size=32, use_layerscale=False, quick_gelu=True, use_pre_norm=True,
               layernorm_eps=1e-5, patch_bias=False)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a, dtype=None):
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.fixture(scope="module")
def jparams():
    p = JL.init_llm(CFG, jax.random.PRNGKey(0))
    # the untrained embedding's 0.02 scale leaves near-uniform logits; a
    # wider one gives greedy decoding clear maxima
    p["embed"] = p["embed"] * 50.0
    return p


@pytest.fixture(scope="module")
def trees(jparams):
    """{name: (JAX tree, port tree)} for float, int8, int4 and fused int4."""
    q8 = JL.quantize_llm_params(jparams, "int8")
    q4 = JL.quantize_llm_params(jparams, "int4")
    out = {"float": jparams, "int8": q8, "int4": q4, "fused": JL.fuse_quantized_layers(q4)}
    return {k: (v, FF.llm(v, TCFG, device="cpu")) for k, v in out.items()}


# ---- configs and the pieces of a layer -------------------------------------------

def test_configs_match_jax_field_for_field():
    for name in ("qwen2_tiny", "qwen25_7b", "llama31_8b"):
        assert _fields(getattr(TL, name)()) == _fields(getattr(JL, name)()), name
    for model_type in ("qwen2.5-7b", "llama-3.1-8b"):
        assert _fields(TL.backbone(model_type)) == _fields(JL.backbone(model_type))
    for name in ("CLIP_VIT_B16", "SIGLIP_SO400M", "DINOV2_SMALL"):
        assert _fields(getattr(TV, name)) == _fields(getattr(JV, name)), name
    assert TL.qwen25_7b().head_dim == 128


def test_rmsnorm_rope_attend_match_jax(rng):
    """float32 pieces: 1e-6 relative (same operations, other order);
    M-RoPE with (3, B, L) positions; GQA maps query head h to KV head
    h // rep (``jnp.repeat``, not ``Tensor.repeat``)."""
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(TL._rmsnorm(_t(x), _t(w), 1e-6).numpy(),
                               _np(JL._rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
                               rtol=1e-6, atol=1e-6)
    pos = rng.integers(0, 300, size=(2, 5))
    np.testing.assert_allclose(TL._rope(_t(x), _t(pos), 1e6).numpy(),
                               _np(JL._rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
                               rtol=1e-5, atol=2e-5)
    pos3 = rng.integers(0, 50, size=(3, 2, 5))
    np.testing.assert_allclose(
        TL._rope(_t(x), _t(pos3), 1e4, (4, 6, 6)).numpy(),
        _np(JL._rope(jnp.asarray(x), jnp.asarray(pos3), 1e4, (4, 6, 6))), rtol=1e-5, atol=2e-5)
    q = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 7, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 7, 2, 16)).astype(np.float32)
    mask = rng.random((2, 5, 7)) < 0.7
    mask[:, :, 0] = True
    got = TL._attend(_t(q), _t(k), _t(v), _t(mask)).numpy()
    want = _np(JL._attend(*(jnp.asarray(a) for a in (q, k, v, mask))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    wrong = TL._attend(_t(q), _t(k).repeat(1, 1, 2, 1), _t(v).repeat(1, 1, 2, 1), _t(mask))
    assert np.abs(wrong.numpy() - want).max() > 1e-2


# ---- forward and decoding ----------------------------------------------------------

@pytest.mark.parametrize("tree,dtype,tol", [
    ("float", "float32", 1e-5), ("int8", "float32", 1e-5), ("int4", "float32", 1e-5),
    ("fused", "float32", 1e-5), ("int8", "bfloat16", 3e-2), ("fused", "bfloat16", 3e-2)])
def test_llm_forward_matches_jax(trees, rng, tree, dtype, tol):
    """Hidden states, max abs error <= tol x max|jax|.  float32 activations:
    the same integer codes and float32 arithmetic (1e-5).  bf16 activations
    run the port's kernel wrappers (plain on the CPU) against JAX's XLA
    route: a few bf16 steps of the O(4) outputs where a bf16 rounding of an
    intermediate falls the other way (3e-2)."""
    jt, tt = trees[tree]
    x = rng.normal(size=(2, 9, CFG.hidden_size)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = _np(JL.llm_forward(CFG, jt, jnp.asarray(x, jd)))
    got = TL.llm_forward(TCFG, tt, _t(x, td)).float().numpy()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _lora(seed):
    lo = JL.init_lora(CFG, jax.random.PRNGKey(seed), rank=4)
    r = np.random.default_rng(seed)
    for lp in lo["layers"]:
        for ab in lp.values():
            ab["B"] = jnp.asarray(r.normal(size=ab["B"].shape) * 0.05, jnp.float32)
    return lo


@pytest.mark.parametrize("with_lora", [False, True])
def test_greedy_generate_matches_jax(trees, rng, with_lora):
    """Float32 tree, two prompts: tokens equal, entropies within 1e-4 nats
    (float32 sums in other orders); LoRA as a runtime residual and merged."""
    jt, tt = trees["float"]
    lora = _lora(1) if with_lora else None
    tlora = FF.llm_lora(lora, device="cpu") if with_lora else None
    x = rng.normal(size=(2, 6, CFG.hidden_size)).astype(np.float32)
    jtok, jent, jlen = JL.greedy_generate(CFG, jt, jnp.asarray(x), max_new_tokens=8,
                                          eos_id=3, lora=lora)
    ttok, tent, tlen = TL.greedy_generate(TCFG, tt, _t(x), max_new_tokens=8, eos_id=3,
                                          lora=tlora)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_allclose(tent.numpy(), np.asarray(jent), atol=1e-4)
    if with_lora:
        merged = TL.merge_lora(tt, tlora)
        mtok, _, _ = TL.greedy_generate(TCFG, merged, _t(x), max_new_tokens=8, eos_id=3)
        np.testing.assert_array_equal(mtok.numpy(), np.asarray(jtok))


def _jax_gumbel(seed, T, BN, V):
    """The noise of each step of JAX's ``_generate_impl`` for key ``seed``."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(T):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(k, (BN, V), jnp.float32)))
    return np.stack(out)


def test_sample_generate_replays_jax_keys(trees, rng):
    """``jax.random.categorical`` is argmax(logits + gumbel): handed JAX's
    per-step noise, the port draws JAX's tokens (B = 2 prompts x N = 3
    samples, EOS latching included) and its surprisals within 1e-4 bits."""
    lg = rng.normal(size=(4, 50)).astype(np.float32)
    k = jax.random.PRNGKey(7)
    assert np.array_equal(np.asarray(jax.random.categorical(k, jnp.asarray(lg))),
                          np.argmax(lg + np.asarray(jax.random.gumbel(k, (4, 50))), -1))
    jt, tt = trees["float"]
    x = rng.normal(size=(2, 5, CFG.hidden_size)).astype(np.float32)
    T, N = 10, 3
    jtok, _, jsur, jlen = JL.sample_generate(CFG, jt, jnp.asarray(x), jax.random.PRNGKey(5),
                                             max_new_tokens=T, eos_id=7, temperature=0.7,
                                             num_return_sequences=N)
    g = _t(_jax_gumbel(5, T, 2 * N, CFG.vocab_size))
    ttok, _, tsur, tlen = TL.sample_generate(TCFG, tt, _t(x), max_new_tokens=T, eos_id=7,
                                             temperature=0.7, num_return_sequences=N, gumbel=g)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_allclose(tsur.numpy(), np.asarray(jsur), atol=1e-4)
    np.testing.assert_allclose(TL.sequence_avg_surprisal(tsur, tlen).numpy(),
                               np.asarray(JL.sequence_avg_surprisal(jsur, jlen)), atol=1e-4)
    a, _, _, _ = TL.sample_generate(TCFG, tt, _t(x), seed=3, max_new_tokens=4, eos_id=7,
                                    num_return_sequences=2)
    b, _, _, _ = TL.sample_generate(TCFG, tt, _t(x), seed=3, max_new_tokens=4, eos_id=7,
                                    num_return_sequences=2)
    assert torch.equal(a, b) and a.shape == (4, 4)


def test_argmax_ties_on_bf16_logits_pick_the_first():
    row = np.array([[0.5, 1.25, -2.0, 1.25, 1.25], [3.0, 3.0, 3.0, 3.0, 3.0]], np.float32)
    want = np.asarray(jnp.argmax(jnp.asarray(row, jnp.bfloat16), axis=-1))
    got = torch.argmax(_t(row, torch.bfloat16), dim=-1).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [1, 0])


def test_megakernel_decode_matches_jax_interpret(trees, rng, monkeypatch):
    """The MEGAKERNELS routes (K9 in the prompt pass, K10 in each decode
    step) on the fused int4 tree with bf16 activations, against the JAX
    decode on a forced TPU backend with its Pallas kernels (K8, K9, K10) in
    interpret mode.  The port's routes are forced onto CPU tensors, where
    the wrappers compute their plain versions.  Tokens equal; entropies
    within 2e-2 nats (bf16 activations, and the kernels' amax * (1/127)
    against the plain versions' amax / 127)."""
    jt = dict(trees["fused"][0], embed=trees["fused"][0]["embed"].astype(jnp.bfloat16))
    tt = FF.llm(jt, TCFG, device="cpu")
    x = rng.normal(size=(1, 6, CFG.hidden_size)).astype(np.float32)

    class TPU:
        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def default_backend():
            return "tpu"

    monkeypatch.setattr(JL, "jax", TPU())
    monkeypatch.setattr(JL, "MEGAKERNELS", True)
    jax.clear_caches()
    try:
        with pltpu.force_tpu_interpret_mode():
            jtok, jent, _ = JL.greedy_generate(CFG, jt, jnp.asarray(x, jnp.bfloat16),
                                               max_new_tokens=4, eos_id=3)
            jtok, jent = np.asarray(jtok), np.asarray(jent)
    finally:
        jax.clear_caches()
    routes = []
    monkeypatch.setattr(TL, "_kernel_device", lambda t: True)
    monkeypatch.setattr(TL, "MEGAKERNELS", True)
    for name in ("qdense_kernel_swiglu", "w4_postattn_fused"):
        fn = getattr(W4F, name)
        monkeypatch.setattr(W4F, name, lambda *a, _fn=fn, _n=name, **k: (routes.append(_n),
                                                                          _fn(*a, **k))[1])
    ttok, tent, _ = TL.greedy_generate(TCFG, tt, _t(x, torch.bfloat16), max_new_tokens=4,
                                       eos_id=3)
    assert routes.count("qdense_kernel_swiglu") == CFG.num_layers
    assert routes.count("w4_postattn_fused") == 3 * CFG.num_layers
    np.testing.assert_array_equal(ttok.numpy(), jtok)
    np.testing.assert_allclose(tent.numpy(), jent, atol=2e-2)


# ---- K9 and K10: plain versions and routes against the Pallas kernels -------------

def _w4_leaf(rng, K, N, gs=128, bias=False):
    j = jq_w4({"kernel": rng.normal(size=(K, N)).astype(np.float32) * 0.05,
               **({"bias": rng.normal(size=(N,)).astype(np.float32) * 0.01} if bias else {})},
              group_size=gs)
    return j, FF._llm_leaf(dict(j), "cpu")


@pytest.mark.parametrize("K,F,N,gs_down,M", [(256, 512, 256, 128, 1), (256, 2176, 256, 32, 3),
                                             (256, 512, 256, 128, 40), (256, 64, 64, 128, 2)])
def test_w4_swiglu_matches_jax_kernel(rng, K, F, N, gs_down, M):
    """K9: the plain version (float32 out) against ``w4_swiglu_mlp`` in
    interpret mode over unrolled (G <= 32) and rolled (G = 68) down
    projections, within JAX's own kernel-vs-reference bound (2e-4
    relative; the kernel's amax * (1/127) against amax / 127); the
    dispatcher (bf16 out) within one bf16 step of the O(3) outputs; M = 40
    takes the composed route, and F = 64 (not a multiple of 128) the
    composed fallback."""
    jgu, tgu = _w4_leaf(rng, K, 2 * F, bias=True)
    jdn, tdn = _w4_leaf(rng, F, N, gs=gs_down)
    x = rng.normal(size=(M, K)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = _np(JPM.qdense_pallas_swiglu(xj, jgu, jdn, out_dtype=jnp.float32, interpret=True))
    xt = _t(x, torch.bfloat16)
    got = W4F.qdense_kernel_swiglu(xt, tgu, tdn).float().numpy()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    if W4F._swiglu_shape_ok(M, K, tgu, tdn):
        plain = W4F.w4_swiglu_plain(xt, tgu, tdn, out_dtype=torch.float32).numpy()
        np.testing.assert_allclose(plain, want, rtol=2e-4, atol=2e-5)
    else:
        assert M > 32 or F % 128


@pytest.mark.parametrize("Ka,D,F,M", [(384, 256, 512, 2), (384, 256, 512, 40), (128, 64, 64, 2)])
def test_w4_postattn_matches_jax_kernel(rng, Ka, D, F, M):
    """K10 against ``w4_postattn_fused`` in interpret mode: the fused case
    (M = 2) bf16 out within JAX's own kernel-vs-reference bound (1e-3
    relative, 1e-4 absolute, on O(4) outputs); M = 40 and the unfriendly
    dims (D = F = 64) take the composed route, within one bf16 step
    (3e-2 relative, as JAX bounds its own fallback)."""
    jo, to = _w4_leaf(rng, Ka, D)
    jgu, tgu = _w4_leaf(rng, D, 2 * F)
    jdn, tdn = _w4_leaf(rng, F, D)
    nw = (rng.normal(size=(D,)) * 0.2 + 1.0).astype(np.float32)
    x = rng.normal(size=(M, 1, D)).astype(np.float32)
    att = rng.normal(size=(M, 1, Ka)).astype(np.float32)
    bf = jnp.bfloat16
    want = _np(JPM.w4_postattn_fused(jnp.asarray(x, bf), jnp.asarray(att, bf), jo, jgu, jdn,
                                     jnp.asarray(nw), eps=1e-6, interpret=True))
    got = W4F.w4_postattn_fused(_t(x, torch.bfloat16), _t(att, torch.bfloat16), to, tgu, tdn,
                                _t(nw), eps=1e-6).float().numpy()
    assert got.shape == want.shape
    if W4F._postattn_shape_ok(M, Ka, D, to, tgu, tdn):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=3e-2, atol=5e-2)


def _mk_sums(codes, qp):
    """The float32 sums (M, N) before the row scale of a w4 product as the
    megakernels take them: per-group int32 dots; a unit u (groups u and u +
    G/2) folded into a warp's sum as acc + lo * s_lo, then + hi * s_hi; the
    8 warps of a tile taking units w, w + 8, ...; warps added in warp
    order."""
    from vla_touch_tpu_torch.ops import quant as Q

    G, N = qp.scale4.shape
    K = codes.shape[1]
    gs, HG = K // G, G // 2
    w = Q.unpack_w4(qp.w4_pack).int()
    dots = [(codes[:, g * gs:(g + 1) * gs].int() @ w[:, g * gs:(g + 1) * gs].t()).float()
            for g in range(G)]
    warps = []
    for wq in range(8):
        acc = torch.zeros((codes.shape[0], N), dtype=torch.float32)
        for u in range(wq, HG, 8):
            acc = acc + dots[u] * qp.scale4[u]
            acc = acc + dots[u + HG] * qp.scale4[u + HG]
        warps.append(acc)
    s = warps[0]
    for acc in warps[1:]:
        s = s + acc
    return s


def _mk_codes(x):
    """The megakernels' per-row int8 codes and row scale amax * (1/127)."""
    from vla_touch_tpu_torch.ops import quant as Q

    codes, amax = Q.quantize_rows(x.float())
    return codes, amax * np.float32(1.0 / 127.0)


def _k10_sum_order(x, att, o, gu, down, nw, eps):
    """K10 (``csrc/w4_postattn.cu``) in float32 on the CPU, each sum in the
    kernel's order."""
    bf = torch.bfloat16
    D, F = x.shape[1], gu.w4_pack.shape[0] // 2
    ca, ra = _mk_codes(att)
    ob = (_mk_sums(ca, o) * ra).to(bf).float()
    x2 = (x.float() + ob).to(bf)
    xf = x2.float()
    r = 1.0 / torch.sqrt((xf * xf).sum(-1, keepdim=True) / D + eps)
    h = ((xf * r) * nw).to(bf)
    ch, rh = _mk_codes(h)
    gsum = _mk_sums(ch, gu) * rh
    g, u = gsum[:, :F].to(bf), gsum[:, F:].to(bf)
    act = W4F.silu_mul(g, u)
    cact, ract = _mk_codes(act)
    y = (_mk_sums(cact, down) * ract).to(bf).float()
    return (x2.float() + y).to(bf)


@pytest.mark.parametrize("Ka,D,F,M", [(1024, 256, 1024, 3), (256, 256, 2048, 8)])
def test_k10_sum_order_matches_jax_kernel(rng, Ka, D, F, M):
    """K10's sums taken in its order (each of o's, gate|up's and down's 8
    warps over every eighth unit, the warps added in order) stay within
    MK_TOL (2e-2 x max|out|) of JAX's ``w4_postattn_fused`` in interpret
    mode, o over 4 or 1 units (pairs of 128-wide groups), down over 4 or 8."""
    jo, to = _w4_leaf(rng, Ka, D)
    jgu, tgu = _w4_leaf(rng, D, 2 * F)
    jdn, tdn = _w4_leaf(rng, F, D)
    nw = (rng.normal(size=(D,)) * 0.2 + 1.0).astype(np.float32)
    x = rng.normal(size=(M, D)).astype(np.float32)
    att = rng.normal(size=(M, Ka)).astype(np.float32)
    bf = jnp.bfloat16
    want = _np(JPM.w4_postattn_fused(jnp.asarray(x, bf), jnp.asarray(att, bf), jo, jgu, jdn,
                                     jnp.asarray(nw), eps=1e-6, interpret=True))
    got = _k10_sum_order(_t(x, torch.bfloat16), _t(att, torch.bfloat16), to, tgu, tdn, _t(nw),
                         1e-6)
    assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("tree", ["int8", "int4"])
def test_swiglu_mlp_matches_jax_bit_for_bit(trees, monkeypatch, tree):
    """The composed MLP of the int8 and unfused w4 trees (gate, up, SiLU *
    up, per-token int8 requantization, down) on bf16 activations equals
    JAX's bit for bit: the SiLU rounds after each operation, as XLA's
    does.  ``F.silu``, which rounds once, moves the requantized product and
    so the output on these inputs (g, u ~ N(0, 9))."""
    import torch.nn.functional as F

    jt, tt = trees[tree]
    h = np.random.default_rng(7).normal(size=(4, 9, CFG.hidden_size)) * 3
    hj = jnp.asarray(h, jnp.bfloat16)
    ht = _t(_np(hj), torch.bfloat16)
    want = _np(JL._mlp(jt["layers"][0], {}, 1.0, hj))
    got = TL._mlp(tt.layers[0], {}, 1.0, ht).float().numpy()
    np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(TL, "silu", F.silu)
    assert np.any(TL._mlp(tt.layers[0], {}, 1.0, ht).float().numpy() != want)


def test_silu_mul_matches_jax(rng):
    g = rng.normal(size=(64,)).astype(np.float32) * 3
    u = rng.normal(size=(64,)).astype(np.float32)
    bf = jnp.bfloat16
    want = _np(JPM._silu_mul(jnp.asarray(g, bf), jnp.asarray(u, bf)))
    got = W4F.silu_mul(_t(g, torch.bfloat16), _t(u, torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)


# ---- tactile encoder, projector, splice ---------------------------------------------

@pytest.fixture(scope="module")
def encoders():
    jcfg = JV.ViTConfig(**CLIP_KW)
    jst = JE.init_tactile_encoder(jcfg, jax.random.PRNGKey(1))
    return jst, FF.tactile_encoder(jst, device="cpu")


def test_tactile_encoder_matches_jax(encoders, rng):
    """ViFiCLIP video feature (CLIP at 32 x 32, patch 16, pre-norm, quick
    GELU, no patch bias; frame mean; L2 norm), the adapter and the
    classifier, float32: 1e-5."""
    jst, tst = encoders
    frames = rng.normal(size=(2, 3, 32, 32, 3)).astype(np.float32)
    want = _np(JE.encode_tactile_video(jst.cfg, jst.clip_params, jst.adapter_params,
                                       jnp.asarray(frames), "plain"))
    got = TE.encode_tactile_video(tst, _t(frames), "plain").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    video = _np(JE.ViFiCLIPVideo(jst.cfg).apply({"params": jst.clip_params},
                                                jnp.asarray(frames)))
    np.testing.assert_allclose(tst.clip(_t(frames)).numpy(), video, rtol=1e-5, atol=1e-5)
    props = _np(JE.classify_properties(jst.classifier_params, jnp.asarray(want)))
    np.testing.assert_allclose(TE.classify_properties(tst, _t(want)).numpy(), props,
                               rtol=1e-5, atol=1e-5)


def test_projector_and_splice_match_jax(rng):
    feats = rng.normal(size=(3, 64)).astype(np.float32)
    jp = JS.TactileProjector(128).init(jax.random.PRNGKey(2), jnp.zeros((1, 64)))["params"]
    tp = FF.tactile_projector(jp, device="cpu")
    want = _np(JS.TactileProjector(128).apply({"params": jp}, jnp.asarray(feats)))
    np.testing.assert_allclose(tp(_t(feats)).detach().numpy(), want, rtol=1e-5, atol=1e-6)
    assert TS.split_on_placeholders("a<tact>b<tact><tact>") == \
        JS.split_on_placeholders("a<tact>b<tact><tact>")
    D = 8
    start, end = rng.normal(size=(D,)).astype(np.float32), rng.normal(size=(D,)).astype(np.float32)
    table = {c: rng.normal(size=(D,)).astype(np.float32) for c in "abcdefgh"}

    def emb(s):
        return np.stack([table[c] for c in s])

    vids = [rng.normal(size=(D,)).astype(np.float32) for _ in range(2)]
    text = "ab<tact>cd<tact>"
    want = np.asarray(JS.process_user_input(text, vids, emb, lambda v: v, lambda f: f[None],
                                            start, end))
    got = TS.process_user_input(text, vids, lambda s: _t(emb(s)), lambda v: _t(v),
                                lambda f: f[None], _t(start), _t(end)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2 + 3 + 2 + 3 + 0, D)


def test_resize_and_png_match_opencv(tmp_path, rng):
    """The numpy INTER_CUBIC resize within one level of ``cv2.resize`` (its
    SIMD paths round a few per cent of pixels the other way), the same size
    a copy; ``load_video_frames`` reads OpenCV's filtered PNGs as RGB, in
    name order, and ``max_frames`` picks evenly spaced frames."""
    cv2 = pytest.importorskip("cv2")
    img = rng.integers(0, 256, (60, 80, 3)).astype(np.uint8)
    for size in (32, 100):
        ref = cv2.resize(img, (size, size), interpolation=cv2.INTER_CUBIC)
        assert np.abs(ref.astype(int) - TD.resize_cubic_u8(img, size)).max() <= 1
    np.testing.assert_array_equal(TD.resize_cubic_u8(img[:32, :32], 32), img[:32, :32])
    smooth = np.linspace(0, 255, 30 * 40 * 3).reshape(30, 40, 3).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "a.png"), smooth[:, :, ::-1])
    cv2.imwrite(str(tmp_path / "b.png"), img[:30, :40, ::-1])
    cv2.imwrite(str(tmp_path / "c.png"), 255 - smooth[:, :, ::-1])
    got = TD.load_video_frames(str(tmp_path))
    np.testing.assert_array_equal(got, np.stack([smooth, img[:30, :40], 255 - smooth]))
    np.testing.assert_array_equal(TD.load_video_frames(str(tmp_path), max_frames=2),
                                  got[[0, 2]])


# ---- the serving entry points end to end ----------------------------------------------

def _video(tmp_path, rng):
    d = tmp_path / "obj_0" / "tactile"
    d.mkdir(parents=True)
    frames = []
    for i in range(6):
        f = np.clip(100 + 20 * i * (i > 1) + rng.normal(0, 3, (32, 32, 3)), 0, 255)
        frames.append(f.astype(np.uint8))
        Image.fromarray(frames[-1]).save(str(d / f"{i:03d}.png"))
    return str(d), np.stack(frames)


def test_serving_and_reason_llm_match_jax(trees, encoders, tmp_path, rng):
    """describe / guess / ask and ``reason_llm`` (greedy turns) on the tiny
    float32 planner: the JAX and port services give the same texts and
    options, and properties within 1e-5."""
    jt, tt = trees["float"]
    jst, tst = encoders
    video, frames = _video(tmp_path, rng)
    jif = JR.make_llm_interface(CFG, jt, max_new_tokens=12)
    tif = TR.make_llm_interface(TCFG, tt, max_new_tokens=12)
    jsv = JSV.TactileDescriptionService(jst, llm_fn=lambda s: jif.generate_fn(jif.embed_text(s)),
                                        frame_size=32)
    tsv = TSV.TactileDescriptionService(tst, llm_fn=lambda s: tif.generate_fn(tif.embed_text(s)),
                                        frame_size=32)
    jd, td = jsv.describe(frames), tsv.describe(frames)
    assert td["description"] == jd["description"]
    np.testing.assert_allclose([td["hardness"], td["roughness"]],
                               [jd["hardness"], jd["roughness"]], rtol=1e-5, atol=1e-5)
    jg, tg = jsv.guess(frames, ["cup", "mango"]), tsv.guess(frames, ["cup", "mango"])
    assert (tg["generation"], tg["option"]) == (jg["generation"], jg["option"])
    assert tsv.ask("Soft?")["answer"] == jsv.ask("Soft?")["answer"]
    assert TSV.TactileDescriptionService(tst).describe(frames)["description"] == \
        JSV.TactileDescriptionService(jst).describe(frames)["description"]

    jp = JS.TactileProjector(CFG.hidden_size).init(
        jax.random.PRNGKey(3), jnp.zeros((1, CLIP_KW["hidden_size"])))["params"]
    row = {"info": {"scenario": "s", "target": "cup", "tactile": [video], "num_candidates": 2},
           "chat": [{"role": "user", "content": "Object 1: <tact_tokens>."},
                    {"role": "assistant", "content": "Soft."},
                    {"role": "user", "content": "Which? A) cup B) mango"},
                    {"role": "assistant", "content": "A"}]}
    jr = JR.reason_llm(jst, jif, jp, [row], str(tmp_path / "j"), frame_size=32)
    trr = TR.reason_llm(tst, tif, FF.tactile_projector(jp, device="cpu"), [row],
                        str(tmp_path / "t"), frame_size=32)
    (jrec,), (trec,) = jr["s_cup"], trr["s_cup"]
    assert trec["chat"][1]["content"] == jrec["chat"][1]["content"]
    assert trec["final_generation"] == jrec["final_generation"]
    assert os.path.exists(tmp_path / "t" / "reason" / "s_cup.json")
    cands = [{"text": "Answer: B", "avg_surprisal": 2.0}, {"text": "A)", "avg_surprisal": 1.0},
             {"text": "Answer: B", "avg_surprisal": 3.0}]
    for kind in ("best_of_n", "majority_voting"):
        assert TR.select_generation(cands, kind)[1:] == JR.select_generation(cands, kind)[1:]


# ---- converters and hygiene -------------------------------------------------------------

def test_from_flax_llm_consumes_every_leaf(trees):
    """Each JAX tree (float, int8, int4, fused) converts with no leaf left
    over, into the layouts the kernels read; a leaf the port does not know
    raises."""
    for name, (jt, tt) in trees.items():
        n_j = sum(np.asarray(a).size for a in jax.tree.leaves(jt))
        n_t = sum(t.numel() for t in tt.state_dict().values())
        assert n_t == n_j, name
    lp = trees["fused"][1].layers[0]
    assert "qkv" in lp and "gateup" in lp and "q" not in lp
    jw4 = trees["int4"][0]["layers"][0]["gate"]["w4_pack"]
    assert tuple(trees["int4"][1].layers[0].gate.w4_pack.shape) == jw4.shape[::-1]
    bad = dict(trees["float"][0])
    bad["layers"] = [dict(bad["layers"][0], extra=np.zeros(3))] + bad["layers"][1:]
    with pytest.raises(KeyError):
        FF.llm(bad, TCFG, device="cpu")
    with pytest.raises(RuntimeError if not torch.cuda.is_available() else TypeError):
        TL.init_llm(TCFG, 0)


def test_planning_modules_import_no_jax():
    """The port's planning modules (the tactile encoder's training, data
    and evaluation modules and the LLM's trainers among them) and the
    megakernel wrappers (with K9's autograd Function) import neither JAX
    nor the JAX package."""
    files = [os.path.join(ROOT, "vla_touch_tpu_torch", "ops", "w4_fused.py")]
    pdir = os.path.join(ROOT, "vla_touch_tpu_torch", "planning")
    files += [os.path.join(pdir, f) for f in sorted(os.listdir(pdir)) if f.endswith(".py")]
    pat = re.compile(r"^\s*(import jax|from jax|.*vla_touch_tpu\.)", re.M)
    for f in files:
        assert not pat.search(open(f).read()), f
    assert {"eval.py", "physiclear.py", "process_datasets.py", "train_encoder.py",
            "encoder.py", "datasets.py", "qa.py", "run_llm.py", "llm.py"} <= {
        os.path.basename(f) for f in files}
    assert len(files) >= 14
    # the planner's LLM training lives in these modules
    for name in ("train_projection", "train_projection_and_lora", "test_llm", "lora_in"):
        assert callable(getattr(TR, name)), name
    for name in ("init_lora", "lm_loss", "train_lm", "LORA_TARGETS"):
        assert hasattr(TL, name), name
    assert issubclass(W4F.W4SwigluFn, torch.autograd.Function)
