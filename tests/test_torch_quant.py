"""PyTorch port, int8/int4 RDT serving twin against the JAX package on the
CPU: the quantizers, the plain versions of K3/K4 (int8-KV flash attention),
K6 (a8w8) and K8 (w4a8) against the JAX Pallas kernels in interpret mode,
the quantized-tree converter, and the quantized chunk end to end at the
``rdt_tiny`` config, through ``rdt_predict_action_quant`` and through the
policy's ``step``.

The JAX chunk draws its starting noise from its key; the port is handed
the same draw as ``init_noise``.  Tolerances are stated per test.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
from jax.experimental.pallas import tpu as pltpu

from vla_touch_tpu.config import NoiseSchedulerConfig, rdt_tiny
from vla_touch_tpu.models.rdt import quant_serve as JQS
from vla_touch_tpu.models.rdt import runner as JR
from vla_touch_tpu.ops import pallas_attention as JPA
from vla_touch_tpu.ops import pallas_matmul as JPM
from vla_touch_tpu.ops import quant as JQ
from vla_touch_tpu_torch import config as TC
from vla_touch_tpu_torch.models.rdt import quant_serve as TQS
from vla_touch_tpu_torch.models.rdt import runner as TR
from vla_touch_tpu_torch.ops import flash_attention_q8 as FQ
from vla_touch_tpu_torch.ops import quant as TQ
from vla_touch_tpu_torch.ops import quant_matmul as QM
from vla_touch_tpu_torch.utils import from_flax as FF

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden")


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _linear(w_kn, b):
    """An nn.Linear holding the flax kernel (K, N) and bias."""
    lin = torch.nn.Linear(*w_kn.shape)
    with torch.no_grad():
        lin.weight.copy_(_t(w_kn.T))
        lin.bias.copy_(_t(b))
    return lin


# ---- the quantizers --------------------------------------------------------------

@pytest.mark.parametrize("K,N", [(256, 384), (48, 128), (2048, 256)])
def test_quantize_linear_matches_jax(rng, K, N):
    """int8 codes and scales bit-equal to JAX's (the kernel layout is the
    transpose of the flax kernel's)."""
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    b = rng.normal(size=N).astype(np.float32)
    jq = JQ.quantize_linear({"kernel": w, "bias": b})
    tq = TQ.quantize_linear(_linear(w, b))
    np.testing.assert_array_equal(tq.w_i8.numpy(), np.asarray(jq["w_i8"]).T)
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq["scale"]))
    np.testing.assert_array_equal(tq.bias.numpy(), b)


@pytest.mark.parametrize("K,N,gs", [(256, 384, 128), (1152, 64, 192), (320, 96, 160),
                                    (128, 64, 64), (48, 32, None), (96, 32, None)])
def test_quantize_linear_w4_matches_jax(rng, K, N, gs):
    """Plane-packed bytes and the clip-searched ``scale4`` bit-equal to
    JAX's, at group sizes 128, 192, 160 and 64 (where ``pick_group_size``
    falls below the requested 128); K = 48 and 96 have no valid int4 group
    size, so both raise and ``quantize_tree_w4`` falls back to int8."""
    w = (rng.normal(size=(K, N)) * 0.05).astype(np.float32)
    b = rng.normal(size=N).astype(np.float32)
    lin = _linear(w, b)
    if gs is None:
        with pytest.raises(ValueError):
            JQ.quantize_linear_w4({"kernel": w, "bias": b})
        with pytest.raises(ValueError):
            TQ.quantize_linear_w4(lin)
        holder = torch.nn.Module()
        holder.fc = lin
        TQ.quantize_tree_w4(holder)
        assert isinstance(holder.fc, TQ.QLinear)
        return
    j4 = JQ.quantize_linear_w4({"kernel": w, "bias": b})
    t4 = TQ.quantize_linear_w4(lin)
    assert t4.group_size == gs == K // np.asarray(j4["scale4"]).shape[0]
    np.testing.assert_array_equal(t4.w4_pack.numpy(), np.asarray(j4["w4_pack"]).T)
    np.testing.assert_array_equal(t4.scale4.numpy(), np.asarray(j4["scale4"]))
    np.testing.assert_array_equal(TQ.unpack_w4(t4.w4_pack).numpy(),
                                  np.asarray(JQ.unpack_w4(j4["w4_pack"], K)).T)


def test_pick_group_size_matches_jax():
    for K in range(32, 4800, 32):
        try:
            want = JQ.pick_group_size(K)
        except ValueError:
            with pytest.raises(ValueError):
                TQ.pick_group_size(K)
            continue
        assert TQ.pick_group_size(K) == want, K


# ---- K6 / K8 plain versions against the Pallas kernels ----------------------------

@pytest.mark.parametrize("M,K,N", [(67, 256, 384), (1, 128, 128), (64, 384, 256)])
def test_a8w8_plain_matches_jax_kernel(rng, M, K, N):
    """K6's plain version vs JAX's ``a8w8_matmul`` Pallas kernel in
    interpret mode, float32 out: <= 1e-5 relative."""
    w = (rng.normal(size=(K, N)) * K ** -0.5).astype(np.float32)
    b = rng.normal(size=N).astype(np.float32) * 0.1
    x = (rng.normal(size=(M, K)) * 2).astype(np.float32)
    jq = JQ.quantize_linear({"kernel": w, "bias": b})
    want = _np(JPM.a8w8_matmul(jnp.asarray(x, jnp.bfloat16), jq["w_i8"], jq["scale"],
                               jq["bias"], out_dtype=jnp.float32, interpret=True))
    tq = TQ.quantize_linear(_linear(w, b))
    got = QM.a8w8_plain(_t(x).to(torch.bfloat16), tq.w_i8, tq.scale, tq.bias,
                        out_dtype=torch.float32).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# (M, K, N, plan at 132 SMs) of every K6 call: the tick's eight linears
# (chip_smoke.QMM_SHAPES) and the planner int8 request's (K6_LLM_SHAPES)
K6_PLAN_CASES = [
    (67, 2048, 6144, (5, 2, 1)), (67, 2048, 2048, (5, 2, 2)), (67, 2048, 128, (5, 2, 2)),
    (64, 4096, 2048, (4, 2, 2)), (64, 2048, 2048, (4, 2, 2)), (64, 256, 2048, (4, 2, 1)),
    (1, 256, 2048, (1, 2, 1)), (1, 2048, 2048, (1, 2, 4)), (24, 3584, 3584, (2, 2, 2)),
    (24, 3584, 512, (2, 2, 8)), (24, 3584, 18944, (2, 4, 1)), (24, 18944, 3584, (2, 2, 2)),
    (1, 3584, 3584, (1, 2, 2)), (1, 3584, 512, (1, 2, 8)), (1, 3584, 18944, (1, 4, 1)),
    (1, 18944, 3584, (1, 2, 2)), (1, 3584, 152064, (1, 2, 1)),
]


@pytest.mark.parametrize("M,K,N,want", K6_PLAN_CASES)
def test_k6_split_plan_covers_every_chunk_once(M, K, N, want):
    """At 132 SMs: the plan named; every (column tile, 64-wide K chunk) of
    every row block in exactly one CTA, every split non-empty; at most one
    CTA per SM when the tiles alone do not fill the card, and one more
    split would overfill it unless K's chunks (at least 4 a split) or the
    cluster cap (8 CTAs, 2 at three or more row tiles) cap the splits
    (then they are at that cap)."""
    n_sms = 132
    plan = QM.k6_plan(M, N, K, n_sms)
    assert plan == want
    mt, wn, splits = plan
    tiles = QM.k6_tiles(M, N, plan)
    assert tiles == -(-M // (16 * mt)) * -(-N // (32 * wn))
    nc = -(-K // QM.K6_CHUNK)
    seen = np.zeros(nc, int)
    for z in range(splits):
        c0, c1 = QM.k6_split_chunks(nc, splits, z)
        assert c1 > c0
        seen[c0:c1] += 1
    assert np.all(seen == 1)
    ctas = tiles * splits
    cap = min(nc // QM.K6_MIN_CHUNKS, QM.K6_TALL_SPLITS if mt >= 3 else QM.K6_MAX_SPLITS)
    if tiles < n_sms:
        assert ctas <= n_sms
        assert ctas + tiles > n_sms or splits == max(1, cap)
    else:
        assert splits == 1


@pytest.mark.parametrize("M,K,N", [(67, 1040, 256), (1, 48, 64), (512, 4096, 128)])
def test_k6_split_plan_ragged_and_tall(M, K, N):
    """A K whose last chunk is partial (1040 = 16 x 64 + 16) and chunk counts
    that the splits do not divide: every chunk once; M = 512 takes seven
    80-row blocks."""
    mt, wn, splits = QM.k6_plan(M, N, K, 132)
    nc = -(-K // 64)
    bounds = [QM.k6_split_chunks(nc, splits, z) for z in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == nc
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert max(c1 - c0 for c0, c1 in bounds) - min(c1 - c0 for c0, c1 in bounds) <= 1
    assert -(-M // (16 * mt)) == (7 if M == 512 else 1)


def test_qdense_large_m_matches_jax(rng):
    """M > 512 (the dispatcher's plain route): the port's ``qdense`` vs
    JAX's XLA ``qdense``, float32 out, <= 1e-5 relative; the dispatcher
    returns ``qdense``'s bf16 output there."""
    K, N = 128, 64
    w = (rng.normal(size=(K, N)) * 0.1).astype(np.float32)
    b = rng.normal(size=N).astype(np.float32)
    x = rng.normal(size=(2, 300, K)).astype(np.float32)
    jq = JQ.quantize_linear({"kernel": w, "bias": b})
    want = _np(JQ.qdense(x, jq, out_dtype=jnp.float32))
    tq = TQ.quantize_linear(_linear(w, b))
    got = TQ.qdense(_t(x), tq, out_dtype=torch.float32).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert torch.equal(QM.qdense_kernel_a8w8(_t(x), tq), TQ.qdense(_t(x), tq))


@pytest.mark.parametrize("M,K,N", [(67, 256, 256), (1, 512, 128), (64, 1152, 128)])
def test_w4a8_plain_matches_jax_kernel(rng, M, K, N):
    """K8's plain version vs JAX's ``w4a8_matmul`` Pallas kernel in
    interpret mode (group sizes 128, 128, 192), float32 out:
    <= 1e-5 relative."""
    w = (rng.normal(size=(K, N)) * K ** -0.5).astype(np.float32)
    b = rng.normal(size=N).astype(np.float32) * 0.1
    x = (rng.normal(size=(M, K)) * 2).astype(np.float32)
    j4 = JQ.quantize_linear_w4({"kernel": w, "bias": b})
    want = _np(JPM.w4a8_matmul(jnp.asarray(x, jnp.bfloat16), j4["w4_pack"], j4["scale4"],
                               j4["bias"], out_dtype=jnp.float32, interpret=True))
    t4 = TQ.quantize_linear_w4(_linear(w, b))
    got = QM.w4a8_plain(_t(x).to(torch.bfloat16), t4.w4_pack, t4.scale4, t4.bias,
                        out_dtype=torch.float32).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_w4a8_plain_matches_jax_kernel_rolled_groups(rng):
    """K8's plain version vs JAX's ``w4a8_matmul`` in interpret mode in its
    rolled branch (G = 36 > 32 groups of 128: the ``fori_loop`` of
    ``_w4a8_kernel``), at a prompt pass's M = 72 and a narrow N: float32
    out, <= 1e-5 relative."""
    M, K, N = 72, 4608, 128
    w = (rng.normal(size=(K, N)) * K ** -0.5).astype(np.float32)
    b = rng.normal(size=N).astype(np.float32) * 0.1
    x = (rng.normal(size=(M, K)) * 2).astype(np.float32)
    j4 = JQ.quantize_linear_w4({"kernel": w, "bias": b})
    assert j4["scale4"].shape[0] == 36
    want = _np(JPM.w4a8_matmul(jnp.asarray(x, jnp.bfloat16), j4["w4_pack"], j4["scale4"],
                               j4["bias"], out_dtype=jnp.float32, interpret=True))
    t4 = TQ.quantize_linear_w4(_linear(w, b))
    got = QM.w4a8_plain(_t(x).to(torch.bfloat16), t4.w4_pack, t4.scale4, t4.bias,
                        out_dtype=torch.float32).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


K8_PLAN_CASES = [
    (1, 2048, 2048, 16, (0, 1)), (16, 3584, 3584, 28, (0, 1)), (67, 2048, 2048, 16, (0, 1)),
    (72, 18944, 3584, 148, (0, 1)), (80, 3584, 37888, 28, (0, 1)), (81, 3584, 3584, 28, (2, 2)),
    (96, 3584, 4608, 28, (2, 1)), (192, 18944, 3584, 148, (2, 1)), (256, 3584, 4608, 28, (2, 2)),
    (442, 3584, 4608, 28, (2, 1)), (442, 18944, 3584, 148, (2, 2)),
    (442, 3584, 37888, 28, (2, 1)), (512, 2048, 256, 16, (2, 8)), (90, 320, 136, 2, (2, 1)),
    (200, 4608, 200, 36, (2, 8)),
]


@pytest.mark.parametrize("M,K,N,G,want", K8_PLAN_CASES)
def test_k8_plan_covers_every_tile_and_unit_once(M, K, N, G, want):
    """At 132 SMs: the plan named; up to 80 rows the warp loop; above, the
    CTA tiles (64 rows x 128 columns) cover every row and column once,
    ragged M and N edges included, and the splits cover every unit (a pair
    of groups, one per nibble plane) exactly once, on unit boundaries, each
    non-empty; at most one CTA per SM where the tiles alone do not fill the
    card, and one more split would overfill it unless the units or the
    cluster cap (8) stop the splits; 2 splits from one to one and a half
    waves of tiles, none above."""
    n_sms = 132
    plan = QM.k8_plan(M, N, K, G, n_sms)
    assert plan == want
    mt, splits = plan
    if mt == 0:
        assert M <= QM.K8_WARP_MAX_M and splits == 1
        return
    assert mt == QM.K8_TILE_MT
    bm, bn = 32 * mt, QM.K8_BN
    rows = np.zeros(M, int)
    for r0 in range(0, -(-M // bm) * bm, bm):
        rows[r0:min(M, r0 + bm)] += 1
    cols = np.zeros(N, int)
    for n0 in range(0, -(-N // bn) * bn, bn):
        cols[n0:min(N, n0 + bn)] += 1
    assert np.all(rows == 1) and np.all(cols == 1)
    assert QM.k8_tiles(M, N) == -(-M // bm) * -(-N // bn)
    units = np.zeros(G // 2, int)
    for z in range(splits):
        u0, u1 = QM.k8_split_units(G // 2, splits, z)
        assert u1 > u0
        units[u0:u1] += 1
    assert np.all(units == 1)
    tiles = QM.k8_tiles(M, N)
    if tiles <= n_sms:
        assert tiles * splits <= n_sms
        assert tiles * (splits + 1) > n_sms or splits == min(G // 2, QM.K8_MAX_SPLITS)
    else:
        assert splits == (2 if 2 * tiles <= 3 * n_sms else 1)


@pytest.mark.parametrize("M", [67, 600])
def test_qdense_w4_both_branches_match_jax(rng, M):
    """``qdense_w4`` at M <= 512 (per-token int8, per-group int32) and at
    M > 512 (bf16 dequantized weight, x not quantized) vs JAX's, float32
    out: <= 1e-5 relative."""
    K, N = 256, 128
    w = (rng.normal(size=(K, N)) * 0.1).astype(np.float32)
    b = rng.normal(size=N).astype(np.float32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    j4 = JQ.quantize_linear_w4({"kernel": w, "bias": b})
    want = _np(JQ.qdense_w4(x, j4, out_dtype=jnp.float32))
    t4 = TQ.quantize_linear_w4(_linear(w, b))
    got = TQ.qdense_w4(_t(x), t4, out_dtype=torch.float32).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert torch.equal(QM.qdense_kernel_w4(_t(x), t4), TQ.qdense_w4(_t(x), t4))


def test_wrappers_take_the_plain_route_only_on_the_cpu():
    """On CPU tensors no launch is counted; another device raises."""
    lin = torch.nn.Linear(64, 32)
    qp, q4 = TQ.quantize_linear(lin), TQ.quantize_linear_w4(lin)
    x = torch.randn(3, 64)
    counts = (QM.a8w8_matmul.launches, QM.w4a8_matmul.launches)
    QM.qdense_kernel_w4(x, qp)
    QM.qdense_kernel_w4(x, q4)
    assert (QM.a8w8_matmul.launches, QM.w4a8_matmul.launches) == counts
    meta = torch.empty((3, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        QM.a8w8_matmul(meta, qp.w_i8, qp.scale)
    with pytest.raises(ValueError, match="unsupported device"):
        QM.w4a8_matmul(meta, q4.w4_pack, q4.scale4)
    q = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        FQ.flash_attention_q8(q, q, q, q, q)


@pytest.mark.parametrize("M,N,to_kernel", [(67, 128, True), (513, 128, False),
                                           (67, 96, False)])
def test_w4_dispatch_mirrors_jax(monkeypatch, M, N, to_kernel):
    """``qdense_kernel_w4`` hands an int4 leaf to K8's wrapper exactly
    where ``qdense_pallas_w4`` hands it to the Pallas kernel: M <= 512 and
    N % 128 == 0 (group size 128 here)."""
    lin = torch.nn.Linear(256, N)
    q4 = TQ.quantize_linear_w4(lin)
    calls = []
    monkeypatch.setattr(QM, "w4a8_matmul", lambda *a: calls.append(a) or QM.w4a8_plain(*a))
    x = torch.randn(M, 256)
    y = QM.qdense_kernel_w4(x, q4)
    assert bool(calls) == to_kernel
    assert torch.equal(y, TQ.qdense_w4(x, q4))


# ---- K3 / K4 plain versions against the Pallas kernels ----------------------------

def _kv_case(rng, B, Lq, Lkv, H, D):
    q = jnp.asarray(rng.normal(size=(B, Lq, H, D)), jnp.bfloat16)
    k = jnp.asarray(rng.normal(size=(B, Lkv, H, D)) * 2, jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(B, Lkv, H, D)), jnp.bfloat16)
    mask = np.ones((B, Lkv), bool)
    mask[0, Lkv - 150:] = False                  # ragged
    mask[-1, :] = False                          # fully masked
    return q, k, v, mask


@pytest.mark.parametrize("D", [32, 72, 160])
def test_quantize_kv_matches_jax(rng, D):
    """int8 codes and per-(B, H, D) scales bit-equal in both layouts, at
    D 32, RDT-170M's 72 and 160.  K3's codes at a D off 16 lie in storage
    whose rows are D rounded up to 16 wide, zero past D (16-byte aligned
    rows for the kernel's loads)."""
    _, k, v, _ = _kv_case(rng, 2, 3, 70, 2, D)
    for jfn, tfn in ((JPA.quantize_kv, FQ.quantize_kv), (JPA.quantize_kv_t, FQ.quantize_kv_t)):
        want = jfn(k, v)
        got = tfn(_t(_np(k)).to(torch.bfloat16), _t(_np(v)).to(torch.bfloat16))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if tfn is FQ.quantize_kv:
            for codes in (got[0], got[2]):
                Dp = -(-D // 16) * 16
                assert codes.stride() == (70 * 2 * Dp, 2 * Dp, Dp, 1)
                store = torch.as_strided(codes, codes.shape[:3] + (Dp,), codes.stride())
                assert not store[..., D:].any()


@pytest.mark.parametrize("transposed,D", [(False, 64), (True, 64), (False, 72), (False, 160),
                                         (True, 160)])
def test_attention_q8_plain_matches_jax_kernels(rng, transposed, D):
    """``attention_q8_plain`` vs ``flash_cross_attention_q8`` / ``_q8t`` in
    interpret mode over 600 keys (two 512-key blocks, the last partial),
    with a ragged mask, at D 64, RDT-170M's 72 (K3 only: JAX's K4 asserts
    D % 32) and 160: <= 2e-2 x max|jax| (the Pallas kernel rounds p to
    bf16 for p.v and writes bf16).  Fully masked rows are exactly 0."""
    q, k, v, mask = _kv_case(rng, 2, 67, 600, 2, D)
    jq, tq = (JPA.quantize_kv_t, FQ.quantize_kv_t) if transposed else \
        (JPA.quantize_kv, FQ.quantize_kv)
    kern = JPA.flash_cross_attention_q8t if transposed else JPA.flash_cross_attention_q8
    want = _np(kern(q, *jq(k, v), kv_mask=jnp.asarray(mask), interpret=True))
    fn = FQ.flash_attention_q8t if transposed else FQ.flash_attention_q8
    cache = tq(_t(_np(k)).to(torch.bfloat16), _t(_np(v)).to(torch.bfloat16))
    got = fn(_t(_np(q)).to(torch.bfloat16), *cache, kv_mask=_t(mask)).float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    assert np.all(got[-1] == 0.0) and np.all(want[-1] == 0.0)


def _split_merged(q, k_i8, k_scale, v_i8, v_scale, mask, bounds):
    """``attention_q8_plain`` cut along Lkv at ``bounds`` and merged with
    the combine launch's rule: per split the unnormalised acc = p.v, m (the
    split's max, -1e30 when it has no valid key) and l = sum p with p =
    exp(s - m); then m* = max m_s, l* = sum e^(m_s - m*) l_s and out = sum
    e^(m_s - m*) acc_s / max(l*, 1e-30) x v_scale.  float32 throughout."""
    qs = FQ.prescale_q(q, k_scale).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qs, k_i8.float())
    scores = scores.masked_fill(~mask[:, None, None, :], -1e30)
    parts = []
    for a, b in zip(bounds, bounds[1:]):
        s = scores[..., a:b]
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None]) * mask[:, None, None, a:b]
        parts.append((torch.einsum("bhqk,bkhd->bhqd", p, v_i8[:, a:b].float()), m, p.sum(-1)))
    m_star = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    acc = l_star = 0.0
    for a, m, l in parts:
        w = torch.exp(m - m_star)
        l_star = l_star + w * l
        acc = acc + w[..., None] * a
    out = acc / torch.clamp_min(l_star, 1e-30)[..., None] * v_scale[:, :, None]
    return out.permute(0, 2, 1, 3)


@pytest.mark.parametrize("transposed", [False, True])
def test_split_merge_rule_matches_plain_and_jax(rng, transposed):
    """The combine's rule over 64-key-tile splits (3 tiles each, the last
    split ragged) equals ``attention_q8_plain`` to float32 rounding (1e-5 x
    max|plain|) and JAX's ``flash_cross_attention_q8`` / ``_q8t`` in
    interpret mode to 2e-2 x max|jax| (the Pallas kernel rounds p and the
    output to bf16).  Row 0 keeps only keys of the first split, so every
    later split of it is all masked; the last row is fully masked and
    comes out exactly 0."""
    q, k, v, mask = _kv_case(rng, 2, 67, 600, 2, 64)
    mask[0, 150:] = False
    jq, tq = (JPA.quantize_kv_t, FQ.quantize_kv_t) if transposed else \
        (JPA.quantize_kv, FQ.quantize_kv)
    kern = JPA.flash_cross_attention_q8t if transposed else JPA.flash_cross_attention_q8
    want_jax = _np(kern(q, *jq(k, v), kv_mask=jnp.asarray(mask), interpret=True))
    k_i8, ks, v_i8, vs = tq(_t(_np(k)).to(torch.bfloat16), _t(_np(v)).to(torch.bfloat16))
    if transposed:
        k_i8, v_i8 = k_i8.permute(0, 3, 1, 2), v_i8.permute(0, 3, 1, 2)
    qt = _t(_np(q)).to(torch.bfloat16)
    got = _split_merged(qt.float(), k_i8, ks, v_i8, vs, _t(mask), [0, 192, 384, 576, 600])
    plain = FQ.attention_q8_plain(qt.float(), k_i8, ks, v_i8, vs, kv_mask=_t(mask))
    assert float((got - plain).abs().max()) <= 1e-5 * float(plain.abs().max())
    got = got.numpy()
    assert np.abs(got - want_jax).max() <= 2e-2 * np.abs(want_jax).max()
    assert np.all(got[-1] == 0.0)


@pytest.mark.parametrize("B,Lq,Lkv,H,want", [
    (1, 67, 4374, 32, (18, 4)),     # the image cross-attention: 576 CTAs
    (2, 67, 4374, 32, (9, 8)),
    (1, 67, 64, 32, (1, 1)),        # the language cache: one tile, no combine
    (1, 67, 65, 32, (1, 2)),
    (1, 67, 1000, 32, (8, 2)),
    (1, 200, 1000, 4, (8, 2)),
    (1, 67, 1, 32, (1, 1)),
    (1, 67, 0, 32, (1, 1)),
])
def test_split_plan_covers_every_tile_once(B, Lq, Lkv, H, want):
    """At 132 SMs: the plan named, no split empty, every tile in one."""
    splits, tps = FQ.split_plan(B, Lq, Lkv, H, 132)
    assert (splits, tps) == want
    n_tiles = -(-Lkv // FQ.BK)
    assert (splits - 1) * tps < max(n_tiles, 1) <= max(splits * tps, 1)
    assert splits == 1 or tps >= 2


# ---- the quantized runner --------------------------------------------------------

RCFG = JR.RDTRunnerConfig(model=rdt_tiny(), noise=NoiseSchedulerConfig(num_inference_timesteps=3))
TCFG = TR.RDTRunnerConfig(model=TC.rdt_tiny(),
                          noise=TC.NoiseSchedulerConfig(num_inference_timesteps=3))


def _select_paths(tree, select, path=()):
    """Paths of the linears of a flax tree that ``select`` picks."""
    out = set()
    for k, v in tree.items():
        if isinstance(v, dict):
            if JQ.is_linear(v):
                if select(path + (k,), v):
                    out.add(path + (k,))
            else:
                out |= _select_paths(v, select, path + (k,))
    return out


@pytest.fixture(scope="module")
def runners():
    """The JAX tiny runner (final projection made non-zero) and the port's
    float32 copy of it."""
    params = JR.init_rdt(RCFG, jax.random.PRNGKey(0))
    r = np.random.default_rng(0)
    fc2 = params["model"]["final_ffn"]["fc2"]
    fc2["kernel"] = jnp.asarray(r.normal(size=fc2["kernel"].shape) * 0.05, jnp.float32)
    port = FF.load_into(TR.RDTRunnerModule(TCFG.model), FF.rdt_runner(params)).eval()
    return params, port.requires_grad_(False)


@pytest.mark.parametrize("blocks,kinds", [(None, ("fc1", "fc2")), ((1,), ("qkv", "proj")),
                                          (None, ("fc1", "fc2", "qkv", "proj", "q"))])
def test_make_w4_select_matches_jax(runners, blocks, kinds):
    params, port = runners
    want = _select_paths(params, JQS.make_w4_select(blocks=blocks, kinds=kinds))
    sel = TQS.make_w4_select(blocks=blocks, kinds=kinds)
    got = set()
    for name, mod in port.named_modules():
        if isinstance(mod, torch.nn.Linear) and sel(tuple(name.split(".")), mod):
            got.add(TQS._flax_path(tuple(name.split("."))))
    assert got == want and want


@pytest.mark.parametrize("weights,kv_proj", [("int8", "bf16"), ("int8", "int8"),
                                             ("int4", "bf16"), ("mixed", "bf16")])
def test_from_flax_quant_runner_equals_port_quantization(runners, weights, kv_proj):
    """JAX's quantized tree through ``from_flax.quant_rdt_runner`` and the
    port's ``quantize_rdt_params`` of the same float32 runner hold the same
    buffers, bit for bit."""
    params, port = runners
    jsel = JQS.make_w4_select(kinds=("fc1", "fc2")) if weights == "mixed" else None
    tsel = TQS.make_w4_select(kinds=("fc1", "fc2")) if weights == "mixed" else None
    conv = FF.quant_rdt_runner(JQS.quantize_rdt_params(params, weights=weights, kv_proj=kv_proj,
                                                       w4_select=jsel), TCFG.model,
                               device="cpu")
    own = TQS.quantize_rdt_params(port, weights=weights, kv_proj=kv_proj, w4_select=tsel)
    a, b = conv.state_dict(), own.state_dict()
    assert set(a) == set(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name
    n_w4 = sum(name.endswith("w4_pack") for name in a)
    assert n_w4 == {"int8": 0, "int4": 19, "mixed": 4}[weights]


def test_from_flax_quant_runner_defaults_to_cuda(runners, monkeypatch):
    """Like every entry point of the port, ``quant_rdt_runner`` without a
    device builds on CUDA, and raises where CUDA is absent."""
    params, _ = runners
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FF.quant_rdt_runner(JQS.quantize_rdt_params(params), TCFG.model)


def _chunk_inputs(seed=0):
    m = RCFG.model
    r = np.random.default_rng(seed)
    B, Ll = 1, 7
    lang = r.normal(size=(B, Ll, m.lang_token_dim)).astype(np.float32)
    lang_mask = np.ones((B, Ll), bool)
    lang_mask[0, 5:] = False
    img = r.normal(size=(B, m.img_cond_len, m.img_token_dim)).astype(np.float32)
    state = r.normal(size=(B, 1, m.state_token_dim)).astype(np.float32)
    amask = np.ones((B, 1, m.output_dim), np.float32)
    freqs = np.asarray([10.0], np.float32)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (B, m.horizon, m.output_dim),
                                         jnp.float32))
    return (lang, lang_mask, img, state, amask, freqs), noise


def _quantized(runners, weights):
    params, port = runners
    jsel = JQS.make_w4_select(kinds=("fc1", "fc2")) if weights == "mixed" else None
    tsel = TQS.make_w4_select(kinds=("fc1", "fc2")) if weights == "mixed" else None
    return (JQS.quantize_rdt_params(params, weights=weights, w4_select=jsel),
            TQS.quantize_rdt_params(port, weights=weights, w4_select=tsel))


@pytest.mark.parametrize("kv_cache", ["bf16", "int8", "int8t", "int8x"])
def test_forward_cached_quant_matches_jax(runners, kv_cache):
    """One denoise-loop forward on the same bf16 inputs, each side building
    its condition cache from the same adaptor outputs.  With the bf16 and
    int8x caches the two compute the same integers and bf16 roundings:
    <= 1e-3 x max|jax| (a run read 0).  With int8/int8t the JAX Pallas
    kernel rounds p to bf16 for p.v where the plain version keeps float32,
    which moves a few bf16 attention outputs by one step and, through the
    next layers' int8 quantization, the output by 1.5e-2 x max|jax| (read):
    <= 3e-2 x max|jax| there."""
    jqp, tqp = _quantized(runners, "int8")
    args, noise = _chunk_inputs()
    lang, lang_mask, img, state, amask, freqs = args
    m = RCFG.model
    lc = JQS._adaptor(jqp["lang_adaptor"], jnp.asarray(lang))
    ic = JQS._adaptor(jqp["img_adaptor"], jnp.asarray(img))
    with pltpu.force_tpu_interpret_mode():
        jkv = JQS.compute_cond_kv_quant(jqp["model"], m, lc, ic, kv_cache=kv_cache)
    tkv = TQS.compute_cond_kv_quant(tqp.model, TCFG.model, _t(_np(lc)).to(torch.bfloat16),
                                    _t(_np(ic)).to(torch.bfloat16), kv_cache=kv_cache)
    x = np.random.default_rng(5).normal(size=(1, 1 + m.horizon, m.hidden_size))
    t = np.array([400], np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = _np(JQS.forward_cached_quant(jqp["model"], m, jnp.asarray(x, jnp.bfloat16),
                                            jnp.asarray(freqs), jnp.asarray(t), jkv,
                                            jnp.asarray(lang_mask)))
    got = TQS.forward_cached_quant(tqp.model, TCFG.model, _t(x).to(torch.bfloat16),
                                   _t(freqs), _t(t), tkv, _t(lang_mask)).float().numpy()
    assert got.shape == want.shape == (1, m.horizon, m.output_dim)
    tol = 3e-2 if kv_cache in ("int8", "int8t") else 1e-3
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("weights,kv_cache", [("int8", "bf16"), ("int8", "int8"),
                                              ("int8", "int8t"), ("int8", "int8x"),
                                              ("int4", "bf16"), ("mixed", "bf16")])
def test_rdt_predict_action_quant_matches_jax(runners, weights, kv_cache):
    """The 3-step quantized chunk vs JAX's on the same weights and noise.
    The adaptors, the condition cache and one forward agree exactly, but
    the solver's float32 state and the timestep embeddings differ in the
    last bits; through the per-token int8 quantization of every layer
    those flip a few codes, and over 3 steps the chunk drifts by up to
    2.4e-2 x max|jax| (read across these six cases).  Gate: <= 5e-2 x
    max|jax| and corr > 0.999 (read 0.99975-0.99979)."""
    jqp, tqp = _quantized(runners, weights)
    args, noise = _chunk_inputs()
    with pltpu.force_tpu_interpret_mode():
        want = _np(JQS.rdt_predict_action_quant(RCFG, jqp, jax.random.PRNGKey(1), *args,
                                                kv_cache=kv_cache, init_noise=noise))
    got = TQS.rdt_predict_action_quant(TCFG, tqp, *(_t(a) for a in args), kv_cache=kv_cache,
                                       init_noise=_t(noise)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


def test_rdt_predict_action_quant_int8_kv_proj_matches_jax(runners):
    """Configuration (f) of ``chip_smoke.py``: int8 weights with int8
    condition K/V projections (``kv_proj='int8'``, through the plain
    ``qdense`` on both sides) and the int8 cache, the 3-step chunk vs JAX's
    on the same weights and noise.  Gate as the chunk test's above:
    <= 5e-2 x max|jax| and corr > 0.999."""
    params, port = runners
    jqp = JQS.quantize_rdt_params(params, weights="int8", kv_proj="int8")
    tqp = TQS.quantize_rdt_params(port, weights="int8", kv_proj="int8")
    assert all(isinstance(b.cross_attn.kv, TQ.QLinear) for b in tqp.model.blocks)
    args, noise = _chunk_inputs()
    with pltpu.force_tpu_interpret_mode():
        want = _np(JQS.rdt_predict_action_quant(RCFG, jqp, jax.random.PRNGKey(1), *args,
                                                kv_cache="int8", init_noise=noise))
    got = TQS.rdt_predict_action_quant(TCFG, tqp, *(_t(a) for a in args), kv_cache="int8",
                                       init_noise=_t(noise)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


def test_quant_chunk_golden_anchor():
    """The frozen ``quant_chunk.npz`` cold chunk (JAX int8 twin, 3 steps),
    reproduced from the converted JAX tree: <= 5e-2 x max|golden| and corr
    > 0.999, as above."""
    fx = np.load(os.path.join(GOLDEN, "quant_chunk.npz"))
    rcfg = JR.RDTRunnerConfig(model=rdt_tiny(dtype="float32"),
                              noise=NoiseSchedulerConfig(num_inference_timesteps=3))
    m = rcfg.model
    params = JR.init_rdt(rcfg, jax.random.PRNGKey(4))
    r = np.random.default_rng(int(fx["input_seed"]))
    fc2 = params["model"]["final_ffn"]["fc2"]
    fc2["kernel"] = jnp.asarray(r.normal(size=fc2["kernel"].shape) * 0.05, jnp.float32)
    qrunner = FF.quant_rdt_runner(JQS.quantize_rdt_params(params), TCFG.model,
                                 device="cpu")
    B, Ll = 1, 7
    lang = r.normal(size=(B, Ll, m.lang_token_dim)).astype(np.float32)
    img = r.normal(size=(B, m.img_cond_len, m.img_token_dim)).astype(np.float32)
    state = r.normal(size=(B, 1, m.state_token_dim)).astype(np.float32)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(21),
                                         (B, m.horizon, m.output_dim), jnp.float32))
    got = TQS.rdt_predict_action_quant(
        TCFG, qrunner, _t(lang), torch.ones((B, Ll), dtype=torch.bool), _t(img), _t(state),
        torch.ones((B, 1, m.output_dim)), torch.tensor([10.0]), init_noise=_t(noise)).numpy()
    want = fx["cold"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


def test_warm_quant_replan_is_not_ported(runners):
    """The warm twin (ported since this test's name was given): a skip
    outside [0, steps) and a warm start without a prior raise; skip 1 from
    a prior gives a finite chunk unlike the cold one.  Its parity with JAX
    is held in ``tests/test_torch_warm.py``."""
    _, tqp = _quantized(runners, "int8")
    args, noise = _chunk_inputs()
    targs = [_t(a) for a in args]
    for bad in (-1, RCFG.noise.num_inference_timesteps):
        with pytest.raises(ValueError, match="skip_steps"):
            TQS.rdt_predict_action_quant(TCFG, tqp, *targs, skip_steps=bad,
                                         prior_chunk=_t(noise), init_noise=_t(noise))
    with pytest.raises(ValueError, match="prior_chunk"):
        TQS.rdt_predict_action_quant(TCFG, tqp, *targs, skip_steps=1, init_noise=_t(noise))
    cold = TQS.rdt_predict_action_quant(TCFG, tqp, *targs, init_noise=_t(noise))
    warm = TQS.rdt_predict_action_quant(TCFG, tqp, *targs, skip_steps=1, prior_chunk=cold,
                                        init_noise=_t(noise))
    assert torch.isfinite(warm).all() and not torch.equal(warm, cold)


def test_policy_step_dispatches_the_quant_twin(runners):
    """``create_model(rdt=<QuantRDTRunner>).step`` at the golden policy
    config against the JAX model's ``step`` on its quantized tree (its
    ``_is_quant_tree`` dispatch): the whole slice, tiny ViT + rdt_tiny +
    int8 twin, 3 steps.  Tolerance as the chunk's, on the actions divided
    by the policy's action scale (the gripper's is 255)."""
    from vla_touch_tpu.models.encoders.vit import ViTConfig
    from vla_touch_tpu.runtime import policy as P
    from vla_touch_tpu_torch.models.encoders import vit as TV
    from vla_touch_tpu_torch.runtime import policy as TP

    vit_kw = dict(hidden_size=48, num_layers=1, num_heads=4, mlp_dim=96, image_size=28,
                  patch_size=14, use_cls_token=False, use_layerscale=False, gelu_tanh=True)
    cfg = P.PolicyConfig(rdt=RCFG, vision=ViTConfig(**vit_kw), image_size=28)
    jmodel = P.create_model(cfg, seed=0)
    params, _ = runners
    jmodel.rdt_params = JQS.quantize_rdt_params(params)
    jmodel._key = jax.random.PRNGKey(99)
    r = np.random.default_rng(3)
    proprio = r.normal(size=(1, 10)).astype(np.float32)
    images = [r.integers(0, 255, size=(28, 28, 3)).astype(np.uint8) for _ in range(6)]
    text = r.normal(size=(1, 6, RCFG.model.lang_token_dim)).astype(np.float32)
    _, k = jax.random.split(jax.random.PRNGKey(99))
    noise = np.asarray(jax.random.normal(k, (1, RCFG.model.horizon, RCFG.model.output_dim),
                                         jnp.float32))
    want = np.asarray(jmodel.step(proprio, images, text))

    tcfg = TP.PolicyConfig(rdt=TCFG, vision=TV.ViTConfig(**vit_kw), image_size=28)
    vision = FF.load_into(TV.SiglipVisionEncoder(tcfg.vision),
                          FF.vit(jmodel.vision_params)).eval().requires_grad_(False)
    qrunner = FF.quant_rdt_runner(jmodel.rdt_params, TCFG.model, device="cpu")
    tmodel = TP.create_model(tcfg, rdt=qrunner, vision=vision, device="cpu")
    got = tmodel.step(proprio, images, text, init_noise=_t(noise))
    assert got.shape == want.shape == (1, RCFG.model.horizon, 10)
    scale = np.asarray(cfg.state_scale, np.float32)
    got, want = got / scale, want / scale
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999
