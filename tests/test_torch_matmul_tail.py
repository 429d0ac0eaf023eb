"""PyTorch port, K7 (``a8w8_matmul_large``) and K5 (``w8a16_matmul``) on the
CPU: their plain versions against the JAX Pallas kernels in interpret mode,
the shape route of K7's entry, K5's refusals, and that the wrappers take
the plain route only on CPU tensors.

The int8 leaves are quantized by JAX and converted with
``utils/from_flax.py`` (JAX's ``w_i8`` is (K, N), the port's (N, K)).
JAX's ``w8a16_matmul`` has no ``interpret`` argument and raises on the CPU
backend, so its test runs it with ``pallas_call`` given ``interpret=True``
(through ``monkeypatch``, on the test's side only) and clears the JAX
caches after.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from vla_touch_tpu.ops import pallas_matmul as JPM
from vla_touch_tpu.ops import quant as JQ
from vla_touch_tpu_torch.ops import quant as TQ
from vla_touch_tpu_torch.ops import quant_matmul as QM
from vla_touch_tpu_torch.utils import from_flax as FF


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _leaves(rng, K, N):
    """A JAX int8 leaf of a random linear ~ N(0, 1/K), bias ~ N(0, 0.01),
    and its conversion to the port's ``QLinear``."""
    w = (rng.normal(size=(K, N)) * K ** -0.5).astype(np.float32)
    b = (rng.normal(size=N) * 0.1).astype(np.float32)
    jq = JQ.quantize_linear({"kernel": w, "bias": b})
    return jq, FF._llm_leaf(dict(jq), "cpu")


def _x(rng, shape, dtype):
    """x ~ N(0, 4) as a (JAX, torch) pair of the same values in ``dtype``
    ("float32" or "bfloat16")."""
    x = (rng.normal(size=shape) * 2).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    return jx, torch.as_tensor(np.array(_np(jx))).to(getattr(torch, dtype))


# ---- K7 ------------------------------------------------------------------------------

@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,blocks", [(300, 256, 512, dict(block_m=128, block_n=256)),
                                          (67, 256, 512, {}), (1, 128, 512, {})])
def test_a8w8_large_plain_matches_jax_kernel(rng, M, K, N, blocks, x_dtype):
    """K7's plain version vs JAX's ``a8w8_matmul_large`` in interpret mode,
    float32 out.  The int8 codes are equal to those of the JAX wrapper's
    quantization (:257-259, restated here), and the outputs agree within
    rtol 1e-6 and atol 1e-6 x max|jax| (the int32 sums are exact; only a
    fused multiply-add could move the float32 epilogue by an ulp)."""
    jq, tq = _leaves(rng, K, N)
    jx, tx = _x(rng, (M, K), x_dtype)
    want = _np(JPM.a8w8_matmul_large(jx, jq["w_i8"], jq["scale"], jq["bias"],
                                     out_dtype=jnp.float32, interpret=True, **blocks))
    got = QM.a8w8_large_plain(tx, tq.w_i8, tq.scale, tq.bias,
                              out_dtype=torch.float32).numpy()
    xf = jx.astype(jnp.float32)
    amax = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-8)
    codes = jnp.clip(jnp.round(xf * (127.0 / amax)), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(TQ.quantize_rows(tx)[0].numpy(), np.asarray(codes))
    assert got.shape == want.shape == (M, N)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_a8w8_large_row_scale_is_the_kernels(rng):
    """The plain version scales a row by ``amax * (1/127)`` as the Pallas
    kernel's caller does, not by ``qdense``'s ``amax / 127``: the two differ
    for some amax, and torch's ``amax * (1.0 / 127.0)`` is JAX's bit for
    bit."""
    amax = np.float32(1.0) + np.arange(4096, dtype=np.float32) * np.float32(2 ** -12)
    mul = np.asarray(jnp.asarray(amax) * (1.0 / 127.0))
    div = np.asarray(jnp.asarray(amax) / 127.0)
    assert (mul != div).any()
    got = (torch.as_tensor(amax) * (1.0 / 127.0)).numpy()
    np.testing.assert_array_equal(got, mul)


@pytest.mark.parametrize("K,N", [(256, 384), (192, 512)])
def test_a8w8_matmul_large_routes_on_shape_as_jax(rng, K, N):
    """K % 128 or N % 512 (JAX's default ``block_n``): the entry returns the
    plain ``qdense`` exactly, and its float32 product agrees with JAX's
    fallback within 1e-5 x max; no launch is counted."""
    jq, tq = _leaves(rng, K, N)
    jx, tx = _x(rng, (2, 40, K), "float32")
    before = QM.a8w8_matmul_large.launches
    got = QM.a8w8_matmul_large(tx, tq.w_i8, tq.scale, tq.bias)
    assert not QM.a8w8_large_takes(K, N)
    assert torch.equal(got, TQ.qdense(tx, tq))
    assert QM.a8w8_matmul_large.launches == before
    want = _np(JPM.a8w8_matmul_large(jx, jq["w_i8"], jq["scale"], jq["bias"],
                                     out_dtype=jnp.float32, interpret=True))
    ref = TQ.qdense(tx, tq, out_dtype=torch.float32).numpy()
    assert np.abs(ref - want).max() <= 1e-5 * np.abs(want).max()


def test_a8w8_matmul_large_cpu_is_the_plain_version(rng):
    """On CPU tensors, at a shape the kernel takes, the entry is the plain
    version (leading dimensions kept, bf16 out) and counts no launch; on
    another device it raises."""
    _, tq = _leaves(rng, 256, 512)
    x = torch.as_tensor(rng.normal(size=(2, 150, 256)).astype(np.float32))
    before = QM.a8w8_matmul_large.launches
    got = QM.a8w8_matmul_large(x, tq.w_i8, tq.scale, tq.bias)
    assert got.shape == (2, 150, 512) and got.dtype == torch.bfloat16
    assert torch.equal(got, QM.a8w8_large_plain(x, tq.w_i8, tq.scale, tq.bias))
    assert QM.a8w8_matmul_large.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        QM.a8w8_matmul_large(torch.empty((3, 256), device="meta"), tq.w_i8, tq.scale)


# ---- K5 ------------------------------------------------------------------------------

@pytest.fixture
def w8a16_interpret(monkeypatch):
    """JAX's ``w8a16_matmul`` with ``pallas_call(..., interpret=True)``."""
    monkeypatch.setattr(JPM.pl, "pallas_call",
                        functools.partial(JPM.pl.pallas_call, interpret=True))
    yield JPM.w8a16_matmul
    jax.clear_caches()


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(67, 256, 384), (1, 128, 128), (33, 256, 512)])
def test_w8a16_plain_matches_jax_kernel(rng, w8a16_interpret, M, K, N, x_dtype):
    """K5's plain version vs JAX's ``w8a16_matmul`` in interpret mode,
    float32 out: rtol 1e-5 and atol 1e-5 x max|jax| (exact products of
    bf16 values, float32 sums in other orders)."""
    jq, tq = _leaves(rng, K, N)
    jx, tx = _x(rng, (M, K), x_dtype)
    want = _np(w8a16_interpret(jx, jq["w_i8"], jq["scale"], jq["bias"],
                               out_dtype=jnp.float32))
    got = QM.w8a16_plain(tx, tq.w_i8, tq.scale, tq.bias, out_dtype=torch.float32).numpy()
    assert got.shape == want.shape == (M, N)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_w8a16_entries_take_the_plain_route_only_on_the_cpu(rng):
    """``w8a16_matmul`` and ``qdense_kernel_w8a16`` compute the plain
    version on CPU tensors, bf16 out, leading dimensions kept, and count no
    launch; another device raises."""
    _, tq = _leaves(rng, 256, 384)
    x = torch.as_tensor(rng.normal(size=(2, 5, 256)).astype(np.float32))
    before = QM.w8a16_matmul.launches
    got = QM.qdense_kernel_w8a16(x, tq)
    assert got.shape == (2, 5, 384) and got.dtype == torch.bfloat16
    assert torch.equal(got, QM.w8a16_plain(x, tq.w_i8, tq.scale, tq.bias))
    assert torch.equal(got, QM.w8a16_matmul(x, tq.w_i8, tq.scale, tq.bias))
    assert QM.w8a16_matmul.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        QM.w8a16_matmul(torch.empty((3, 256), device="meta"), tq.w_i8, tq.scale)


@pytest.mark.parametrize("K,N", [(192, 256), (256, 200)])
def test_w8a16_refuses_k_or_n_not_a_multiple_of_128(K, N):
    """As JAX's assert (:80), on the CPU too."""
    w = torch.zeros((N, K), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 128"):
        QM.w8a16_matmul(torch.zeros((3, K)), w, torch.ones(N))


# ---- K5's split plan and sum order; K7's tiles --------------------------------------

# (M, K, N, plan at 132 SMs, every cluster of a wave placed at once) of
# every K5 shape of chip_smoke.K5_SHAPES: the twin's linears and the planner
# int8 request's M = 1 linears (on the card the plan counts the clusters
# CUDA's occupancy calculator places, so a tall tile's splits may be fewer)
K5_PLAN_CASES = [
    (67, 2048, 6144, (5, 8, 5)), (67, 2048, 2048, (5, 4, 8)), (67, 2048, 128, (5, 4, 8)),
    (64, 4096, 2048, (4, 4, 8)), (64, 2048, 2048, (4, 4, 8)), (64, 256, 2048, (4, 4, 2)),
    (1, 256, 2048, (1, 4, 2)), (1, 2048, 2048, (1, 4, 8)), (1, 3584, 3584, (1, 8, 8)),
    (1, 3584, 512, (1, 4, 8)), (1, 3584, 18944, (1, 8, 3)), (1, 18944, 3584, (1, 8, 8)),
    (1, 3584, 152064, (1, 4, 1)),
]


def _k5_coverage(M, K, N, plan):
    """Every (row, column) of the output in exactly one tile of the grid,
    every 64-wide K chunk in exactly one split, every split non-empty."""
    mt, wn, splits = plan
    assert 1 <= mt <= QM.K5_MAX_MT and wn in QM.K5_WNS
    nc = K // 64
    assert 1 <= splits <= min(QM.K6_MAX_SPLITS, nc)
    seen = np.zeros(nc, int)
    for z in range(splits):
        c0, c1 = QM.k6_split_chunks(nc, splits, z)
        assert c1 > c0
        seen[c0:c1] += 1
    assert np.all(seen == 1)
    cover = np.zeros((M, N), int)
    rows, cols = 16 * mt, 32 * wn
    grid = (-(-N // cols), -(-M // rows))
    assert grid[0] * grid[1] == QM.k5_tiles(M, N, plan)
    for bx in range(grid[0]):
        for by in range(grid[1]):
            cover[by * rows:(by + 1) * rows, bx * cols:(bx + 1) * cols] += 1
    assert np.all(cover == 1)


@pytest.mark.parametrize("M,K,N,want", K5_PLAN_CASES)
def test_k5_split_plan_covers_every_chunk_and_tile_once(M, K, N, want):
    """At 132 SMs: the plan named; every output element in one tile and
    every 64-wide K chunk in one split (a cluster of at most 8 CTAs); a
    split plan's CTAs fit the card at once (two per SM at one or two row
    tiles)."""
    plan = QM.k5_plan(M, N, K, 132)
    assert plan == want
    _k5_coverage(M, K, N, plan)
    mt, wn, splits = plan
    ctas = QM.k5_tiles(M, N, plan) * splits
    assert splits == 1 or ctas <= 132 * (2 if mt <= 2 else 1)


@pytest.mark.parametrize("M,K,N", [(67, 2048, 2048), (64, 4096, 2048), (67, 2048, 6144)])
def test_k5_plan_counts_the_clusters_the_card_places(M, K, N):
    """Where fewer clusters of a split count fit at once than the tiles
    need (an H100 places 15 clusters of eight 80-row CTAs, 17 of six),
    the plan takes fewer splits rather than a second wave; every element
    and chunk still once."""
    placed = {8: 15, 7: 15, 6: 17, 5: 22, 4: 30, 3: 44, 2: 66, 1: 132}
    plan = QM.k5_plan(M, N, K, 132, active=lambda mt, wn, splits: placed[splits])
    _k5_coverage(M, K, N, plan)
    assert QM.k5_tiles(M, N, plan) <= placed[plan[2]]
    assert plan != QM.k5_plan(M, N, K, 132) or QM.k5_tiles(M, N, plan) <= 15


@pytest.mark.parametrize("M,K,N", [(130, 384, 640), (81, 2048, 2048), (1, 128, 128),
                                   (500, 256, 1024), (17, 18944, 256)])
def test_k5_split_plan_ragged_and_tall(M, K, N):
    """Rows past 80 take further row blocks of at most five 16-row tiles,
    a partial last column tile and K cut into splits it does not divide:
    every element and chunk once."""
    plan = QM.k5_plan(M, N, K, 132)
    _k5_coverage(M, K, N, plan)
    assert plan[0] == min(5, -(-M // 16))


def _k5_sum_order(x, w_i8, scale, bias, plan):
    """K5's float32 sums in the kernel's order: per split, each warp row wk
    takes the chunks c0 + s * WK + wk in turn, four 16-deep mma steps a
    chunk over the K positions t*16 + 4q + {0..3} (t = 0..3); the WK warp
    rows summed in order, then the splits in rank order, then
    acc * scale + bias."""
    x = x.astype(np.float32)
    w = w_i8.astype(np.float32)
    M, K = x.shape
    mt, wn, splits = plan
    WK, nc = 8 // wn, K // 64
    steps = [np.array([t * 16 + 4 * q + d for t in range(4) for d in range(4)])
             for q in range(4)]
    parts = []
    for z in range(splits):
        c0, c1 = QM.k6_split_chunks(nc, splits, z)
        warps = [np.zeros((M, w.shape[0]), np.float32) for _ in range(WK)]
        for c in range(c0, c1):
            for ks in steps:
                k = c * 64 + ks
                warps[(c - c0) % WK] += x[:, k] @ w[:, k].T
        part = warps[0]
        for p in warps[1:]:
            part = part + p
        parts.append(part)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    y = acc * scale
    return y + bias if bias is not None else y


@pytest.mark.parametrize("M,K,N,plan", [(67, 1280, 256, (5, 4, 8)), (67, 1280, 256, (5, 8, 3)),
                                        (1, 384, 512, (1, 4, 5)), (33, 256, 384, (3, 8, 1))])
def test_k5_sum_order_matches_plain_and_jax_kernel(rng, w8a16_interpret, M, K, N, plan):
    """K5's split and cluster sum order, emulated in float32, against its
    plain version and JAX's ``w8a16_matmul`` in interpret mode: rtol 1e-5
    and atol 1e-5 x max|jax| (exact products of bf16 values, float32 sums
    in other orders)."""
    jq, tq = _leaves(rng, K, N)
    jx, tx = _x(rng, (M, K), "bfloat16")
    want = _np(w8a16_interpret(jx, jq["w_i8"], jq["scale"], jq["bias"],
                               out_dtype=jnp.float32))
    plain = QM.w8a16_plain(tx, tq.w_i8, tq.scale, tq.bias, out_dtype=torch.float32).numpy()
    got = _k5_sum_order(tx.float().numpy(), tq.w_i8.numpy(), tq.scale.numpy(),
                        tq.bias.numpy(), plan)
    assert got.shape == want.shape == (M, N)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5 * np.abs(plain).max())


@pytest.mark.parametrize("M,K,N", [(4374, 1152, 2048), (4374, 2048, 2048), (4374, 2048, 4096),
                                   (1, 2048, 4096), (129, 2048, 4096), (1, 128, 512)])
def test_k7_tiles_cover_every_output_once(M, K, N):
    """At 132 SMs, the persistent grid's schedule (CTA c takes tiles c, c +
    grid, ...; tile i is row tile i % row tiles of column band i // row
    tiles) puts every output element in exactly one 128 x 256 tile, and
    the tiles at work at once are consecutive: a band or two."""
    bn = QM.K7_BN
    assert N % bn == 0
    rows_t, cols_t = -(-M // QM.K7_BM), N // bn
    tiles = QM.k7_tiles(M, N)
    assert tiles == rows_t * cols_t
    grid = min(tiles, 132)
    cover = np.zeros((M, N), np.int8)
    for c in range(grid):
        for i in range(c, tiles, grid):
            bx, by = i % rows_t, i // rows_t
            cover[bx * QM.K7_BM:(bx + 1) * QM.K7_BM, by * bn:(by + 1) * bn] += 1
    assert np.all(cover == 1)
    first_wave = list(range(grid))
    assert max(i // rows_t for i in first_wave) - min(i // rows_t for i in first_wave) \
        <= -(-grid // rows_t)


def test_quant_ab_binds_the_parent_k8_by_its_declaration():
    """``tools/torch_quant_ab.py`` reads the parent K8's C signature off its
    source: this tree's entry takes the plan (``mt``, ``splits``), an entry
    that ends at ``G, stream`` (as before the tile body) does not, and an
    entry of neither form or a source without one raises."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "torch_quant_ab", os.path.join(root, "tools", "torch_quant_ab.py"))
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    src = open(os.path.join(root, "vla_touch_tpu_torch", "csrc", "w4a8_matmul.cu")).read()
    assert ab.k8_entry_takes_plan(src)
    old = ('extern "C" int w4a8_matmul(const void* x, int x_f32, long long x_sm, '
           'const void* w4_pack,\n    const void* scale4, const void* bias, void* xq, '
           'void* rs, void* out, int M,\n    int N, int K, int G, void* stream) {')
    assert not ab.k8_entry_takes_plan(old)
    with pytest.raises(ValueError, match="neither"):
        ab.k8_entry_takes_plan(old.replace("int G, void* stream", "int G, int x, void* stream"))
    with pytest.raises(ValueError, match="no w4a8_matmul"):
        ab.k8_entry_takes_plan("int main() {}")
