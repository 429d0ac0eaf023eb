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
