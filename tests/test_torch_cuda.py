"""PyTorch port, on the card: kernels K1 (flash attention) and K2 (fused
residual block) against their plain versions on CUDA tensors.

These build the CUDA sources with nvcc and need an NVIDIA GPU; without one
they skip (the ``cuda`` marker).  On a machine with a card run them with
``python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest`` (the
suite's conftest imports JAX, which the port does not need).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("B,Lq,Lkv,H,D,mask_kind,layout", [
    (2, 35, 300, 4, 72, "ragged", "separate"),
    (2, 67, 130, 2, 64, "fully_masked", "separate"),
    (1, 129, 64, 3, 128, None, "separate"),
    (1, 67, 67, 32, 64, None, "fused_qkv"),
    (2, 67, 300, 4, 64, "ragged", "fused_kv"),
])
def test_flash_attention_kernel_matches_plain(cuda, B, Lq, Lkv, H, D, mask_kind, layout):
    """bf16 kernel vs the plain version: max abs error <= 2e-2 x max|plain|
    (bf16 output and bf16 p, 2^-8 relative each).  The fused layouts pass
    q/k/v as the modules do: strided views of one (B, L, 3 or 2, H, D)
    projection."""
    from vla_touch_tpu_torch.ops import flash_attention as FA

    g = torch.Generator(device=cuda).manual_seed(0)

    def mk(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)

    if layout == "fused_qkv":
        q, k, v = mk(B, Lq, 3, H, D).unbind(2)
    elif layout == "fused_kv":
        q, (k, v) = mk(B, Lq, H, D), mk(B, Lkv, 2, H, D).unbind(2)
    else:
        q, k, v = mk(B, Lq, H, D), mk(B, Lkv, H, D), mk(B, Lkv, H, D)
    mask = None
    if mask_kind:
        mask = torch.ones((B, Lkv), dtype=torch.bool, device=cuda)
        mask[0, Lkv // 3:] = False
        if mask_kind == "fully_masked":
            mask[-1] = False
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, kv_mask=mask)
    assert FA.flash_attention.launches == before + 1
    want = FA.attention_plain(q, k, v, kv_mask=mask).float()
    torch.cuda.synchronize()
    assert float((got.float() - want).abs().max()) <= 2e-2 * float(want.abs().max())
    if mask_kind == "fully_masked":
        assert float(got[-1].float().abs().max()) == 0.0


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    from vla_touch_tpu_torch.ops.flash_attention import flash_attention

    q = torch.zeros((1, 4, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)                        # float32
    q = torch.zeros((1, 4, 2, 20), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)                        # D not a multiple of 8


@pytest.mark.parametrize("T,Cin,C", [(16, 10, 256), (4, 1024, 512), (8, 256, 256)])
def test_resblock_kernel_matches_plain(cuda, T, Cin, C):
    """bf16 kernel vs the f32 plain version: 3e-2 (bf16 output)."""
    from vla_touch_tpu_torch.ops import unet_kernels as UK

    g = torch.Generator(device=cuda).manual_seed(1)
    S, B, G, K = 2, 1, 512, 5

    def w(*shape, scale):
        return (torch.randn(shape, generator=g, device=cuda) * scale).to(torch.bfloat16)

    p = {"w0": w(S, K, Cin, C, scale=(K * Cin) ** -0.5), "b0": w(S, C, scale=0.1),
         "g0w": 1 + w(S, C, scale=0.1), "g0b": w(S, C, scale=0.1),
         "fw": w(S, G, 2 * C, scale=G ** -0.5), "fb": w(S, 2 * C, scale=0.1),
         "w1": w(S, K, C, C, scale=(K * C) ** -0.5), "b1": w(S, C, scale=0.1),
         "g1w": 1 + w(S, C, scale=0.1), "g1b": w(S, C, scale=0.1)}
    if Cin != C:
        p["wr"], p["br"] = w(S, Cin, C, scale=Cin ** -0.5), w(S, C, scale=0.1)
    x = w(S, B, T, Cin, scale=1.0)
    cond = w(S, B, G, scale=1.0)
    before = UK.resblock_fused.launches
    got = UK.resblock_fused(x, cond, p)
    assert UK.resblock_fused.launches == before + 1
    want = UK.resblock_ref(x, cond, p)
    torch.cuda.synchronize()
    err = float((got.float() - want).abs().max())
    assert np.isfinite(err) and err < 3e-2, err
    with pytest.raises(TypeError):
        UK.resblock_fused(x.float(), cond, p)
