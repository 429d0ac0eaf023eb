"""PyTorch port, on the card: kernels K1 (flash attention), K2 (fused
residual block), K3/K4 (flash attention over an int8 K/V cache), K5 (w8a16
matmul), K6 (a8w8 matmul), K7 (a8w8 matmul for large M), K8 (w4a8 matmul),
K9 (w4 SwiGLU MLP) and K10 (w4 post-attention) against their plain
versions on CUDA tensors.

These build the CUDA sources with nvcc and need an NVIDIA GPU; without one
they skip (the ``cuda`` marker).  On a machine with a card run them with
``python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest`` (the
suite's conftest imports JAX, which the port does not need).
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

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
    (1, 67, 4374, 32, 64, None, "fused_kv"),          # the image call: split by
                                                      # card_plan (12 x 6 on an H100)
    (1, 67, 1000, 32, 64, None, "fused_kv"),          # ragged last split
    (1, 67, 4374, 32, 64, "dead_split", "fused_kv"),  # one split all masked
    (2, 67, 4374, 32, 64, "fully_masked", "fused_kv"),
    (6, 729, 729, 16, 72, None, "separate"),          # SigLIP: D 72, one split
    (2, 730, 730, 6, 64, "dead_split", "separate"),   # DinoV2: 128-row tiles, split
    (1, 129, 200, 4, 64, "ragged", "separate"),       # Lq 129: two q tiles
])
def test_flash_attention_kernel_matches_plain(cuda, B, Lq, Lkv, H, D, mask_kind, layout):
    """bf16 kernel vs the plain version: max abs error <= 2e-2 x max|plain|
    (bf16 output and bf16 p, 2^-8 relative each).  The fused layouts pass
    q/k/v as the modules do: strided views of one (B, L, 3 or 2, H, D)
    projection.  The split cases cross the kernel's split boundaries: a
    ragged last split, and ("dead_split") every key of its second split
    masked."""
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
    if mask_kind == "dead_split":
        _, splits, tps = FA.card_plan(B, Lq, Lkv, H, D, cuda.index or 0)
        assert splits >= 3
        mask = torch.ones((B, Lkv), dtype=torch.bool, device=cuda)
        mask[:, tps * FA.BK:2 * tps * FA.BK] = False
    elif mask_kind:
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


@pytest.mark.parametrize("B,Lq,Lkv,H,D,layout,short_mask", [
    (4, 67, 67, 32, 64, "fused_qkv", False),      # RDT training self-attention
    (4, 67, 4374, 32, 64, "fused_kv", False),     # image cross-attention
    (4, 67, 1024, 32, 64, "fused_kv", True),      # language cross, 32 valid keys
])
def test_flash_attention_autograd_on_the_card(cuda, B, Lq, Lkv, H, D, layout, short_mask):
    """Attention with grad-requiring operands on the card goes through K1's
    autograd Function (the kernel forward, its output carrying a grad_fn),
    and its q/k/v gradients equal attention_plain's autograd on the same
    operands (the backward is that program recomputed: 1e-3 x max |grad|
    for reduction order).  A direct wrapper call with such operands raises:
    no path returns an output without a grad_fn."""
    from vla_touch_tpu_torch.ops import attention as A
    from vla_touch_tpu_torch.ops import flash_attention as FA

    g = torch.Generator(device=cuda).manual_seed(1)

    def mk(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)

    if layout == "fused_qkv":
        base = mk(B, Lq, 3, H, D).requires_grad_(True)
        q, k, v = base.unbind(2)
        leaves = (base,)
    else:
        q, base = mk(B, Lq, H, D).requires_grad_(True), mk(B, Lkv, 2, H, D).requires_grad_(True)
        k, v = base.unbind(2)
        leaves = (q, base)
    mask = None
    if short_mask:
        mask = torch.zeros((B, Lkv), dtype=torch.bool, device=cuda)
        mask[:, :32] = True
    cot = torch.randn((B, Lq, H, D), generator=g, device=cuda)
    before = FA.flash_attention.launches
    out = A.dot_product_attention(q, k, v, kv_mask=mask)
    assert out.grad_fn is not None and FA.flash_attention.launches == before + 1
    got = torch.autograd.grad((out.float() * cot).sum(), leaves)
    want = torch.autograd.grad((FA.attention_plain(q, k, v, kv_mask=mask).float() * cot).sum(),
                               leaves)
    for a, b in zip(got, want):
        assert float((a.float() - b.float()).abs().max()) <= 1e-3 * float(b.float().abs().max())
    with pytest.raises(RuntimeError, match="requires grad"):
        FA.flash_attention(q, k, v, kv_mask=mask)
    with torch.no_grad():
        assert A.dot_product_attention(q, k, v, kv_mask=mask).grad_fn is None


@pytest.mark.parametrize("plan", [(80, 1, 69), (80, 9, 8), (80, 18, 4), (80, 23, 3),
                                  (80, 35, 2), (128, 18, 4)])
def test_flash_attention_kernel_plans_agree(cuda, plan):
    """Every plan (rows per CTA, splits, tiles per split) of the image call
    agrees with the plain version within 2e-2 x max|plain|, and a split
    call counts one launch."""
    from vla_touch_tpu_torch.ops import flash_attention as FA

    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((1, 67, 32, 64), generator=g, device=cuda).to(torch.bfloat16)
    k, v = torch.randn((1, 4374, 2, 32, 64), generator=g, device=cuda).to(torch.bfloat16).unbind(2)
    before = FA.flash_attention.launches
    got = FA._launch(q, k, v, None, None, lambda *_: plan)
    assert FA.flash_attention.launches == before + 1
    want = FA.attention_plain(q, k, v).float()
    torch.cuda.synchronize()
    assert float((got.float() - want).abs().max()) <= 2e-2 * float(want.abs().max())


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    from vla_touch_tpu_torch.ops.flash_attention import flash_attention

    q = torch.zeros((1, 4, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)                        # float32
    q = torch.zeros((1, 4, 2, 264), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)                        # D above 256


@pytest.mark.parametrize("B,Lq,Lkv,H,D,masked", [
    (6, 4, 4, 4, 12, False),             # the full walkthrough's ViT
    (3, 5, 5, 4, 8, False),              # the planning walkthrough's CLIP
    (2, 5, 5, 4, 96, False),             # its cut DinoV2
    (6, 729, 729, 16, 12, False),
    (1, 67, 4374, 32, 20, True),         # split, ragged mask, D 20
    (2, 130, 300, 3, 100, True),
    (1, 67, 500, 4, 1, False),
    (1, 67, 4374, 8, 160, False),        # above D 128: pieces of V, split
    (2, 200, 700, 4, 200, True),         # two q tiles, two pieces, ragged
    (6, 729, 729, 4, 256, False),
    (1, 67, 1000, 16, 144, True),
    (1, 67, 67, 16, 72, False),          # RDT-170M's self-attention
])
def test_flash_attention_kernel_at_every_head_dim(cuda, B, Lq, Lkv, H, D, masked):
    """Any D <= 256 launches the kernel (a D off the 8-column piece on zero
    columns; above 128, CTAs of 128-column pieces of V): one counted launch
    a call, within 2e-2 x max|plain| of the plain version at the true D's
    scale, and a CUDA graph of the call replays the eager call's bits."""
    from vla_touch_tpu_torch.ops import flash_attention as FA

    g = torch.Generator(device=cuda).manual_seed(3)

    def mk(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)

    q, k, v = mk(B, Lq, H, D), mk(B, Lkv, H, D), mk(B, Lkv, H, D)
    mask = None
    if masked:
        mask = torch.ones((B, Lkv), dtype=torch.bool, device=cuda)
        mask[0, 50:] = False
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, kv_mask=mask)
    assert FA.flash_attention.launches == before + 1
    assert got.shape == (B, Lq, H, D) and got.is_contiguous()
    want = FA.attention_plain(q, k, v, kv_mask=mask).float()
    torch.cuda.synchronize()
    assert float((got.float() - want).abs().max()) <= 2e-2 * float(want.abs().max())
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        FA.flash_attention(q, k, v, kv_mask=mask)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = FA.flash_attention(q, k, v, kv_mask=mask)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


# (T, Cin, C) of the 12 blocks of one BRIDGeR UNet pass (chip_smoke.K2_SHAPES)
K2_BLOCKS = [(16, 10, 256), (16, 256, 256), (8, 256, 512), (8, 512, 512), (4, 512, 512),
             (4, 512, 512), (4, 512, 512), (4, 512, 512), (4, 1024, 512), (4, 512, 512),
             (8, 1024, 256), (8, 256, 256)]


def _k2_case(g, T, Cin, C, device, S=2, B=1, G=512, K=5):
    def w(*shape, scale):
        return (torch.randn(shape, generator=g, device=device) * scale).to(torch.bfloat16)

    p = {"w0": w(S, K, Cin, C, scale=(K * Cin) ** -0.5), "b0": w(S, C, scale=0.1),
         "g0w": 1 + w(S, C, scale=0.1), "g0b": w(S, C, scale=0.1),
         "fw": w(S, G, 2 * C, scale=G ** -0.5), "fb": w(S, 2 * C, scale=0.1),
         "w1": w(S, K, C, C, scale=(K * C) ** -0.5), "b1": w(S, C, scale=0.1),
         "g1w": 1 + w(S, C, scale=0.1), "g1b": w(S, C, scale=0.1)}
    if Cin != C:
        p["wr"], p["br"] = w(S, Cin, C, scale=Cin ** -0.5), w(S, C, scale=0.1)
    return w(S, B, T, Cin, scale=1.0), w(S, B, G, scale=1.0), p


@pytest.mark.parametrize("T,Cin,C", [(16, 10, 256), (4, 1024, 512), (8, 256, 256), (32, 10, 256),
                                    (32, 256, 256), (20, 256, 512)])
def test_resblock_kernel_matches_plain(cuda, T, Cin, C):
    """bf16 kernel vs the f32 plain version: 3e-2 (bf16 output)."""
    from vla_touch_tpu_torch.ops import unet_kernels as UK

    g = torch.Generator(device=cuda).manual_seed(1)
    x, cond, p = _k2_case(g, T, Cin, C, cuda)
    before = UK.resblock_fused.launches
    got = UK.resblock_fused(x, cond, p)
    assert UK.resblock_fused.launches == before + 1
    want = UK.resblock_ref(x, cond, p)
    torch.cuda.synchronize()
    err = float((got.float() - want).abs().max())
    assert np.isfinite(err) and err < 3e-2, err
    with pytest.raises(TypeError):
        UK.resblock_fused(x.float(), cond, p)


def test_resblock_kernel_serves_every_block_of_a_unet_pass(cuda):
    """All twelve block shapes in the order of a UNet pass (so narrower
    calls follow wider ones, whose launch limits are cached: those may only
    rise), then the first again; each within 3e-2 of the plain version, with
    B = 2 at the first shape (the batch loop), and a second call of each
    gives the same bits (every sum in a fixed order, nothing left from the
    call before)."""
    from vla_touch_tpu_torch.ops import unet_kernels as UK

    g = torch.Generator(device=cuda).manual_seed(21)
    for i, (T, Cin, C) in enumerate(K2_BLOCKS + K2_BLOCKS[:1]):
        x, cond, p = _k2_case(g, T, Cin, C, cuda, B=2 if i == 0 else 1)
        first = UK.resblock_fused(x, cond, p)
        second = UK.resblock_fused(x, cond, p)
        want = UK.resblock_ref(x, cond, p)
        torch.cuda.synchronize()
        err = float((first.float() - want).abs().max())
        assert np.isfinite(err) and err < 3e-2, (T, Cin, C, err)
        assert torch.equal(first, second), (T, Cin, C)


def test_resblock_kernel_repeats_bit_for_bit_under_graph_replay(cuda):
    """A CUDA graph of one call replayed twice gives the eager call's bits:
    the scratch holds nothing a later call or replay needs reset."""
    from vla_touch_tpu_torch.ops import unet_kernels as UK

    g = torch.Generator(device=cuda).manual_seed(22)
    x, cond, p = _k2_case(g, 8, 1024, 256, cuda)
    got = UK.resblock_fused(x, cond, p)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        UK.resblock_fused(x, cond, p)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = UK.resblock_fused(x, cond, p)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, got)


# (T, Cin, C) of the first two levels of the UNet at the reference's
# 64-step chunk (four and two m16 time tiles) and at horizon 48 (three);
# past one 64-step time chunk (horizons 96 to 256); and blocks too wide for
# one SM as they are (the default down_dims' 1024 channels at T 64 and 128,
# the up path's 2048 inputs)
K2_LONG = [(64, 10, 256), (64, 256, 256), (32, 256, 512), (32, 1024, 256), (48, 10, 256),
           (48, 256, 256), (24, 1024, 256), (61, 256, 512), (96, 10, 256), (128, 256, 256),
           (200, 256, 512), (256, 256, 256), (64, 1024, 1024), (64, 2048, 1024),
           (128, 1024, 1024)]


@pytest.mark.parametrize("T,Cin,C", K2_LONG)
def test_resblock_kernel_at_the_64_step_chunk(cuda, T, Cin, C):
    """Any T launches the kernel: one counted launch, within 3e-2 of the
    plain version (GroupNorm over the whole time axis), B 2 as the batch
    loop, and a CUDA graph of the call replays the eager bits (T 128 too,
    two time chunks; and the wide blocks' capped splits)."""
    from vla_touch_tpu_torch.ops import unet_kernels as UK

    g = torch.Generator(device=cuda).manual_seed(24)
    x, cond, p = _k2_case(g, T, Cin, C, cuda, B=2)
    before = UK.resblock_fused.launches
    got = UK.resblock_fused(x, cond, p)
    assert UK.resblock_fused.launches == before + 1
    want = UK.resblock_ref(x, cond, p)
    torch.cuda.synchronize()
    err = float((got.float() - want).abs().max())
    assert np.isfinite(err) and err < 3e-2, err
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        UK.resblock_fused(x, cond, p)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = UK.resblock_fused(x, cond, p)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, got)


def test_resblock_kernel_refuses_a_grid_that_cannot_be_resident(cuda):
    """A block too wide for one SM's shared memory as it is (its input rows
    alone would need ~650 KB; a FiLM condition of 8192 channels) was
    refused as a grid that cannot be resident.  Now every block is: its
    splits span at most 256 input channels (the staged A), so it launches
    once and matches the plain version within 3e-2."""
    from vla_touch_tpu_torch.ops import unet_kernels as UK

    g = torch.Generator(device=cuda).manual_seed(23)
    for T, Cin, C, G in ((4, 16384, 64, 512), (16, 256, 256, 8192)):
        x, cond, p = _k2_case(g, T, Cin, C, cuda, S=1, G=G)
        before = UK.resblock_fused.launches
        got = UK.resblock_fused(x, cond, p)
        assert UK.resblock_fused.launches == before + 1
        want = UK.resblock_ref(x, cond, p)
        torch.cuda.synchronize()
        err = float((got.float() - want).abs().max())
        assert np.isfinite(err) and err < 3e-2, (T, Cin, C, G, err)


# ---- K6 / K8: the int8 and int4 serving matmuls --------------------------------

def _int8_linear(g, N, K, device):
    from vla_touch_tpu_torch.ops import quant as Q

    lin = torch.nn.Linear(K, N).to(device)
    with torch.no_grad():
        lin.weight.copy_(torch.randn((N, K), generator=g, device=device) * K ** -0.5)
        lin.bias.copy_(torch.randn((N,), generator=g, device=device) * 0.1)
    return lin, Q


@pytest.mark.parametrize("M,K,N,x_dtype", [
    (67, 2048, 6144, torch.bfloat16),
    (1, 256, 2048, torch.bfloat16),
    (64, 4096, 2048, torch.float32),
    (130, 48, 200, torch.bfloat16),
    (24, 18944, 512, torch.bfloat16),
])
def test_a8w8_kernel_matches_plain(cuda, M, K, N, x_dtype):
    """K6 vs the plain qdense on the same operands.  The int8 codes and the
    int32 sums are exact and the float32 epilogue runs in the same order,
    so the kernel's bf16 out is the plain float32 out rounded: one bf16
    step (2^-8 relative)."""
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    g = torch.Generator(device=cuda).manual_seed(2)
    lin, Q = _int8_linear(g, N, K, cuda)
    qp = Q.quantize_linear(lin)
    x = (torch.randn((M, K), generator=g, device=cuda) * 2).to(x_dtype)
    before = QM.a8w8_matmul.launches
    got = QM.a8w8_matmul(x, qp.w_i8, qp.scale, qp.bias)
    assert QM.a8w8_matmul.launches == before + 1
    want = QM.a8w8_plain(x, qp.w_i8, qp.scale, qp.bias, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    tol = 2 ** -8 * float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= tol


@pytest.mark.parametrize("M,K,N,x_dtype", [
    (67, 1040, 256, torch.bfloat16),     # 17 chunks, the last of 16 bytes, over 3 splits
    (1, 2048, 2048, torch.float32),
    (24, 3584, 512, torch.bfloat16),
    (67, 2048, 2048, torch.float32),
    (80, 2048, 2048, torch.bfloat16),
    (512, 4096, 128, torch.bfloat16),
    (1, 18944, 3584, torch.bfloat16),
    (67, 2048, 6144, torch.bfloat16),
])
def test_a8w8_kernel_is_exact_under_split_k(cuda, M, K, N, x_dtype):
    """K6 under its split plan is bit for bit the plain float32 out rounded
    to bf16 (exact int32 partials, one epilogue per element in the plain
    order); a CUDA graph of the call replayed twice gives the same bits,
    so no call leaves state behind for the next (the splits of a tile
    meet in their cluster's shared memory)."""
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    g = torch.Generator(device=cuda).manual_seed(12)
    lin, Q = _int8_linear(g, N, K, cuda)
    qp = Q.quantize_linear(lin)
    x = (torch.randn((M, K), generator=g, device=cuda) * 2).to(x_dtype)
    got = QM.a8w8_matmul(x, qp.w_i8, qp.scale, qp.bias)
    want = QM.a8w8_plain(x, qp.w_i8, qp.scale, qp.bias, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert int((got != want.to(torch.bfloat16)).sum()) == 0
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        QM.a8w8_matmul(x, qp.w_i8, qp.scale, qp.bias)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = QM.a8w8_matmul(x, qp.w_i8, qp.scale, qp.bias)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(out.clone())
    assert torch.equal(replays[0], got) and torch.equal(replays[1], got)
    assert torch.equal(QM.a8w8_matmul(x, qp.w_i8, qp.scale, qp.bias), got)


@pytest.mark.parametrize("plan", [(5, 2, 1), (5, 2, 3), (5, 4, 1), (5, 4, 5), (2, 4, 8)])
def test_a8w8_kernel_plans_agree(cuda, plan):
    """Every plan the tools time gives the same bits at (67, 2048, 2048)."""
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    g = torch.Generator(device=cuda).manual_seed(13)
    lin, Q = _int8_linear(g, 2048, 2048, cuda)
    qp = Q.quantize_linear(lin)
    x = (torch.randn((67, 2048), generator=g, device=cuda) * 2).to(torch.bfloat16)
    want = QM.a8w8_plain(x, qp.w_i8, qp.scale, qp.bias, out_dtype=torch.float32)
    got = QM._a8w8_launch(x, qp.w_i8, qp.scale, qp.bias, plan)
    torch.cuda.synchronize()
    assert int((got != want.to(torch.bfloat16)).sum()) == 0


@pytest.mark.parametrize("M,K,N,x_dtype", [
    (67, 2048, 2048, torch.bfloat16),
    (1, 256, 2048, torch.bfloat16),
    (64, 4096, 2048, torch.float32),
    (90, 320, 136, torch.bfloat16),
    (442, 18944, 512, torch.bfloat16),
])
def test_w4a8_kernel_matches_plain(cuda, M, K, N, x_dtype):
    """K8 vs the plain qdense_w4 (group sizes 128, 128, 128, 160 and 128;
    N 136 leaves a partial column tile; 148 rolled groups over 442 rows is
    the planner's down projection in a long prompt pass).  The group sums are exact; only the
    float32 sum across groups runs in another order, so the kernel's bf16
    out is within one bf16 step (2^-8 relative) of the plain float32 out."""
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    g = torch.Generator(device=cuda).manual_seed(3)
    lin, Q = _int8_linear(g, N, K, cuda)
    qp = Q.quantize_linear_w4(lin)
    x = (torch.randn((M, K), generator=g, device=cuda) * 2).to(x_dtype)
    before = QM.w4a8_matmul.launches
    got = QM.w4a8_matmul(x, qp.w4_pack, qp.scale4, qp.bias)
    assert QM.w4a8_matmul.launches == before + 1
    want = QM.w4a8_plain(x, qp.w4_pack, qp.scale4, qp.bias, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    tol = 2 ** -8 * float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= tol


@pytest.mark.parametrize("M,K,N,gs", [
    (17, 2048, 2048, 128), (64, 4096, 2048, 128), (67, 2048, 6144, 128),
    (72, 3584, 3584, 128), (442, 3584, 4608, 128), (512, 2048, 256, 128),
    (67, 2048, 200, 128), (72, 18944, 512, 128), (442, 18944, 136, 128),
    (442, 2048, 512, 512),
])
def test_w4a8_tile_body_matches_plain(cuda, M, K, N, gs):
    """K8 under k8_plan (the warp loop up to 80 rows, the tile body above)
    and under the tile body's plans (2, 1) and (2, 2) at every shape, vs
    the plain qdense_w4: within one bf16 step (2^-8 x max|plain|); N 200
    and 136 leave a partial 128-column tile; K 18944 has 148 groups (rolled
    in the TPU kernel); groups of 512 take the fold's I2F path (group sums
    past 2^22)."""
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    g = torch.Generator(device=cuda).manual_seed(31)
    lin, Q = _int8_linear(g, N, K, cuda)
    qp = Q.quantize_linear_w4(lin, group_size=gs)
    assert K // qp.scale4.shape[0] == gs
    x = (torch.randn((M, K), generator=g, device=cuda) * 2).to(torch.bfloat16)
    before = QM.w4a8_matmul.launches
    got = QM.w4a8_matmul(x, qp.w4_pack, qp.scale4, qp.bias)
    assert QM.w4a8_matmul.launches == before + 1
    want = QM.w4a8_plain(x, qp.w4_pack, qp.scale4, qp.bias, out_dtype=torch.float32)
    tol = 2 ** -8 * float(want.abs().max())
    torch.cuda.synchronize()
    assert float((got.float() - want).abs().max()) <= tol
    for plan in ((2, 1), (2, 2)):
        got = QM._w4a8_launch(x, qp.w4_pack, qp.scale4, qp.bias, plan)
        torch.cuda.synchronize()
        assert float((got.float() - want).abs().max()) <= tol, plan


@pytest.mark.parametrize("M,K,N,plan", [(67, 2048, 2048, (2, 4)), (72, 18944, 3584, (2, 2)),
                                        (442, 3584, 3584, None)])
def test_w4a8_tile_body_repeats_bit_for_bit(cuda, M, K, N, plan):
    """Every sum of the tile body runs in a fixed order (the splits of a
    tile meet in their cluster's shared memory in rank order): a second
    call and two replays of a CUDA graph of the call give the same bits
    (plan None: k8_plan's, (2, 2) at the 442-row o projection)."""
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    g = torch.Generator(device=cuda).manual_seed(32)
    lin, Q = _int8_linear(g, N, K, cuda)
    qp = Q.quantize_linear_w4(lin)
    x = (torch.randn((M, K), generator=g, device=cuda) * 2).to(torch.bfloat16)

    def call():
        return QM._w4a8_launch(x, qp.w4_pack, qp.scale4, qp.bias, plan)

    got = call()
    assert torch.equal(call(), got)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, got)


@pytest.mark.parametrize("plan", [(0, 1), (2, 1), (2, 3), (2, 4), (2, 8)])
def test_w4a8_tile_plans_agree(cuda, plan):
    """The warp loop and every tile plan (mt, splits) the tools time stay
    within one bf16 step of the plain version at (67, 2048, 2048)."""
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    g = torch.Generator(device=cuda).manual_seed(33)
    lin, Q = _int8_linear(g, 2048, 2048, cuda)
    qp = Q.quantize_linear_w4(lin)
    x = (torch.randn((67, 2048), generator=g, device=cuda) * 2).to(torch.bfloat16)
    want = QM.w4a8_plain(x, qp.w4_pack, qp.scale4, qp.bias, out_dtype=torch.float32)
    got = QM._w4a8_launch(x, qp.w4_pack, qp.scale4, qp.bias, plan)
    torch.cuda.synchronize()
    assert float((got.float() - want).abs().max()) <= 2 ** -8 * float(want.abs().max())


def test_qdense_kernel_a8w8_routes_k_off_16_as_jax_routes_to_xla(cuda):
    """An int8 leaf whose K is off K6's 16-column piece (which K6 refuses)
    goes to the plain ``qdense``, as JAX's dispatch sends K off 128 to XLA:
    no launch, the plain version's bits; K 48 launches K6 (one bf16 step
    of the plain version)."""
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    g = torch.Generator(device=cuda).manual_seed(31)
    for K, launched in ((40, 0), (48, 1)):
        lin, Q = _int8_linear(g, 128, K, cuda)
        qp = Q.quantize_linear(lin)
        x = torch.randn((67, K), generator=g, device=cuda).to(torch.bfloat16)
        before = QM.a8w8_matmul.launches
        got = QM.qdense_kernel_a8w8(x, qp)
        assert QM.a8w8_matmul.launches == before + launched
        want = Q.qdense(x, qp)
        torch.cuda.synchronize()
        if launched:
            err = float((got.float() - want.float()).abs().max())
            assert err <= 2 ** -7 * float(want.float().abs().max())
        else:
            assert torch.equal(got, want)


def test_int8_matmul_kernels_refuse_what_they_do_not_take(cuda):
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    x = torch.zeros((4, 40), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((8, 40), device=cuda, dtype=torch.int8)
    s = torch.ones((8,), device=cuda)
    with pytest.raises(ValueError):
        QM.a8w8_matmul(x, w, s)                          # K not a multiple of 16
    with pytest.raises(TypeError):
        QM.a8w8_matmul(x[:, :32].half(), w[:, :32].contiguous(), s)   # fp16 x
    with pytest.raises(ValueError):
        QM.w4a8_matmul(x[:, :32], w[:, :16], torch.ones((3, 8), device=cuda))  # odd G


@pytest.mark.parametrize("M,K,N,x_dtype", [
    (4374, 2048, 4096, torch.bfloat16),
    (4374, 1152, 2048, torch.float32),
    (300, 256, 512, torch.bfloat16),
    (1, 128, 512, torch.float32),
    (130, 2048, 1024, torch.bfloat16),
])
def test_a8w8_large_kernel_matches_plain(cuda, M, K, N, x_dtype):
    """K7 vs its plain version (x quantized from float32 as given, rows
    scaled by amax * (1/127)): the codes and int32 sums are exact and the
    float32 epilogue runs in the same order, so the kernel's bf16 out is the
    plain float32 out rounded, within one bf16 step (2^-8 relative); M 4374
    is the image condition's length, with a partial 128-row tile."""
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    g = torch.Generator(device=cuda).manual_seed(9)
    lin, Q = _int8_linear(g, N, K, cuda)
    qp = Q.quantize_linear(lin)
    x = (torch.randn((M, K), generator=g, device=cuda) * 2).to(x_dtype)
    before = QM.a8w8_matmul_large.launches
    got = QM.a8w8_matmul_large(x, qp.w_i8, qp.scale, qp.bias)
    assert QM.a8w8_matmul_large.launches == before + 1
    want = QM.a8w8_large_plain(x, qp.w_i8, qp.scale, qp.bias, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert float((got.float() - want).abs().max()) <= 2 ** -8 * float(want.abs().max())


@pytest.mark.parametrize("M,K,N,x_dtype", [
    (67, 2048, 2048, torch.bfloat16),
    (1, 256, 2048, torch.float32),
    (33, 256, 512, torch.bfloat16),
    (130, 384, 640, torch.bfloat16),
    (1, 18944, 3584, torch.bfloat16),
])
def test_w8a16_kernel_matches_plain(cuda, M, K, N, x_dtype):
    """K5 vs its plain version (the float32 product of the bf16 x and the
    int8 weights): exact products, float32 sums in another order, so the
    kernel's bf16 out is within one bf16 step (2^-8 relative) of the plain
    float32 out.  M 130 takes two row blocks, the second partial."""
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    g = torch.Generator(device=cuda).manual_seed(10)
    lin, Q = _int8_linear(g, N, K, cuda)
    qp = Q.quantize_linear(lin)
    x = (torch.randn((M, K), generator=g, device=cuda) * 2).to(x_dtype)
    before = QM.w8a16_matmul.launches
    got = QM.qdense_kernel_w8a16(x, qp)
    assert QM.w8a16_matmul.launches == before + 1
    want = QM.w8a16_plain(x, qp.w_i8, qp.scale, qp.bias, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert float((got.float() - want).abs().max()) <= 2 ** -8 * float(want.abs().max())


def _graph_of(fn):
    """(graph, out): ``fn()`` warmed on a side stream, then captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


@pytest.mark.parametrize("M,K,N", [(1, 1024, 640), (17, 1024, 640), (67, 1024, 640),
                                   (80, 1024, 640), (81, 1024, 640), (130, 1024, 640),
                                   (1, 3584, 152064)])
def test_w8a16_kernel_every_plan_repeats_bit_for_bit(cuda, M, K, N):
    """K5 under every plan it can take at (M, K, N) (4 or 8 warps across
    columns, 1 to 8 K splits; the lm_head width: 1, 2 and 8) is within one
    bf16 step (2^-8 relative) of its plain version and gives the same bits
    when repeated; its own plan also under CUDA-graph replay (the splits
    of a tile meet in their cluster's shared memory, in rank order)."""
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    g = torch.Generator(device=cuda).manual_seed(14)
    lin, Q = _int8_linear(g, N, K, cuda)
    qp = Q.quantize_linear(lin)
    x = (torch.randn((M, K), generator=g, device=cuda) * 2).to(torch.bfloat16)
    want = QM.w8a16_plain(x, qp.w_i8, qp.scale, qp.bias, out_dtype=torch.float32)
    tol = 2 ** -8 * float(want.abs().max())
    mt = min(5, -(-M // 16))
    splits = (1, 2, 8) if N > 100000 else range(1, 9)
    for plan in [(mt, wn, s) for wn in (4, 8) for s in splits]:
        got = QM._w8a16_launch(x, qp.w_i8, qp.scale, qp.bias, plan)
        again = QM._w8a16_launch(x, qp.w_i8, qp.scale, qp.bias, plan)
        torch.cuda.synchronize()
        assert float((got.float() - want).abs().max()) <= tol, plan
        assert torch.equal(got, again), plan
    got = QM.w8a16_matmul(x, qp.w_i8, qp.scale, qp.bias)
    graph, out = _graph_of(lambda: QM.w8a16_matmul(x, qp.w_i8, qp.scale, qp.bias))
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, got)


@pytest.mark.parametrize("M", [1, 22, 129, 4374])
@pytest.mark.parametrize("K,N", [(128, 512), (1152, 4096)])
def test_a8w8_large_kernel_is_exact(cuda, M, K, N):
    """K7 on a float32 x whose row stride exceeds K:
    no bf16 output unlike the plain float32 out rounded to bf16 (exact
    codes and int32 sums, the plain epilogue's order); K 128 is a single
    128-byte stage, 4374 rows end in a 22-row tile; the same bits when
    repeated."""
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    g = torch.Generator(device=cuda).manual_seed(15)
    lin, Q = _int8_linear(g, N, K, cuda)
    qp = Q.quantize_linear(lin)
    x = (torch.randn((M, K + 64), generator=g, device=cuda) * 2)[:, :K]
    assert x.stride(0) == K + 64
    want = QM.a8w8_large_plain(x, qp.w_i8, qp.scale, qp.bias, out_dtype=torch.float32)
    got = QM.a8w8_matmul_large(x, qp.w_i8, qp.scale, qp.bias)
    again = QM.a8w8_matmul_large(x, qp.w_i8, qp.scale, qp.bias)
    torch.cuda.synchronize()
    assert int((got != want.to(torch.bfloat16)).sum()) == 0
    assert torch.equal(got, again)


@pytest.mark.parametrize("M", [22, 4374])
def test_a8w8_large_kernel_writes_no_row_past_m(cuda, M):
    """K7's C entry with its output at the start of a buffer whose 128 rows
    past M hold a canary (a bf16 NaN's bits): the first M rows are the
    wrapper's output and no guard element changes (the last row tile's
    rows past M are masked; the wrapper's own output ends in allocator
    slack that no other check reads)."""
    import ctypes

    from vla_touch_tpu_torch.csrc import build
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    g = torch.Generator(device=cuda).manual_seed(17)
    K, N = 2048, 4096
    lin, Q = _int8_linear(g, N, K, cuda)
    qp = Q.quantize_linear(lin)
    x = (torch.randn((M, K), generator=g, device=cuda) * 2).to(torch.bfloat16)
    canary, guard = 0x7FC1, 128
    buf = torch.full((M + guard, N), canary, dtype=torch.int16, device=cuda)
    xq = torch.empty((M, K), dtype=torch.int8, device=cuda)
    rs = torch.empty((M,), dtype=torch.float32, device=cuda)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib, f = build.entry("a8w8_matmul_large", [P, I, L, P, P, P, P, P, P, I, I, I, P])
    err = f(x.data_ptr(), 0, x.stride(0), qp.w_i8.data_ptr(), qp.scale.data_ptr(),
            qp.bias.data_ptr(), xq.data_ptr(), rs.data_ptr(), buf.data_ptr(), M, N, K,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "a8w8_matmul_large")
    got = QM.a8w8_matmul_large(x, qp.w_i8, qp.scale, qp.bias)
    torch.cuda.synchronize()
    assert torch.equal(buf[:M].view(torch.bfloat16), got)
    assert int((buf[M:] != canary).sum()) == 0


def test_a8w8_large_kernel_under_a_graph_of_two_weight_sets(cuda):
    """One CUDA graph captures K7 on two weight tensors (each launch keeps
    its own TMA maps, passed by value): each replay gives each call's own
    exact output."""
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    g = torch.Generator(device=cuda).manual_seed(16)
    M, K, N = 300, 1152, 1024
    qps = []
    for _ in range(2):
        lin, Q = _int8_linear(g, N, K, cuda)
        qps.append(Q.quantize_linear(lin))
    x = (torch.randn((M, K), generator=g, device=cuda) * 2).to(torch.bfloat16)
    wants = [QM.a8w8_large_plain(x, qp.w_i8, qp.scale, qp.bias, out_dtype=torch.float32)
             .to(torch.bfloat16) for qp in qps]
    graph, outs = _graph_of(lambda: [QM.a8w8_matmul_large(x, qp.w_i8, qp.scale, qp.bias)
                                     for qp in qps])
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for out, want in zip(outs, wants):
            assert int((out != want).sum()) == 0
    assert not torch.equal(outs[0], outs[1])


def test_k5_k7_refuse_or_route_what_they_do_not_take(cuda):
    """K7's entry sends N % 512 != 0 to the plain qdense (no launch); both
    refuse fp16 x and a weight that is not 16-byte aligned; K5 refuses K
    not a multiple of 128."""
    from vla_touch_tpu_torch.ops import quant as Q
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    x = torch.randn((20, 256), device=cuda).to(torch.bfloat16)
    w = torch.ones((384, 256), device=cuda, dtype=torch.int8)
    s = torch.ones((384,), device=cuda)
    n7 = QM.a8w8_matmul_large.launches
    y = QM.a8w8_matmul_large(x, w, s)
    assert QM.a8w8_matmul_large.launches == n7
    assert torch.equal(y, Q.qdense(x, Q.QLinear(w, s)))
    w = torch.ones((512, 256), device=cuda, dtype=torch.int8)
    s = torch.ones((512,), device=cuda)
    for fn in (QM.a8w8_matmul_large, QM.w8a16_matmul):
        with pytest.raises(TypeError):
            fn(x.half(), w, s)
        with pytest.raises(ValueError):
            fn(x[:, :128], w.reshape(-1)[1:1 + 512 * 128].view(512, 128), s)
    with pytest.raises(ValueError):
        QM.w8a16_matmul(x[:, :192], w[:, :192].contiguous(), s)


# ---- K3 / K4: flash attention over an int8 K/V cache ---------------------------

@pytest.mark.parametrize("B,Lq,Lkv,H,D,mask_kind", [
    (1, 67, 4374, 32, 64, None),         # the image cache: 18 splits, combined
    (2, 67, 4374, 32, 64, "fully_masked"),   # row 0 loses its last quarter, row 1 all
    (1, 67, 4374, 32, 64, "dead_split"),     # every key of the second split masked
    (1, 67, 64, 32, 64, "ragged"),       # the language cache: one split
    (1, 67, 1, 32, 64, None),
    (1, 67, 65, 32, 64, "ragged"),       # two tiles, the second ragged
    (1, 67, 1000, 32, 64, None),         # a ragged last tile at 8 splits
    (1, 200, 1000, 4, 64, "ragged"),     # two query tiles, each split
    (2, 35, 300, 4, 64, "fully_masked"),
    (1, 67, 4374, 16, 72, None),         # RDT-170M's image cache (K4: refused, as JAX)
    (1, 67, 64, 16, 72, "ragged"),       # ... and its language cache
    (1, 67, 4374, 8, 160, None),         # above D 128: fewer query rows a CTA
    (2, 67, 1000, 8, 160, "fully_masked"),
    (1, 130, 600, 4, 256, "ragged"),     # D 256: 32 query rows a CTA, 5 q tiles
    (1, 20, 300, 2, 40, None),
])
@pytest.mark.parametrize("transposed", [False, True])
def test_flash_attention_q8_kernels_match_plain(cuda, B, Lq, Lkv, H, D, mask_kind, transposed):
    """K3 (B, L, H, D cache) and K4 (B, H, D, L cache) vs the plain version:
    max abs error <= 2e-2 x max|plain| (bf16 p and output); fully masked
    rows exactly 0; one launch counted per call, combine included.  K4 at a
    D off 16 raises, as JAX's K4 asserts D % 32."""
    from vla_touch_tpu_torch.ops import flash_attention_q8 as FQ

    g = torch.Generator(device=cuda).manual_seed(4)

    def mk(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)

    q, kv = mk(B, Lq, H, D), mk(B, Lkv, 2, H, D)
    quant = FQ.quantize_kv_t if transposed else FQ.quantize_kv
    cache = quant(kv[:, :, 0], kv[:, :, 1])
    mask = None
    if mask_kind == "dead_split":
        splits, tps = FQ.split_plan(B, Lq, Lkv, H, FQ._sm_count(cuda.index or 0))
        assert splits >= 3
        mask = torch.ones((B, Lkv), dtype=torch.bool, device=cuda)
        mask[:, tps * 64:2 * tps * 64] = False
    elif mask_kind:
        mask = torch.ones((B, Lkv), dtype=torch.bool, device=cuda)
        mask[0, Lkv * 3 // 4:] = False
        if mask_kind == "fully_masked":
            mask[-1] = False
    fn = FQ.flash_attention_q8t if transposed else FQ.flash_attention_q8
    plain = FQ.attention_q8t_plain if transposed else FQ.attention_q8_plain
    before = fn.launches
    if transposed and D % 16:
        with pytest.raises(ValueError, match="multiple of 16"):
            fn(q, *cache, kv_mask=mask)
        assert fn.launches == before
        return
    got = fn(q, *cache, kv_mask=mask)
    assert fn.launches == before + 1
    want = plain(q.float(), *cache, kv_mask=mask)
    torch.cuda.synchronize()
    assert float((got.float() - want).abs().max()) <= 2e-2 * float(want.abs().max())
    if mask_kind == "fully_masked":
        assert float(got[-1].float().abs().max()) == 0.0


def test_flash_attention_q8_refuses_what_it_does_not_take(cuda):
    from vla_touch_tpu_torch.ops import flash_attention_q8 as FQ

    q = torch.zeros((1, 4, 2, 64), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((1, 20, 2, 64), device=cuda, dtype=torch.int8)
    s = torch.ones((1, 2, 64), device=cuda)
    with pytest.raises(TypeError):
        FQ.flash_attention_q8(q.float(), k, s, k, s)     # float32 q
    with pytest.raises(ValueError):
        FQ.flash_attention_q8t(q, k, s, k, s)            # K3's layout given to K4
    kt = torch.zeros((1, 2, 64, 20), device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError):
        FQ.flash_attention_q8t(q, kt, s, kt, s)          # rows not 16-byte aligned
    q = torch.zeros((1, 4, 2, 272), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((1, 20, 2, 272), device=cuda, dtype=torch.int8)
    s = torch.ones((1, 2, 272), device=cuda)
    with pytest.raises(ValueError, match="<= 256"):
        FQ.flash_attention_q8(q, k, s, k, s)             # D above 256


def test_flash_attention_q8_copies_a_cache_off_the_16_byte_rows(cuda):
    """K3 at D 72 on a contiguous cache (rows 72 bytes: not 16-byte aligned)
    gives the bits of the same codes in quantize_kv's row-aligned storage
    (the wrapper copies them into it), one launch a call."""
    from vla_touch_tpu_torch.ops import flash_attention_q8 as FQ

    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((1, 67, 16, 72), generator=g, device=cuda).to(torch.bfloat16)
    kv = torch.randn((1, 700, 2, 16, 72), generator=g, device=cuda).to(torch.bfloat16)
    k8, sk, v8, sv = FQ.quantize_kv(kv[:, :, 0], kv[:, :, 1])
    assert k8.stride(2) == 80 and not k8.is_contiguous()
    before = FQ.flash_attention_q8.launches
    aligned = FQ.flash_attention_q8(q, k8, sk, v8, sv)
    packed = FQ.flash_attention_q8(q, k8.contiguous(), sk, v8.contiguous(), sv)
    assert FQ.flash_attention_q8.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(aligned, packed)


def _w4_leaf(g, N, K, device, bias=False):
    from vla_touch_tpu_torch.ops import quant as Q

    lin = torch.nn.Linear(K, N, bias=bias, device=device)
    with torch.no_grad():
        lin.weight.copy_(torch.randn((N, K), generator=g, device=device) * K ** -0.5)
        if bias:
            lin.bias.copy_(torch.randn((N,), generator=g, device=device) * 0.1)
    return Q.quantize_linear_w4(lin)


@pytest.mark.parametrize("kernel", ["K9", "K10"])
@pytest.mark.parametrize("M,D,F,gs_down", [(1, 512, 1024, 128), (5, 512, 1024, 32),
                                           (17, 384, 640, 128), (32, 3584, 18944, 128)])
def test_w4_megakernels_match_plain(cuda, kernel, M, D, F, gs_down):
    """K9 / K10 vs their plain versions: max abs error <= 1e-2 x max|plain|
    (the codes of x, att and h are exact; a bf16 g/u or activation whose
    float32 sums, taken in other orders, straddle a rounding edge can move
    one activation code).  Unrolled and rolled group counts, one and two
    16-row tiles, biases on gate|up, Qwen2.5-7B width at M = 32."""
    from vla_touch_tpu_torch.ops import w4_fused as W4F

    g = torch.Generator(device=cuda).manual_seed(6)
    gu = _w4_leaf(g, 2 * F, D, cuda, bias=True)
    down = _w4_leaf(g, D, F, cuda)
    if gs_down != 128:
        from vla_touch_tpu_torch.ops import quant as Q

        lin = torch.nn.Linear(F, D, bias=False, device=cuda)
        with torch.no_grad():
            lin.weight.copy_(torch.randn((D, F), generator=g, device=cuda) * F ** -0.5)
        down = Q.quantize_linear_w4(lin, group_size=gs_down)
    x = (torch.randn((M, D), generator=g, device=cuda) * 2).to(torch.bfloat16)
    if kernel == "K9":
        fn, ops = W4F.w4_swiglu_mlp, (x, gu, down)
        want = W4F.w4_swiglu_plain(*ops, out_dtype=torch.float32)
    else:
        att = (torch.randn((M, D), generator=g, device=cuda) * 2).to(torch.bfloat16)
        o = _w4_leaf(g, D, D, cuda)
        nw = 1 + 0.1 * torch.randn((D,), generator=g, device=cuda)
        fn, ops = W4F.w4_postattn_fused, (x, att, o, gu, down, nw)
        want = W4F.w4_postattn_plain(*ops, out_dtype=torch.float32)
    before = fn.launches
    got = fn(*ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert float((got.float() - want).abs().max()) <= 1e-2 * float(want.abs().max())


@pytest.mark.parametrize("kernel", ["K9", "K10"])
@pytest.mark.parametrize("M", [1, 5, 8, 17, 32])
def test_w4_megakernels_repeat_bit_for_bit(cuda, kernel, M):
    """K9 / K10 at a narrow width (D 512, F 2048; K10's o from Ka 1024),
    where most blocks of the grid get no o or down tile: within MK_TOL
    (2e-2 x max|plain|) of the plain version, and a second call gives the
    same bits (every sum in a fixed order; the row maxima start at 0 in
    every call)."""
    from vla_touch_tpu_torch.ops import w4_fused as W4F

    D, F, Ka = 512, 2048, 1024
    g = torch.Generator(device=cuda).manual_seed(9)
    gu, down = _w4_leaf(g, 2 * F, D, cuda, bias=True), _w4_leaf(g, D, F, cuda)
    x = (torch.randn((M, D), generator=g, device=cuda) * 2).to(torch.bfloat16)
    if kernel == "K9":
        fn, ops = W4F.w4_swiglu_mlp, (x, gu, down)
        want = W4F.w4_swiglu_plain(*ops, out_dtype=torch.float32)
    else:
        att = (torch.randn((M, Ka), generator=g, device=cuda) * 2).to(torch.bfloat16)
        o = _w4_leaf(g, D, Ka, cuda)
        nw = 1 + 0.1 * torch.randn((D,), generator=g, device=cuda)
        fn, ops = W4F.w4_postattn_fused, (x, att, o, gu, down, nw)
        want = W4F.w4_postattn_plain(*ops, out_dtype=torch.float32)
    before = fn.launches
    first, second = fn(*ops), fn(*ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    assert torch.equal(first, second)
    assert float((first.float() - want).abs().max()) <= 2e-2 * float(want.abs().max())


def test_w4_megakernels_serve_a_wider_call_after_a_narrower_one(cuda):
    """K9 at width 1024, then 256, then 1024 again (one row tile each): the
    kernel's shared-memory limit set for the first call must not be lowered
    by the second under the third, whose grid is cached."""
    from vla_touch_tpu_torch.ops import w4_fused as W4F

    g = torch.Generator(device=cuda).manual_seed(10)
    for D in (1024, 256, 1024):
        gu, down = _w4_leaf(g, 2 * 512, D, cuda), _w4_leaf(g, D, 512, cuda)
        x = torch.randn((1, D), generator=g, device=cuda).to(torch.bfloat16)
        before = W4F.w4_swiglu_mlp.launches
        got = W4F.w4_swiglu_mlp(x, gu, down)
        torch.cuda.synchronize()
        assert W4F.w4_swiglu_mlp.launches == before + 1
        want = W4F.w4_swiglu_plain(x, gu, down, out_dtype=torch.float32)
        assert float((got.float() - want).abs().max()) <= 2e-2 * float(want.abs().max())


def test_w4_megakernels_compose_what_they_do_not_take(cuda):
    """M > 32 and widths that are not multiples of 128 take the composed
    route (K8 or plain) and launch no megakernel; the dispatcher sends
    M <= 32 to K9."""
    from vla_touch_tpu_torch.ops import w4_fused as W4F

    g = torch.Generator(device=cuda).manual_seed(7)
    D, F = 256, 512
    gu, down, o = _w4_leaf(g, 2 * F, D, cuda), _w4_leaf(g, D, F, cuda), _w4_leaf(g, D, D, cuda)
    nw = torch.ones((D,), device=cuda)
    x = torch.randn((40, D), generator=g, device=cuda).to(torch.bfloat16)
    n9, n10 = W4F.w4_swiglu_mlp.launches, W4F.w4_postattn_fused.launches
    y = W4F.w4_postattn_fused(x, x, o, gu, down, nw)
    z = W4F.qdense_kernel_swiglu(x, gu, down)
    torch.cuda.synchronize()
    assert (W4F.w4_swiglu_mlp.launches, W4F.w4_postattn_fused.launches) == (n9, n10)
    want = W4F.w4_postattn_plain(x, x, o, gu, down, nw, out_dtype=torch.float32)
    assert float((y.float() - want).abs().max()) <= 1e-2 * float(want.abs().max())
    assert z.shape == (40, D)
    W4F.qdense_kernel_swiglu(x[:3], gu, down)
    assert W4F.w4_swiglu_mlp.launches == n9 + 1


def test_w4_megakernels_route_on_the_librarys_shared_memory_budget(cuda):
    """The routing guard asks the kernel library (``w4_megakernel_fits``):
    one 16-row tile of width 8192 fits an H100 block, two do not; so K9 at
    M = 24 and width 8192 composes (K8) and launches no megakernel, and at
    M = 16 it launches."""
    from vla_touch_tpu_torch.ops import w4_fused as W4F

    dev = torch.device(cuda)
    assert W4F._fits(32, 3584, dev) and W4F._fits(16, 8192, dev)
    assert not W4F._fits(24, 8192, dev) and not W4F._fits(33, 256, dev)
    g = torch.Generator(device=cuda).manual_seed(8)
    D, F = 8192, 256
    gu, down = _w4_leaf(g, 2 * F, D, cuda), _w4_leaf(g, D, F, cuda)
    x = torch.randn((24, D), generator=g, device=cuda).to(torch.bfloat16)
    n9 = W4F.w4_swiglu_mlp.launches
    y = W4F.w4_swiglu_mlp(x, gu, down)
    torch.cuda.synchronize()
    assert W4F.w4_swiglu_mlp.launches == n9
    want = W4F.w4_swiglu_plain(x, gu, down, out_dtype=torch.float32)
    assert float((y.float() - want).abs().max()) <= 1e-2 * float(want.abs().max())
    W4F.w4_swiglu_mlp(x[:16], gu, down)
    assert W4F.w4_swiglu_mlp.launches == n9 + 1


@pytest.mark.parametrize("B", [3, 6])
def test_flash_attention_kernel_at_the_vit_twin_layout(cuda, B):
    """K1 at SigLIP's shape with q, k and v strided views of one fused
    (B, 729, 3, 16, 72) projection, as the serving twin
    (``models/encoders/vit_serve.py``) passes them, on the warm tick's 3
    frames and a cold tick's 6: <= 2e-2 x max|plain|."""
    from vla_touch_tpu_torch.ops import flash_attention as FA

    g = torch.Generator(device=cuda).manual_seed(B)
    qkv = torch.randn((B, 729, 3, 16, 72), generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v)
    assert FA.flash_attention.launches == before + 1
    want = FA.attention_plain(q, k, v).float()
    torch.cuda.synchronize()
    assert float((got.float() - want).abs().max()) <= 2e-2 * float(want.abs().max())


@pytest.mark.parametrize("quant", [False, True])
def test_warm_chunk_on_cuda_matches_plain(cuda, quant):
    """The warm-started chunk (skip 2 of 5, a prior shifted by 4 ticks) of
    the bf16 runner and of the int8 twin with the int8 cache, on the card
    (K1, and K3/K6 in the twin) against the same chunk on the CPU (the
    plain versions): action corr > 0.999 and <= 5e-2 x max|plain|; K1 runs
    3 steps x 2 x depth times (the twin: K1 and K3 3 x depth each)."""
    import numpy as np

    from vla_touch_tpu_torch import config as TC
    from vla_touch_tpu_torch.models.rdt import quant_serve as QS
    from vla_touch_tpu_torch.models.rdt import runner as R
    from vla_touch_tpu_torch.ops import flash_attention as FA
    from vla_touch_tpu_torch.ops import flash_attention_q8 as FQ
    from vla_touch_tpu_torch.runtime.control_loop import shift_prior

    cfg = R.RDTRunnerConfig(model=TC.rdt_tiny(dtype="bfloat16", hidden_size=256, num_heads=4,
                                              depth=4))
    m = cfg.model
    runner = R.init_rdt(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        fc2 = runner.model.final_ffn.fc2.weight
        fc2.copy_((torch.randn(fc2.shape, generator=g) * 0.05).to(fc2.dtype))
    if quant:
        runner = QS.quantize_rdt_params(runner, "int8")
    r = np.random.default_rng(2)
    lang_mask = np.ones((1, 6), bool)
    lang_mask[0, 4:] = False
    args = [torch.as_tensor(a) for a in (
        r.normal(size=(1, 6, m.lang_token_dim)).astype(np.float32), lang_mask,
        r.normal(size=(1, m.img_cond_len, m.img_token_dim)).astype(np.float32),
        r.normal(size=(1, 1, m.state_token_dim)).astype(np.float32),
        np.ones((1, 1, m.output_dim), np.float32), np.asarray([10.0], np.float32))]
    args[0], args[2], args[3] = (a.to(torch.bfloat16) for a in (args[0], args[2], args[3]))
    noise = torch.randn((1, m.horizon, m.output_dim), generator=g)

    def chunk(dev, prior=None, skip=0):
        mod = runner.to(dev)
        kw = dict(init_noise=noise.to(dev), prior_chunk=prior, skip_steps=skip)
        on = [a.to(dev) for a in args]
        if quant:
            return QS.rdt_predict_action_quant(cfg, mod, *on, kv_cache="int8", **kw).cpu()
        return R.rdt_predict_action(cfg, mod, *on, **kw).cpu()

    prior = torch.as_tensor(shift_prior(chunk("cpu")[0].numpy(), 4))[None]
    want = chunk("cpu", prior, 2)
    n1, n3 = FA.flash_attention.launches, FQ.flash_attention_q8.launches
    got = chunk(cuda, prior.to(cuda), 2)
    steps = cfg.noise.num_inference_timesteps - 2
    assert FA.flash_attention.launches - n1 == steps * m.depth * (1 if quant else 2)
    assert FQ.flash_attention_q8.launches - n3 == (steps * m.depth if quant else 0)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 5e-2 * float(want.abs().max())
    assert np.corrcoef(got.numpy().ravel(), want.numpy().ravel())[0, 1] > 0.999


def test_serving_pool_batch_on_the_card_equals_the_direct_call(cuda):
    """A bucket-4 batch of 3 requests through ``from_policy`` on the card
    (a bf16 runner at D 64 and a one-block SigLIP, K1 throughout): every row
    equals the direct batched ``policy_step`` on the same padded batch and
    the pool's first noise draw, bit for bit, and the zero pad row (every
    frame and language key masked) is finite."""
    import numpy as np

    from vla_touch_tpu_torch import config as TC
    from vla_touch_tpu_torch.models.encoders.vit import ViTConfig
    from vla_touch_tpu_torch.models.rdt import runner as R
    from vla_touch_tpu_torch.ops import flash_attention as FA
    from vla_touch_tpu_torch.runtime import policy as P
    from vla_touch_tpu_torch.runtime import serving_pool as SP

    m = TC.rdt_tiny(dtype="bfloat16", hidden_size=256, num_heads=4, img_token_dim=256,
                    max_lang_cond_len=64)
    cfg = P.PolicyConfig(rdt=R.RDTRunnerConfig(model=m), image_size=28,
                         vision=ViTConfig(hidden_size=256, num_layers=1, num_heads=4,
                                          mlp_dim=512, image_size=28, patch_size=14,
                                          use_cls_token=False, use_layerscale=False,
                                          gelu_tanh=True))
    model = P.create_model(cfg, seed=0, cache_frames=False)
    with torch.no_grad():
        fc2 = model.rdt.model.final_ffn.fc2.weight
        fc2.copy_(torch.randn(fc2.shape, generator=torch.Generator(device=cuda).manual_seed(1),
                              device=cuda).to(fc2.dtype) * 0.05)
    r = np.random.default_rng(3)
    reqs = [dict(proprio=r.normal(size=(10,)).astype(np.float32),
                 images=r.integers(0, 256, (6, 28, 28, 3)).astype(np.uint8),
                 image_mask=np.ones((6,), bool),
                 text_embeds=r.normal(size=(L, m.lang_token_dim)).astype(np.float32),
                 text_mask=np.ones((L,), bool)) for L in (5, 20, 33)]
    before = FA.flash_attention.launches
    with SP.from_policy(cfg, model.rdt, model.vision, seed=9, max_wait_ms=200) as pool:
        rows = np.stack([f.result(timeout=120) for f in [pool.submit(**q) for q in reqs]])
    assert FA.flash_attention.launches - before == 1 + 2 * m.depth * \
        cfg.rdt.noise.num_inference_timesteps
    batch = {k: torch.as_tensor(SP._pad_rows([q[k] for q in reqs], 4,
                                             64 if k.startswith("text") else None), device=cuda)
             for k in reqs[0]}
    noise = torch.randn((4, m.horizon, m.output_dim), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(9))
    direct = P.policy_step(cfg, model.rdt, model.vision, **batch, init_noise=noise).cpu().numpy()
    assert np.isfinite(direct).all()
    np.testing.assert_array_equal(rows, direct[:3])


def test_safetensors_load_onto_the_card_gives_the_cpu_bits(cuda, tmp_path):
    """``load_file(device="cuda")`` gives the CPU read's bits, every dtype."""
    from vla_touch_tpu_torch.utils import safetensors_io as ST

    g = torch.Generator().manual_seed(0)
    tensors = {"f32": torch.randn(33, 7, generator=g), "bf16": torch.randn(129, generator=g).bfloat16(),
               "f16": torch.randn(4, 4, generator=g).half(), "i8": torch.arange(-5, 6, dtype=torch.int8),
               "bool": torch.tensor([True, False]), "i64": torch.arange(3), "empty": torch.zeros(0, 2)}
    path = str(tmp_path / "t.safetensors")
    ST.save_file(tensors, path)
    cpu, card = ST.load_file(path), ST.load_file(path, device="cuda")
    for k, t in tensors.items():
        assert card[k].device.type == "cuda" and card[k].dtype == t.dtype, k
        assert torch.equal(card[k].cpu(), cpu[k]) and torch.equal(cpu[k], t), k


@pytest.mark.parametrize("B,masked_past", [(1, None), (2, 576)])
def test_flash_attention_kernel_at_the_qwen2vl_vision_shapes(cuda, B, masked_past):
    """K1 at Qwen2-VL's vision tower: head dim 80, 16 heads, frames of 1024
    patches as the batch (a 448^2 image); with two images of 448^2 and
    336^2 the second row's keys past its 576 patches are masked.  Max abs
    error <= 2e-2 x max|plain|; the pad query rows are computed (and dropped
    by the tower)."""
    from vla_touch_tpu_torch.ops import flash_attention as FA

    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn((B, 1024, 16, 80), generator=g, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    mask = None
    if masked_past is not None:
        mask = torch.ones((B, 1024), dtype=torch.bool, device=cuda)
        mask[1, masked_past:] = False
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, kv_mask=mask)
    assert FA.flash_attention.launches == before + 1
    want = FA.attention_plain(q, k, v, kv_mask=mask).float()
    torch.cuda.synchronize()
    assert float((got.float() - want).abs().max()) <= 2e-2 * float(want.abs().max())


def test_load_llm_from_hf_int4_on_the_card_equals_quantize_llm_params(cuda, tmp_path):
    """``load_llm_from_hf(weights="int4")`` quantizes layer by layer on the
    card to the codes, scales and biases ``quantize_llm_params`` gives on
    the loaded bf16 tree."""
    import dataclasses

    from vla_touch_tpu_torch.planning import llm as L
    from vla_touch_tpu_torch.planning import qwen2vl as VL
    from vla_touch_tpu_torch.utils import safetensors_io as ST

    cfg = dataclasses.replace(VL.qwen2vl_tiny()[0], hidden_size=256, num_heads=2,
                              num_kv_heads=1, mlp_dim=640, vocab_size=512)
    g = torch.Generator().manual_seed(2)
    with torch.device("meta"):
        shapes = {n: tuple(p.shape) for n, p in L.LLM(
            cfg, torch.nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size)),
            [L.DecoderLayer(cfg) for _ in range(cfg.num_layers)],
            torch.nn.Parameter(torch.empty(cfg.hidden_size)),
            torch.nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)).state_dict().items()}
    ST.save_file({hf: torch.randn(shapes[ours], generator=g).bfloat16()
                  for hf, ours in L.hf_key_map(cfg).items()}, str(tmp_path / "m.safetensors"))
    got = L.load_llm_from_hf(cfg, str(tmp_path), weights="int4")
    want = L.quantize_llm_params(L.load_llm_from_hf(cfg, str(tmp_path)), "int4")
    w = want.state_dict()
    for name, t in got.state_dict().items():
        assert t.device.type == "cuda" and t.dtype == w[name].dtype, name
        assert torch.equal(t, w[name]), name
    assert isinstance(got.layers[0].gate, type(want.layers[0].gate))


@pytest.mark.parametrize("Lq", [201, 197])
def test_flash_attention_at_the_vificlip_training_shapes(cuda, Lq):
    """K1 at the prompt-learned CLIP ViT-B/16's contrastive step, 8 videos x
    4 frames as the batch, 12 heads of 64: 197 patch tokens + 4 prompts in
    the blocks before the prompt depth, 197 after.  The forward within 2e-2
    x max|plain|; through ``dot_product_attention`` under grad
    (``FlashAttentionFn``) the q, k, v gradients within 1e-3 x max|plain
    grad| of the plain autograd's."""
    from vla_touch_tpu_torch.ops import attention as A
    from vla_touch_tpu_torch.ops import flash_attention as FA

    g = torch.Generator(device=cuda).manual_seed(3)
    ops = [torch.randn((32, Lq, 12, 64), generator=g, device=cuda).to(torch.bfloat16)
           .requires_grad_(True) for _ in range(3)]
    with torch.no_grad():
        got = FA.flash_attention(*ops)
        want = FA.attention_plain(*ops).float()
    assert float((got.float() - want).abs().max()) <= 2e-2 * float(want.abs().max())
    cot = torch.randn((32, Lq, 12, 64), generator=g, device=cuda)
    before = FA.flash_attention.launches
    out = A.dot_product_attention(*ops)
    assert FA.flash_attention.launches == before + 1 and out.grad_fn is not None
    got = torch.autograd.grad((out.float() * cot).sum(), ops)
    want = torch.autograd.grad((FA.attention_plain(*ops).float() * cot).sum(), ops)
    for a, b in zip(got, want):
        assert float((a.float() - b.float()).abs().max()) <= 1e-3 * float(b.float().abs().max())


def test_contrastive_step_on_the_card_matches_the_cpu_step(cuda):
    """One contrastive loss and gradient (prompt-learned towers, text
    frozen, CLIP projections; 2 layers, 128 wide, 2 heads of 64) on the
    card in bf16 over float32 master weights against the CPU in float32:
    the loss within 5e-3 relative, the gradient within 6e-2 relative L2
    and at corr >= 0.999 (bf16 against float32 on the CPU reads 1.5e-3,
    2.2e-2 and 0.99975 here, ``tools/torch_vificlip_bf16_step.py tiny``); K1
    runs once a vision block.  Then one ``train_vificlip_contrastive``
    step on the card leaves the frozen text tower bit for bit as it was."""
    import copy

    from vla_touch_tpu_torch.models.encoders import clip_text as CT
    from vla_touch_tpu_torch.models.encoders import vit as V
    from vla_touch_tpu_torch.ops import flash_attention as FA
    from vla_touch_tpu_torch.planning import encoder as PE
    from vla_touch_tpu_torch.planning import train_encoder as TE

    vc = V.ViTConfig(hidden_size=128, num_layers=2, num_heads=2, mlp_dim=256, patch_size=16,
                     image_size=32, use_layerscale=False, quick_gelu=True, use_pre_norm=True,
                     layernorm_eps=1e-5, patch_bias=False)
    tc = CT.CLIPTextConfig(vocab_size=64, hidden_size=128, num_layers=2, num_heads=2,
                           mlp_dim=256, max_positions=16, eos_token_id=63)
    kw = dict(prompt_learning=True, num_prompts=2, prompt_depth_vision=1, prompt_depth_text=1,
              projection_dim=64)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 63, (4, 12))
    ids[:, -1] = 63
    batch = {"frames": rng.normal(size=(4, 2, 32, 32, 3)).astype(np.float32), "input_ids": ids}
    cpu = PE.init_vificlip_model(vc, tc, seed=0, device="cpu", **kw)
    card = copy.deepcopy(cpu).to(cuda)
    out = {}
    for name, m, dt, dev in (("cpu", cpu, torch.float32, "cpu"), ("card", card, torch.bfloat16, cuda)):
        V.master_weights_(m, dt).requires_grad_(True)
        m.text.requires_grad_(False)
        before = FA.flash_attention.launches
        loss = TE.contrastive_loss(m, batch, dev)
        loss.backward()
        launches = FA.flash_attention.launches - before
        out[name] = (float(loss.detach()), {n: p.grad.cpu().double() for n, p in m.named_parameters()
                                   if p.grad is not None}, launches)
    (l_cpu, g_cpu, _), (l_card, g_card, k1) = out["cpu"], out["card"]
    assert k1 == vc.num_layers
    assert abs(l_card - l_cpu) <= 5e-3 * abs(l_cpu)
    assert set(g_card) == set(g_cpu) and not any(n.startswith("text.") for n in g_cpu)
    a = torch.cat([g_cpu[n].flatten() for n in g_cpu])
    b = torch.cat([g_card[n].flatten() for n in g_cpu])
    assert float((b - a).norm() / a.norm()) <= 6e-2
    assert float(torch.corrcoef(torch.stack([a, b]))[0, 1]) >= 0.999
    text = {n: p.detach().clone() for n, p in card.text.named_parameters()}
    card, _ = TE.train_vificlip_contrastive([batch], model=card)
    for n, p in card.text.named_parameters():
        assert torch.equal(p, text[n]), n


# ---- the planner's LLM training: K8 and K9 under autograd, the grad guards ------

@pytest.mark.parametrize("M,K,N", [(37, 3584, 4608), (300, 3584, 512)])
def test_w4a8_fn_on_the_card_matches_the_cpu_plain_gradient(cuda, M, K, N):
    """``qdense_kernel_w4`` under grad on the card (``W4A8MatmulFn``: K8
    forward, warp loop at M 37 and tile body at M 300, the plain vjp
    backward) against the plain ``qdense_w4`` differentiated on the CPU, at
    Qwen2.5-7B training widths: the forward within 1e-2 x max|plain|, one
    launch counted; x's gradient nonzero exactly at each row's largest |x|
    (bf16 rows can tie there, and the gradient splits evenly), its values
    within 1e-5 relative (float32 sums over N in other orders)."""
    from vla_touch_tpu_torch.ops import quant as Q
    from vla_touch_tpu_torch.ops import quant_matmul as QM

    g = torch.Generator(device=cuda).manual_seed(17)
    leaf = _w4_leaf(g, N, K, cuda, bias=True)
    x = (torch.randn((M, K), generator=g, device=cuda) * 2).to(torch.bfloat16)
    c = torch.randn((M, N), generator=g, device=cuda)
    xc = x.detach().requires_grad_(True)
    before = QM.w4a8_matmul.launches
    y = QM.qdense_kernel_w4(xc, leaf)
    assert QM.w4a8_matmul.launches == before + 1
    assert y.grad_fn.name() == "W4A8MatmulFnBackward"
    (y.float() * c).sum().backward()
    cpu = Q.QLinearW4(leaf.w4_pack.cpu(), leaf.scale4.cpu(), leaf.bias.cpu())
    xp = x.cpu().requires_grad_(True)
    yp = Q.qdense_w4(xp, cpu, out_dtype=torch.float32)
    (yp.to(torch.bfloat16).float() * c.cpu()).sum().backward()
    yp = yp.detach()
    assert float((y.detach().float().cpu() - yp).abs().max()) <= 1e-2 * float(yp.abs().max())
    got, want = xc.grad.float().cpu(), xp.grad.float()
    ax = x.float().cpu().abs()
    assert torch.equal(got != 0, ax == ax.amax(1, keepdim=True))
    assert torch.allclose(got, want, rtol=1e-5, atol=0)


def test_w4_swiglu_fn_on_the_card_matches_the_cpu_plain_gradient(cuda):
    """``qdense_kernel_swiglu`` under grad on the card (``W4SwigluFn``: K9
    forward, the vjp of ``w4_swiglu_plain`` backward) at Qwen2.5-7B width
    and a short training row (M 24) against the plain composition
    differentiated on the CPU: the forward within 2e-2 x max|plain|, x's
    gradient within 1e-2 of its largest element (the bf16 intermediates'
    roundings, taken in other orders on the card, can move an activation
    code)."""
    from vla_touch_tpu_torch.ops import quant as Q
    from vla_touch_tpu_torch.ops import w4_fused as W4F

    g = torch.Generator(device=cuda).manual_seed(18)
    D, F, M = 3584, 18944, 24
    gu, down = _w4_leaf(g, 2 * F, D, cuda), _w4_leaf(g, D, F, cuda)
    x = (torch.randn((M, D), generator=g, device=cuda) * 2).to(torch.bfloat16)
    c = torch.randn((M, D), generator=g, device=cuda)
    xc = x.detach().requires_grad_(True)
    before = W4F.w4_swiglu_mlp.launches
    y = W4F.qdense_kernel_swiglu(xc, gu, down)
    assert W4F.w4_swiglu_mlp.launches == before + 1
    assert y.grad_fn.name() == "W4SwigluFnBackward"
    (y.float() * c).sum().backward()

    def cpu(qp):
        return Q.QLinearW4(qp.w4_pack.cpu(), qp.scale4.cpu(), None)

    xp = x.cpu().requires_grad_(True)
    yp = W4F.w4_swiglu_plain(xp, cpu(gu), cpu(down))
    (yp.float() * c.cpu()).sum().backward()
    assert float((y.detach().float().cpu() - yp.detach().float()).abs().max()) <= \
        2e-2 * float(yp.detach().float().abs().max())
    got, want = xc.grad.float().cpu(), xp.grad.float()
    assert float((got - want).abs().max()) <= 1e-2 * float(want.abs().max())


@pytest.mark.parametrize("kernel", ["K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "K10"])
def test_kernel_wrappers_refuse_a_grad_requiring_card_operand(cuda, kernel):
    """Every raw-pointer wrapper (K2-K10, as K1) raises on a CUDA operand
    that requires grad under autograd, naming K8's and K9's autograd
    Functions, instead of returning an output with no ``grad_fn``; the
    same call under ``no_grad`` launches."""
    from vla_touch_tpu_torch.ops import flash_attention_q8 as FQ
    from vla_touch_tpu_torch.ops import quant as Q
    from vla_touch_tpu_torch.ops import quant_matmul as QM
    from vla_touch_tpu_torch.ops import unet_kernels as UK
    from vla_touch_tpu_torch.ops import w4_fused as W4F

    g = torch.Generator(device=cuda).manual_seed(19)

    def bf(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)

    if kernel == "K2":
        x, cond, p = _k2_case(g, 16, 256, 256, cuda)
        fn, args, grad_at = UK.resblock_fused, (x, cond, p), 0
    elif kernel in ("K3", "K4"):
        kv = bf(1, 64, 2, 4, 64)
        quant = FQ.quantize_kv_t if kernel == "K4" else FQ.quantize_kv
        fn = FQ.flash_attention_q8t if kernel == "K4" else FQ.flash_attention_q8
        args, grad_at = (bf(1, 8, 4, 64),) + tuple(quant(kv[:, :, 0], kv[:, :, 1])), 0
    elif kernel in ("K5", "K6", "K7"):
        lin = torch.nn.Linear(1024, 512, device=cuda)
        qp = Q.quantize_linear(lin)
        fn = {"K5": QM.w8a16_matmul, "K6": QM.a8w8_matmul, "K7": QM.a8w8_matmul_large}[kernel]
        args, grad_at = (bf(4, 1024), qp.w_i8, qp.scale, qp.bias), 0
    elif kernel == "K8":
        qp = _w4_leaf(g, 512, 1024, cuda)
        fn, args, grad_at = QM.w4a8_matmul, (bf(4, 1024), qp.w4_pack, qp.scale4, qp.bias), 0
    else:
        gu, down, o = _w4_leaf(g, 2048, 512, cuda), _w4_leaf(g, 512, 1024, cuda), \
            _w4_leaf(g, 512, 512, cuda)
        if kernel == "K9":
            fn, args, grad_at = W4F.w4_swiglu_mlp, (bf(4, 512), gu, down), 0
        else:
            fn = W4F.w4_postattn_fused
            args, grad_at = (bf(4, 512), bf(4, 512), o, gu, down, torch.ones(512, device=cuda)), 1
    route = {"K8": "W4A8MatmulFn", "K9": "W4SwigluFn"}.get(kernel, "no autograd route")
    grad_args = list(args)
    grad_args[grad_at] = args[grad_at].detach().clone().requires_grad_(True)
    before = fn.launches
    with pytest.raises(RuntimeError, match=f"requires grad.*{route}"):
        fn(*grad_args)
    assert fn.launches == before
    with torch.no_grad():
        fn(*grad_args)
    assert fn.launches == before + 1


def test_flash_attention_kernel_at_the_sparsh_shape(cuda):
    """K1 at the Sparsh tactile ViT-B/16's self-attention: 32 frame pairs of
    226 tokens (15^2 patches and CLS), 12 heads of 64, q/k/v the strided
    views of one projection as ``ViTSelfAttention`` passes them.  Max abs
    error <= 2e-2 x max|plain|."""
    from vla_touch_tpu_torch.ops import flash_attention as FA

    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((32, 226, 3, 12, 64), generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = x.unbind(2)
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v)
    assert FA.flash_attention.launches == before + 1
    want = FA.attention_plain(q, k, v).float()
    torch.cuda.synchronize()
    assert float((got.float() - want).abs().max()) <= 2e-2 * float(want.abs().max())


@pytest.mark.parametrize("version", ["standard", "hsr"])
def test_force_sequence_on_the_card_equals_the_cpu(cuda, version):
    """The batched GelSight pass over 16 frames of 240 x 320 on CUDA: masks
    and validity equal the CPU's, forces within 1e-5 px; each frame's force
    equals ``estimate_force`` on that frame on the card bit for bit."""
    from vla_touch_tpu_torch.ops import marker_tracking as MT

    H, W, rows, cols = 240, 320, 7, 9
    yy, xx = np.mgrid[0:H, 0:W]
    ch, cw = H // rows, W // cols
    bg, fg = (120.0, 30.0) if version == "hsr" else (200.0, 40.0)

    def frame(sx, sy):
        img = np.full((H, W), bg, np.float32)
        for r in range(rows):
            for c in range(cols):
                d2 = (yy - (r * ch + ch / 2 + sy)) ** 2 + (xx - (c * cw + cw / 2 + sx)) ** 2
                img[d2 <= 16] = fg
        return img

    frames = torch.as_tensor(np.stack([frame(0.4 * t, -0.2 * t) for t in range(16)]))
    cfg = MT.TrackerConfig(gelsight_version=version)
    out = {}
    for dev in ("cpu", cuda):
        f = frames.to(dev)
        base = MT.calibrate(f[0], cfg)
        out[str(dev)] = (MT.estimate_force_sequence(f, base, cfg), base,
                         MT.marker_mask(f[5], cfg))
    (cpu, cbase, cmask), (card, kbase, kmask) = out["cpu"], out[str(cuda)]
    assert torch.equal(cmask, kmask.cpu())
    assert torch.equal(cbase["valid"], kbase["valid"].cpu())
    torch.testing.assert_close(card["forces"].cpu(), cpu["forces"], atol=1e-5, rtol=0)
    f = frames.to(cuda)
    for t in (0, 7, 15):
        assert torch.equal(MT.estimate_force(f[t], kbase, cfg)["force"], card["forces"][t])


def test_nvjpeg_decode_of_a_cache_matches_the_host_decoders(cuda, tmp_path):
    """``EpisodeCache.decode_frames(device='cuda')`` (nvJPEG) on a JPEG
    cache against OpenCV's decode of the same blobs: within
    ``chip_smoke.py``'s NVJPEG_MAX_ABS 8 / NVJPEG_MEAN_ABS 1.0 uint8 levels;
    a raw cache's frames copied up exactly; an empty batch."""
    import ctypes

    import cv2

    from vla_touch_tpu_torch.data.episode import write_synthetic_episode
    from vla_touch_tpu_torch.runtime import native_loader as NL

    src = str(tmp_path / "ep.npz")
    write_synthetic_episode(src, num_steps=12, img_size=96, chunk=4, lang_dim=8)
    for codec in ("jpeg", "raw"):
        c = NL.EpisodeCache(NL.pack_episode(src, str(tmp_path / f"{codec}.epc"), codec=codec))
        got = c.decode_frames(1, 2, 9, device="cuda")
        assert got.device.type == "cuda" and got.shape == (9, 96, 96, 3)
        got = got.cpu().numpy()
        if codec == "raw":
            np.testing.assert_array_equal(got, c.decode_frames(1, 2, 9, device="cpu"))
            continue
        ptrs, lens = c.frame_blobs(1, 2, 9)
        ref = np.stack([cv2.imdecode(np.frombuffer(ctypes.string_at(int(p), int(n)), np.uint8),
                                     cv2.IMREAD_COLOR)[:, :, ::-1] for p, n in zip(ptrs, lens)])
        diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        assert diff.max() <= 8 and diff.mean() <= 1.0, (diff.max(), diff.mean())
        assert NL.nvjpeg_decode(ptrs[:0], lens[:0], 96, 96).shape == (0, 96, 96, 3)
        c.close()


def test_nvjpeg_decoder_state_serves_any_batch_size_and_thread(cuda, tmp_path):
    """A thread's nvJPEG decoder state, kept between calls and initialised
    afresh when the batch size changes, decodes each frame as a decode of
    the whole camera does: batch sizes in turn on one thread, calls on
    three loader threads, and ``host_frames`` there (nvJPEG on the thread's
    own stream where the build has no libjpeg), the caller's stream left
    as it was."""
    from concurrent.futures import ThreadPoolExecutor

    from vla_touch_tpu_torch.data.episode import write_synthetic_episode
    from vla_touch_tpu_torch.runtime import native_loader as NL

    src = str(tmp_path / "ep.npz")
    write_synthetic_episode(src, num_steps=12, img_size=96, chunk=4, lang_dim=8)
    c = NL.EpisodeCache(NL.pack_episode(src, str(tmp_path / "jpeg.epc"), codec="jpeg"))
    want = c.decode_frames(0, 0, 12, device="cuda").cpu().numpy()
    for start, count in ((0, 1), (3, 5), (0, 12), (3, 5), (11, 1)):
        got = c.decode_frames(0, start, count, device="cuda").cpu().numpy()
        np.testing.assert_array_equal(got, want[start:start + count])

    def on_thread(start):
        stream = torch.cuda.current_stream()
        dev = c.decode_frames(0, start, 4, device="cuda").cpu().numpy()
        host = None if c.host_decode else c.host_frames(0, start, 4)
        assert torch.cuda.current_stream() == stream
        return start, dev, host

    with ThreadPoolExecutor(max_workers=3) as pool:
        for start, dev, host in pool.map(on_thread, range(9)):
            np.testing.assert_array_equal(dev, want[start:start + 4])
            if host is not None:
                np.testing.assert_array_equal(host, want[start:start + 4])
    c.close()
