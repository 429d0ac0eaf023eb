"""PyTorch port, K1 (bf16 flash attention): the split-KV rule of
``csrc/flash_attention.cu`` emulated on the CPU, and the plan the wrapper
gives it, against the plain version and JAX's Pallas kernel in interpret
mode.  The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from vla_touch_tpu_torch.ops import flash_attention as FA
from vla_touch_tpu_torch.ops import flash_attention_q8 as FQ


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _split_merged(q, k, v, mask, tiles_per_split, scale=None):
    """K1's arithmetic in float32: per split, an online softmax over 64-key
    tiles (running max m, acc and l rescaled by e^(m_old - m_new), masked
    keys giving p = 0), each split's unnormalised (acc, m, l); then the
    combine's merge in split order, m* = max m_s, l* = sum e^(m_s - m*) l_s,
    out = sum e^(m_s - m*) acc_s / max(l*, 1e-30).  A split with no valid
    key keeps m = -1e30 and l = 0."""
    B, Lq, H, D = q.shape
    Lkv = k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    s_all = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    valid = mask[:, None, None, :]
    span = tiles_per_split * FA.BK
    parts = []
    for a in range(0, max(Lkv, 1), span):
        m = torch.full((B, H, Lq), -1e30)
        acc = torch.zeros((B, H, Lq, D))
        l = torch.zeros((B, H, Lq))
        for t in range(a, min(a + span, Lkv), FA.BK):
            sl = slice(t, min(t + FA.BK, Lkv))
            ok = valid[..., sl]
            s = torch.where(ok, s_all[..., sl], torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(ok, torch.exp(s - m_new[..., None]), torch.tensor(0.0))
            l = alpha * l + p.sum(-1)
            acc = alpha[..., None] * acc + torch.einsum("bhqk,bkhd->bhqd", p, v[:, sl].float())
            m = m_new
        parts.append((acc, m, l))
    m_star = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    acc = l_star = 0.0
    for a, m, l in parts:
        w = torch.exp(m - m_star)
        l_star = l_star + w * l
        acc = acc + w[..., None] * a
    return (acc / torch.clamp_min(l_star, 1e-30)[..., None]).permute(0, 2, 1, 3)


@pytest.mark.parametrize("D", [64, 72])
def test_split_merge_rule_matches_plain_and_jax(rng, D):
    """K1's split-and-merge over 2-tile splits of 64-key tiles (600 keys:
    five splits, the last ragged) equals ``attention_plain`` to float32
    rounding (1e-5 x max|plain|) and JAX's ``flash_cross_attention`` in
    interpret mode to 2e-2 x max|jax| (the Pallas kernel rounds p and the
    output to bf16).  Batch row 0 keeps only the keys of the first split, so
    its later splits are all masked; in batch row 1 the second split is all
    masked (a dead split between live ones); the last row is fully masked
    and comes out exactly 0.  D 72 is SigLIP's head dim."""
    from jax.experimental.pallas import tpu as pltpu

    from vla_touch_tpu.ops import pallas_attention as pa

    B, Lq, Lkv, H = 3, 67, 600, 2
    qkv = [rng.normal(size=(B, L, H, D)).astype(np.float32) for L in (Lq, Lkv, Lkv)]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in qkv)
    mask = np.ones((B, Lkv), bool)
    mask[0, 128:] = False
    mask[1, 128:256] = False
    mask[2] = False
    tmask = torch.from_numpy(mask)
    got = _split_merged(q, k, v, tmask, tiles_per_split=2)
    plain = FA.attention_plain(q.float(), k.float(), v.float(), kv_mask=tmask)
    assert float((got - plain).abs().max()) <= 1e-5 * float(plain.abs().max())
    with pltpu.force_tpu_interpret_mode():
        want = _np(pa.flash_cross_attention(*(jnp.asarray(a, jnp.bfloat16) for a in qkv),
                                            kv_mask=jnp.asarray(mask)))
    assert np.abs(got.numpy() - want).max() <= 2e-2 * np.abs(want).max()
    assert np.all(got.numpy()[-1] == 0.0) and np.all(want[-1] == 0.0)


# (B, Lq, Lkv, H, resident CTAs per SM of the built kernel on an H100 at
# that shape's rows and head dim, the plan at 132 SMs)
@pytest.mark.parametrize("B,Lq,Lkv,H,resident,want", [
    (6, 729, 729, 16, 1, (128, 1, 12)),   # SigLIP: 576 CTAs already fill the card
    (2, 730, 730, 6, 2, (128, 3, 4)),     # DinoV2: 72 q tiles x 3 splits
    (1, 67, 67, 32, 3, (80, 1, 2)),       # RDT self-attention
    (1, 67, 4374, 32, 3, (80, 12, 6)),    # RDT image cross: 384 CTAs, one wave
    (1, 67, 64, 32, 3, (80, 1, 1)),       # RDT language cross: one tile
    (4, 197, 197, 12, 2, (128, 1, 4)),    # planner CLIP: 4 tiles, no split
    (2, 67, 4374, 32, 3, (80, 6, 12)),
    (1, 67, 1000, 32, 3, (80, 4, 4)),     # ragged last split
    (1, 129, 200, 4, 2, (128, 1, 4)),     # two q tiles
    (1, 67, 0, 32, 3, (80, 1, 1)),
])
def test_k1_plan_covers_every_tile_once(B, Lq, Lkv, H, resident, want):
    """K1's plan through the shared ``split_plan``: the rows per CTA and
    splits named, no split empty, every tile in one, a split of 4 tiles at
    least; the K3/K4 plan of the same function is unchanged
    (tests/test_torch_quant.py)."""
    rows, splits, tps = FA.k1_plan(B, Lq, Lkv, H, 132, resident)
    assert (rows, splits, tps) == want
    n_tiles = -(-Lkv // FA.BK)
    assert (splits - 1) * tps < max(n_tiles, 1) <= max(splits * tps, 1)
    assert splits == 1 or tps >= FA.K1_MIN_TILES
    assert splits * B * H * -(-Lq // rows) <= max(resident * 132, B * H * -(-Lq // rows))


def test_k3_k4_take_k1s_plan_function():
    """One copy of the plan: K3/K4's module re-exports K1's."""
    assert FQ.split_plan is FA.split_plan and FQ.BK == FA.BK == 64
    assert FA.cta_rows(1) == 64 and FA.cta_rows(67) == 80 and FA.cta_rows(128) == 128
    assert FA.cta_rows(129) == FA.cta_rows(4374) == 128
