"""The planner's vision-language backbone, Qwen2-VL (counterpart of
``vla_touch_tpu/planning/qwen2vl.py``): the vision tower (a ViT over
14-pixel patches of two frames, 2-D rotary attention within each temporal
frame, a 2 x 2 merger into the decoder's width), the multimodal rotary
(M-RoPE) position ids, the embedding splice and the HF weight loaders.
The decoder is ``planning/llm.py``'s Qwen2 with ``mrope_section`` set; its
forward and decoding take the (3, B, L) positions :func:`mrope_positions`
builds.

The tower computes as the JAX package does on its checkpoint's bf16
weights: float32 patches times bf16-valued weights promote to float32, so
the residual stream, the norms, the rotary and the MLPs run in float32.
Its attention (``ops/attention.py::dot_product_attention``) is K1
(``ops/flash_attention.py``) on the card, with the frames as the batch:
(frames, longest frame, heads, head dim), q, k and v rounded to bf16 for
the kernel, a frame shorter than the longest padded and its pad keys
masked (pad query rows are computed and dropped).  On the CPU it is K1's
plain version in float32, which is the JAX package's segment-masked float32
attention.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from vla_touch_tpu_torch.ops import attention as A
from vla_touch_tpu_torch.ops.nn import gelu_erf, quick_gelu
from vla_touch_tpu_torch.planning.llm import (LLMConfig, _mm, _require, load_llm_from_hf,
                                              read_safetensors_dir)
from vla_touch_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Qwen2VLVisionConfig:
    """Qwen2-VL ViT hyperparameters (HF ``Qwen2VLVisionConfig``)."""

    depth: int = 32
    embed_dim: int = 1280
    num_heads: int = 16
    mlp_ratio: int = 4
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    hidden_size: int = 3584            # decoder width the merger maps into
    rope_theta: float = 1e4
    ln_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def mlp_dim(self) -> int:
        return self.embed_dim * self.mlp_ratio

    @property
    def merge_dim(self) -> int:
        return self.embed_dim * self.spatial_merge_size ** 2


def qwen2vl_7b() -> LLMConfig:
    """Qwen2-VL-7B-Instruct's text decoder: Qwen2.5-7B's dimensions and
    M-RoPE (``mrope_section`` (16, 24, 24) over head_dim // 2 = 64 slots)."""
    return LLMConfig(vocab_size=152064, hidden_size=3584, num_layers=28, num_heads=28,
                     num_kv_heads=4, mlp_dim=18944, rope_theta=1e6, tie_embeddings=False,
                     mrope_section=(16, 24, 24))


def qwen2vl_7b_vision() -> Qwen2VLVisionConfig:
    return Qwen2VLVisionConfig()


def qwen2vl_tiny(**kw):
    """(text config, vision config) pair for tests."""
    text = LLMConfig(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
                     num_kv_heads=2, mlp_dim=128, rope_theta=1e6, tie_embeddings=False,
                     mrope_section=(2, 3, 3))
    vis = Qwen2VLVisionConfig(depth=2, embed_dim=32, num_heads=2, mlp_ratio=4, patch_size=4,
                              temporal_patch_size=2, spatial_merge_size=2, hidden_size=64)
    return dataclasses.replace(text, **kw), vis


# --------------------------------------------------------------------------
# The tower's parameters
# --------------------------------------------------------------------------


class VisionBlock(nn.Module):
    def __init__(self, vcfg: Qwen2VLVisionConfig):
        super().__init__()
        D = vcfg.embed_dim
        self.norm1 = nn.LayerNorm(D, eps=vcfg.ln_eps)
        self.norm2 = nn.LayerNorm(D, eps=vcfg.ln_eps)
        self.qkv = nn.Linear(D, 3 * D)
        self.proj = nn.Linear(D, D)
        self.fc1 = nn.Linear(D, vcfg.mlp_dim)
        self.fc2 = nn.Linear(vcfg.mlp_dim, D)


class VisionMerger(nn.Module):
    def __init__(self, vcfg: Qwen2VLVisionConfig):
        super().__init__()
        self.ln_q = nn.LayerNorm(vcfg.embed_dim, eps=vcfg.ln_eps)
        self.fc1 = nn.Linear(vcfg.merge_dim, vcfg.merge_dim)
        self.fc2 = nn.Linear(vcfg.merge_dim, vcfg.hidden_size)


class VisionTower(nn.Module):
    """The tower's parameters under the JAX tree's names: ``patch_embed``
    (the Conv3d as a (D, C·T·P·P) linear), ``blocks`` and ``merger``.  Run
    it with :func:`vision_forward`."""

    def __init__(self, vcfg: Qwen2VLVisionConfig):
        super().__init__()
        self.cfg = vcfg
        self.patch_embed = nn.Linear(vcfg.patch_dim, vcfg.embed_dim, bias=False)
        self.blocks = nn.ModuleList(VisionBlock(vcfg) for _ in range(vcfg.depth))
        self.merger = VisionMerger(vcfg)


@torch.no_grad()
def init_vision(vcfg: Qwen2VLVisionConfig, seed: int = 0, device=None,
                dtype=torch.float32) -> VisionTower:
    """A seeded random tower on ``device`` (default CUDA), drawn as the JAX
    package's ``init_vision`` draws it (linears ~ N(0, 1/fan_in), the patch
    embedding ~ N(0, 0.02^2), biases 0, norms 1; other numbers: torch's
    generator); weights in ``dtype``, biases and norms in float32."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device("meta"):
        tower = VisionTower(vcfg)
    tower = tower.to_empty(device=dev)
    for name, p in tower.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            std = 0.02 if name == "patch_embed.weight" else p.shape[1] ** -0.5
            p.data = p.data.normal_(0.0, std, generator=gen).to(dtype)
    return tower.eval().requires_grad_(False)


# --------------------------------------------------------------------------
# The tower's forward
# --------------------------------------------------------------------------


def vision_rot_pos_ids(grid_thw: Sequence[tuple], merge: int) -> np.ndarray:
    """(N, 2) [h, w] rotary position ids in the HF patch order: each (t, h,
    w) grid is flattened merge-group-major, (h // m, w // m, m, m), so each
    run of m·m patches forms one merged token."""
    out = []
    for t, h, w in grid_thw:
        hp = np.arange(h)[:, None].repeat(w, 1)
        wp = np.arange(w)[None, :].repeat(h, 0)

        def regroup(x):
            return x.reshape(h // merge, merge, w // merge, merge).transpose(0, 2, 1, 3).reshape(-1)

        hw = np.stack([regroup(hp), regroup(wp)], axis=-1)   # (h*w, 2)
        out.append(np.tile(hw, (t, 1)))
    return np.concatenate(out, axis=0)


def vision_segment_ids(grid_thw: Sequence[tuple]) -> np.ndarray:
    """(N,) attention segment per patch: attention stays within each
    temporal frame of each image (HF's cu_seqlens, h·w repeated t times)."""
    segs, base = [], 0
    for t, h, w in grid_thw:
        segs.append(base + np.repeat(np.arange(t), h * w))
        base += t
    return np.concatenate(segs)


def _dense_b(x, lin: nn.Linear):
    y = _mm(x, lin.weight.t())
    return y if lin.bias is None else y + lin.bias


def _ln(x, norm: nn.LayerNorm, eps: float):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * norm.weight + norm.bias).to(x.dtype)


def _vision_rope(x, cos, sin):
    """x (N, H, hd), cos/sin (N, 1, hd/2) -> NEOX half-split rotation."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


class FrameLayout:
    """The patches of each attention segment laid out as one batch row:
    (F, L) with L the longest segment.  Rows of equal-length segments that
    already lie in order are a reshape; otherwise each segment is gathered
    into its row, the shorter rows padded with copies of their first patch
    and those keys masked, and the rows scattered back after."""

    def __init__(self, segment_ids, N: int, device):
        if segment_ids is None:
            frames = [np.arange(N)]
        else:
            seg = np.asarray(torch.as_tensor(segment_ids).cpu())
            frames = [np.nonzero(seg == s)[0] for s in np.unique(seg)]
        lens = [len(f) for f in frames]
        self.F, self.L = len(frames), max(lens)
        self.mask = self.gather = self.scatter = None
        if len(set(lens)) > 1:
            mask = np.zeros((self.F, self.L), bool)
            for i, n in enumerate(lens):
                mask[i, :n] = True
            self.mask = torch.as_tensor(mask, device=device)
        if self.mask is not None or not np.array_equal(np.concatenate(frames), np.arange(N)):
            idx = np.stack([np.concatenate([f, np.full(self.L - len(f), f[0])]) for f in frames])
            where = np.empty(N, np.int64)
            for i, f in enumerate(frames):
                where[f] = i * self.L + np.arange(len(f))
            self.gather = torch.as_tensor(idx.reshape(-1), device=device)
            self.scatter = torch.as_tensor(where, device=device)

    def rows(self, t):
        """(N, H, hd) -> (F, L, H, hd)."""
        if self.gather is not None:
            t = t[self.gather]
        return t.reshape(self.F, self.L, *t.shape[1:])

    def attend(self, q, k, v):
        """Attention of (N, H, hd) q/k/v within segments -> (N, H·hd)."""
        out = A.dot_product_attention(self.rows(q), self.rows(k), self.rows(v),
                                      kv_mask=self.mask)
        out = out.reshape(self.F * self.L, -1)
        return out if self.scatter is None else out[self.scatter]


@torch.no_grad()
def vision_forward(vcfg: Qwen2VLVisionConfig, params: VisionTower, patches, pos_ids,
                   segment_ids=None):
    """patches (N, patch_dim) -> merged tokens (N // merge², hidden).

    ``pos_ids`` (N, 2) from :func:`vision_rot_pos_ids`; ``segment_ids``
    (N,) confines attention to each segment (:func:`vision_segment_ids`,
    one per temporal frame); None: one frame, full attention.  Patches,
    positions and segment ids may be numpy arrays."""
    dev = params.patch_embed.weight.device
    patches = torch.as_tensor(patches, device=dev)
    N = patches.shape[0]
    H, hd = vcfg.num_heads, vcfg.head_dim
    x = _mm(patches, params.patch_embed.weight.t())

    # 2-D rotary: hd // 2 slots, the h frequencies (hd // 4), then the w ones
    quarter = hd // 4
    freqs = vcfg.rope_theta ** (-torch.arange(0, quarter, dtype=torch.float32, device=dev)
                                / quarter)
    pos = torch.as_tensor(pos_ids, device=dev).float()
    ang = torch.cat([pos[:, 0, None] * freqs[None], pos[:, 1, None] * freqs[None]], -1)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    layout = FrameLayout(segment_ids, N, dev)

    for bp in params.blocks:
        h = _ln(x, bp.norm1, vcfg.ln_eps)
        qkv = _dense_b(h, bp.qkv).reshape(N, 3, H, hd)
        q = _vision_rope(qkv[:, 0], cos, sin)
        k = _vision_rope(qkv[:, 1], cos, sin)
        att = layout.attend(q, k, qkv[:, 2])
        x = x + _dense_b(att.to(x.dtype), bp.proj)
        h = _ln(x, bp.norm2, vcfg.ln_eps)
        x = x + _dense_b(quick_gelu(_dense_b(h, bp.fc1)), bp.fc2)

    m = params.merger
    x = _ln(x, m.ln_q, vcfg.ln_eps).reshape(-1, vcfg.merge_dim)
    return _dense_b(gelu_erf(_dense_b(x, m.fc1)), m.fc2)


# --------------------------------------------------------------------------
# M-RoPE positions and the splice
# --------------------------------------------------------------------------


def mrope_positions(segments: Sequence[tuple], merge: int = 2) -> np.ndarray:
    """(3, L) M-RoPE position ids of a segment list, as HF's
    ``get_rope_index``: text tokens advance the three components together;
    an ("image", (t, h, w)) segment (the raw patch grid, before the merge)
    places its temporal / height / width components on its merged grid from
    the running offset, and the next segment resumes at max(position) + 1.

    segments: [("text", n), ("image", (t, h, w)), ...]
    """
    cols = []
    offset = 0
    for kind, spec in segments:
        if kind == "text":
            n = int(spec)
            p = np.arange(offset, offset + n)
            cols.append(np.stack([p, p, p]))
            offset += n
        else:
            t, h, w = spec
            hm, wm = h // merge, w // merge
            tt = np.repeat(np.arange(t), hm * wm)
            hh = np.tile(np.repeat(np.arange(hm), wm), t)
            ww = np.tile(np.arange(wm), t * hm)
            cols.append(offset + np.stack([tt, hh, ww]))
            offset += int(max(t, hm, wm))
    return np.concatenate(cols, axis=1)


def splice_embeds(text_embeds, vision_tokens, start: int):
    """Put the vision tokens into (L, D) text embeddings at ``start``, in
    place of the image-pad placeholders (HF's semantics)."""
    n = vision_tokens.shape[0]
    return torch.cat([text_embeds[:start], vision_tokens.to(text_embeds.dtype),
                      text_embeds[start + n:]], dim=0)


# --------------------------------------------------------------------------
# HF weights
# --------------------------------------------------------------------------


def vision_hf_key_map(vcfg: Qwen2VLVisionConfig) -> dict:
    """HF ``visual.*`` key -> (the tower's state-dict name, transform):
    'conv' = the Conv3d weight (D, C, T, P, P) as the linear's (D, C·T·P·P);
    None = as stored (a torch linear weight is (out, in), as the tower's)."""
    m = {"visual.patch_embed.proj.weight": ("patch_embed.weight", "conv")}
    for i in range(vcfg.depth):
        hf, ours = f"visual.blocks.{i}", f"blocks.{i}"
        for hfn, on in (("norm1", "norm1"), ("norm2", "norm2"), ("attn.qkv", "qkv"),
                        ("attn.proj", "proj"), ("mlp.fc1", "fc1"), ("mlp.fc2", "fc2")):
            for leaf in ("weight", "bias"):
                m[f"{hf}.{hfn}.{leaf}"] = (f"{ours}.{on}.{leaf}", None)
    for hfn, on in (("ln_q", "ln_q"), ("mlp.0", "fc1"), ("mlp.2", "fc2")):
        for leaf in ("weight", "bias"):
            m[f"visual.merger.{hfn}.{leaf}"] = (f"merger.{on}.{leaf}", None)
    return m


def port_vision_state_dict(vcfg: Qwen2VLVisionConfig, state: dict) -> dict:
    """HF ``visual.*`` state dict (tensors or arrays) -> the tower's state
    dict, float32 tensors on the CPU; every shape checked."""
    with torch.device("meta"):
        want = VisionTower(vcfg).state_dict()
    out = {}
    for hf_key, (name, tf) in vision_hf_key_map(vcfg).items():
        w = state[hf_key]
        w = (w if isinstance(w, torch.Tensor) else torch.from_numpy(np.array(w))).float()
        if tf == "conv":
            w = w.reshape(w.shape[0], -1)
        if tuple(w.shape) != tuple(want[name].shape):
            raise ValueError(f"{hf_key}: shape {tuple(w.shape)}, the tower's {name} "
                             f"is {tuple(want[name].shape)}")
        out[name] = w
    return out


def tower_from_state(vcfg: Qwen2VLVisionConfig, state: dict, device=None,
                     dtype=None) -> VisionTower:
    """A :class:`VisionTower` on ``device`` (default CUDA) holding ``state``
    (the tower's names): tensors of two or more dimensions in ``dtype``
    (None: as given), the rest in float32."""
    dev = resolve_device(device)
    with torch.device("meta"):
        tower = VisionTower(vcfg)
    cast = {}
    for name, t in state.items():
        t = t.to(dev)
        cast[name] = t.to(dtype if dtype is not None and t.dim() >= 2 else
                          (t.dtype if t.dim() >= 2 else torch.float32))
    tower.load_state_dict(cast, assign=True)
    return tower.eval().requires_grad_(False)


def load_qwen2vl_from_hf(tcfg: LLMConfig, vcfg: Qwen2VLVisionConfig, model_dir: str,
                         weights: Optional[str] = None, dtype=torch.bfloat16, device=None):
    """A Qwen2-VL safetensors checkpoint -> (the decoder's :class:`LLM`, the
    :class:`VisionTower`) on ``device`` (default CUDA).  The decoder loads
    through :func:`~vla_touch_tpu_torch.planning.llm.load_llm_from_hf` (the
    same ``model.layers.*`` key space as Qwen2.5, optionally quantized
    layer by layer); the tower (run once per image, not decode-bound) in
    ``dtype``, its biases and norms in float32."""
    tparams = load_llm_from_hf(tcfg, model_dir, weights=weights, dtype=dtype, device=device)
    tensors = read_safetensors_dir(model_dir)
    kmap = vision_hf_key_map(vcfg)
    _require("vision tensors", model_dir, kmap, tensors)
    state = port_vision_state_dict(vcfg, {k: tensors[k] for k in kmap})
    return tparams, tower_from_state(vcfg, state, device=device, dtype=dtype)
