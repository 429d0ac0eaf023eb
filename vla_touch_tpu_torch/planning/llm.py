"""The planner's decoder-only LLM (counterpart of
``vla_touch_tpu/planning/llm.py``): the Qwen2 architecture (GQA attention
with rotary embeddings and qkv bias, RMSNorm, SwiGLU MLP) over input
embeddings, served in float, int8 or grouped int4, with greedy and sampled
decoding over a preallocated KV cache.

The parameters are an :class:`LLM` module: ``embed`` (V, D), ``layers`` (a
``ModuleList`` of :class:`DecoderLayer`, each with float32 ``input_norm`` /
``post_norm`` and the projection leaves ``q k v o gate up down``),
``final_norm`` and, untied, ``lm_head``.  A leaf is an ``nn.Linear`` or a
quantized leaf of ``ops/quant.py`` (:func:`quantize_llm_params`); a fused
tree (:func:`fuse_quantized_layers`) holds ``qkv`` and ``gateup`` instead.
LoRA factors are plain dicts as in the JAX package: ``{"layers": [{target:
{"A": (din, r), "B": (r, dout)}}], "scale": alpha / r}``.

Kernels on the serving path: every quantized leaf at M <= 512 goes through
``ops/quant_matmul.py::qdense_kernel_w4`` (int8 -> K6, grouped int4 -> K8);
with :data:`MEGAKERNELS` on, bf16 activations on the card and w4 leaves,
the prompt pass's SwiGLU MLP goes to K9 (``ops/w4_fused.py::
qdense_kernel_swiglu``) and each decode step's post-attention half to K10
(``w4_postattn_fused``), where the JAX package takes them on a TPU.
Attention stays a float32 einsum outside any kernel, as in the JAX package.

Training (:func:`lm_loss`, :func:`train_lm`; ``run_llm.py``'s projector and
LoRA trainers): :func:`llm_forward` is differentiable, as JAX's is.  Under
autograd a w4 leaf at M <= 512 runs K8 inside
``ops/quant_matmul.py::W4A8MatmulFn`` and the K9 route inside
``ops/w4_fused.py::W4SwigluFn``, whose backwards are the plain program's
vjp (so x's gradient through a quantized product passes only through each
row's ``amax``, as in the JAX package).  Decoding runs under ``no_grad``.

JAX's type promotion is kept where it shows: a float leaf multiplies in
the promoted type of x and the kernel and adds its bias with promotion, and
a LoRA residual runs in float32.  Greedy decoding takes the first maximal
index of the logits in their own dtype; sampling is ``argmax(logits /
temperature + gumbel)``, which is exactly ``jax.random.categorical``, so a
caller can hand in the Gumbel noise (a test replays JAX's keys).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vla_touch_tpu_torch.ops import quant as Q
from vla_touch_tpu_torch.ops import quant_matmul as QM
from vla_touch_tpu_torch.ops import w4_fused as W4F
from vla_touch_tpu_torch.ops.nn import silu
from vla_touch_tpu_torch.utils.device import resolve_device


# --------------------------------------------------------------------------
# Config
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LLMConfig:
    vocab_size: int = 384
    hidden_size: int = 128
    num_layers: int = 2
    num_heads: int = 4
    num_kv_heads: int = 2
    mlp_dim: int = 256
    rope_theta: float = 1e6
    rms_eps: float = 1e-6
    tie_embeddings: bool = True
    qkv_bias: bool = True              # Qwen2 convention
    # Qwen2-VL multimodal rotary: per-frequency-slot (temporal, height,
    # width) split of head_dim // 2; None = standard RoPE.
    mrope_section: Optional[tuple] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def qwen2_tiny(**kw) -> LLMConfig:
    return LLMConfig(**kw)


def qwen25_7b() -> LLMConfig:
    """Qwen2.5-7B-Instruct's dimensions."""
    return LLMConfig(vocab_size=152064, hidden_size=3584, num_layers=28,
                     num_heads=28, num_kv_heads=4, mlp_dim=18944,
                     rope_theta=1e6, tie_embeddings=False)


def llama31_8b() -> LLMConfig:
    """LLaMA-3.1-8B's dimensions (no qkv bias)."""
    return LLMConfig(vocab_size=128256, hidden_size=4096, num_layers=32,
                     num_heads=32, num_kv_heads=8, mlp_dim=14336,
                     rope_theta=5e5, tie_embeddings=False, qkv_bias=False)


def backbone(model_type: str):
    """The planner's three backbones by name: 'llama-3.1-8b' and
    'qwen2.5-7b' -> :class:`LLMConfig`; 'qwen2-vl-7b' -> (the M-RoPE text
    config, ``planning/qwen2vl.py``'s ``Qwen2VLVisionConfig``)."""
    if model_type == "llama-3.1-8b":
        return llama31_8b()
    if model_type == "qwen2.5-7b":
        return qwen25_7b()
    if model_type == "qwen2-vl-7b":
        from vla_touch_tpu_torch.planning.qwen2vl import qwen2vl_7b, qwen2vl_7b_vision

        return qwen2vl_7b(), qwen2vl_7b_vision()
    raise ValueError(f"unknown model_type {model_type!r} (expected "
                     "'llama-3.1-8b', 'qwen2.5-7b' or 'qwen2-vl-7b')")


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

class DecoderLayer(nn.Module):
    """One decoder block's parameters.  ``DecoderLayer(cfg)`` builds the
    float leaves (uninitialised); ``DecoderLayer(**parts)`` holds the given
    norms and leaves (quantized, fused or merged trees)."""

    def __init__(self, cfg: Optional[LLMConfig] = None, **parts):
        super().__init__()
        if cfg is not None:
            D, hd = cfg.hidden_size, cfg.head_dim
            parts = dict(
                input_norm=nn.Parameter(torch.ones(D)),
                q=nn.Linear(D, cfg.num_heads * hd, bias=cfg.qkv_bias),
                k=nn.Linear(D, cfg.num_kv_heads * hd, bias=cfg.qkv_bias),
                v=nn.Linear(D, cfg.num_kv_heads * hd, bias=cfg.qkv_bias),
                o=nn.Linear(cfg.num_heads * hd, D, bias=False),
                post_norm=nn.Parameter(torch.ones(D)),
                gate=nn.Linear(D, cfg.mlp_dim, bias=False),
                up=nn.Linear(D, cfg.mlp_dim, bias=False),
                down=nn.Linear(cfg.mlp_dim, D, bias=False))
        for name, part in parts.items():
            setattr(self, name, part)

    def leaves(self) -> dict:
        return dict(self.named_children())

    def __contains__(self, name: str) -> bool:
        return name in self._modules


class LLM(nn.Module):
    """The parameter tree: ``embed``, ``layers``, ``final_norm`` and, when
    the embeddings are untied, ``lm_head``."""

    def __init__(self, cfg: LLMConfig, embed: nn.Parameter, layers, final_norm: nn.Parameter,
                 lm_head: Optional[nn.Module] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        if lm_head is not None:
            self.lm_head = lm_head

    def with_layers(self, layers, lm_head=None) -> "LLM":
        """The same embedding and final norm (shared, not copied) over
        ``layers``; ``lm_head`` replaces this tree's when given."""
        head = lm_head if lm_head is not None else getattr(self, "lm_head", None)
        return LLM(self.cfg, self.embed, layers, self.final_norm, head)


# Output rows a quantizer call takes at once: 2^26 weights (256 MiB in
# float32) a call bound its transients (the clip search holds several float32
# copies), which for Qwen's 152064-row lm_head would otherwise reach ~14 GiB.
QUANT_CHUNK = 1 << 26


def _quantize_leaf(lin: nn.Linear, weights: str):
    """int8 or grouped int4 of one linear, :data:`QUANT_CHUNK` weights'
    worth of output rows at a time.  Exact: every scale and code belongs to
    one output row (column of the JAX kernel), so the rows' leaves
    concatenate to the whole leaf's."""
    N, K = lin.weight.shape
    rows = max(1, QUANT_CHUNK // K)
    if N > rows:
        parts = []
        for lo in range(0, N, rows):
            sub = nn.Linear(K, 1, bias=lin.bias is not None, device="meta")
            sub.weight = nn.Parameter(lin.weight[lo:lo + rows], requires_grad=False)
            if lin.bias is not None:
                sub.bias = nn.Parameter(lin.bias[lo:lo + rows], requires_grad=False)
            parts.append(_quantize_leaf(sub, weights))
        return _cat_leaves(parts)
    if weights == "int4":
        try:
            return Q.quantize_linear_w4(lin)
        except ValueError:                 # no valid int4 group size: int8
            return Q.quantize_linear(lin)
    return Q.quantize_linear(lin)


def _quantize_layer(lp: DecoderLayer, weights: str) -> DecoderLayer:
    parts = {}
    for name in ("input_norm", "post_norm"):
        parts[name] = getattr(lp, name)
    for name, m in lp.leaves().items():
        parts[name] = _quantize_leaf(m, weights) if isinstance(m, nn.Linear) else m
    return DecoderLayer(**parts)


def _check_weights(weights):
    if weights not in ("int8", "int4"):
        raise ValueError(f"weights must be 'int8' or 'int4', got {weights!r}")


@torch.no_grad()
def init_llm(cfg: LLMConfig, seed: int = 0, device=None, dtype=torch.float32,
             weights: Optional[str] = None) -> LLM:
    """A seeded random decoder on ``device`` (default CUDA): projection
    weights ~ N(0, 1/fan_in) and the embedding (and an untied ``lm_head``)
    ~ N(0, 0.02^2) in ``dtype``, biases 0, norms 1 in float32, as the JAX
    package's ``init_llm`` draws them (other numbers: torch's generator).
    ``weights='int8'|'int4'`` quantizes each layer as soon as it is made,
    so the peak is the quantized tree plus one float layer."""
    if weights is not None:
        _check_weights(weights)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D = cfg.hidden_size

    def normal_(t, std):
        return t.normal_(0.0, std, generator=gen)

    layers = []
    for _ in range(cfg.num_layers):
        with torch.device("meta"):
            lp = DecoderLayer(cfg)
        lp = lp.to_empty(device=dev)
        for name, m in lp.leaves().items():
            m.weight.data = m.weight.data.to(dtype)
            normal_(m.weight, m.in_features ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        lp.input_norm.fill_(1.0)
        lp.post_norm.fill_(1.0)
        layers.append(_quantize_layer(lp, weights) if weights else lp)
    embed = nn.Parameter(normal_(torch.empty((cfg.vocab_size, D), device=dev, dtype=dtype), 0.02))
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = nn.Linear(D, cfg.vocab_size, bias=False, device=dev, dtype=dtype)
        normal_(lm_head.weight, 0.02)
        if weights:
            lm_head = _quantize_leaf(lm_head, weights)
    model = LLM(cfg, embed, layers, nn.Parameter(torch.ones(D, device=dev)), lm_head)
    return model.eval().requires_grad_(False)


LORA_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")


@torch.no_grad()
def init_lora(cfg: LLMConfig, rank: int = 8, alpha: float = 16.0, targets=LORA_TARGETS,
              seed: int = 0, device=None) -> dict:
    """Per-layer (A, B) factors on ``device`` (default CUDA), float32: A ~
    N(0, 1) * din^-0.5 drawn layer by layer and target by target from a
    torch generator seeded by ``seed``, B zeros, so the adapted model starts
    exactly at the base; ``scale`` alpha / rank (the JAX package's
    ``init_lora``; other numbers: torch's generator)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D, hd = cfg.hidden_size, cfg.head_dim
    dims = {"q": (D, cfg.num_heads * hd), "k": (D, cfg.num_kv_heads * hd),
            "v": (D, cfg.num_kv_heads * hd), "o": (cfg.num_heads * hd, D),
            "gate": (D, cfg.mlp_dim), "up": (D, cfg.mlp_dim), "down": (cfg.mlp_dim, D)}
    layers = []
    for _ in range(cfg.num_layers):
        lp = {}
        for t in targets:
            din, dout = dims[t]
            a = torch.empty((din, rank), device=dev).normal_(generator=gen) * din ** -0.5
            lp[t] = {"A": a, "B": torch.zeros((rank, dout), device=dev)}
        layers.append(lp)
    return {"layers": layers, "scale": float(alpha) / float(rank)}


def merge_lora(params: LLM, lora: dict) -> LLM:
    """Fold LoRA factors into the float kernels, ``W' = W + A @ B * scale``
    in float32 (the JAX package's ``merge_lora``).  Returns a new tree that
    shares every untouched parameter; quantize it afterwards."""
    scale = lora["scale"]
    layers = []
    for lp, lol in zip(params.layers, lora["layers"]):
        parts = dict(input_norm=lp.input_norm, post_norm=lp.post_norm, **lp.leaves())
        for t, ab in (lol or {}).items():
            old = parts[t]
            lin = nn.Linear(old.in_features, old.out_features, bias=old.bias is not None,
                            device=old.weight.device)
            with torch.no_grad():
                lin.weight.copy_(old.weight.float() + (ab["A"].float() @ ab["B"].float()
                                                       * scale).t())
                if old.bias is not None:
                    lin.bias.copy_(old.bias.float())
            parts[t] = lin.requires_grad_(False)
        layers.append(DecoderLayer(**parts))
    return params.with_layers(layers)


@torch.no_grad()
def quantize_llm_params(params: LLM, weights: str = "int8") -> LLM:
    """Every decoder projection and an untied ``lm_head`` in int8
    (per-channel) or grouped int4 (``ops/quant.py``; a width with no valid
    group size stays int8).  Embedding and norms are shared with
    ``params``.  Merge LoRA first, or keep the adapters as a float32
    residual."""
    _check_weights(weights)
    head = getattr(params, "lm_head", None)
    return params.with_layers([_quantize_layer(lp, weights) for lp in params.layers],
                              None if head is None else _quantize_leaf(head, weights))


def _cat_leaves(leaves):
    """Output-axis concatenation of quantized leaves (exact: their scales
    are per output column), or None when they cannot share one leaf."""
    first = leaves[0]
    if any(type(lf) is not type(first) or (lf.bias is None) != (first.bias is None)
           for lf in leaves):
        return None
    bias = None if first.bias is None else torch.cat([lf.bias for lf in leaves])
    if isinstance(first, Q.QLinearW4):
        if len({lf.scale4.shape[0] for lf in leaves}) != 1:
            return None                    # differing group grids
        return Q.QLinearW4(torch.cat([lf.w4_pack for lf in leaves]),
                           torch.cat([lf.scale4 for lf in leaves], dim=1).contiguous(), bias)
    if isinstance(first, Q.QLinear):
        return Q.QLinear(torch.cat([lf.w_i8 for lf in leaves]),
                         torch.cat([lf.scale for lf in leaves]), bias)
    return None                            # not a quantized leaf


def fuse_quantized_layers(params: LLM) -> LLM:
    """q/k/v into one ``qkv`` leaf and gate/up into ``gateup`` (rows [0, F)
    gate, [F, 2F) up), for a quantized tree: one launch where there were
    three and two.  Exact.  Merge LoRA before fusing; a runtime LoRA
    residual still works on the fused tree."""
    layers = []
    for lp in params.layers:
        parts = dict(input_norm=lp.input_norm, post_norm=lp.post_norm, **lp.leaves())
        qkv = _cat_leaves([parts["q"], parts["k"], parts["v"]])
        if qkv is not None:
            parts["qkv"] = qkv
            for t in ("q", "k", "v"):
                del parts[t]
        gu = _cat_leaves([parts["gate"], parts["up"]])
        if gu is not None:
            parts["gateup"] = gu
            del parts["gate"], parts["up"]
        layers.append(DecoderLayer(**parts))
    return params.with_layers(layers)


# --------------------------------------------------------------------------
# HF checkpoints
# --------------------------------------------------------------------------

_HF_LAYER_KEYS = {
    "input_layernorm.weight": "input_norm",
    "self_attn.q_proj.weight": "q.weight", "self_attn.q_proj.bias": "q.bias",
    "self_attn.k_proj.weight": "k.weight", "self_attn.k_proj.bias": "k.bias",
    "self_attn.v_proj.weight": "v.weight", "self_attn.v_proj.bias": "v.bias",
    "self_attn.o_proj.weight": "o.weight",
    "post_attention_layernorm.weight": "post_norm",
    "mlp.gate_proj.weight": "gate.weight", "mlp.up_proj.weight": "up.weight",
    "mlp.down_proj.weight": "down.weight",
}


def hf_key_map(cfg: LLMConfig) -> dict:
    """HF safetensors key -> the :class:`LLM`'s state-dict name, for
    Qwen2 / LLaMA checkpoints.  Torch and the port both store a linear
    weight as (out, in), so every tensor loads as it is stored."""
    m = {"model.embed_tokens.weight": "embed"}
    for i in range(cfg.num_layers):
        for hf, ours in _HF_LAYER_KEYS.items():
            if ours.endswith(".bias") and not cfg.qkv_bias:
                continue
            m[f"model.layers.{i}.{hf}"] = f"layers.{i}.{ours}"
    m["model.norm.weight"] = "final_norm"
    if not cfg.tie_embeddings:
        m["lm_head.weight"] = "lm_head.weight"
    return m


def read_safetensors_dir(model_dir: str) -> dict:
    """{key: CPU tensor} over every ``*.safetensors`` shard of ``model_dir``,
    each a view of its file's memory map (``utils/safetensors_io.py``)."""
    import glob
    import os

    from vla_touch_tpu_torch.utils.safetensors_io import load_file

    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {model_dir}")
    tensors = {}
    for fp in files:
        tensors.update(load_file(fp))
    return tensors


def _require(what: str, model_dir: str, kmap: dict, tensors: dict) -> None:
    """Raise a KeyError naming the mapped tensors the checkpoint lacks: a
    dropped qkv bias or shard would otherwise give a wrong model silently."""
    missing = sorted(k for k in kmap if k not in tensors)
    if missing:
        raise KeyError(
            f"checkpoint at {model_dir} is missing {len(missing)} {what} the config "
            f"requires, e.g. {missing[:4]} - wrong config (qkv_bias/tie_embeddings/"
            f"num_layers?) or incomplete download")


@torch.no_grad()
def load_llm_from_hf(cfg: LLMConfig, model_dir: str, weights: Optional[str] = None,
                     dtype=torch.bfloat16, fuse: bool = False, device=None) -> LLM:
    """A Qwen2 / LLaMA safetensors checkpoint (a directory of shards) as an
    :class:`LLM` on ``device`` (default CUDA): every tensor of two or more
    dimensions in ``dtype``, norms and biases in float32, as the JAX
    package's loader casts them.  The files are read through the port's
    own reader (no ``safetensors`` package).

    ``weights='int8'|'int4'`` quantizes each decoder layer as it loads
    (:func:`_quantize_layer`, as :func:`quantize_llm_params` does), and the
    untied ``lm_head`` after, so the device holds the quantized tree plus
    one float layer at a time.  ``fuse=True`` (quantized loads only) then
    applies :func:`fuse_quantized_layers`."""
    if fuse and weights is None:
        raise ValueError("fuse=True requires weights='int8'|'int4'")
    if weights is not None:
        _check_weights(weights)
    dev = resolve_device(device)
    tensors = read_safetensors_dir(model_dir)
    kmap = hf_key_map(cfg)
    _require("tensors", model_dir, kmap, tensors)

    def get(hf_key):
        t = tensors[hf_key].to(dev)
        return t.to(dtype if t.dim() >= 2 else torch.float32)

    layers = []
    for i in range(cfg.num_layers):
        prefix = f"layers.{i}."
        state = {name[len(prefix):]: get(hf) for hf, name in kmap.items()
                 if name.startswith(prefix)}
        with torch.device("meta"):
            lp = DecoderLayer(cfg)
        lp.load_state_dict(state, assign=True)
        lp.requires_grad_(False)
        layers.append(_quantize_layer(lp, weights) if weights else lp)
    embed = nn.Parameter(get("model.embed_tokens.weight"), requires_grad=False)
    final_norm = nn.Parameter(get("model.norm.weight"), requires_grad=False)
    lm_head = None
    if not cfg.tie_embeddings:
        w = get("lm_head.weight")
        with torch.device("meta"):
            lm_head = nn.Linear(w.shape[1], w.shape[0], bias=False)
        lm_head.weight = nn.Parameter(w, requires_grad=False)
        if weights:
            lm_head = _quantize_leaf(lm_head, weights)
    model = LLM(cfg, embed, layers, final_norm, lm_head).eval()
    return fuse_quantized_layers(model) if fuse else model


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

# Dispatch policy of the decode: False keeps every quantized matmul on its
# own kernel (K6/K8); True sends the SwiGLU MLP of the prompt pass to K9 and
# the post-attention half of each decode step to K10.  Read at call time.
# Set from the H100 measurement of the three tiers (unfused, fused, fused +
# megakernels) in chip_smoke.py; PERF.md gives the numbers that chose it.
MEGAKERNELS = True


def _kernel_device(t) -> bool:
    """Whether the megakernel routes apply to activations on t's device (the
    JAX package takes them on a TPU; the port on the card)."""
    return t.device.type == "cuda"


def _mm(a, b):
    """``a @ b`` in the promoted dtype, as ``jnp`` promotes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _is_quantized(p) -> bool:
    return isinstance(p, (Q.QLinear, Q.QLinearW4))


def _lora_res(y, ab, h, scale):
    """The float LoRA residual over a (possibly fused or quantized) base."""
    return y if ab is None else y + _mm(_mm(h, ab["A"]), ab["B"]) * scale


def _dense(x, p, lora=None, scale=1.0):
    if _is_quantized(p):
        if x.dtype == torch.bfloat16:
            # the serving path: int8 -> K6, grouped int4 -> K8, M > 512 plain
            y = QM.qdense_kernel_w4(x, p)
        else:
            # the kernels write bf16: float32 activation trees stay plain
            y = Q.qdense_any(x, p, out_dtype=x.dtype)
    else:
        y = _mm(x, p.weight.t())
        if p.bias is not None:
            y = y + p.bias
    return _lora_res(y, lora, x, scale)


_rmsnorm = W4F.rmsnorm


def _rope(x, positions, theta, mrope_section=None):
    """x (B, L, H, hd), positions (B, L) -> rotated (NEOX half-split), float32
    angles, cast to x's dtype.  M-RoPE: positions (3, B, L) and
    ``mrope_section`` (t, h, w) summing to hd // 2; frequency slot i takes its
    angle from the component its section assigns."""
    return _apply_rope(x, _rope_tables(positions, x.shape[-1], theta, mrope_section))


def _rope_tables(positions, hd, theta, mrope_section=None):
    """(cos, sin) (B, L, 1, hd/2) float32 of :func:`_rope`, computed once for
    every layer and both of q and k."""
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    if positions.dim() == 3:
        assert mrope_section is not None and sum(mrope_section) == half
        ang3 = positions.float()[..., None] * freqs            # (3, B, L, half)
        pieces, lo = [], 0
        for c, sec in enumerate(mrope_section):
            pieces.append(ang3[c, :, :, lo:lo + sec])
            lo += sec
        ang = torch.cat(pieces, dim=-1)
    else:
        ang = positions.float()[:, :, None] * freqs
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def _apply_rope(x, tables):
    cos, sin = tables
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def _attend(q, k, v, mask):
    """q (B, Lq, H, hd); k/v (B, Lk, Hkv, hd); mask (B, Lq, Lk) bool, True =
    attend.  Query head h reads KV head h // (H / Hkv) (``jnp.repeat``)."""
    B, Lq, H, hd = q.shape
    Hkv = k.shape[2]
    if Hkv != H:
        k = k.repeat_interleave(H // Hkv, dim=2)
        v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (hd ** -0.5)
    s = torch.where(mask[:, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype).reshape(B, Lq, H * hd)


def _proj_qkv(cfg: LLMConfig, lp, lo, lscale, h, B, L):
    """q/k/v, through the fused ``qkv`` leaf when the tree has one."""
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if "qkv" in lp:
        nq, nkv = H * hd, Hkv * hd
        q, k, v = torch.split(_dense(h, lp.qkv), [nq, nkv, nkv], dim=-1)
        q = _lora_res(q, lo.get("q"), h, lscale)
        k = _lora_res(k, lo.get("k"), h, lscale)
        v = _lora_res(v, lo.get("v"), h, lscale)
    else:
        q = _dense(h, lp.q, lo.get("q"), lscale)
        k = _dense(h, lp.k, lo.get("k"), lscale)
        v = _dense(h, lp.v, lo.get("v"), lscale)
    return q.reshape(B, L, H, hd), k.reshape(B, L, Hkv, hd), v.reshape(B, L, Hkv, hd)


def _swiglu_megakernel_ok(lp, lo) -> bool:
    """K9 applies: both MLP leaves grouped int4 in the fused ``gateup``
    layout, and no LoRA residual on them."""
    return ("gateup" in lp and isinstance(lp.gateup, Q.QLinearW4)
            and isinstance(getattr(lp, "down", None), Q.QLinearW4)
            and not any(lo.get(k) for k in ("gate", "up", "down")))


def _postattn_megakernel_ok(lp, lo) -> bool:
    """K10 applies: K9's conditions and a LoRA-free w4 ``o``."""
    return (isinstance(getattr(lp, "o", None), Q.QLinearW4) and not lo.get("o")
            and _swiglu_megakernel_ok(lp, lo))


def _mlp(lp, lo, lscale, h):
    """The SwiGLU MLP, through ``gateup`` when the tree has it."""
    if (MEGAKERNELS and _swiglu_megakernel_ok(lp, lo) and _kernel_device(h)
            and h.dtype == torch.bfloat16):
        return W4F.qdense_kernel_swiglu(h, lp.gateup, lp.down)
    if "gateup" in lp:
        g, u = torch.chunk(_dense(h, lp.gateup), 2, dim=-1)
        g = _lora_res(g, lo.get("gate"), h, lscale)
        u = _lora_res(u, lo.get("up"), h, lscale)
    else:
        g = _dense(h, lp.gate, lo.get("gate"), lscale)
        u = _dense(h, lp.up, lo.get("up"), lscale)
    return _dense(silu(g) * u, lp.down, lo.get("down"), lscale)


def _layer(cfg: LLMConfig, lp, x, rope, mask, lora, lscale):
    """One decoder block at the rotary tables ``rope``; returns (x, (k, v))."""
    B, L, _ = x.shape
    h = _rmsnorm(x, lp.input_norm, cfg.rms_eps)
    lo = lora or {}
    q, k, v = _proj_qkv(cfg, lp, lo, lscale, h, B, L)
    q = _apply_rope(q, rope)
    k = _apply_rope(k, rope)
    att = _attend(q, k, v, mask)
    x = x + _dense(att, lp.o, lo.get("o"), lscale)
    h = _rmsnorm(x, lp.post_norm, cfg.rms_eps)
    x = x + _mlp(lp, lo, lscale, h)
    return x, (k, v)


def llm_forward(cfg: LLMConfig, params: LLM, embeds, positions=None, attn_mask=None,
                lora: Optional[dict] = None, return_kv: bool = False):
    """Causal forward over input embeddings (B, L, D); positions (B, L) or
    M-RoPE (3, B, L), default arange; attn_mask (B, L) True = real token.
    Returns hidden (B, L, D) (and the per-layer (k, v) if ``return_kv``)."""
    B, L, _ = embeds.shape
    dev = embeds.device
    if positions is None:
        positions = torch.arange(L, device=dev)[None].expand(B, L)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))[None]
    mask = causal if attn_mask is None else causal & attn_mask[:, None, :].bool()
    lscale = (lora or {}).get("scale", 0.0)
    llayers = (lora or {}).get("layers", [None] * cfg.num_layers)
    x = embeds
    rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.mrope_section)
    kvs = []
    for lp, lol in zip(params.layers, llayers):
        x, kv = _layer(cfg, lp, x, rope, mask, lol, lscale)
        kvs.append(kv)
    x = _rmsnorm(x, params.final_norm, cfg.rms_eps)
    return (x, kvs) if return_kv else x


def lm_logits(cfg: LLMConfig, params: LLM, hidden):
    if cfg.tie_embeddings:
        return _mm(hidden, params.embed.t())
    return _dense(hidden, params.lm_head)


def embed_tokens(params: LLM, ids):
    return F.embedding(torch.as_tensor(ids, device=params.embed.device), params.embed)


def lm_loss(cfg: LLMConfig, params: LLM, input_embeds, target_ids, loss_mask,
            lora: Optional[dict] = None):
    """Teacher-forced cross-entropy: position t predicts ``target_ids[t]``
    (shifted by the caller); float32 logits, ``log_softmax``, the mean over
    ``loss_mask`` with its denominator at least 1.  Differentiable w.r.t.
    ``input_embeds`` (the projector trains through it), ``lora`` and the
    float parameters."""
    hidden = llm_forward(cfg, params, input_embeds, lora=lora)
    logp = torch.log_softmax(lm_logits(cfg, params, hidden).float(), dim=-1)
    nll = -torch.gather(logp, -1, torch.as_tensor(target_ids, device=logp.device)
                        .long()[..., None])[..., 0]
    mask = torch.as_tensor(loss_mask, device=logp.device).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def token_entropy(logits):
    """Shannon entropy (nats) of the next-token distribution."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def token_surprisal(logits, tok, temperature=None):
    """-log2 p(tok) under the (tempered) distribution the token came from."""
    lg = logits.float()
    if temperature is not None:
        lg = lg / temperature
    logp = torch.log_softmax(lg, dim=-1)
    return -torch.gather(logp, -1, tok[..., None].long())[..., 0] / math.log(2.0)


def sequence_avg_surprisal(surprisals, lengths):
    """Average -log2 p per emitted token over the first ``lengths[i]`` steps."""
    T = surprisals.shape[1]
    mask = (torch.arange(T, device=surprisals.device)[None] < lengths[:, None]).float()
    return (surprisals * mask).sum(1) / lengths.clamp_min(1).float()


def gumbel_noise(shape, generator, device):
    """Standard Gumbel noise ``-log(-log(u))``, u uniform on [tiny, 1), as
    ``jax.random.gumbel`` draws it (other numbers: torch's generator)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


@torch.no_grad()
def _generate_impl(cfg: LLMConfig, params: LLM, prompt_embeds, max_new_tokens: int,
                   eos_id: int, lora: Optional[dict], temperature: Optional[float],
                   gumbel, seed: int, num_return_sequences: int, prompt_positions=None):
    """Prompt pass, then T - 1 decode steps over a preallocated KV cache.

    ``temperature`` None: greedy argmax.  Otherwise step t draws
    ``argmax(logits / temperature + gumbel[t])`` with ``gumbel`` (T, B*N, V)
    given, or drawn from a generator seeded by ``seed``.  The prompt pass
    runs once at B and its K/V repeat N times (rows [b*N, (b+1)*N) sample
    input b).  ``prompt_positions`` ((B, Lp) or M-RoPE (3, B, Lp)) rotate the
    prompt; decode continues at max(position) + 1.  Every step runs, also
    after EOS (later tokens are EOS), as the JAX scan does.  Returns
    (tokens (B*N, T), entropies, surprisals, lengths)."""
    B, Lp, D = prompt_embeds.shape
    dev = prompt_embeds.device
    T, N = max_new_tokens, num_return_sequences
    sampling = temperature is not None
    gen = None
    if sampling and gumbel is None:
        gen = torch.Generator(device=dev).manual_seed(seed)

    def select(logits, t):
        if not sampling:
            return torch.argmax(logits, dim=-1)
        g = (torch.as_tensor(gumbel[t], device=dev) if gumbel is not None
             else gumbel_noise(logits.shape, gen, dev))
        return torch.argmax(logits.float() / temperature + g, dim=-1)

    hidden, kvs = llm_forward(cfg, params, prompt_embeds, lora=lora,
                              positions=prompt_positions, return_kv=True)
    if prompt_positions is None:
        pos_start = torch.full((B,), Lp, dtype=torch.long, device=dev)
    else:
        pp = prompt_positions
        pos_start = (pp.amax(dim=(0, 2)) if pp.dim() == 3 else pp.amax(dim=1)).long() + 1
    logits = lm_logits(cfg, params, hidden[:, -1])
    if N > 1:
        logits = logits.repeat_interleave(N, dim=0)
        kvs = [(k.repeat_interleave(N, dim=0), v.repeat_interleave(N, dim=0)) for k, v in kvs]
        pos_start = pos_start.repeat_interleave(N)
    BN = B * N
    Lmax = Lp + T
    cache = []
    for k, v in kvs:
        kc = k.new_zeros((BN, Lmax) + tuple(k.shape[2:]))
        vc = v.new_zeros((BN, Lmax) + tuple(v.shape[2:]))
        kc[:, :Lp] = k
        vc[:, :Lp] = v
        cache.append((kc, vc))
    rope_delta = pos_start - Lp                   # decode position = kv_len + delta
    lscale = (lora or {}).get("scale", 0.0)
    llayers = (lora or {}).get("layers", [None] * cfg.num_layers)

    tok = select(logits, 0)
    toks, ents, surps = [tok], [token_entropy(logits)], [token_surprisal(logits, tok, temperature)]
    done = tok == eos_id
    ar = torch.arange(Lmax, device=dev)
    for t in range(1, T):
        kv_len = Lp + t - 1
        x = embed_tokens(params, tok)[:, None]                 # (BN, 1, D)
        rope = _rope_tables((kv_len + rope_delta)[:, None], cfg.head_dim, cfg.rope_theta)
        valid = (ar < kv_len + 1)[None, None].expand(BN, 1, Lmax)
        for li, (lp, lol) in enumerate(zip(params.layers, llayers)):
            kc, vc = cache[li]
            h = _rmsnorm(x, lp.input_norm, cfg.rms_eps)
            lo = lol or {}
            q, k, v = _proj_qkv(cfg, lp, lo, lscale, h, BN, 1)
            q = _apply_rope(q, rope)
            k = _apply_rope(k, rope)
            kc[:, kv_len] = k[:, 0]
            vc[:, kv_len] = v[:, 0]
            att = _attend(q, kc, vc, valid)
            if (MEGAKERNELS and _postattn_megakernel_ok(lp, lo) and _kernel_device(x)
                    and x.dtype == torch.bfloat16):
                x = W4F.w4_postattn_fused(x, att, lp.o, lp.gateup, lp.down, lp.post_norm,
                                      eps=cfg.rms_eps)
            else:
                x2 = x + _dense(att, lp.o, lo.get("o"), lscale)
                h2 = _rmsnorm(x2, lp.post_norm, cfg.rms_eps)
                x = x2 + _mlp(lp, lo, lscale, h2)
        x = _rmsnorm(x, params.final_norm, cfg.rms_eps)
        logits = lm_logits(cfg, params, x[:, 0])
        nxt = torch.where(done, eos_id, select(logits, t))
        ents.append(token_entropy(logits))
        surps.append(token_surprisal(logits, nxt, temperature))
        toks.append(nxt)
        done = done | (nxt == eos_id)
        tok = nxt
    tokens = torch.stack(toks, dim=1)
    lengths = (tokens != eos_id).sum(1) + (tokens == eos_id).any(1).long()
    return tokens, torch.stack(ents, dim=1), torch.stack(surps, dim=1), lengths


def greedy_generate(cfg: LLMConfig, params: LLM, prompt_embeds, max_new_tokens: int = 32,
                    eos_id: int = 1, lora: Optional[dict] = None, prompt_positions=None):
    """Greedy decode: (tokens (B, T), entropies (B, T), lengths (B,));
    positions after EOS hold EOS."""
    tokens, entropies, _, lengths = _generate_impl(
        cfg, params, prompt_embeds, max_new_tokens, eos_id, lora, temperature=None,
        gumbel=None, seed=0, num_return_sequences=1, prompt_positions=prompt_positions)
    return tokens, entropies, lengths


def sample_generate(cfg: LLMConfig, params: LLM, prompt_embeds, seed: int = 0,
                    max_new_tokens: int = 32, eos_id: int = 1, lora: Optional[dict] = None,
                    temperature: float = 1.0, num_return_sequences: int = 1,
                    prompt_positions=None, gumbel=None):
    """Temperature sampling with N return sequences per input: rows [b*N,
    (b+1)*N) sample input b.  ``gumbel`` (T, B*N, V): the noise of each
    step (default: drawn from a generator seeded by ``seed``).  Returns
    (tokens, entropies, surprisals (-log2 p under the tempered
    distribution), lengths)."""
    return _generate_impl(cfg, params, prompt_embeds, max_new_tokens, eos_id, lora,
                          temperature=float(temperature), gumbel=gumbel, seed=seed,
                          num_return_sequences=int(num_return_sequences),
                          prompt_positions=prompt_positions)


# --------------------------------------------------------------------------
# Full-parameter LM training
# --------------------------------------------------------------------------


def train_lm(cfg: LLMConfig, params: LLM, texts, tokenizer=None, steps: int = 200,
             lr: float = 1e-2):
    """Full-parameter causal-LM training of a float tree on a list of
    strings, in place: each text framed as BOS + bytes + EOS, padded with
    PAD, every position after BOS predicted (the mask shifted with the
    targets), all positions attendable; Adam (``optax.adam``: b1 0.9, b2
    0.999, eps 1e-8, no decay) over every parameter.  Returns (params, the
    last step's loss, taken before its update)."""
    from vla_touch_tpu_torch.train import optim

    tok = tokenizer or ByteTokenizer()
    seqs = [[tok.BOS] + list(tok.encode(t)) + [tok.EOS] for t in texts]
    Lmax = max(len(s) for s in seqs)
    ids = np.full((len(seqs), Lmax), tok.PAD, np.int64)
    msk = np.zeros((len(seqs), Lmax), np.float32)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
        msk[i, 1:len(s)] = 1.0
    dev = params.embed.device
    ids = torch.as_tensor(ids, device=dev)
    inp, tgt = ids[:, :-1], ids[:, 1:]
    lmask = torch.as_tensor(msk[:, 1:], device=dev)
    if dev.type == "cuda":
        optim.float32_math()
    params.requires_grad_(True)
    opt = optim.AdamW(params.parameters(), weight_decay=0.0)
    try:
        loss = None
        for _ in range(steps):
            loss = lm_loss(cfg, params, embed_tokens(params, inp), tgt, lmask)
            loss.backward()
            opt.step(lr)
            opt.zero_grad()
    finally:
        params.requires_grad_(False)
    return params, float(loss.detach())


# --------------------------------------------------------------------------
# Byte-level tokenizer (network-free; a HF tokenizer drops in by duck typing)
# --------------------------------------------------------------------------


class ByteTokenizer:
    """bytes 0..255 -> ids 0..255; specials above."""

    BOS = 256
    EOS = 257
    TACTILE_START = 258
    TACTILE_END = 259
    PAD = 260
    vocab_size = 384

    def encode(self, text: str, add_bos: bool = False) -> list:
        ids = list(text.encode("utf-8", errors="replace"))
        return ([self.BOS] if add_bos else []) + ids

    def decode(self, ids) -> str:
        bs = bytes(int(i) for i in np.asarray(ids).reshape(-1) if 0 <= int(i) < 256)
        return bs.decode("utf-8", errors="replace")
