"""The T5 v1.1 encoder, RDT's language tower (counterpart of
``vla_touch_tpu/models/encoders/t5_native.py``).

T5 v1.1: pre-RMSNorm residual blocks, the relative-position bucket bias
shared from layer 0, no bias in any linear, the gated tanh-GELU FFN, d_kv
independent of d_model (XXL: 64 heads of 64 over d_model 4096, 4.76 B
parameters, 9.5 GB in bf16).

:func:`t5_encode` is JAX's program: RMSNorm in float32 and cast back, no
1/sqrt(d) scale, the scores in float32 plus the bucket bias and a
``finfo(float32).min`` key mask, softmax in float32 cast to the compute
dtype.  The attention carries an additive per-head bias, which K1 (a
masked softmax with no additive term) does not take, and which the JAX
package computes as an einsum outside any Pallas kernel; so the products
here are plain torch.

:class:`T5Encoder` holds the JAX tree's leaves under their names
(``embed``, ``rel_bias``, ``layers.{i}.{norm1,q,k,v,o,norm2,wi_0,wi_1,wo}``,
``final_norm``); the linears and the embedding are in the compute dtype,
the norms and the bias table stay float32, as JAX keeps them.
:func:`t5_from_hf` reads an HF ``T5EncoderModel`` state dict into that
tree and ``utils/from_flax.py::t5_encoder`` into the module's state.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vla_touch_tpu_torch.ops.nn import gelu_tanh


@dataclasses.dataclass(frozen=True)
class T5EncoderConfig:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 1024
    num_layers: int = 8
    num_heads: int = 6
    rel_buckets: int = 32
    rel_max_distance: int = 128
    eps: float = 1e-6


def t5_v1_1_xxl() -> T5EncoderConfig:
    return T5EncoderConfig(d_model=4096, d_kv=64, d_ff=10240, num_layers=24,
                           num_heads=64)


def t5_tiny(**kw) -> T5EncoderConfig:
    d = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2,
             num_heads=4)
    d.update(kw)
    return T5EncoderConfig(**d)


# ---------------------------------------------------------------- module --


class T5Layer(nn.Module):
    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        D, inner = cfg.d_model, cfg.num_heads * cfg.d_kv
        self.norm1 = nn.Parameter(torch.ones(D))
        self.q = nn.Linear(D, inner, bias=False)
        self.k = nn.Linear(D, inner, bias=False)
        self.v = nn.Linear(D, inner, bias=False)
        self.o = nn.Linear(inner, D, bias=False)
        self.norm2 = nn.Parameter(torch.ones(D))
        self.wi_0 = nn.Linear(D, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(D, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, D, bias=False)


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model))
        self.rel_bias = nn.Parameter(torch.empty(cfg.rel_buckets, cfg.num_heads))
        self.layers = nn.ModuleList(T5Layer(cfg) for _ in range(cfg.num_layers))
        self.final_norm = nn.Parameter(torch.ones(cfg.d_model))

    @torch.no_grad()
    def init_special_(self, generator):
        """JAX's init of the two tables: the embedding N(0, 1), the bucket
        bias N(0, 0.1^2)."""
        self.embed.normal_(0.0, 1.0, generator=generator)
        self.rel_bias.normal_(0.0, 0.1, generator=generator)

    def forward(self, input_ids, attention_mask, dtype=None):
        return t5_encode(self.cfg, self, input_ids, attention_mask, dtype)


def set_dtype_(module: T5Encoder, dtype: torch.dtype) -> T5Encoder:
    """Put the linears and the embedding in ``dtype``; the norms and the
    bucket bias stay float32."""
    module.embed.data = module.embed.data.to(dtype)
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.weight.data = m.weight.data.to(dtype)
    for name, p in module.named_parameters():
        if "norm" in name or name == "rel_bias":
            p.data = p.data.float()
    return module


def init_t5_encoder(cfg: T5EncoderConfig, seed: int = 0, device=None,
                    dtype: torch.dtype = torch.float32) -> T5Encoder:
    """A seeded random encoder on ``device`` (default CUDA), its linears and
    embedding allocated straight in ``dtype`` (XXL in bf16 never passes
    through float32): linears N(0, 1/fan_in), norms 1, the tables as
    :meth:`T5Encoder.init_special_`."""
    from vla_touch_tpu_torch.utils.device import resolve_device
    from vla_touch_tpu_torch.utils.random_init import init_module_

    dev = resolve_device(device)
    with torch.device("meta"):
        module = set_dtype_(T5Encoder(cfg), dtype)
    module = module.to_empty(device=dev)
    init_module_(module, seed)
    return module.eval().requires_grad_(False)


def t5_from_hf(sd: dict, num_layers: int) -> dict:
    """HF ``T5EncoderModel`` state dict -> JAX's parameter tree (numpy):
    linear weights transposed to (in, out); the bucket table, an
    ``nn.Embedding`` that is already (buckets, heads), as is."""
    def lin(name):
        return np.ascontiguousarray(np.asarray(sd[name]).T)

    layers = []
    for i in range(num_layers):
        p = f"encoder.block.{i}.layer"
        layers.append({
            "norm1": np.asarray(sd[f"{p}.0.layer_norm.weight"]),
            "q": lin(f"{p}.0.SelfAttention.q.weight"),
            "k": lin(f"{p}.0.SelfAttention.k.weight"),
            "v": lin(f"{p}.0.SelfAttention.v.weight"),
            "o": lin(f"{p}.0.SelfAttention.o.weight"),
            "norm2": np.asarray(sd[f"{p}.1.layer_norm.weight"]),
            "wi_0": lin(f"{p}.1.DenseReluDense.wi_0.weight"),
            "wi_1": lin(f"{p}.1.DenseReluDense.wi_1.weight"),
            "wo": lin(f"{p}.1.DenseReluDense.wo.weight"),
        })
    embed_key = "shared.weight" if "shared.weight" in sd else "encoder.embed_tokens.weight"
    return {
        "embed": np.asarray(sd[embed_key]),
        "rel_bias": np.ascontiguousarray(np.asarray(
            sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"])),
        "layers": layers,
        "final_norm": np.asarray(sd["encoder.final_layer_norm.weight"]),
    }


def load_t5_encoder(path: str, cfg: T5EncoderConfig, device=None,
                    dtype: torch.dtype = torch.bfloat16) -> T5Encoder:
    """The encoder from an HF-layout checkpoint file (``model.safetensors``
    or ``pytorch_model.bin``), built without allocating and filled from the
    file, on ``device`` (default CUDA), its linears and embedding in
    ``dtype``."""
    from vla_touch_tpu_torch.utils import from_flax as FF
    from vla_touch_tpu_torch.utils.device import resolve_device
    from vla_touch_tpu_torch.utils.torch_port import read_state_dict

    dev = resolve_device(device)
    with torch.device("meta"):
        module = set_dtype_(T5Encoder(cfg), dtype)
    module = module.to_empty(device=dev)
    tree = t5_from_hf(read_state_dict(path), cfg.num_layers)
    FF.load_into(module, FF.t5_encoder(tree))
    return module.eval().requires_grad_(False)


# --------------------------------------------------------------- forward --


def _rmsnorm(x, w, eps):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


@functools.lru_cache(maxsize=16)
def _buckets_cpu(qlen: int, klen: int, num_buckets: int, max_distance: int) -> torch.Tensor:
    ctx = torch.arange(qlen)[:, None]
    mem = torch.arange(klen)[None, :]
    rel = mem - ctx                                     # (q, k)
    nb = num_buckets // 2
    big = rel > 0
    rel_abs = torch.abs(rel)
    max_exact = nb // 2
    is_small = rel_abs < max_exact
    # JAX's float32 order: log(max(rel, 1) / max_exact) * scale, the scale a
    # float32 of the float64 constant (at rel 16, 32, 64 the product lands
    # on a bucket boundary, which another order misses)
    scale = torch.tensor(np.float32((nb - max_exact) / np.log(max_distance / max_exact)))
    frac = torch.clamp(rel_abs, min=1).float() / np.float32(max_exact)
    large = max_exact + (torch.log(frac) * scale).to(torch.int32)
    large = torch.clamp(large, max=nb - 1)
    buckets = torch.where(is_small, rel_abs.to(torch.int32), large) + torch.where(big, nb, 0)
    return buckets.to(torch.int32)


def relative_position_buckets(qlen: int, klen: int, num_buckets: int, max_distance: int,
                              device=None) -> torch.Tensor:
    """Bidirectional T5 bucket map (L_q, L_k) int32, HF's
    ``T5Attention._relative_position_bucket``.  Computed on the CPU (its
    float32 ``log`` is the one JAX's map was held to) and cached, then moved
    to ``device``."""
    return _buckets_cpu(qlen, klen, num_buckets, max_distance).to(device or "cpu")


def t5_encode(cfg: T5EncoderConfig, module: T5Encoder, input_ids, attention_mask,
              dtype: Optional[torch.dtype] = None):
    """(B, L) token ids + (B, L) mask -> (B, L, d_model) hidden states in
    ``dtype`` (default: the embedding's dtype), HF
    ``T5EncoderModel(...).last_hidden_state``."""
    dtype = dtype or module.embed.dtype
    dev = module.embed.device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    attention_mask = torch.as_tensor(attention_mask, device=dev)
    B, L = input_ids.shape
    x = module.embed.to(dtype)[input_ids]

    buckets = relative_position_buckets(L, L, cfg.rel_buckets, cfg.rel_max_distance, dev)
    # (L, L, H) -> (1, H, L, L); shared by every layer
    bias = module.rel_bias.float()[buckets.long()].permute(2, 0, 1)[None]
    neg = torch.tensor(np.finfo(np.float32).min, device=dev)
    bias = bias + torch.where(attention_mask[:, None, None, :].bool(),
                              torch.zeros((), device=dev), neg)

    H, dk = cfg.num_heads, cfg.d_kv
    for lp in module.layers:
        # T5 attention: no 1/sqrt(d) scale (it is folded into the weights)
        h = _rmsnorm(x, lp.norm1, cfg.eps)
        q = F.linear(h, lp.q.weight.to(dtype)).reshape(B, L, H, dk)
        k = F.linear(h, lp.k.weight.to(dtype)).reshape(B, L, H, dk)
        v = F.linear(h, lp.v.weight.to(dtype)).reshape(B, L, H, dk)
        # products of the compute dtype are exact in float32: float32 scores
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias
        a = torch.softmax(s, dim=-1).to(dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B, L, H * dk)
        x = x + F.linear(o, lp.o.weight.to(dtype))

        h = _rmsnorm(x, lp.norm2, cfg.eps)
        g = gelu_tanh(F.linear(h, lp.wi_0.weight.to(dtype)))
        u = F.linear(h, lp.wi_1.weight.to(dtype))
        x = x + F.linear(g * u, lp.wo.weight.to(dtype))

    return _rmsnorm(x, module.final_norm, cfg.eps)


class NativeT5Embedder:
    """The language embedder of :mod:`models.encoders.t5` on the port's
    encoder: texts through ``tokenizer`` (HF-style: ``tokenizer(text,
    truncation=True, max_length=n)`` -> ``input_ids``, ``attention_mask``)
    on the host, the encoder on ``device`` (default CUDA) in ``dtype``
    (default bf16; the module's linears are cast there once)."""

    def __init__(self, cfg: T5EncoderConfig, module: T5Encoder, tokenizer,
                 max_length: int = 1024, dtype: torch.dtype = torch.bfloat16, device=None):
        from vla_touch_tpu_torch.utils.device import resolve_device

        self.cfg, self.tokenizer = cfg, tokenizer
        self.max_length, self.dtype = max_length, dtype
        self.device = resolve_device(device)
        self.module = set_dtype_(module.to(self.device), dtype)

    @torch.inference_mode()
    def get_text_embeddings(self, texts) -> list:
        """One (L_i, d_model) float32 numpy array per text."""
        out = []
        for text in texts:
            tok = self.tokenizer(text, truncation=True, max_length=self.max_length)
            ids = torch.as_tensor(np.asarray(tok["input_ids"], np.int64)[None])
            mask = torch.as_tensor(np.asarray(tok["attention_mask"], np.int64)[None])
            hidden = t5_encode(self.cfg, self.module, ids, mask, self.dtype)
            out.append(hidden[0].float().cpu().numpy())
        return out
