"""Plain PyTorch reference of the two networks the benchmark's cells run:
RDT (arXiv:2410.07864, the HF ``rdt-1b`` runner) and the
SigLIP-so400m-patch14-384 vision tower.

It reads weights by their names in the published checkpoints (the frozen
manifests beside this file) and computes in float32 with TF32 off, unless a
lower precision is asked for (:class:`Ref` with ``precision="fp8"``: every
product's two operands rounded to float8 e4m3 with a per-tensor scale, the
control that a sound run must tell apart).  It imports neither the program
under test nor JAX, and keeps no cache: every call works from the raw
weights and inputs.

The equations are the published ones:

- RDT: a DiT over [timestep, control frequency, state, action x horizon]
  tokens; each block is a pre-RmsNorm self-attention (fused qkv, per-head
  RmsNorm of q and k), a pre-RmsNorm cross-attention (to the language
  condition, masked, in even blocks; to the image condition in odd blocks)
  and a pre-RmsNorm tanh-GELU MLP of the hidden width; the conditions are
  projected by MLP adaptors and get their positional tables added.
- SigLIP: a 14 x 14 patch convolution without padding (384 -> 27 x 27),
  a learned positional table, pre-LayerNorm blocks (epsilon 1e-6, tanh
  GELU), the post-LayerNorm; the attention-pool head is not used.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0                     # the largest finite float8 e4m3 value


def float32_matmuls() -> None:
    """float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale (amax to 448);
    the gradient passes through unchanged."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = amax / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


class Ref:
    """Weights by checkpoint name (any float dtype; used as float32) and
    the precision of the products."""

    def __init__(self, weights: dict, precision: Optional[str] = None):
        if precision not in (None, "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.weights = weights
        self.precision = precision

    def w(self, name: str) -> torch.Tensor:
        t = self.weights[name]
        return t if t.dtype == torch.float32 else t.float()

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return round_fp8(x) if self.precision == "fp8" else x

    # ---- layers ----
    def linear(self, x, prefix: str):
        bias = self.weights.get(prefix + "bias")
        return F.linear(self.r(x), self.r(self.w(prefix + "weight")),
                        None if bias is None else self.w(prefix + "bias"))

    def attention(self, q, k, v, kv_mask=None):
        """q (B, Lq, H, D), k and v (B, Lk, H, D); ``kv_mask`` (B, Lk) bool,
        True where a key is valid."""
        scores = torch.einsum("bqhd,bkhd->bhqk", self.r(q), self.r(k)) / math.sqrt(q.shape[-1])
        if kv_mask is not None:
            scores = scores.masked_fill(~kv_mask[:, None, None, :], float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", self.r(probs), self.r(v))


def rmsnorm(x, weight, eps: float = 1e-6):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * weight


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


# ---- RDT ----------------------------------------------------------------------------


def adaptor(ref: Ref, name: str, kind: str, x):
    """``linear`` or ``mlp{N}x_gelu``: Linears at Sequential indices 0, 2,
    ..., tanh-GELU between."""
    if kind == "linear":
        return ref.linear(x, f"{name}.")
    depth = int(kind[len("mlp"):kind.index("x_gelu")])
    for i in range(depth):
        if i:
            x = gelu_tanh(x)
        x = ref.linear(x, f"{name}.{2 * i}.")
    return x


def timestep_embed(ref: Ref, prefix: str, t, dim: int = 256):
    """GLIDE's sinusoidal embedding [cos, sin] of a scalar per row, then
    Linear -> SiLU -> Linear."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return ref.linear(F.silu(ref.linear(emb, prefix + "mlp.0.")), prefix + "mlp.2.")


def adapt_conditions(ref: Ref, cfg: dict, lang_tokens, img_tokens):
    """The two conditions projected and with their positional tables."""
    lang_c = adaptor(ref, "lang_adaptor", cfg["lang_adaptor"], lang_tokens)
    img_c = adaptor(ref, "img_adaptor", cfg["img_adaptor"], img_tokens)
    lang_c = lang_c + ref.w("model.lang_cond_pos_embed")[:, :lang_c.shape[1]]
    img_c = img_c + ref.w("model.img_cond_pos_embed")
    return lang_c, img_c


def rdt_forward(ref: Ref, cfg: dict, x, freq, t, lang_c, img_c, lang_mask=None):
    """x (B, 1 + horizon, H) adapted [state, action...] tokens; conditions
    from :func:`adapt_conditions`; returns (B, horizon, output_dim)."""
    H, heads = cfg["hidden_size"], cfg["num_heads"]
    D = H // heads
    B = x.shape[0]
    t_tok = timestep_embed(ref, "model.t_embedder.", t)
    f_tok = timestep_embed(ref, "model.freq_embedder.", freq)
    x = torch.cat([t_tok[:, None], f_tok[:, None], x], dim=1) + ref.w("model.x_pos_embed")
    N = x.shape[1]
    for i in range(cfg["depth"]):
        p = f"model.blocks.{i}."
        c, mask = (lang_c, lang_mask) if i % 2 == 0 else (img_c, None)
        h = rmsnorm(x, ref.w(p + "norm1.weight"))
        qkv = ref.linear(h, p + "attn.qkv.").reshape(B, N, 3, heads, D)
        q = rmsnorm(qkv[:, :, 0], ref.w(p + "attn.q_norm.weight"))
        k = rmsnorm(qkv[:, :, 1], ref.w(p + "attn.k_norm.weight"))
        x = x + ref.linear(ref.attention(q, k, qkv[:, :, 2]).reshape(B, N, H), p + "attn.proj.")
        h = rmsnorm(x, ref.w(p + "norm2.weight"))
        q = rmsnorm(ref.linear(h, p + "cross_attn.q.").reshape(B, N, heads, D),
                    ref.w(p + "cross_attn.q_norm.weight"))
        kv = ref.linear(c, p + "cross_attn.kv.").reshape(B, c.shape[1], 2, heads, D)
        k = rmsnorm(kv[:, :, 0], ref.w(p + "cross_attn.k_norm.weight"))
        out = ref.attention(q, k, kv[:, :, 1], mask)
        x = x + ref.linear(out.reshape(B, N, H), p + "cross_attn.proj.")
        h = rmsnorm(x, ref.w(p + "norm3.weight"))
        x = x + ref.linear(gelu_tanh(ref.linear(h, p + "ffn.fc1.")), p + "ffn.fc2.")
    h = rmsnorm(x, ref.w("model.final_layer.norm_final.weight"))
    h = ref.linear(gelu_tanh(ref.linear(h, "model.final_layer.ffn_final.fc1.")),
                   "model.final_layer.ffn_final.fc2.")
    return h[:, -cfg["horizon"]:]


# ---- SigLIP -------------------------------------------------------------------------


def siglip_normalize(images):
    """uint8 (..., S, S, 3) -> float32 in [-1, 1] (mean = std = 0.5)."""
    return images.float() / 255.0 * 2.0 - 1.0


def siglip_forward(ref: Ref, vcfg: dict, pixels, prefix: str = "vision_model."):
    """pixels (B, S, S, 3) normalised -> (B, 729, 1152) patch tokens."""
    D, heads, p = vcfg["hidden_size"], vcfg["num_heads"], vcfg["patch_size"]
    eps = vcfg["layernorm_eps"]
    e = prefix + "embeddings."
    x = F.conv2d(ref.r(pixels.permute(0, 3, 1, 2)), ref.r(ref.w(e + "patch_embedding.weight")),
                 ref.w(e + "patch_embedding.bias"), stride=p)
    x = x.flatten(2).transpose(1, 2) + ref.w(e + "position_embedding.weight")[None]
    B, N, _ = x.shape

    def ln(h, name):
        return F.layer_norm(h, (D,), ref.w(name + ".weight"), ref.w(name + ".bias"), eps)

    for i in range(vcfg["num_layers"]):
        lp = f"{prefix}encoder.layers.{i}."
        h = ln(x, lp + "layer_norm1")
        q, k, v = (ref.linear(h, f"{lp}self_attn.{n}_proj.").reshape(B, N, heads, D // heads)
                   for n in ("q", "k", "v"))
        x = x + ref.linear(ref.attention(q, k, v).reshape(B, N, D), lp + "self_attn.out_proj.")
        h = ln(x, lp + "layer_norm2")
        x = x + ref.linear(gelu_tanh(ref.linear(h, lp + "mlp.fc1.")), lp + "mlp.fc2.")
    return ln(x, prefix + "post_layernorm")


@torch.no_grad()
def encode_frames(ref: Ref, vcfg: dict, images, image_mask, block: int = 6):
    """uint8 frames (B, F, S, S, 3) and their mask (B, F) -> (B, F * 729,
    1152) tokens; a masked frame is 0 after normalisation.  ``block``
    frames at a time, so that it fits beside the program."""
    B, nf = images.shape[:2]
    x = siglip_normalize(images)
    x = torch.where(image_mask[:, :, None, None, None], x, torch.zeros_like(x))
    flat = x.reshape((B * nf,) + tuple(x.shape[2:]))
    out = torch.cat([siglip_forward(ref, vcfg, flat[i:i + block])
                     for i in range(0, flat.shape[0], block)])
    return out.reshape(B, -1, out.shape[-1])


# ---- parameter shapes ---------------------------------------------------------------


def rdt_shapes(cfg: dict) -> dict:
    """Checkpoint name -> shape of an RDT runner at ``cfg``'s widths (the
    HF ``rdt-1b`` layout)."""
    H, D = cfg["hidden_size"], cfg["hidden_size"] // cfg["num_heads"]
    out = {}

    def lin(name, n_in, n_out):
        out[name + ".weight"] = [n_out, n_in]
        out[name + ".bias"] = [n_out]

    for name, n_in in (("lang_adaptor", cfg["lang_token_dim"]),
                       ("img_adaptor", cfg["img_token_dim"]),
                       ("state_adaptor", 2 * cfg["state_token_dim"])):
        kind = cfg[name]
        depth = 1 if kind == "linear" else int(kind[len("mlp"):kind.index("x_gelu")])
        if depth == 1:
            lin(name, n_in, H)
        for i in range(depth if depth > 1 else 0):
            lin(f"{name}.{2 * i}", n_in if i == 0 else H, H)
    for te in ("t_embedder", "freq_embedder"):
        lin(f"model.{te}.mlp.0", 256, H)
        lin(f"model.{te}.mlp.2", H, H)
    out["model.x_pos_embed"] = [1, cfg["horizon"] + 3, H]
    out["model.lang_cond_pos_embed"] = [1, cfg["max_lang_cond_len"], H]
    out["model.img_cond_pos_embed"] = [1, cfg["img_cond_len"], H]
    for i in range(cfg["depth"]):
        p = f"model.blocks.{i}."
        for n in ("norm1", "norm2", "norm3"):
            out[p + n + ".weight"] = [H]
        lin(p + "attn.qkv", H, 3 * H)
        lin(p + "attn.proj", H, H)
        lin(p + "cross_attn.q", H, H)
        lin(p + "cross_attn.kv", H, 2 * H)
        lin(p + "cross_attn.proj", H, H)
        for a in ("attn", "cross_attn"):
            out[p + a + ".q_norm.weight"] = [D]
            out[p + a + ".k_norm.weight"] = [D]
        lin(p + "ffn.fc1", H, H)
        lin(p + "ffn.fc2", H, H)
    out["model.final_layer.norm_final.weight"] = [H]
    lin("model.final_layer.ffn_final.fc1", H, H)
    lin("model.final_layer.ffn_final.fc2", H, cfg["output_dim"])
    return dict(sorted(out.items()))


def siglip_shapes(vcfg: dict, prefix: str = "vision_model.") -> dict:
    """Checkpoint name -> shape of the SigLIP tower (no pooling head)."""
    D, p, C = vcfg["hidden_size"], vcfg["patch_size"], vcfg["num_channels"]
    n = (vcfg["image_size"] // p) ** 2
    e = prefix + "embeddings."
    out = {e + "patch_embedding.weight": [D, C, p, p], e + "patch_embedding.bias": [D],
           e + "position_embedding.weight": [n, D],
           prefix + "post_layernorm.weight": [D], prefix + "post_layernorm.bias": [D]}
    for i in range(vcfg["num_layers"]):
        lp = f"{prefix}encoder.layers.{i}."
        for name, shape in (("layer_norm1", [D]), ("layer_norm2", [D])):
            out[lp + name + ".weight"] = shape
            out[lp + name + ".bias"] = shape
        for n in ("q", "k", "v", "out"):
            out[f"{lp}self_attn.{n}_proj.weight"] = [D, D]
            out[f"{lp}self_attn.{n}_proj.bias"] = [D]
        out[lp + "mlp.fc1.weight"] = [vcfg["mlp_dim"], D]
        out[lp + "mlp.fc1.bias"] = [vcfg["mlp_dim"]]
        out[lp + "mlp.fc2.weight"] = [D, vcfg["mlp_dim"]]
        out[lp + "mlp.fc2.bias"] = [D]
    return dict(sorted(out.items()))
