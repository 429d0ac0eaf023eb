"""Int8 / int4 RDT serving twin (counterpart of
``vla_touch_tpu/models/rdt/quant_serve.py``).

:func:`quantize_rdt_params` turns the port's bf16 :class:`RDTRunnerModule`
into a :class:`QuantRDTRunner`: every linear of the runner becomes an int8
(:class:`ops.quant.QLinear`) or grouped-int4 (:class:`ops.quant.QLinearW4`)
leaf, except the timestep embedders (kept, run in float32) and the
cross-attention ``kv`` projections (bf16 by default, :class:`ops.quant.BF16Linear`).
:func:`rdt_predict_action_quant` is the serving forward, cold or warm-started
from the previous chunk as :func:`runner.rdt_predict_action`.  It runs in
bf16 whatever the config's dtype, as the JAX package's does.

Every quantized linear goes through ``ops/quant_matmul.py::
qdense_kernel_w4``: on CUDA tensors an int8 leaf at M <= 512 launches K6
and an int4 leaf K8 (M > 512, the image adaptor over 4374 tokens, takes the
plain route, as the JAX package leaves it to XLA).  The condition K/V
projections call the plain :func:`ops.quant.qdense` directly, never the
dispatcher, as in the JAX package.  ``kv_cache`` picks the condition cache:

- ``'bf16'``: bf16 K/V, cross-attention through K1;
- ``'int8'``: int8 K/V (B, L, H, D) with per-(B, H, D) scales, through K3;
- ``'int8t'``: the transposed int8 cache (B, H, D, L), through K4;
- ``'int8x'``: int8 K/V dequantized to bf16 in plain torch, through K1.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from vla_touch_tpu_torch.config import RDTModelConfig
from vla_touch_tpu_torch.models.rdt import runner as R
from vla_touch_tpu_torch.ops import attention as A
from vla_touch_tpu_torch.ops import flash_attention_q8 as FQ
from vla_touch_tpu_torch.ops import nn as NN
from vla_touch_tpu_torch.ops import quant as Q
from vla_touch_tpu_torch.ops import quant_matmul as QM
from vla_touch_tpu_torch.ops import schedulers as sched_lib
from vla_touch_tpu_torch.ops.pos_embed import timestep_embedding

KV_CACHES = ("bf16", "int8", "int8t", "int8x")


class QuantRDTRunner(nn.Module):
    """A quantized RDT runner: ``model``, ``lang_adaptor``, ``img_adaptor``
    and ``state_adaptor`` with the port's module names (``blocks.{i}``),
    their linears replaced by quantized leaves (buffers ``w_i8``/``scale``
    or ``w4_pack``/``scale4``, plus ``bias``)."""

    def __init__(self, cfg: RDTModelConfig, model: nn.Module, lang_adaptor: nn.Module,
                 img_adaptor: nn.Module, state_adaptor: nn.Module):
        super().__init__()
        self.cfg = cfg
        self.model = model
        self.lang_adaptor = lang_adaptor
        self.img_adaptor = img_adaptor
        self.state_adaptor = state_adaptor


def _flax_path(path) -> tuple:
    """The port's module path with ``blocks``, ``i`` mapped back to the JAX
    tree's ``block{i}``."""
    out, i = [], 0
    while i < len(path):
        if path[i] == "blocks" and i + 1 < len(path) and str(path[i + 1]).isdigit():
            out.append(f"block{path[i + 1]}")
            i += 2
        else:
            out.append(path[i])
            i += 1
    return tuple(out)


def make_w4_select(blocks=None, kinds=("fc1", "fc2", "qkv", "proj", "q")):
    """Predicate for ``quantize_rdt_params(weights='mixed')``: int4 on the
    named matmul classes (fc1/fc2, qkv, proj of both attentions, q) of the
    named transformer blocks (None = every block), int8 elsewhere; the
    adaptors and the final head never match.  Takes the port's module path
    and picks exactly the leaves the JAX predicate picks on its tree."""
    blockset = None if blocks is None else {f"block{i}" for i in blocks}

    def sel(path, leaf):
        path = _flax_path(path)
        if not any(p.startswith("block") for p in path):
            return False
        if blockset is not None and not any(p in blockset for p in path):
            return False
        return path[-1] in kinds

    return sel


def _admitted(path, leaf) -> bool:
    """Every linear but the timestep embedders and the cross-attention kv."""
    if any("embedder" in p for p in path):
        return False
    return not (len(path) >= 2 and path[-2] == "cross_attn" and path[-1] == "kv")


@torch.no_grad()
def quantize_rdt_params(runner: R.RDTRunnerModule, weights: str = "int8",
                        kv_proj: str = "bf16", w4_select=None) -> QuantRDTRunner:
    """Quantize a copy of ``runner`` (the port's bf16 or float32 runner, on
    any device) into a :class:`QuantRDTRunner`, as the JAX
    ``quantize_rdt_params`` does its tree: ``weights`` 'int8', 'int4' (where
    a valid group size exists, else int8) or 'mixed' (int4 where
    ``w4_select(path, linear)`` says so, e.g. :func:`make_w4_select`);
    ``kv_proj`` 'bf16' or 'int8' for the condition K/V projections."""
    if kv_proj not in ("bf16", "int8"):
        raise ValueError(f"kv_proj {kv_proj!r}")
    q = copy.deepcopy(runner)
    if weights == "int4":
        Q.quantize_tree_w4(q, _admitted)
    elif weights == "mixed":
        if w4_select is None:
            raise ValueError("weights='mixed' needs w4_select")
        Q.quantize_tree_w4(q, _admitted, w4_select=w4_select)
    elif weights == "int8":
        Q.quantize_tree(q, _admitted)
    else:
        raise ValueError(f"weights {weights!r}")
    for blk in q.model.blocks:
        lin = blk.cross_attn.kv
        if kv_proj == "int8":
            blk.cross_attn.kv = Q.quantize_linear(lin)
        else:
            blk.cross_attn.kv = Q.BF16Linear(lin.weight.detach().to(torch.bfloat16),
                                           lin.bias.detach().float())
    return QuantRDTRunner(runner.cfg, q.model, q.lang_adaptor, q.img_adaptor,
                          q.state_adaptor).eval().requires_grad_(False)


# ---- the serving forward --------------------------------------------------------

def _timestep_embed(p, t):
    """The timestep / control-frequency embedder in float32 on float32
    copies of its weights, bf16 out (``quant_serve.py:134-139``)."""
    freq = timestep_embedding(t, 256, dtype=torch.float32)
    x = freq @ p.fc1.weight.float().t() + p.fc1.bias.float()
    x = NN.silu(x)
    x = x @ p.fc2.weight.float().t() + p.fc2.bias.float()
    return x.to(torch.bfloat16)


def _qd(x, leaf):
    return QM.qdense_kernel_w4(x, leaf)


def _mlp_tanh_gelu(p, x):
    # bf16 in, each operation rounded to bf16 as JAX's: F.gelu rounds once,
    # which moves ~40 % of the outputs by one bf16 step and, through the next
    # layer's per-token int8 quantization, the chunk by ~2 % of its scale
    return _qd(NN.gelu_tanh(_qd(x, p.fc1)), p.fc2)


def _self_attn(p, x, num_heads):
    B, N, C = x.shape
    qkv = _qd(x, p.qkv).reshape(B, N, 3, num_heads, C // num_heads)
    q = p.q_norm(qkv[:, :, 0])
    k = p.k_norm(qkv[:, :, 1])
    out = A.dot_product_attention(q, k, qkv[:, :, 2])
    return _qd(out.reshape(B, N, C), p.proj)


def _cross_attn_cached(p, x, kv, mask, num_heads):
    B, N, C = x.shape
    q = p.q_norm(_qd(x, p.q).reshape(B, N, num_heads, C // num_heads))
    kind, *cache = kv
    if kind == "int8":
        out = FQ.flash_attention_q8(q, *cache, kv_mask=mask)
    elif kind == "int8t":
        out = FQ.flash_attention_q8t(q, *cache, kv_mask=mask)
    elif kind == "int8x":
        # int8 cache dequantized in plain torch, attention through K1
        k_i8, sk, v_i8, sv = cache
        k = (k_i8.float() * sk[:, None]).to(torch.bfloat16)
        v = (v_i8.float() * sv[:, None]).to(torch.bfloat16)
        out = A.dot_product_attention(q, k, v, kv_mask=mask)
    else:
        k, v = cache
        out = A.dot_product_attention(q, k, v, kv_mask=mask)
    return _qd(out.reshape(B, N, C), p.proj)


def _adaptor(p, x):
    """mlp{N}x_gelu / linear condition adaptor on quantized leaves."""
    for i in range(p.depth):
        if i > 0:
            x = NN.gelu_tanh(x)
        x = _qd(x, getattr(p, f"fc{i}"))
    return x


def compute_cond_kv_quant(mp: nn.Module, cfg: RDTModelConfig, lang_c, img_c,
                          kv_cache: str = "bf16") -> list:
    """Per-block cached K/V, once per chunk: a tuple ``(kind, ...)`` per
    block, ``kind`` one of :data:`KV_CACHES`.  The kv projections run the
    plain ``qdense`` (int8 kv leaf) or bf16 (:class:`ops.quant.BF16Linear`)."""
    if kv_cache not in KV_CACHES:
        raise ValueError(f"kv_cache {kv_cache!r} not in {KV_CACHES}")
    bf = torch.bfloat16
    lang_c = lang_c.to(bf) + mp.lang_cond_pos_embed[:, : lang_c.shape[1]].to(bf)
    img_c = img_c.to(bf) + mp.img_cond_pos_embed.to(bf)
    conds = (lang_c, img_c)
    hd = cfg.hidden_size // cfg.num_heads
    out = []
    for i, blk in enumerate(mp.blocks):
        ca = blk.cross_attn
        c = conds[i % 2]
        B, L, _ = c.shape
        kv = Q.qdense(c, ca.kv) if isinstance(ca.kv, Q.QLinear) else ca.kv(c)
        kv = kv.reshape(B, L, 2, cfg.num_heads, hd)
        k, v = ca.k_norm(kv[:, :, 0]), kv[:, :, 1]
        if kv_cache == "int8":
            out.append(("int8",) + FQ.quantize_kv(k, v))
        elif kv_cache == "int8t":
            out.append(("int8t",) + FQ.quantize_kv_t(k, v))
        elif kv_cache == "int8x":
            out.append(("int8x",) + FQ.quantize_kv(k, v))
        else:
            out.append(("bf16", k, v))
    return out


def forward_cached_quant(mp: nn.Module, cfg: RDTModelConfig, x, freq, t, cond_kv,
                         lang_mask=None):
    """Denoise-loop forward over the cached condition K/V, bf16."""
    bf = torch.bfloat16
    t_tok = _timestep_embed(mp.t_embedder, t)
    f_tok = _timestep_embed(mp.freq_embedder, freq)
    x = torch.cat([t_tok[:, None], f_tok[:, None], x.to(bf)], dim=1)
    x = x + mp.x_pos_embed.to(bf)
    masks = (lang_mask, None)
    for i, blk in enumerate(mp.blocks):
        x = x + _self_attn(blk.attn, blk.norm1(x), cfg.num_heads)
        x = x + _cross_attn_cached(blk.cross_attn, blk.norm2(x), cond_kv[i],
                                   masks[i % 2], cfg.num_heads)
        x = x + _mlp_tanh_gelu(blk.ffn, blk.norm3(x))
    out = _mlp_tanh_gelu(mp.final_ffn, mp.final_norm(x))
    return out[:, -cfg.horizon:]


@torch.inference_mode()
def rdt_predict_action_quant(cfg: R.RDTRunnerConfig, runner: QuantRDTRunner,
                             lang_tokens, lang_mask, img_tokens, state_tokens,
                             action_mask, ctrl_freqs,
                             num_inference_timesteps: Optional[int] = None,
                             kv_cache: str = "bf16", prior_chunk=None,
                             skip_steps: int = 0, init_noise=None,
                             generator: Optional[torch.Generator] = None):
    """Quantized twin of :func:`runner.rdt_predict_action`, same contract:
    (B, horizon, 128) float32; ``prior_chunk`` with ``skip_steps`` > 0
    re-noises the previous chunk to step ``skip_steps``'s level and runs
    the solver's tail."""
    m = cfg.model
    steps = num_inference_timesteps or cfg.noise.num_inference_timesteps
    schedule = sched_lib.DiffusionSchedule.create(cfg.noise.num_train_timesteps,
                                                  cfg.noise.beta_schedule)
    B = state_tokens.shape[0]
    mask_h = action_mask.float().expand(B, m.horizon, m.output_dim)
    noise = R.start_noise(m, B, state_tokens.device, init_noise, generator)
    x_init = R.solver_start(cfg, steps, noise, mask_h, prior_chunk, skip_steps)
    state_in = torch.cat([state_tokens, action_mask.to(state_tokens.dtype)], dim=2)
    lang_c = _adaptor(runner.lang_adaptor, lang_tokens)
    img_c = _adaptor(runner.img_adaptor, img_tokens)
    state_traj = _adaptor(runner.state_adaptor, state_in)
    mp = runner.model
    cond_kv = compute_cond_kv_quant(mp, m, lang_c, img_c, kv_cache=kv_cache)

    def model_fn(noisy_action, t):
        action_in = torch.cat([noisy_action, mask_h], dim=2)
        action_traj = _adaptor(runner.state_adaptor, action_in.to(torch.bfloat16))
        x = torch.cat([state_traj, action_traj], dim=1)
        return forward_cached_quant(mp, m, x, ctrl_freqs, t, cond_kv, lang_mask).float()

    action = sched_lib.sample_dpm_solver(model_fn, x_init, schedule, steps,
                                         prediction_type=cfg.noise.prediction_type,
                                         start_index=skip_steps)
    return action * mask_h
