"""HF / torch checkpoint -> flax-layout parameter trees (counterpart of
``vla_touch_tpu/utils/torch_port.py``).

Each converter takes a state dict of numpy arrays and returns the numpy
tree, in the flax layout, that the JAX function returns; the port loads
such a tree into its modules through :mod:`utils.from_flax`, so it has no
second naming scheme.  The converters only re-lay arrays out: a transpose
is a view, so a tree built from a memory-mapped checkpoint holds no copy of
its linears (only a ``ConvTranspose`` kernel, which is flipped, is copied).

Checkpoint files are read and written through :mod:`utils.safetensors_io`
(no ``safetensors`` package) or, for ``.bin`` / ``.pt``, ``torch.load``.
"""

from __future__ import annotations

import numpy as np
import torch


def linear(weight: np.ndarray, bias: np.ndarray | None = None) -> dict:
    """torch ``nn.Linear`` (out, in) -> flax ``Dense`` {kernel (in, out), bias}."""
    out = {"kernel": np.asarray(weight).T}
    if bias is not None:
        out["bias"] = np.asarray(bias)
    return out


def rmsnorm(weight: np.ndarray) -> dict:
    return {"weight": np.asarray(weight)}


def layernorm(weight: np.ndarray, bias: np.ndarray) -> dict:
    return {"scale": np.asarray(weight), "bias": np.asarray(bias)}


def groupnorm(weight: np.ndarray, bias: np.ndarray) -> dict:
    return {"weight": np.asarray(weight), "bias": np.asarray(bias)}


def conv1d(weight: np.ndarray, bias: np.ndarray | None = None) -> dict:
    """torch ``nn.Conv1d`` weight (out, in, k) -> flax ``Conv`` kernel (k, in, out)."""
    out = {"kernel": np.asarray(weight).transpose(2, 1, 0)}
    if bias is not None:
        out["bias"] = np.asarray(bias)
    return out


def conv_transpose1d(weight: np.ndarray, bias: np.ndarray | None = None) -> dict:
    """torch ``nn.ConvTranspose1d`` weight (in, out, k) -> flax ``ConvTranspose``
    kernel (k, in, out), spatially flipped (torch's transposed conv scatters
    with the unflipped kernel; flax's conv_transpose correlates)."""
    w = weight[:, :, ::-1]  # flip k
    out = {"kernel": np.ascontiguousarray(w.transpose(2, 0, 1))}
    if bias is not None:
        out["bias"] = np.asarray(bias)
    return out


def lstm(state_dict: dict, num_layers: int, prefix: str = "") -> dict:
    """torch ``nn.LSTM`` state-dict -> :class:`StackedLSTM` params.

    Torch packs gates as (i, f, g, o) rows of ``weight_ih_l{n}`` (4H, in) and
    ``weight_hh_l{n}`` (4H, H) with two bias vectors; our cell uses two Dense
    layers ``ih``/``hh`` with the same gate order, so this is a transpose.
    """
    params = {}
    for n in range(num_layers):
        w_ih = np.asarray(state_dict[f"{prefix}weight_ih_l{n}"])
        w_hh = np.asarray(state_dict[f"{prefix}weight_hh_l{n}"])
        b_ih = np.asarray(state_dict[f"{prefix}bias_ih_l{n}"])
        b_hh = np.asarray(state_dict[f"{prefix}bias_hh_l{n}"])
        params[f"layer{n}"] = {
            "ih": {"kernel": w_ih.T, "bias": b_ih},
            # torch adds both biases; fold b_hh into the hh Dense.
            "hh": {"kernel": w_hh.T, "bias": b_hh},
        }
    return params


def timm_attention(sd: dict, prefix: str = "") -> dict:
    """timm ``Attention`` (fused qkv + qk RmsNorm + proj) -> SelfAttention."""
    return {
        "qkv": linear(sd[f"{prefix}qkv.weight"], sd.get(f"{prefix}qkv.bias")),
        "q_norm": rmsnorm(sd[f"{prefix}q_norm.weight"]),
        "k_norm": rmsnorm(sd[f"{prefix}k_norm.weight"]),
        "proj": linear(sd[f"{prefix}proj.weight"], sd.get(f"{prefix}proj.bias")),
    }


def cross_attention(sd: dict, prefix: str = "") -> dict:
    """Reference ``CrossAttention`` (blocks.py:72-101) -> CrossAttention."""
    return {
        "q": linear(sd[f"{prefix}q.weight"], sd.get(f"{prefix}q.bias")),
        "kv": linear(sd[f"{prefix}kv.weight"], sd.get(f"{prefix}kv.bias")),
        "q_norm": rmsnorm(sd[f"{prefix}q_norm.weight"]),
        "k_norm": rmsnorm(sd[f"{prefix}k_norm.weight"]),
        "proj": linear(sd[f"{prefix}proj.weight"], sd.get(f"{prefix}proj.bias")),
    }


def rdt_block(sd: dict, prefix: str) -> dict:
    """Reference ``RDTBlock`` (blocks.py:144-183) -> our RDTBlock params."""
    return {
        "norm1": rmsnorm(sd[f"{prefix}norm1.weight"]),
        "attn": timm_attention(sd, f"{prefix}attn."),
        "norm2": rmsnorm(sd[f"{prefix}norm2.weight"]),
        "cross_attn": cross_attention(sd, f"{prefix}cross_attn."),
        "norm3": rmsnorm(sd[f"{prefix}norm3.weight"]),
        "ffn": mlp(sd, f"{prefix}ffn."),
    }


def timestep_embedder(sd: dict, prefix: str) -> dict:
    """Reference ``TimestepEmbedder`` (mlp.0 / mlp.2) -> fc1/fc2."""
    return {
        "fc1": linear(sd[f"{prefix}mlp.0.weight"], sd[f"{prefix}mlp.0.bias"]),
        "fc2": linear(sd[f"{prefix}mlp.2.weight"], sd[f"{prefix}mlp.2.bias"]),
    }


def condition_adapter(sd: dict, prefix: str, depth: int) -> dict:
    """``linear``/``mlp{N}x_gelu`` Sequential -> ConditionAdapter fc{i}.

    Torch layout: Linear at Sequential indices 0, 2, 4, ... (GELUs between).
    A bare ``linear`` adaptor has no ``.N.`` index in its keys.
    """
    if f"{prefix}weight" in sd:  # bare nn.Linear
        return {"fc0": linear(sd[f"{prefix}weight"], sd[f"{prefix}bias"])}
    out = {}
    for i in range(depth):
        out[f"fc{i}"] = linear(sd[f"{prefix}{2 * i}.weight"],
                               sd[f"{prefix}{2 * i}.bias"])
    return out


def rdt_model(sd: dict, depth: int, prefix: str = "") -> dict:
    """Full reference ``RDT`` state dict -> our RDT params
    (``model.py:22-124``)."""
    p = {
        "t_embedder": timestep_embedder(sd, f"{prefix}t_embedder."),
        "freq_embedder": timestep_embedder(sd, f"{prefix}freq_embedder."),
        "x_pos_embed": np.asarray(sd[f"{prefix}x_pos_embed"]),
        "lang_cond_pos_embed": np.asarray(sd[f"{prefix}lang_cond_pos_embed"]),
        "img_cond_pos_embed": np.asarray(sd[f"{prefix}img_cond_pos_embed"]),
        "final_norm": rmsnorm(sd[f"{prefix}final_layer.norm_final.weight"]),
        "final_ffn": mlp(sd, f"{prefix}final_layer.ffn_final."),
    }
    for i in range(depth):
        p[f"block{i}"] = rdt_block(sd, f"{prefix}blocks.{i}.")
    return p


def _conv_block(sd: dict, prefix: str) -> dict:
    """Reference ``Conv1dBlock`` (Sequential: conv, GroupNorm, Mish)."""
    return {
        "conv": {"conv": conv1d(sd[f"{prefix}.block.0.weight"],
                                sd[f"{prefix}.block.0.bias"])},
        "gn": groupnorm(sd[f"{prefix}.block.1.weight"],
                        sd[f"{prefix}.block.1.bias"]),
    }


def _cond_res_block(sd: dict, prefix: str) -> dict:
    """Reference ``ConditionalResidualBlock1D`` -> our block params."""
    out = {
        "block0": _conv_block(sd, f"{prefix}.blocks.0"),
        "block1": _conv_block(sd, f"{prefix}.blocks.1"),
        "cond_encoder": linear(sd[f"{prefix}.cond_encoder.1.weight"],
                               sd[f"{prefix}.cond_encoder.1.bias"]),
    }
    if f"{prefix}.residual_conv.weight" in sd:
        out["residual_conv"] = {
            "conv": conv1d(sd[f"{prefix}.residual_conv.weight"],
                           sd[f"{prefix}.residual_conv.bias"])
        }
    return out


def unet1d(sd: dict, num_levels: int, prefix: str = "",
           use_timestep: bool = True) -> dict:
    """Reference ``DiffusionConditionalUnet1D`` state dict -> ConditionalUnet1D
    params (``conditional_unet_1D.py:108-247``)."""
    p: dict = {}
    if use_timestep:
        p["step_fc1"] = linear(sd[f"{prefix}diffusion_step_encoder.1.weight"],
                               sd[f"{prefix}diffusion_step_encoder.1.bias"])
        p["step_fc2"] = linear(sd[f"{prefix}diffusion_step_encoder.3.weight"],
                               sd[f"{prefix}diffusion_step_encoder.3.bias"])
    for i in range(num_levels):
        p[f"down{i}_res0"] = _cond_res_block(sd, f"{prefix}down_modules.{i}.0")
        p[f"down{i}_res1"] = _cond_res_block(sd, f"{prefix}down_modules.{i}.1")
        if f"{prefix}down_modules.{i}.2.conv.weight" in sd:
            p[f"down{i}_down"] = {
                "conv": conv1d(sd[f"{prefix}down_modules.{i}.2.conv.weight"],
                               sd[f"{prefix}down_modules.{i}.2.conv.bias"])
            }
    p["mid0"] = _cond_res_block(sd, f"{prefix}mid_modules.0")
    p["mid1"] = _cond_res_block(sd, f"{prefix}mid_modules.1")
    for i in range(num_levels - 1):
        p[f"up{i}_res0"] = _cond_res_block(sd, f"{prefix}up_modules.{i}.0")
        p[f"up{i}_res1"] = _cond_res_block(sd, f"{prefix}up_modules.{i}.1")
        if f"{prefix}up_modules.{i}.2.conv.weight" in sd:
            p[f"up{i}_up"] = {
                "conv": conv_transpose1d(sd[f"{prefix}up_modules.{i}.2.conv.weight"],
                                         sd[f"{prefix}up_modules.{i}.2.conv.bias"])
            }
    p["final_block"] = _conv_block(sd, f"{prefix}final_conv.0")
    p["final_conv"] = {"conv": conv1d(sd[f"{prefix}final_conv.1.weight"],
                                      sd[f"{prefix}final_conv.1.bias"])}
    return p


def mlp(sd: dict, prefix: str = "") -> dict:
    """timm ``Mlp`` -> Mlp (fc1/fc2)."""
    return {
        "fc1": linear(sd[f"{prefix}fc1.weight"], sd.get(f"{prefix}fc1.bias")),
        "fc2": linear(sd[f"{prefix}fc2.weight"], sd.get(f"{prefix}fc2.bias")),
    }


def rdt_runner(sd: dict, depth: int, adaptor_depths=(2, 2, 3)) -> dict:
    """Full reference ``RDTRunner`` state dict (the HF ``rdt-1b`` checkpoint
    layout: ``model.*`` + ``lang_adaptor.*`` + ``img_adaptor.*`` +
    ``state_adaptor.*``, rdt_runner.py:27-60) -> RDTRunnerModule params.

    ``adaptor_depths``: (lang, img, state) MLP depths — (2, 2, 3) for the
    upstream mlp2x/mlp2x/mlp3x configuration.
    """
    return {
        "model": rdt_model(sd, depth=depth, prefix="model."),
        "lang_adaptor": condition_adapter(sd, "lang_adaptor.",
                                          adaptor_depths[0]),
        "img_adaptor": condition_adapter(sd, "img_adaptor.",
                                         adaptor_depths[1]),
        "state_adaptor": condition_adapter(sd, "state_adaptor.",
                                           adaptor_depths[2]),
    }


def _invert_linear(p: dict, prefix: str, out: dict) -> None:
    out[f"{prefix}weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        out[f"{prefix}bias"] = np.asarray(p["bias"])


def rdt_runner_to_torch(params: dict, adaptor_depths=(2, 2, 3)) -> dict:
    """Inverse of :func:`rdt_runner`: our params -> the reference HF
    checkpoint key layout (hub_mixin save-compat), so checkpoints trained
    here load into the reference stack and vice versa.  Weights are views
    of the tree's kernels."""
    sd: dict = {}
    model = params["model"]
    for name in ("x_pos_embed", "lang_cond_pos_embed", "img_cond_pos_embed"):
        sd[f"model.{name}"] = np.asarray(model[name])
    for te in ("t_embedder", "freq_embedder"):
        _invert_linear(model[te]["fc1"], f"model.{te}.mlp.0.", sd)
        _invert_linear(model[te]["fc2"], f"model.{te}.mlp.2.", sd)
    depth = len([k for k in model if k.startswith("block")])
    for i in range(depth):
        b = model[f"block{i}"]
        p = f"model.blocks.{i}."
        for n in ("norm1", "norm2", "norm3"):
            sd[f"{p}{n}.weight"] = np.asarray(b[n]["weight"])
        _invert_linear(b["attn"]["qkv"], f"{p}attn.qkv.", sd)
        sd[f"{p}attn.q_norm.weight"] = np.asarray(b["attn"]["q_norm"]["weight"])
        sd[f"{p}attn.k_norm.weight"] = np.asarray(b["attn"]["k_norm"]["weight"])
        _invert_linear(b["attn"]["proj"], f"{p}attn.proj.", sd)
        _invert_linear(b["cross_attn"]["q"], f"{p}cross_attn.q.", sd)
        _invert_linear(b["cross_attn"]["kv"], f"{p}cross_attn.kv.", sd)
        sd[f"{p}cross_attn.q_norm.weight"] = np.asarray(
            b["cross_attn"]["q_norm"]["weight"])
        sd[f"{p}cross_attn.k_norm.weight"] = np.asarray(
            b["cross_attn"]["k_norm"]["weight"])
        _invert_linear(b["cross_attn"]["proj"], f"{p}cross_attn.proj.", sd)
        _invert_linear(b["ffn"]["fc1"], f"{p}ffn.fc1.", sd)
        _invert_linear(b["ffn"]["fc2"], f"{p}ffn.fc2.", sd)
    sd["model.final_layer.norm_final.weight"] = np.asarray(
        model["final_norm"]["weight"])
    _invert_linear(model["final_ffn"]["fc1"],
                   "model.final_layer.ffn_final.fc1.", sd)
    _invert_linear(model["final_ffn"]["fc2"],
                   "model.final_layer.ffn_final.fc2.", sd)
    for name, d in zip(("lang_adaptor", "img_adaptor", "state_adaptor"),
                       adaptor_depths):
        for i in range(d):
            prefix = (f"{name}." if d == 1 else f"{name}.{2 * i}.")
            _invert_linear(params[name][f"fc{i}"], prefix, sd)
    return sd


def _adaptor_depths(params: dict) -> tuple:
    return tuple(len([k for k in params[name] if k.startswith("fc")])
                 for name in ("lang_adaptor", "img_adaptor", "state_adaptor"))


def save_rdt_checkpoint(path: str, params) -> str:
    """Write a safetensors checkpoint in the reference HF layout.
    ``params``: the runner's flax tree, or the port's ``RDTRunnerModule``
    (written in float32, as the HF ``rdt-1b`` file is).  The adaptors'
    depths are read off the tree."""
    from vla_touch_tpu_torch.utils import safetensors_io as st

    if not isinstance(params, dict):
        from vla_touch_tpu_torch.utils.from_flax import to_flax

        params = to_flax(params)
    st.save_file(rdt_runner_to_torch(params, _adaptor_depths(params)), path)
    return path


def read_state_dict(path: str) -> dict:
    """{key: numpy array} of a checkpoint file: a safetensors file as views
    of its memory map (``BF16`` leaves widened to float32, exactly, since
    numpy has no bfloat16), else a torch pickle (``.bin`` / ``.pt``) loaded
    on the CPU with ``weights_only``."""
    if path.endswith(".safetensors"):
        from vla_touch_tpu_torch.utils import safetensors_io as st

        raw = st.load_file(path)
    else:
        raw = torch.load(path, map_location="cpu", weights_only=True)
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() for k, v in raw.items()}


def load_rdt_checkpoint(path: str, depth: int = 28, adaptor_depths=(2, 2, 3)) -> dict:
    """Load an HF-format RDT checkpoint file (``pytorch_model.bin`` or
    ``model.safetensors``) and convert to the runner's flax tree
    (hub_mixin.py:16-76 load-compat: safetensors preferred, torch pickle
    fallback)."""
    return rdt_runner(read_state_dict(path), depth=depth, adaptor_depths=adaptor_depths)


def load_rdt_runner(path: str, cfg, device=None, dtype=None):
    """The port's ``RDTRunnerModule`` for ``cfg`` (an ``RDTRunnerConfig``)
    from an HF-format checkpoint file, on ``device`` (default CUDA) in
    ``dtype`` (default the model's compute dtype), frozen.  The module is
    built without allocating, then filled leaf by leaf from the file's
    memory map."""
    from vla_touch_tpu_torch.models.rdt.runner import RDTRunnerModule
    from vla_touch_tpu_torch.utils import from_flax as FF
    from vla_touch_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    with torch.device("meta"):
        module = RDTRunnerModule(cfg.model)
    depths = tuple(getattr(module, n).depth
                   for n in ("lang_adaptor", "img_adaptor", "state_adaptor"))
    tree = load_rdt_checkpoint(path, depth=cfg.model.depth, adaptor_depths=depths)
    module = module.to_empty(device=dev).to(dtype or cfg.model.compute_dtype)
    FF.load_into(module, FF.rdt_runner(tree))
    return module.eval().requires_grad_(False)


def conv2d(weight: np.ndarray, bias: np.ndarray | None = None) -> dict:
    """torch ``nn.Conv2d`` weight (out, in, kh, kw) -> flax ``Conv`` kernel
    (kh, kw, in, out)."""
    out = {"kernel": np.asarray(weight).transpose(2, 3, 1, 0)}
    if bias is not None:
        out["bias"] = np.asarray(bias)
    return out


def dinov2_from_hf(sd: dict, num_layers: int) -> dict:
    """HF ``Dinov2Model`` state dict -> :class:`DinoV2Encoder` params."""
    vit: dict = {
        "patch_embed": conv2d(
            sd["embeddings.patch_embeddings.projection.weight"],
            sd["embeddings.patch_embeddings.projection.bias"]),
        "pos_embed": np.asarray(sd["embeddings.position_embeddings"]),
        "cls_token": np.asarray(sd["embeddings.cls_token"]),
        "final_norm": layernorm(sd["layernorm.weight"], sd["layernorm.bias"]),
    }
    for i in range(num_layers):
        p = f"encoder.layer.{i}."
        vit[f"block{i}"] = {
            "norm1": layernorm(sd[f"{p}norm1.weight"], sd[f"{p}norm1.bias"]),
            "attention": {
                "query": linear(sd[f"{p}attention.attention.query.weight"],
                                sd[f"{p}attention.attention.query.bias"]),
                "key": linear(sd[f"{p}attention.attention.key.weight"],
                              sd[f"{p}attention.attention.key.bias"]),
                "value": linear(sd[f"{p}attention.attention.value.weight"],
                                sd[f"{p}attention.attention.value.bias"]),
                "output": linear(sd[f"{p}attention.output.dense.weight"],
                                 sd[f"{p}attention.output.dense.bias"]),
            },
            "layerscale1": np.asarray(sd[f"{p}layer_scale1.lambda1"]),
            "norm2": layernorm(sd[f"{p}norm2.weight"], sd[f"{p}norm2.bias"]),
            "fc1": linear(sd[f"{p}mlp.fc1.weight"], sd[f"{p}mlp.fc1.bias"]),
            "fc2": linear(sd[f"{p}mlp.fc2.weight"], sd[f"{p}mlp.fc2.bias"]),
            "layerscale2": np.asarray(sd[f"{p}layer_scale2.lambda1"]),
        }
    return {"vit": vit}


def clip_vision_from_hf(sd: dict, num_layers: int,
                        prefix: str = "vision_model.") -> dict:
    """HF ``CLIPVisionModel`` state dict -> :class:`CLIPVisionPooled` params
    (the Octopi tactile tower, ``openai/clip-vit-base-patch16``).

    Same block mapping as SigLIP (both are HF CLIP-style encoders) plus the
    CLS token, CLIP's pre-layernorm (HF's historically misspelled
    ``pre_layrnorm``), and the bias-free patch conv."""
    vit: dict = {
        "patch_embed": conv2d(sd[f"{prefix}embeddings.patch_embedding.weight"]),
        "cls_token": np.asarray(
            sd[f"{prefix}embeddings.class_embedding"])[None, None],
        "pos_embed": np.asarray(
            sd[f"{prefix}embeddings.position_embedding.weight"])[None],
        "pre_norm": layernorm(sd[f"{prefix}pre_layrnorm.weight"],
                              sd[f"{prefix}pre_layrnorm.bias"]),
        "final_norm": layernorm(sd[f"{prefix}post_layernorm.weight"],
                                sd[f"{prefix}post_layernorm.bias"]),
    }
    for i in range(num_layers):
        p = f"{prefix}encoder.layers.{i}."
        vit[f"block{i}"] = {
            "norm1": layernorm(sd[f"{p}layer_norm1.weight"],
                               sd[f"{p}layer_norm1.bias"]),
            "attention": {
                "query": linear(sd[f"{p}self_attn.q_proj.weight"],
                                sd[f"{p}self_attn.q_proj.bias"]),
                "key": linear(sd[f"{p}self_attn.k_proj.weight"],
                              sd[f"{p}self_attn.k_proj.bias"]),
                "value": linear(sd[f"{p}self_attn.v_proj.weight"],
                                sd[f"{p}self_attn.v_proj.bias"]),
                "output": linear(sd[f"{p}self_attn.out_proj.weight"],
                                 sd[f"{p}self_attn.out_proj.bias"]),
            },
            "norm2": layernorm(sd[f"{p}layer_norm2.weight"],
                               sd[f"{p}layer_norm2.bias"]),
            "fc1": linear(sd[f"{p}mlp.fc1.weight"], sd[f"{p}mlp.fc1.bias"]),
            "fc2": linear(sd[f"{p}mlp.fc2.weight"], sd[f"{p}mlp.fc2.bias"]),
        }
    return {"vit": vit}


def siglip_from_hf(sd: dict, num_layers: int, prefix: str = "vision_model.") -> dict:
    """HF ``SiglipVisionModel`` state dict -> :class:`SiglipVisionEncoder`
    params (attention-pool head skipped; the tower uses patch tokens)."""
    vit: dict = {
        "patch_embed": conv2d(sd[f"{prefix}embeddings.patch_embedding.weight"],
                              sd[f"{prefix}embeddings.patch_embedding.bias"]),
        "pos_embed": np.asarray(
            sd[f"{prefix}embeddings.position_embedding.weight"])[None],
        "final_norm": layernorm(sd[f"{prefix}post_layernorm.weight"],
                                sd[f"{prefix}post_layernorm.bias"]),
    }
    for i in range(num_layers):
        p = f"{prefix}encoder.layers.{i}."
        vit[f"block{i}"] = {
            "norm1": layernorm(sd[f"{p}layer_norm1.weight"],
                               sd[f"{p}layer_norm1.bias"]),
            "attention": {
                "query": linear(sd[f"{p}self_attn.q_proj.weight"],
                                sd[f"{p}self_attn.q_proj.bias"]),
                "key": linear(sd[f"{p}self_attn.k_proj.weight"],
                              sd[f"{p}self_attn.k_proj.bias"]),
                "value": linear(sd[f"{p}self_attn.v_proj.weight"],
                                sd[f"{p}self_attn.v_proj.bias"]),
                "output": linear(sd[f"{p}self_attn.out_proj.weight"],
                                 sd[f"{p}self_attn.out_proj.bias"]),
            },
            "norm2": layernorm(sd[f"{p}layer_norm2.weight"],
                               sd[f"{p}layer_norm2.bias"]),
            "fc1": linear(sd[f"{p}mlp.fc1.weight"], sd[f"{p}mlp.fc1.bias"]),
            "fc2": linear(sd[f"{p}mlp.fc2.weight"], sd[f"{p}mlp.fc2.bias"]),
        }
    return {"vit": vit}
