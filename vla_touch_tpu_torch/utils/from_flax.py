"""Flax parameter trees (as numpy arrays) -> the port's state dicts.

The port's modules reuse the flax names, so a tree converts by flattening
its path (the RDT and ViT ``block{i}`` become ``blocks.{i}``) plus one
layout rule per leaf kind:

- ``Dense`` kernel (in, out)            -> ``weight`` (out, in);
- ``Conv`` kernel (k, Cin, F)            -> Conv1d ``weight`` (F, Cin, k), and the
  flax wrapper's inner ``conv`` level disappears;
- ``ConvTranspose`` kernel (k, Cin, F)   -> ConvTranspose1d ``weight`` (Cin, F, k),
  spatially FLIPPED: flax correlates the dilated input with its kernel as
  stored, torch's transposed conv scatters with it;
- patch ``Conv`` kernel HWIO (p, p, C, D) -> Linear ``weight`` (D, p*p*C) over
  the (ky, kx, c)-ordered patch;
- LayerNorm ``scale`` -> ``weight``; every other leaf as is.

Everything runs on numpy, so a tree can come from a checkpoint file as well
as from the JAX package.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def to_state_dict(tree: dict, lists: tuple = ()) -> dict:
    """Generic flax tree -> {torch name: numpy array}.  ``lists`` names the
    flax module prefixes that the port holds in an ``nn.ModuleList``
    (``("block",)``: ``block3`` -> ``blocks.3``)."""
    out = {}
    for path, arr in _flatten(tree):
        *mods, leaf = path
        for name in lists:
            mods = [re.sub(rf"^{name}(\d+)$", rf"{name}s.\1", m) for m in mods]
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 3:
                if mods and mods[-1] == "conv":
                    mods = mods[:-1]
                if mods and mods[-1].endswith("_up"):
                    arr = arr[::-1].transpose(1, 2, 0)
                else:
                    arr = arr.transpose(2, 1, 0)
            elif arr.ndim == 4:
                arr = arr.reshape(-1, arr.shape[-1]).T
            leaf = "weight"
        elif leaf == "bias" and mods and mods[-1] == "conv":
            mods = mods[:-1]
        elif leaf == "scale":
            leaf = "weight"
        # (ascontiguousarray makes a 0-d leaf 1-d: a logit scale keeps its ())
        out[".".join(mods + [leaf])] = np.ascontiguousarray(arr).reshape(arr.shape)
    return out


def load_into(module: torch.nn.Module, state: dict) -> torch.nn.Module:
    """Copy a converted state dict into ``module`` (strict: every parameter
    must be present and no extra key may remain), leaf by leaf, each moved
    to its parameter's device and cast there to its dtype."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing[:8]}, "
                       f"unexpected {extra[:8]}")
    with torch.no_grad():
        for name, t in own.items():
            a = np.asarray(state[name], np.float32)     # a memory map stays one
            src = torch.from_numpy(a if a.flags.writeable else a.copy())
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(t.shape)}")
            t.copy_(src.to(t.device).to(t.dtype))
    return module


def rdt_runner(params: dict) -> dict:
    """RDT runner tree (``model`` + three adaptors)."""
    return to_state_dict(params, lists=("block",))


def vit(params: dict) -> dict:
    """DinoV2 / SigLIP encoder tree (``vit`` subtree inside)."""
    return to_state_dict(params, lists=("block",))


def unet1d(params: dict) -> dict:
    """One ``ConditionalUnet1D`` tree."""
    return to_state_dict(params)


def bridge_controller(params: dict, ema_shadow: dict) -> dict:
    """Deployable BRIDGeR state: the observation encoder from ``params``
    and the b/v/s UNets from the EMA shadow (``{"b_net", "v_net",
    "s_net"}``).  The auxiliary force decoder (training only) is dropped."""
    enc = {k: v for k, v in params.items() if k.startswith("se_fc")}
    return to_state_dict({**enc, "si": ema_shadow})


def _expect_keys(what: str, tree: dict, allowed: set, required: set) -> None:
    """Key-coverage check of a whole tree's top level: every key known,
    every required key present."""
    extra, missing = sorted(set(tree) - allowed), sorted(required - set(tree))
    if extra or missing:
        raise KeyError(f"{what}: unexpected {extra[:8]}, missing {missing[:8]}")


def unet_bundle(si: dict) -> dict:
    """The ``si`` tree (``{"b_net", "v_net", "s_net"}``, live or EMA) ->
    state dict names relative to the port's ``SITripleUnet``."""
    _expect_keys("si", si, {"b_net", "v_net", "s_net"}, {"b_net", "v_net", "s_net"})
    return to_state_dict(si)


def bridge_controller_full(params: dict) -> dict:
    """The whole BRIDGeR parameter tree, the force decoder ``fd_fc*``
    included (training; ``BridgeControllerModule(cfg, force_decoder=True)``)."""
    enc = {f"se_fc{i}" for i in (1, 2, 3)}
    dec = {f"fd_fc{i}" for i in (1, 2, 3)}
    _expect_keys("bridge controller", params, enc | dec | {"si"}, enc | {"si"})
    if dec & set(params) and not dec <= set(params):
        raise KeyError(f"bridge controller: partial force decoder {sorted(dec & set(params))}")
    unet_bundle(params["si"])
    return to_state_dict(params)


def lstm_controller(params: dict) -> dict:
    """The LSTM residual controller tree (``models/controllers/lstm.py``)."""
    names = {"force_fc1", "force_fc2", "obs_fc1", "obs_fc2", "obs_fc3", "lstm",
             "head_fc1", "head_norm", "head_fc2"}
    _expect_keys("lstm controller", params, names, names)
    return to_state_dict(params)


def dinov2_runtime(params: dict) -> dict:
    """The controllers' DinoV2 tree (``{"vit": ...}``, as
    ``dinov2_runtime.init_params`` makes it)."""
    _expect_keys("dinov2", params, {"vit"}, {"vit"})
    return to_state_dict(params, lists=("block",))


def t5_encoder(params: dict) -> dict:
    """JAX's T5 encoder tree (plain arrays: ``embed``, ``rel_bias``,
    ``final_norm`` and a ``layers`` list whose ``q``, ``k``, ``v``, ``o``,
    ``wi_*``, ``wo`` are (in, out)) -> ``models/encoders/t5_native.py::
    T5Encoder``'s state."""
    names = {"embed", "rel_bias", "layers", "final_norm"}
    _expect_keys("t5 encoder", params, names, names)
    out = {k: np.asarray(params[k]) for k in ("embed", "rel_bias", "final_norm")}
    for i, layer in enumerate(params["layers"]):
        for name, arr in layer.items():
            arr = np.asarray(arr)
            key = f"layers.{i}.{name}"
            if name.startswith("norm"):
                out[key] = arr
            else:
                out[f"{key}.weight"] = np.ascontiguousarray(arr.T)
    return out


def to_flax(module: torch.nn.Module, state: dict = None) -> dict:
    """The inverse of :func:`to_state_dict`: a port module -> the flax tree
    of numpy float32 arrays the JAX package's module holds.  Leaves come
    from ``state`` (name -> tensor, the module's names) when given, else
    from the module.  Linear -> Dense ``kernel`` (in, out) (a ViT's patch
    Linear -> the HWIO patch Conv kernel); Conv1d / ConvTranspose1d -> the
    inner ``conv`` level's (k, Cin, F) kernel (the latter flipped back);
    norms' ``weight`` -> ``scale``; ``blocks.{i}`` -> ``block{i}``."""
    from vla_touch_tpu_torch.ops import nn as N

    def leaf(name, t, transpose=False):
        t = (state[name] if state is not None else t).detach().float()
        # a kernel is transposed where it lies (on the card: no strided host copy)
        return (t.T.contiguous() if transpose else t).cpu().numpy()

    tree: dict = {}

    def put(path, key, arr):
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[key] = np.ascontiguousarray(arr).reshape(arr.shape)

    for mname, m in module.named_modules():
        own = dict(m.named_parameters(recurse=False))
        if not own:
            continue
        path = re.sub(r"(^|\.)blocks\.(\d+)", r"\1block\2", mname).split(".") if mname else []
        full = {k: (f"{mname}.{k}" if mname else k) for k in own}
        if isinstance(m, torch.nn.Linear):
            w = leaf(full["weight"], m.weight, transpose=True)
            if path and path[-1] == "patch_embed":
                p = int(round((w.shape[0] // 3) ** 0.5))
                put(path, "kernel", w.reshape(p, p, w.shape[0] // (p * p), w.shape[1]))
            else:
                put(path, "kernel", w)
            if m.bias is not None:
                put(path, "bias", leaf(full["bias"], m.bias))
        elif isinstance(m, (N.Conv1d, N.ConvTranspose1d)):
            w = leaf(full["weight"], m.weight)
            w = (w.transpose(2, 1, 0) if isinstance(m, N.Conv1d)
                 else w.transpose(2, 0, 1)[::-1])
            put(path + ["conv"], "kernel", w)
            put(path + ["conv"], "bias", leaf(full["bias"], m.bias))
        elif isinstance(m, (torch.nn.LayerNorm, N.LayerNorm)):
            put(path, "scale", leaf(full["weight"], m.weight))
            put(path, "bias", leaf(full["bias"], m.bias))
        else:
            for k, t in own.items():
                put(path, k, leaf(full[k], t))
    return tree


def _port_path(path) -> list:
    out = []
    for p in path:
        m = re.match(r"^block(\d+)$", p)
        out += ["blocks", m.group(1)] if m else [p]
    return out


def quant_rdt_runner(qparams: dict, cfg, device=None):
    """A JAX quantized runner tree (``quant_serve.quantize_rdt_params``:
    ``w_i8``/``scale`` and ``w4_pack``/``scale4`` leaves, bf16 ``kv``
    kernels, float embedders, norms and positional tables) -> the port's
    ``QuantRDTRunner`` for ``cfg`` (an ``RDTModelConfig``), on ``device``
    (``None`` means CUDA, as for every entry point of the port).

    Integer codes and scales are taken as they are, only re-laid out for
    the kernels: ``w_i8`` (K, N) -> (N, K), ``w4_pack`` (K/2, N) -> (N, K/2)
    (the plane packing is kept: byte j of row n holds rows j and K/2 + j);
    ``scale4`` stays (G, N)."""
    from vla_touch_tpu_torch.models.rdt.quant_serve import QuantRDTRunner
    from vla_touch_tpu_torch.models.rdt.runner import RDTRunnerModule
    from vla_touch_tpu_torch.ops.quant import BF16Linear, QLinear, QLinearW4
    from vla_touch_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    with torch.device("meta"):
        module = RDTRunnerModule(cfg)
    module = module.to_empty(device=device)

    def f32(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    def leaf(node, path):
        bias = f32(node["bias"]) if "bias" in node else None
        if "w_i8" in node:
            w = torch.from_numpy(np.ascontiguousarray(np.asarray(node["w_i8"]).T))
            return QLinear(w.to(device), f32(node["scale"]), bias)
        if "w4_pack" in node:
            w = torch.from_numpy(np.ascontiguousarray(np.asarray(node["w4_pack"]).T))
            return QLinearW4(w.to(device), f32(node["scale4"]), bias)
        if path[-2:] == ("cross_attn", "kv"):
            return BF16Linear(f32(np.asarray(node["kernel"], np.float32).T).to(torch.bfloat16)
                              .contiguous(), bias)
        return None

    def rec(node, path):
        """Install the quantized leaves; return the rest of the tree."""
        rest = {}
        for k, v in node.items():
            if not isinstance(v, dict):
                rest[k] = v
                continue
            q = leaf(v, path + (k,))
            if q is None:
                sub = rec(v, path + (k,))
                if sub:
                    rest[k] = sub
                continue
            *parent, name = _port_path(path + (k,))
            setattr(module.get_submodule(".".join(parent)), name, q)
        return rest

    state = to_state_dict(rec(qparams, ()), lists=("block",))
    own = dict(module.named_parameters())
    if set(own) != set(state):
        raise KeyError(f"quantized tree mismatch: missing {sorted(set(own) - set(state))[:8]},"
                       f" unexpected {sorted(set(state) - set(own))[:8]}")
    with torch.no_grad():
        for name, p in own.items():
            src = f32(state[name])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(src.shape)} != {tuple(p.shape)}")
            p.copy_(src)
    return QuantRDTRunner(cfg, module.model, module.lang_adaptor, module.img_adaptor,
                          module.state_adaptor).eval().requires_grad_(False)


def vit_serve(tree: dict, cfg, pooled: bool = False, device=None):
    """A JAX ViT serving tree (``vit_serve.quantize_vit_params``: fused
    ``qkv`` leaves, int8 ``w_i8``/``scale`` or bf16 ``kernel`` block
    linears, float32 patch embedding, positional table and norms; with or
    without the ``serve_bf16`` marker) -> the port's ``ViTServe`` for
    ``cfg`` (a ``ViTConfig``) on ``device`` (default CUDA).  ``pooled``: the
    twin returns the CLS token (DinoV2).  Codes and scales are taken as
    they are: ``w_i8`` (K, N) -> (N, K); a bf16 ``kernel`` (K, N) -> bf16
    (N, K)."""
    from vla_touch_tpu_torch.models.encoders import vit_serve as VS
    from vla_touch_tpu_torch.ops.quant import BF16Linear, QLinear
    from vla_touch_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    vp = tree.get("vit", tree)

    def f32(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    def lin(node):
        bias = f32(node["bias"]) if "bias" in node else None
        if "w_i8" in node:
            w = np.ascontiguousarray(np.asarray(node["w_i8"]).T)
            return QLinear(torch.from_numpy(w).to(device), f32(node["scale"]), bias)
        w = f32(np.asarray(node["kernel"], np.float32).T).to(torch.bfloat16).contiguous()
        return BF16Linear(w, bias)

    def norm(node):
        ln = torch.nn.LayerNorm(cfg.hidden_size, eps=cfg.layernorm_eps, device=device)
        with torch.no_grad():
            ln.weight.copy_(f32(node["scale"]))
            ln.bias.copy_(f32(node["bias"]))
        return ln

    blocks = []
    for i in range(cfg.num_layers):
        b = vp[f"block{i}"]
        ls = ((f32(b["layerscale1"]), f32(b["layerscale2"])) if cfg.use_layerscale
              else None)
        blocks.append(VS.ServeBlock(norm(b["norm1"]), lin(b["attention"]["qkv"]),
                                    lin(b["attention"]["output"]), norm(b["norm2"]),
                                    lin(b["fc1"]), lin(b["fc2"]), ls))
    pe = vp["patch_embed"]
    k = np.asarray(pe["kernel"], np.float32)
    return VS.ViTServe(
        cfg, f32(k.reshape(-1, k.shape[-1]).T), f32(pe["bias"]) if "bias" in pe else None,
        f32(vp["pos_embed"]), f32(vp["cls_token"]) if cfg.use_cls_token else None,
        norm(vp["pre_norm"]) if cfg.use_pre_norm else None, blocks,
        norm(vp["final_norm"]), pooled=pooled).eval().requires_grad_(False)


# ---- the planner -------------------------------------------------------------------


def _tensor(a, device):
    """A numpy (or ml_dtypes bfloat16) array as a tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def _llm_leaf(node: dict, device):
    """One projection leaf of a JAX LLM tree, popping what it uses: a float
    ``kernel`` (K, N) -> ``nn.Linear``; int8 ``w_i8`` (K, N) -> ``QLinear``
    (N, K); grouped-int4 ``w4_pack`` (K/2, N) -> ``QLinearW4`` (N, K/2)
    with ``scale4`` (G, N) as is (the plane packing is kept)."""
    from vla_touch_tpu_torch.ops.quant import QLinear, QLinearW4

    b = node.pop("bias", None)
    bias = None if b is None else _tensor(np.asarray(b, np.float32), device)
    if "w_i8" in node:
        w = np.ascontiguousarray(np.asarray(node.pop("w_i8")).T)
        return QLinear(torch.from_numpy(w).to(device), _tensor(node.pop("scale"), device), bias)
    if "w4_pack" in node:
        w = np.ascontiguousarray(np.asarray(node.pop("w4_pack")).T)
        return QLinearW4(torch.from_numpy(w).to(device),
                         _tensor(node.pop("scale4"), device).contiguous(), bias)
    # the kernel keeps its dtype and the bias stays float32, as in the tree
    w = _tensor(node.pop("kernel"), device)
    with torch.device("meta"):
        lin = torch.nn.Linear(w.shape[0], w.shape[1], bias=bias is not None)
    lin.weight = torch.nn.Parameter(w.t().contiguous(), requires_grad=False)
    if bias is not None:
        lin.bias = torch.nn.Parameter(bias, requires_grad=False)
    return lin


def _consumed(what: str, tree: dict) -> None:
    """Raise if a converter left any leaf of ``tree`` unread."""
    left = [".".join(map(str, p)) for p, _ in _flatten(tree)]
    if left:
        raise KeyError(f"{what}: leaves not converted: {left[:8]}")


def llm(params: dict, cfg, device=None):
    """A JAX LLM tree (``planning/llm.py``: float, ``quantize_llm_params``
    int8 / int4, or ``fuse_quantized_layers`` with ``qkv`` / ``gateup``)
    -> the port's ``LLM`` for ``cfg`` on ``device`` (default CUDA).  Every
    leaf must be consumed.  The names follow the JAX package's
    ``hf_key_map``: the port's ``layers.{i}.q.weight`` (out, in) is HF's
    ``model.layers.{i}.self_attn.q_proj.weight``, ``embed`` HF's
    ``model.embed_tokens.weight``."""
    from vla_touch_tpu_torch.planning import llm as L
    from vla_touch_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    tree = {k: (dict(v) if isinstance(v, dict) else v) for k, v in params.items()}
    layers = []
    for i, lp in enumerate(tree.pop("layers")):
        lp = {k: (dict(v) if isinstance(v, dict) else v) for k, v in lp.items()}
        parts = {n: torch.nn.Parameter(_tensor(np.asarray(lp.pop(n), np.float32), device),
                                       requires_grad=False)
                 for n in ("input_norm", "post_norm")}
        for name in list(lp):
            if not isinstance(lp[name], dict):
                raise KeyError(f"layers.{i}.{name}: not a projection leaf")
            parts[name] = _llm_leaf(lp[name], device)
            _consumed(f"layers.{i}.{name}", lp.pop(name))
        layers.append(L.DecoderLayer(**parts))
    embed = torch.nn.Parameter(_tensor(tree.pop("embed"), device), requires_grad=False)
    final_norm = torch.nn.Parameter(_tensor(np.asarray(tree.pop("final_norm"), np.float32),
                                            device), requires_grad=False)
    lm_head = None
    if "lm_head" in tree:
        head = tree.pop("lm_head")
        lm_head = _llm_leaf(head, device)
        _consumed("lm_head", head)
    _consumed("llm", tree)
    return L.LLM(cfg, embed, layers, final_norm, lm_head).eval()


def llm_lora(lora: dict, device=None) -> dict:
    """JAX LoRA factors ``{"layers": [{target: {"A", "B"}}], "scale"}`` ->
    the same structure of float32 tensors on ``device`` (default CUDA).
    ``layers`` may also be the ``{"0": ..., "1": ...}`` dict a msgpack file
    of the tree reads back as."""
    from vla_touch_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    layers = lora["layers"]
    if isinstance(layers, dict):
        layers = [layers[str(i)] for i in range(len(layers))]
    layers = [{t: {k: _tensor(np.asarray(ab[k], np.float32), device) for k in ("A", "B")}
               for t, ab in (lp or {}).items()} for lp in layers]
    return {"layers": layers, "scale": float(np.asarray(lora["scale"]))}


def llm_lora_to_flax(lora: dict) -> dict:
    """The inverse of :func:`llm_lora`: the port's factors -> the JAX
    package's tree of float32 numpy arrays (``scale`` a float)."""
    layers = [{t: {k: ab[k].detach().float().cpu().numpy() for k in ("A", "B")}
               for t, ab in (lp or {}).items()} for lp in lora["layers"]]
    return {"layers": layers, "scale": float(lora["scale"])}


def tactile_encoder(state, device=None, dtype=torch.float32):
    """A JAX ``TactileEncoderState`` (its ``cfg``, ``clip_params``,
    ``adapter_params`` per sensor and ``classifier_params``) -> the port's,
    the CLIP tower in ``dtype``, on ``device`` (default CUDA).  CLIP's patch
    conv (HWIO, no bias) becomes the tower's bias-free patch Linear."""
    import dataclasses

    from vla_touch_tpu_torch.models.encoders.vit import ViTConfig
    from vla_touch_tpu_torch.planning import encoder as PE
    from vla_touch_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = ViTConfig(**dataclasses.asdict(state.cfg))

    def build(factory, tree, dt):
        with torch.device("meta"):
            m = factory()
        m = m.to_empty(device=device).to(dt)
        return load_into(m, to_state_dict(tree, lists=("block",))).eval().requires_grad_(False)

    D = cfg.hidden_size
    clip = build(lambda: PE.ViFiCLIPVideo(cfg), state.clip_params, dtype)
    adapters = torch.nn.ModuleDict({
        s: build(lambda: PE.Adapter(D, D), p, torch.float32)
        for s, p in state.adapter_params.items()})
    classifier = build(lambda: PE.PropertyClassifier(D), state.classifier_params, torch.float32)
    return PE.TactileEncoderState(cfg=cfg, clip=clip, adapters=adapters, classifier=classifier,
                                  feature_dim=state.feature_dim)


def vificlip_model(params: dict, vision_cfg, text_cfg, device=None, **kw):
    """A JAX ``ViFiCLIPModel`` tree (``vision``, ``text`` and the two logit
    scales; plain or prompt-learned towers, ``kw`` as the model's:
    ``prompt_learning``, ``num_prompts``, the prompt depths, ``gate_prior``)
    -> the port's model, float32, on ``device`` (default CUDA).  The vision
    tower's patch conv becomes its bias-free patch Linear; :func:`to_flax`
    is the inverse."""
    from vla_touch_tpu_torch.planning import encoder as PE
    from vla_touch_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    with torch.device("meta"):
        m = PE.ViFiCLIPModel(vision_cfg, text_cfg, **kw)
    m = m.to_empty(device=device).float()
    return load_into(m, to_state_dict(params, lists=("block",))).eval().requires_grad_(False)


def qwen2vl_vision(params: dict, vcfg, device=None):
    """A JAX Qwen2-VL vision tree (``planning/qwen2vl.py``'s ``init_vision``
    or ``load_qwen2vl_from_hf``: ``patch_embed``, a list of ``blocks``,
    ``merger``) -> the port's ``VisionTower`` on ``device`` (default CUDA),
    each leaf in its own dtype (bf16 weights stay bf16)."""
    from vla_touch_tpu_torch.planning import qwen2vl as VL

    tree = dict(params, blocks={str(i): b for i, b in enumerate(params["blocks"])})
    state = {k: _torch(v) for k, v in to_state_dict(tree).items()}
    return VL.tower_from_state(vcfg, state, device=device)


def tactile_projector(params: dict, device=None):
    """A JAX ``TactileProjector`` tree (fc1, fc2) -> the port's, float32."""
    from vla_touch_tpu_torch.planning.llm_splice import TactileProjector
    from vla_touch_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    k1 = np.asarray(params["fc1"]["kernel"])
    with torch.device("meta"):
        m = TactileProjector(k1.shape[0], k1.shape[1])
    m = m.to_empty(device=device).float()
    return load_into(m, to_state_dict(params)).eval().requires_grad_(False)


# ---- the RDT training state ------------------------------------------------------


def flax_paths(module: torch.nn.Module) -> dict:
    """name -> (flax path, transposed) of each of ``module``'s parameters:
    where it sits in the JAX package's tree, and whether its layout there
    is the transpose (a Linear weight as a Dense kernel).  For modules of
    Linears, RmsNorms and bare parameters (the RDT runner)."""
    out = {}
    for mname, m in module.named_modules():
        path = tuple(re.sub(r"(^|\.)blocks\.(\d+)", r"\1block\2", mname).split(".")
                     if mname else ())
        for k in dict(m.named_parameters(recurse=False)):
            full = f"{mname}.{k}" if mname else k
            linear = isinstance(m, torch.nn.Linear) and k == "weight"
            out[full] = (path + ("kernel" if linear else k,), linear)
    return out


def _torch(a, copy: bool = True) -> torch.Tensor:
    """A numpy leaf (bfloat16 as ml_dtypes stores it) or tensor -> tensor
    (``copy`` False: a writable array's own memory, for a caller that
    copies it on)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a) if copy or not a.flags.writeable else a)


def nest(paths: dict, values: dict, transpose: bool = True) -> dict:
    """{name: tensor} -> the flax tree of :func:`flax_paths` (transposed
    leaves as their transpose unless ``transpose`` is False: the 8-bit
    moments' blocks)."""
    tree: dict = {}
    for name, v in values.items():
        path, t = paths[name]
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v.t() if t and transpose else v
    return tree


def unnest(paths: dict, tree: dict, device=None, transpose: bool = True) -> dict:
    """The inverse of :func:`nest`: {name: tensor on ``device``}.  Every
    name of ``paths`` must be in the tree."""
    out = {}
    for name, (path, t) in paths.items():
        node = tree
        for p in path:
            if p not in node:
                raise KeyError(f"{'/'.join(path)} missing from the tree")
            node = node[p]
        # to another device: one copy there, transposed where it lands
        away = device is not None and torch.device(device).type != "cpu"
        v = _torch(node, copy=not away)
        if device is not None:
            v = v.to(device)
        out[name] = (v.t() if t and transpose else v).contiguous()
    return out


def rdt_train_state_to_flax(state, optimizer) -> dict:
    """A ``train.rdt_train.TrainState`` -> the JAX package's checkpoint
    trees: ``params``, ``ema`` (the shadow), ``opt_state`` (optax's chain
    state) and ``meta`` (step, EMA update count)."""
    paths = flax_paths(state.module)
    return {"params": nest(paths, state.params),
            "ema": nest(paths, state.ema.shadow),
            "opt_state": optimizer.to_tree(
                state.opt_state, lambda d: nest(paths, d),
                lambda d: nest(paths, d, transpose=False)),
            "meta": {"step": int(state.step),
                     "ema_num_updates": int(state.ema.num_updates)}}


def _runs(positions) -> tuple:
    """Ascending positions as (start, stop) runs."""
    runs = []
    for i in positions.tolist():
        if runs and runs[-1][1] == i:
            runs[-1][1] = i + 1
        else:
            runs.append([i, i + 1])
    return tuple((a, b) for a, b in runs)


def _shard(shape: tuple, pieces: list, transposed: bool, local: torch.Tensor):
    """A torch-layout leaf of full ``shape``, of which this rank holds
    ``local`` as ``pieces`` cut it ([(parallel.comm.Piece or None, mesh
    axis name)]), as a ``Shard`` in JAX's layout."""
    from vla_touch_tpu_torch.utils.checkpoint import Shard

    region = [((0, n),) for n in shape]
    spec = [None] * len(shape)
    for piece, axis_name in pieces:
        if piece is not None:
            region[piece.axis] = _runs(piece.index[piece.rank])
            spec[piece.axis] = axis_name
    spec = tuple(spec) if any(spec) else ()
    if transposed:
        return Shard(tuple(reversed(shape)), tuple(reversed(region)), local.t(),
                     tuple(reversed(spec)))
    return Shard(tuple(shape), tuple(region), local, spec)


def rdt_train_state_shards(state, optimizer) -> dict:
    """:func:`rdt_train_state_to_flax` of this rank's part of a sharded
    ``TrainState``, nothing gathered: each leaf of ``params``, ``ema`` and
    ``opt_state`` a ``utils.checkpoint.Shard`` (the leaf's global JAX shape,
    this rank's region of it, the local tensor as a view, and its spec),
    the update counts as they are.  The regions come from the state's
    ``ShardPlan``: a parameter's TP piece (a fused projection's head-aligned
    piece: three runs) and, under ZeRO-3, its data piece; the shadow's and
    AdamW moments' both; the 8-bit moments' this data rank's whole blocks
    of the flattened JAX-layout leaf (rows of the (blocks, 256) codes).  A
    state without a plan holds every leaf whole."""
    from vla_touch_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from vla_touch_tpu_torch.utils.checkpoint import Shard

    paths = flax_paths(state.module)
    plan = state.plan

    def leaf(n, local, param):
        if plan is None:
            return _shard(tuple(local.shape), [], paths[n][1], local.detach())
        lp = plan.leaves[n]
        data = lp.data if not param or plan.zero3 else None
        return _shard(lp.shape, [(lp.tp, MODEL_AXIS), (data, DATA_AXIS)], lp.transposed,
                      local.detach())

    def blocks(n, local):
        if plan is None:
            return Shard(tuple(local.shape), tuple(((0, k),) for k in local.shape), local)
        nb, nbl = plan.n_blocks(plan.leaves[n])
        lo = plan.data_rank * nbl
        rows = max(0, min(lo + nbl, nb) - lo)
        shape = (nb,) + tuple(local.shape[1:])
        region = ((((lo, lo + rows),) if rows else ()),) + tuple(((0, k),) for k in shape[1:])
        return Shard(shape, region, local[:rows], (DATA_AXIS,) + (None,) * (len(shape) - 1))

    def tree(d, param=False):
        return nest(paths, {n: leaf(n, v, param) for n, v in d.items()}, transpose=False)

    return {"params": tree(dict(state.module.named_parameters()), param=True),
            "ema": tree(state.ema.shadow),
            "opt_state": optimizer.to_tree(
                state.opt_state, tree,
                lambda d: nest(paths, {n: blocks(n, v) for n, v in d.items()},
                               transpose=False)),
            "meta": {"step": int(state.step),
                     "ema_num_updates": int(state.ema.num_updates)}}


def rdt_train_state_from_flax(trees: dict, state, optimizer):
    """The inverse of :func:`rdt_train_state_to_flax`, into ``state``: its
    module's parameters are overwritten in place (cast to their dtype),
    the EMA shadow and optimizer state replaced, on the module's device.
    A sharded state takes this rank's regions of the leaves (as
    ``load_pytree_orbax`` reads them with the regions of
    :func:`rdt_train_state_shards`), the 8-bit blocks padded to the rank's
    block count.  Returns ``state``."""
    from vla_touch_tpu_torch.utils import ema as ema_lib

    paths = flax_paths(state.module)
    dev = next(state.module.parameters()).device
    plan = state.plan
    params = unnest(paths, trees["params"], dev)
    with torch.no_grad():
        for name, p in state.module.named_parameters():
            p.copy_(params[name].to(p.dtype))
    shadow = unnest(paths, trees["ema"], dev)
    state.ema = ema_lib.EmaState(
        shadow={n: shadow[n].to(s.dtype) for n, s in state.ema.shadow.items()},
        num_updates=torch.tensor(trees["meta"]["ema_num_updates"], dtype=torch.int32))

    def blocks(t):
        out = unnest(paths, t, dev, transpose=False)
        if plan is None:
            return out
        pad = {n: plan.n_blocks(plan.leaves[n])[1] - v.shape[0] for n, v in out.items()}
        return {n: torch.nn.functional.pad(v, (0, 0) * (v.dim() - 1) + (0, pad[n]))
                for n, v in out.items()}

    state.opt_state = optimizer.from_tree(trees["opt_state"], lambda t: unnest(paths, t, dev),
                                          blocks)
    state.step = int(trees["meta"]["step"])
    return state
