"""PyTorch port, the planner's vision-language backbone against the JAX
package on the CPU: the M-RoPE decoder (forward, greedy decoding's resume
offset, the text-only reduction), Qwen2-VL's vision tower, its position and
segment helpers, the spliced multimodal logits and greedy tokens, the HF
loaders (``load_llm_from_hf`` plain, int8, int4 and fused;
``load_qwen2vl_from_hf``) on tiny directories the ``safetensors`` package
writes, the backbone registry, the Qwen manifests' key spaces, and the
planner session and its transcripts.

``qwen2vl_tiny()`` in float32 throughout; inputs come from numpy seeds and
go to both packages, JAX trees convert through ``utils/from_flax.py``.  On
the CPU the tower's attention is K1's plain version in float32.
Tolerances are stated per test.
"""

import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_touch_tpu.planning import llm as JL
from vla_touch_tpu.planning import planner as JPL
from vla_touch_tpu.planning import qwen2vl as JVL
from vla_touch_tpu.planning import transcripts as JTR
from vla_touch_tpu_torch.planning import llm as TL
from vla_touch_tpu_torch.planning import planner as TPL
from vla_touch_tpu_torch.planning import qwen2vl as TVL
from vla_touch_tpu_torch.planning import transcripts as TTR
from vla_touch_tpu_torch.utils import checkpoint_manifest as TM
from vla_touch_tpu_torch.utils import from_flax as FF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JTCFG, JVCFG = JVL.qwen2vl_tiny()
TTCFG, TVCFG = TVL.qwen2vl_tiny()
MERGE = JVCFG.spatial_merge_size
# two prompts of 15 tokens: text, a (2, 4, 4) grid (8 merged tokens), text;
# and text, a (1, 4, 8) grid (8 merged tokens, offset advanced by 4), text
SEGS = ([("text", 3), ("image", (2, 4, 4)), ("text", 4)],
        [("text", 5), ("image", (1, 4, 8)), ("text", 2)])
# the vision tower's grids: one image; two images of other sizes
GRIDS = {"one_grid": [(2, 4, 4)], "two_grids": [(2, 4, 4), (1, 6, 4)]}
TRANSCRIPTS = os.path.join(ROOT, "tests", "fixtures", "octopi_results")


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a, dtype=None):
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _assert_state_equal(got: torch.nn.Module, want: torch.nn.Module):
    """Equal names, dtypes, shapes and bits."""
    g, w = got.state_dict(), want.state_dict()
    assert set(g) == set(w), set(g) ^ set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert torch.equal(g[k].cpu(), w[k].cpu()), k


# JAX's forwards jitted (one compile in place of an eager compile per op)
_jax_vision = jax.jit(JVL.vision_forward, static_argnums=0)
_jax_llm = jax.jit(JL.llm_forward, static_argnums=0)


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


def _draw(rng, path, shape):
    """A leaf of a seeded random tree: linears ~ N(0, 1/fan_in), biases
    N(0, 0.1^2), norm scales 1 + N(0, 0.1^2), the embedding N(0, 1) (wide,
    so greedy decoding has clear maxima)."""
    leaf = path[-1]
    if leaf == "kernel":
        return (rng.normal(size=shape) * shape[0] ** -0.5).astype(np.float32)
    if leaf == "embed":
        return rng.normal(size=shape).astype(np.float32)
    base = 0.0 if leaf == "bias" else 1.0
    return (base + 0.1 * rng.normal(size=shape)).astype(np.float32)


@pytest.fixture(scope="module")
def text():
    """(JAX tree, port LLM) of the tiny M-RoPE decoder, drawn with numpy."""
    rng = np.random.default_rng(10)
    p = {"layers": [{} for _ in range(JTCFG.num_layers)]}
    for path, _ in JL.hf_key_map(JTCFG).values():
        node = p
        for q in path[:-1]:
            node = node.setdefault(q, {}) if isinstance(node, dict) else node[q]
        _set(p, path, _draw(rng, path, _text_shape(JTCFG, path)))
    return p, FF.llm(p, TTCFG, device="cpu")


@pytest.fixture(scope="module")
def vision():
    """(JAX tree, port tower) of the tiny vision tower, drawn with numpy."""
    rng = np.random.default_rng(11)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in TVL.VisionTower(TVCFG).state_dict().items()}
    ours = TVL.vision_hf_key_map(TVCFG)
    p = {"patch_embed": {}, "blocks": [{} for _ in range(JVCFG.depth)],
         "merger": {"ln_q": {}, "fc1": {}, "fc2": {}}}
    for hf, (path, tf) in JVL.vision_hf_key_map(JVCFG).items():
        node = p
        for q in path[:-1]:
            node = node.setdefault(q, {}) if isinstance(node, dict) else node[q]
        shape = shapes[ours[hf][0]]
        _set(p, path, _draw(rng, path, shape[::-1] if tf else shape))
    return p, FF.qwen2vl_vision(p, TVCFG, device="cpu")


def _positions():
    return np.stack([TVL.mrope_positions(s, MERGE) for s in SEGS], axis=1)   # (3, 2, 15)


# ---- item 0: the port's M-RoPE path, held first ------------------------------------


def test_mrope_llm_forward_matches_jax(text, rng):
    """(3, B, L) positions from ``mrope_positions`` (a different layout in
    each row): hidden states within atol 1e-5."""
    jt, tt = text
    pos = _positions()
    x = rng.normal(size=(2, pos.shape[-1], JTCFG.hidden_size)).astype(np.float32)
    want = _np(_jax_llm(JTCFG, jt, jnp.asarray(x), positions=jnp.asarray(pos)))
    got = TL.llm_forward(TTCFG, tt, _t(x), positions=_t(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_mrope_greedy_generate_matches_jax(text, rng):
    """Greedy decoding over (3, B, L) prompt positions resumes at max(prompt
    position) + 1 (not the prompt length): 6 tokens equal, entropies within
    1e-4 nats."""
    jt, tt = text
    pos = _positions()
    assert pos.max() + 1 < pos.shape[-1]        # the offset differs from Lp
    x = rng.normal(size=(2, pos.shape[-1], JTCFG.hidden_size)).astype(np.float32)
    jtok, jent, jlen = JL.greedy_generate(JTCFG, jt, jnp.asarray(x), max_new_tokens=6,
                                          eos_id=3, prompt_positions=jnp.asarray(pos))
    ttok, tent, tlen = TL.greedy_generate(TTCFG, tt, _t(x), max_new_tokens=6, eos_id=3,
                                          prompt_positions=_t(pos))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_allclose(tent.numpy(), np.asarray(jent), atol=1e-4)


def test_mrope_text_only_reduces_to_standard_rope(text, rng):
    """(3, B, L) positions with equal components give the (B, L) result bit
    for bit (a pure-text prompt through the VL decoder is the text
    decoder's), in the port as in JAX."""
    _, tt = text
    x = _t(rng.normal(size=(2, 6, TTCFG.hidden_size)).astype(np.float32))
    p2 = torch.arange(6)[None].expand(2, 6)
    a = TL.llm_forward(TTCFG, tt, x, positions=p2)
    b = TL.llm_forward(TTCFG, tt, x, positions=p2[None].expand(3, 2, 6))
    assert torch.equal(a, b)


# ---- the vision tower --------------------------------------------------------------


def test_position_and_segment_helpers_equal_jax():
    for grids in ([(1, 4, 4)], [(2, 4, 4), (1, 6, 4)], [(1, 32, 32), (1, 24, 24)],
                  [(3, 2, 6)]):
        np.testing.assert_array_equal(TVL.vision_rot_pos_ids(grids, MERGE),
                                      JVL.vision_rot_pos_ids(grids, MERGE))
        np.testing.assert_array_equal(TVL.vision_segment_ids(grids),
                                      JVL.vision_segment_ids(grids))
        segs = [("text", 5)] + [x for g in grids for x in (("image", g), ("text", 2))]
        np.testing.assert_array_equal(TVL.mrope_positions(segs, MERGE),
                                      JVL.mrope_positions(segs, MERGE))
    for s in SEGS:
        np.testing.assert_array_equal(TVL.mrope_positions(s, MERGE),
                                      JVL.mrope_positions(s, MERGE))


@pytest.mark.parametrize("case", ["one_grid", "two_grids", "interleaved", "no_segments",
                                  "bf16_weights"])
def test_vision_forward_matches_jax(vision, rng, case):
    """Merged tokens within atol / rtol 1e-5: one grid (two frames of 16
    patches, K1's rows a reshape); two grids (frames of 16, 16 and 24
    patches, the short rows padded and their keys masked); one grid's
    segment ids interleaved (rows gathered); no segment ids (one frame);
    and bf16 weights with float32 patches, which promote to float32 as
    JAX's loader tree does."""
    jp, tp = vision
    grids = GRIDS["two_grids" if case == "two_grids" else "one_grid"]
    pos = JVL.vision_rot_pos_ids(grids, MERGE)
    seg = JVL.vision_segment_ids(grids)
    if case == "interleaved":
        seg = np.tile(np.repeat([0, 1], 4), len(seg) // 8)   # runs of 4, alternating
    n = len(pos)
    patches = rng.normal(size=(n, JVCFG.patch_dim)).astype(np.float32)
    if case == "bf16_weights":
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16 if a.ndim >= 2 else jnp.float32),
                          jp)
        tp = FF.qwen2vl_vision(jp, TVCFG, device="cpu")
        assert tp.blocks[0].qkv.weight.dtype == torch.bfloat16
    jseg = None if case == "no_segments" else jnp.asarray(seg)
    want = _np(_jax_vision(JVCFG, jp, jnp.asarray(patches), jnp.asarray(pos),
                                  segment_ids=jseg))
    got = TVL.vision_forward(TVCFG, tp, patches, pos,
                             segment_ids=None if case == "no_segments" else seg)
    assert got.dtype == torch.float32 and got.shape == (n // MERGE ** 2, JVCFG.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_frame_layout_pads_and_masks_short_frames():
    """Two grids: one K1 call of (3 frames, 24 rows); rows 0 and 1 hold 16
    patches and 8 masked pad keys; every patch comes back to its place."""
    seg = TVL.vision_segment_ids(GRIDS["two_grids"])
    lay = TVL.FrameLayout(seg, len(seg), "cpu")
    assert (lay.F, lay.L) == (3, 24)
    assert lay.mask.sum(1).tolist() == [16, 16, 24]
    x = torch.arange(len(seg) * 2, dtype=torch.float32).reshape(-1, 1, 2)
    rows = lay.rows(x)
    assert rows.shape == (3, 24, 1, 2)
    back = rows.reshape(3 * 24, -1)[lay.scatter]
    assert torch.equal(back, x.reshape(len(seg), 2))
    one = TVL.FrameLayout(TVL.vision_segment_ids([(2, 4, 4)]), 32, "cpu")
    assert one.mask is None and one.gather is None and (one.F, one.L) == (2, 16)


# ---- the composed request ----------------------------------------------------------


def _request(rng):
    """ids with an 8-token image placeholder, the grid's patches."""
    grid = (2, 4, 4)
    ids = np.asarray([7, 3] + [5] * 8 + [4, 9, 11, 2])
    patches = rng.normal(size=(32, JVCFG.patch_dim)).astype(np.float32)
    return grid, ids, patches


def _jax_prompt(jt, jv, grid, ids, patches):
    vtok = _jax_vision(JVCFG, jv, jnp.asarray(patches),
                              jnp.asarray(JVL.vision_rot_pos_ids([grid], MERGE)),
                              segment_ids=jnp.asarray(JVL.vision_segment_ids([grid])))
    start = ids.tolist().index(5)
    emb = JVL.splice_embeds(JL.embed_tokens(jt, jnp.asarray(ids)), vtok, start)
    segs = [("text", start), ("image", grid), ("text", len(ids) - start - 8)]
    return emb[None], jnp.asarray(JVL.mrope_positions(segs, MERGE))[:, None, :]


def _port_prompt(tt, tv, grid, ids, patches):
    vtok = TVL.vision_forward(TVCFG, tv, patches, TVL.vision_rot_pos_ids([grid], MERGE),
                              segment_ids=TVL.vision_segment_ids([grid]))
    start = ids.tolist().index(5)
    emb = TVL.splice_embeds(TL.embed_tokens(tt, ids), vtok, start)
    segs = [("text", start), ("image", grid), ("text", len(ids) - start - 8)]
    return emb[None], torch.as_tensor(TVL.mrope_positions(segs, MERGE))[:, None, :]


def test_spliced_multimodal_logits_match_jax(text, vision, rng):
    """Vision tokens spliced at the placeholders, M-RoPE positions, the
    decoder and its head: logits within atol 5e-5."""
    (jt, tt), (jv, tv) = text, vision
    grid, ids, patches = _request(rng)
    jemb, jpos = _jax_prompt(jt, jv, grid, ids, patches)
    temb, tpos = _port_prompt(tt, tv, grid, ids, patches)
    np.testing.assert_allclose(temb.numpy(), _np(jemb), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    want = _np(JL.lm_logits(JTCFG, jt, _jax_llm(JTCFG, jt, jemb, positions=jpos)))
    got = TL.lm_logits(TTCFG, tt, TL.llm_forward(TTCFG, tt, temb, positions=tpos))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=0)


def test_multimodal_greedy_tokens_match_jax(text, vision, rng):
    (jt, tt), (jv, tv) = text, vision
    grid, ids, patches = _request(rng)
    jemb, jpos = _jax_prompt(jt, jv, grid, ids, patches)
    temb, tpos = _port_prompt(tt, tv, grid, ids, patches)
    jtok, _, _ = JL.greedy_generate(JTCFG, jt, jemb, max_new_tokens=6, eos_id=0,
                                    prompt_positions=jpos)
    ttok, _, _ = TL.greedy_generate(TTCFG, tt, temb, max_new_tokens=6, eos_id=0,
                                    prompt_positions=tpos)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


# ---- the HF loaders ------------------------------------------------------------------


def _hf_state(rng, depth_cut=None):
    """A tiny Qwen2-VL checkpoint's tensors (float32, HF names and layouts)."""
    tcfg = JTCFG if depth_cut is None else dataclasses.replace(JTCFG, num_layers=depth_cut)
    sd = {}
    for k in JL.hf_key_map(tcfg):
        path, transpose = JL.hf_key_map(tcfg)[k]
        shape = _text_shape(tcfg, path)
        sd[k] = rng.normal(size=shape[::-1] if transpose else shape).astype(np.float32)
    with torch.device("meta"):
        want = TVL.VisionTower(TVCFG).state_dict()
    for k, (name, tf) in TVL.vision_hf_key_map(TVCFG).items():
        shape = tuple(want[name].shape)
        if tf == "conv":
            shape = (shape[0], JVCFG.in_channels, JVCFG.temporal_patch_size,
                     JVCFG.patch_size, JVCFG.patch_size)
        sd[k] = rng.normal(size=shape).astype(np.float32)
    return sd


def _text_shape(cfg, path):
    """Shape of a leaf of JAX's ``init_llm`` tree (kernels (in, out))."""
    D, hd = cfg.hidden_size, cfg.head_dim
    leaf = path[-2] if path[-1] in ("kernel", "bias") else path[-1]
    dims = {"q": (D, cfg.num_heads * hd), "k": (D, cfg.num_kv_heads * hd),
            "v": (D, cfg.num_kv_heads * hd), "o": (cfg.num_heads * hd, D),
            "gate": (D, cfg.mlp_dim), "up": (D, cfg.mlp_dim), "down": (cfg.mlp_dim, D),
            "lm_head": (D, cfg.vocab_size), "embed": (cfg.vocab_size, D)}
    if path[-1] == "bias":
        return (dims[leaf][1],)
    if leaf in ("input_norm", "post_norm", "final_norm"):
        return (D,)
    return dims[leaf]


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """The tiny checkpoint in two shards, as the ``safetensors`` package
    writes them."""
    from safetensors.numpy import save_file

    sd = _hf_state(np.random.default_rng(3))
    d = tmp_path_factory.mktemp("qwen2vl_tiny")
    keys = sorted(sd)
    save_file({k: sd[k] for k in keys[::2]}, str(d / "model-00001-of-00002.safetensors"))
    save_file({k: sd[k] for k in keys[1::2]}, str(d / "model-00002-of-00002.safetensors"))
    return str(d), sd


@pytest.mark.parametrize("weights,fuse", [(None, False), ("int8", False), ("int4", False),
                                          ("int4", True), ("int8", True)])
def test_load_llm_from_hf_equals_jax_loader(hf_dir, weights, fuse):
    """The port's loader (its own safetensors reader) against the JAX
    loader: bf16 weights, float32 norms and biases, the int8 / grouped-int4
    codes and the fused leaves bit for bit.  The port's loader quantizes as
    ``quantize_llm_params`` does (JAX's, run eagerly, and the port's agree
    bit for bit); JAX's loader jit-compiles the quantizer, and XLA:CPU
    turns its ``amax / 127`` and ``amax / 7`` into products with the
    reciprocal, so its scales may differ from those in the last place (one
    ulp), and no more."""
    d, _ = hf_dir
    got = TL.load_llm_from_hf(TTCFG, d, weights=weights, fuse=fuse, device="cpu")
    jax_loaded = JL.load_llm_from_hf(JTCFG, d, weights=weights, fuse=fuse)
    if weights is None:
        _assert_state_equal(got, FF.llm(jax_loaded, TTCFG, device="cpu"))
        assert got.layers[0].q.weight.dtype == torch.bfloat16
        assert got.layers[0].q.bias.dtype == torch.float32
        return
    if fuse:
        assert "qkv" in got.layers[0] and "gateup" in got.layers[0]
    _assert_like_jax_loader(got, jax_loaded, d, weights, fuse)


def _assert_like_jax_loader(got, jax_loaded, d, weights, fuse=False):
    """``got`` is the port's ``quantize_llm_params`` of its loaded bf16 tree
    (which equals JAX's, above) bit for bit; ``tests/test_torch_quant.py``
    holds that quantizer to JAX's eager one leaf by leaf.  Against JAX's
    loader: every leaf bit for bit but the scales, which may differ in the
    last place."""
    want = TL.quantize_llm_params(TL.load_llm_from_hf(TTCFG, d, device="cpu"), weights)
    _assert_state_equal(got, TL.fuse_quantized_layers(want) if fuse else want)
    g, w = got.state_dict(), FF.llm(jax_loaded, TTCFG, device="cpu").state_dict()
    assert set(g) == set(w)
    for k in w:
        if k.endswith(("scale", "scale4")):
            assert float(((g[k] - w[k]).abs() - w[k].abs() * 2.0 ** -23).max()) <= 0.0, k
        else:
            assert torch.equal(g[k], w[k]), k


def test_load_llm_from_hf_int4_equals_quantize_llm_params(hf_dir):
    """Quantizing layer by layer as the tree loads gives what
    ``quantize_llm_params`` gives on the loaded bf16 tree."""
    d, _ = hf_dir
    plain = TL.load_llm_from_hf(TTCFG, d, device="cpu")
    for weights in ("int4", "int8"):
        _assert_state_equal(TL.load_llm_from_hf(TTCFG, d, weights=weights, device="cpu"),
                            TL.quantize_llm_params(plain, weights))


@pytest.mark.parametrize("weights", ["int4", "int8"])
def test_quantizing_in_row_chunks_is_exact(rng, weights, monkeypatch):
    """The loader's and ``quantize_llm_params``' leaves are quantized a
    bounded number of output rows at a time: codes, scales and biases equal
    one call over the whole linear bit for bit, at uneven chunks too."""
    from vla_touch_tpu_torch.ops import quant as Q

    lin = torch.nn.Linear(256, 1000)
    with torch.no_grad():
        lin.weight.copy_(_t(rng.normal(size=(1000, 256)) * 0.06))
        lin.bias.copy_(_t(rng.normal(size=(1000,))))
    whole = (Q.quantize_linear_w4 if weights == "int4" else Q.quantize_linear)(lin)
    for chunk in (256 * 37, 256 * 500):
        monkeypatch.setattr(TL, "QUANT_CHUNK", chunk)
        _assert_state_equal(TL._quantize_leaf(lin, weights), whole)


def test_load_llm_from_hf_raises_as_jax(hf_dir, tmp_path):
    """A missing mapped tensor raises a KeyError naming it (JAX's too);
    ``fuse=True`` without ``weights`` raises ValueError; an empty directory
    FileNotFoundError; and the default device is CUDA."""
    from safetensors.numpy import save_file

    _, sd = hf_dir
    cut = {k: v for k, v in sd.items() if k != "model.layers.1.self_attn.k_proj.bias"}
    save_file(cut, str(tmp_path / "model.safetensors"))
    for loader in (lambda: JL.load_llm_from_hf(JTCFG, str(tmp_path)),
                   lambda: TL.load_llm_from_hf(TTCFG, str(tmp_path), device="cpu")):
        with pytest.raises(KeyError, match="k_proj.bias"):
            loader()
    with pytest.raises(ValueError):
        JL.load_llm_from_hf(JTCFG, str(tmp_path), fuse=True)
    with pytest.raises(ValueError):
        TL.load_llm_from_hf(TTCFG, str(tmp_path), fuse=True, device="cpu")
    with pytest.raises(FileNotFoundError):
        TL.load_llm_from_hf(TTCFG, str(tmp_path / "none"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TL.load_llm_from_hf(TTCFG, hf_dir[0])


@pytest.mark.parametrize("weights", [None, "int4"])
def test_load_qwen2vl_from_hf_equals_jax_loader(hf_dir, weights):
    """Both halves: the decoder as above; the tower's bf16
    weights (the Conv3d reshaped to the linear's (D, C·T·P·P)) and float32
    biases and norms, through ``from_flax.qwen2vl_vision`` of JAX's tree."""
    d, sd = hf_dir
    jt, jv = JVL.load_qwen2vl_from_hf(JTCFG, JVCFG, d, weights=weights)
    tt, tv = TVL.load_qwen2vl_from_hf(TTCFG, TVCFG, d, weights=weights, device="cpu")
    if weights is None:
        _assert_state_equal(tt, FF.llm(jt, TTCFG, device="cpu"))
    else:
        _assert_like_jax_loader(tt, jt, d, weights)
    _assert_state_equal(tv, FF.qwen2vl_vision(jv, TVCFG, device="cpu"))
    assert tv.patch_embed.weight.dtype == torch.bfloat16
    assert tv.blocks[0].norm1.weight.dtype == torch.float32
    # port_vision_state_dict is JAX's port_vision_state_dict, converted
    vstate = {k: v for k, v in sd.items() if k.startswith("visual.")}
    got = TVL.port_vision_state_dict(TVCFG, vstate)
    want = FF.qwen2vl_vision(JVL.port_vision_state_dict(JVCFG, vstate), TVCFG,
                             device="cpu").state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_load_qwen2vl_from_hf_missing_vision_key_raises(hf_dir, tmp_path):
    from safetensors.numpy import save_file

    _, sd = hf_dir
    save_file({k: v for k, v in sd.items() if k != "visual.merger.mlp.2.bias"},
              str(tmp_path / "model.safetensors"))
    for loader in (lambda: JVL.load_qwen2vl_from_hf(JTCFG, JVCFG, str(tmp_path)),
                   lambda: TVL.load_qwen2vl_from_hf(TTCFG, TVCFG, str(tmp_path),
                                                    device="cpu")):
        with pytest.raises(KeyError, match="vision tensors"):
            loader()


def test_bf16_checkpoint_loads_as_its_float32_twin(hf_dir, tmp_path):
    """A checkpoint stored in BF16 (as Qwen ships it; written here by the
    port's writer) loads to the same tree as its float32 file cast to
    bf16 on load."""
    from vla_touch_tpu_torch.utils.safetensors_io import save_file

    d, sd = hf_dir
    save_file({k: torch.from_numpy(v).to(torch.bfloat16) if v.ndim >= 2 else
               torch.from_numpy(v) for k, v in sd.items()}, str(tmp_path / "m.safetensors"))
    a = TVL.load_qwen2vl_from_hf(TTCFG, TVCFG, str(tmp_path), weights="int4", device="cpu")
    b = TVL.load_qwen2vl_from_hf(TTCFG, TVCFG, d, weights="int4", device="cpu")
    _assert_state_equal(a[0], b[0])
    _assert_state_equal(a[1], b[1])


# ---- registry and manifests --------------------------------------------------------


def test_configs_and_backbone_match_jax():
    for name in ("qwen2vl_7b", "qwen2vl_7b_vision"):
        assert _fields(getattr(TVL, name)()) == _fields(getattr(JVL, name)()), name
    assert [_fields(c) for c in TVL.qwen2vl_tiny()] == [_fields(c) for c in JVL.qwen2vl_tiny()]
    for model_type in ("qwen2.5-7b", "llama-3.1-8b"):
        assert _fields(TL.backbone(model_type)) == _fields(JL.backbone(model_type))
    t, v = TL.backbone("qwen2-vl-7b")
    jt, jv = JL.backbone("qwen2-vl-7b")
    assert _fields(t) == _fields(jt) and _fields(v) == _fields(jv)
    assert t.mrope_section == (16, 24, 24) and v.depth == 32 and v.head_dim == 80
    with pytest.raises(ValueError):
        TL.backbone("gpt-5")
    # the port's key map is JAX's, its names the port's; without a qkv bias
    # (LLaMA) it asks for no bias tensor, where JAX's asks for q/k/v biases a
    # LLaMA checkpoint does not hold
    for cfg in (TL.qwen25_7b(), TTCFG):
        assert set(TL.hf_key_map(cfg)) == set(JL.hf_key_map(cfg))
    llama = TL.hf_key_map(TL.llama31_8b())
    assert set(llama) == {k for k in JL.hf_key_map(JL.llama31_8b()) if not k.endswith("bias")}
    assert set(TVL.vision_hf_key_map(TVCFG)) == set(JVL.vision_hf_key_map(JVCFG))


def _meta_llm_shapes(cfg):
    with torch.device("meta"):
        m = TL.LLM(cfg, torch.nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size)),
                   [TL.DecoderLayer(cfg) for _ in range(cfg.num_layers)],
                   torch.nn.Parameter(torch.empty(cfg.hidden_size)),
                   torch.nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False))
    return {k: tuple(v.shape) for k, v in m.state_dict().items()}


@pytest.mark.parametrize("name", ["qwen2_5_7b", "qwen2_vl_7b"])
def test_qwen_manifests_match_the_key_maps(name):
    """The key maps at full size cover the manifest's key space exactly,
    and each key's shape is that of the port's parameter (meta-device
    modules; the Conv3d as its linear)."""
    man = TM.load_manifest(name)
    tcfg = TL.qwen25_7b() if name == "qwen2_5_7b" else TVL.qwen2vl_7b()
    shapes = _meta_llm_shapes(tcfg)
    got = {hf: shapes[ours] for hf, ours in TL.hf_key_map(tcfg).items()}
    if name == "qwen2_vl_7b":
        vcfg = TVL.qwen2vl_7b_vision()
        with torch.device("meta"):
            vshapes = {k: tuple(v.shape) for k, v in TVL.VisionTower(vcfg).state_dict().items()}
        for hf, (ours, tf) in TVL.vision_hf_key_map(vcfg).items():
            got[hf] = vshapes[ours]
            if tf == "conv":        # the Conv3d (D, C, T, P, P) as the linear's (D, C·T·P·P)
                s = man[hf]
                assert (s[0], int(np.prod(s[1:]))) == vshapes[ours]
                got[hf] = s
    assert set(got) == set(man), set(got) ^ set(man)
    assert got == man
    assert TM.KNOWN[name][1].startswith("planning.")


# ---- the planner session and its transcripts ----------------------------------------


def _rows(path):
    return [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in open(path)]


@pytest.mark.parametrize("use_tactile", [True, False])
def test_planner_session_matches_jax(tmp_path, use_tactile):
    """The same scripted VLM and feedback through both sessions: the same
    messages, the same log rows (timestamps apart), the same summary."""
    forces = [np.array([0.1, 0.0, 0.1]), np.array([1.5, 0.2, 1.6]),
              np.array([0.8, 0.1, 0.9])]
    out = {}
    for tag, P in (("jax", JPL), ("port", TPL)):
        script = iter(["grasp sponge", "press sponge", "wipe left", "DONE"])
        fb = P.TactileFeedback()
        cfg = P.PlannerConfig(experiment="wipe", results_dir=str(tmp_path / tag),
                              session_name="s", use_tactile=use_tactile)
        seen = []

        def vlm_fn(messages, script=script, seen=seen):
            seen.append([dict(m) for m in messages])
            return next(script)

        session = P.PlannerSession(cfg, vlm_fn, fb)
        fi = iter(forces)
        res = session.run(lambda action, turn: fb.from_force(next(fi)) + " " +
                          fb.from_properties(3.0 + turn, 1.5))
        out[tag] = (session.messages, _rows(res["log_path"]), seen,
                    {k: v for k, v in res.items() if k != "log_path"})
    assert out["port"] == out["jax"]
    assert TPL.SYSTEM_PROMPT == JPL.SYSTEM_PROMPT and TPL.EXPERIMENTS == JPL.EXPERIMENTS
    assert TPL.TactileFeedback().from_frames(None) == JPL.TactileFeedback().from_frames(None)
    with pytest.raises(RuntimeError, match="openai"):
        TPL.openai_vlm()


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(TRANSCRIPTS, "**", "*.jsonl"),
                                                  recursive=True)),
                         ids=lambda p: os.path.relpath(p, TRANSCRIPTS))
def test_replay_trial_matches_jax(tmp_path, path):
    """Every recorded transcript: parsed trials and notes as JAX's; each
    trial replayed through the port's session gives JAX's row and log and
    the recording's steps; the rows written back parse to themselves."""
    trials, notes = TTR.parse_results_jsonl(path, return_notes=True)
    assert (trials, notes) == JTR.parse_results_jsonl(path, return_notes=True)
    rows = []
    for trial in trials:
        got = TTR.replay_trial(trial, str(tmp_path / "port"))
        want = JTR.replay_trial(trial, str(tmp_path / "jax"))
        assert got == want
        assert got["steps"] == trial["steps"]
        name = f"replay_{TTR._experiment_for(trial)}_{trial.get('trial_number', 0)}.jsonl"
        assert _rows(tmp_path / "port" / name) == _rows(tmp_path / "jax" / name)
        os.remove(tmp_path / "port" / name)
        os.remove(tmp_path / "jax" / name)
        rows.append(got)
    out = TTR.write_results_jsonl(rows, str(tmp_path / "out" / "r.jsonl"))
    assert TTR.parse_results_jsonl(out) == rows


def test_trial_row_round_trip_of_a_live_session(tmp_path):
    """A live session exported with ``trial_row`` and re-driven with
    ``replay_trial`` gives the same steps (the planner's own transcripts)."""
    replies = iter(["squeeze mango", "", "pick up the mango", "place mango in basket"])
    cfg = TPL.PlannerConfig(experiment="mango", max_turns=3, results_dir=str(tmp_path),
                            session_name="live")
    session = TPL.PlannerSession(cfg, lambda m: next(replies))
    session.run(lambda action, turn: f"feedback {turn}")
    row = TTR.trial_row(session, trial_number=4, image="mango.png", start_time="t0")
    assert [s["assistant"] for s in row["steps"]] == [
        "squeeze mango", "", "pick up the mango", "place mango in basket"]
    again = TTR.replay_trial(row, str(tmp_path / "replay"))
    assert again["steps"] == row["steps"] and again["initial_prompt"] == row["initial_prompt"]
    assert again == JTR.replay_trial(row, str(tmp_path / "jax"))
