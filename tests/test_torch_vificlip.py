"""PyTorch port, the planner's tactile encoder trained and evaluated, against
the JAX package on the CPU: the CLIP text tower and its HF converter, the
prompt-learned vision and text towers at every kind of prompt depth,
``ViFiCLIPModel`` and its contrastive loss, float32 and bf16 compute, the
contrastive trainer (frozen text tower) and the property trainer step for
step, the encoder's checkpoint directory both ways, and the data side
(PhysiCLeAR tables, QA rows and files, raw-corpus processing, both
datasets' batches, the evaluation metrics).

Tiny configs: vision 32 wide, 3 layers, 2 heads, 32^2 frames in 16^2
patches; text vocab 64, 16 positions, 3 layers; 2 prompts.  Parameters
come from the port's seeded init and go to JAX through
``utils/from_flax.py::to_flax`` (JAX's own init builds the reference
trees once, for their structure); inputs come from numpy seeds.  Frames are
PNGs that OpenCV writes, at the preprocessing size where a resize is a
copy, so the frame pipelines compare exactly.  Tolerances are stated per
test.
"""

import dataclasses
import filecmp
import json
import os
import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_touch_tpu.models.encoders import clip_text as JCT
from vla_touch_tpu.models.encoders import vit as JV
from vla_touch_tpu.planning import datasets as JD
from vla_touch_tpu.planning import encoder as JE
from vla_touch_tpu.planning import eval as JEV
from vla_touch_tpu.planning import physiclear as JPC
from vla_touch_tpu.planning import process_datasets as JPD
from vla_touch_tpu.planning import qa as JQA
from vla_touch_tpu.planning import train_encoder as JTE
from vla_touch_tpu_torch.models.encoders import clip_text as TCT
from vla_touch_tpu_torch.models.encoders import vit as TV
from vla_touch_tpu_torch.planning import datasets as TD
from vla_touch_tpu_torch.planning import encoder as TE
from vla_touch_tpu_torch.planning import eval as TEV
from vla_touch_tpu_torch.planning import physiclear as TPC
from vla_touch_tpu_torch.planning import process_datasets as TPD
from vla_touch_tpu_torch.planning import qa as TQA
from vla_touch_tpu_torch.planning import train_encoder as TTE
from vla_touch_tpu_torch.utils import from_flax as FF

VK = dict(hidden_size=32, num_layers=3, num_heads=2, mlp_dim=64, patch_size=16, image_size=32,
          use_layerscale=False, quick_gelu=True, use_pre_norm=True, layernorm_eps=1e-5,
          patch_bias=False)
TK = dict(vocab_size=64, hidden_size=32, num_layers=3, num_heads=2, mlp_dim=64,
          max_positions=16, eos_token_id=63)
JVC, JTC = JV.ViTConfig(**VK), JCT.CLIPTextConfig(**TK)
TVC, TTC = TV.ViTConfig(**VK), TCT.CLIPTextConfig(**TK)
N_PROMPTS = 2
EOS = TK["eos_token_id"]
# prompt depths: none, the embedding only, mid-depth (slots dropped at 2),
# every layer, past the last layer
DEPTHS = [0, 1, 2, 3, 5]


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rel=1e-5):
    """max abs error <= rel x max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


def _corr(a, b):
    return float(np.corrcoef(np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64))[0, 1])


def _ids(rng, B=3, L=12, eos_at=(9, 11, 1)):
    """(B, L) token ids below EOS with one EOS per row at ``eos_at`` (a row
    whose EOS sits at 1 comes before the prompt slots [1, 1 + 2)), and a
    padding mask that ends each row after its EOS."""
    ids = rng.integers(0, EOS, (B, L))
    mask = np.zeros((B, L), np.int32)
    for b, e in enumerate(eos_at[:B]):
        ids[b, e] = EOS
        mask[b, :e + 1] = 1
    return ids, mask


def _model_kw(depth_v=2, depth_t=2, prompt=True):
    return dict(prompt_learning=prompt, num_prompts=N_PROMPTS, prompt_depth_vision=depth_v,
                prompt_depth_text=depth_t)


def _port_model(seed=1, **kw):
    return TE.init_vificlip_model(TVC, TTC, seed=seed, device="cpu", **kw)


def _perturbed(tree, rng, scale=0.05):
    """Every leaf plus noise: the zero-initialised biases and the equal
    gates and scales would hide a swapped or dropped leaf."""
    return jax.tree.map(lambda a: (a + scale * rng.normal(size=np.shape(a))).astype(np.float32),
                        tree)


def _tree_equal(a, b):
    fa, fb = jax.tree_util.tree_flatten_with_path(a), jax.tree_util.tree_flatten_with_path(b)
    assert fa[1] == fb[1]
    for (path, x), (_, y) in zip(fa[0], fb[0]):
        assert np.asarray(x).dtype == np.asarray(y).dtype, path
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=str(path))


# ---- configs, masks, the text tower ---------------------------------------------------

def test_configs_and_text_helpers_match_jax(rng):
    assert dataclasses.asdict(TCT.CLIP_TEXT_B16) == dataclasses.asdict(JCT.CLIP_TEXT_B16)
    assert dataclasses.asdict(TTC.vit()) == dataclasses.asdict(JTC.vit())
    assert TE.LOGIT_SCALE_INIT == float(np.log(1 / 0.07))
    ids, mask = _ids(rng)
    np.testing.assert_array_equal(TCT.causal_bias(7).numpy(), _np(JCT.causal_bias(7)))
    np.testing.assert_array_equal(TCT.padding_bias(_t(mask)).numpy(),
                                  _np(JCT.padding_bias(jnp.asarray(mask))))
    ids[2, 5] = EOS                      # two EOS in a row: the first pools
    h = rng.normal(size=(3, 12, 4)).astype(np.float32)
    np.testing.assert_array_equal(TCT.eos_pool(_t(h), _t(ids), EOS).numpy(),
                                  _np(JCT.eos_pool(jnp.asarray(h), jnp.asarray(ids), EOS)))


@pytest.fixture(scope="module")
def text_tree():
    """A tiny HF ``CLIPTextModel`` state dict (numpy) and its converted tree."""
    r = np.random.default_rng(11)
    D, F = TK["hidden_size"], TK["mlp_dim"]
    sd = {"text_model.embeddings.token_embedding.weight": (TK["vocab_size"], D),
          "text_model.embeddings.position_embedding.weight": (TK["max_positions"], D),
          "text_model.final_layer_norm.weight": (D,), "text_model.final_layer_norm.bias": (D,)}
    for i in range(TK["num_layers"]):
        h = f"text_model.encoder.layers.{i}"
        for n in ("layer_norm1", "layer_norm2"):
            sd[f"{h}.{n}.weight"], sd[f"{h}.{n}.bias"] = (D,), (D,)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{h}.self_attn.{n}.weight"], sd[f"{h}.self_attn.{n}.bias"] = (D, D), (D,)
        sd[f"{h}.mlp.fc1.weight"], sd[f"{h}.mlp.fc1.bias"] = (F, D), (F,)
        sd[f"{h}.mlp.fc2.weight"], sd[f"{h}.mlp.fc2.bias"] = (D, F), (D,)
    sd = {k: (0.3 * r.normal(size=s) + (1.0 if k.endswith("norm1.weight") else 0.0)
              ).astype(np.float32) for k, s in sd.items()}
    return sd, TCT.clip_text_from_hf(sd, TK["num_layers"])


@pytest.mark.parametrize("padded", [False, True])
def test_clip_text_tower_and_hf_converter_match_jax(text_tree, rng, padded):
    """``clip_text_from_hf`` gives JAX's tree leaf for leaf; the tower on it
    (last hidden states and the EOS-pooled feature, with and without the
    padding mask) within 1e-5 of max|JAX|."""
    sd, tree = text_tree
    _tree_equal(tree, JCT.clip_text_from_hf(sd, TK["num_layers"]))
    with torch.device("meta"):
        tower = TCT.CLIPTextTower(TTC)
    tower = FF.load_into(tower.to_empty(device="cpu"),
                         FF.to_state_dict(tree, lists=("block",))).eval()
    ids, mask = _ids(rng, eos_at=(9, 11, 6))
    am = mask if padded else None
    want = JCT.CLIPTextTower(JTC).apply({"params": tree}, jnp.asarray(ids),
                                         None if am is None else jnp.asarray(am))
    with torch.no_grad():
        got = tower(_t(ids), None if am is None else _t(am))
    for g, w in zip(got, want):
        _close(g.numpy(), _np(w))


# ---- the prompt-learned towers ----------------------------------------------------------

@pytest.mark.parametrize("depth", DEPTHS)
def test_prompt_text_tower_matches_jax(rng, depth):
    """The prompt slots [1, 1 + n) overwritten, re-put and gated, dropped at
    mid-depth with the shortened causal and padding bias, and the EOS index
    moved back and clamped at 0 (row 2's EOS is at 1, before the slots):
    hidden states and pooled feature within 1e-5 of max|JAX|, padded."""
    m = _port_model(**_model_kw(depth_t=depth)).text
    tree = _perturbed(FF.to_flax(m), rng)
    FF.load_into(m, FF.to_state_dict(tree, lists=("block",)))
    ids, mask = _ids(rng)
    want = jax.jit(JE.PromptLearningCLIPText(JTC, num_prompts=N_PROMPTS, prompt_depth=depth).apply)(
        {"params": tree}, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = m(_t(ids), _t(mask))
    for g, w in zip(got, want):
        _close(g.numpy(), _np(w))


@pytest.mark.parametrize("depth", DEPTHS)
def test_prompt_vision_tower_matches_jax(rng, depth):
    """Prompts appended before the pre-LayerNorm, replaced and gated per
    layer, dropped at ``depth`` (or after the last block): the pooled CLS
    within 1e-5 of max|JAX|."""
    m = _port_model(**_model_kw(depth_v=depth)).vision
    tree = _perturbed(FF.to_flax(m), rng)
    FF.load_into(m, FF.to_state_dict(tree, lists=("block",)))
    px = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    want = jax.jit(JE.PromptLearningCLIPVision(JVC, num_prompts=N_PROMPTS, prompt_depth=depth).apply)(
        {"params": tree}, jnp.asarray(px))
    with torch.no_grad():
        got = m(_t(px))
    _close(got.numpy(), _np(want))


# ---- the model, its converter and its loss -----------------------------------------------

@pytest.fixture(scope="module")
def jax_trees():
    """The shapes and dtypes of JAX's own init of both model variants."""
    frames = jnp.zeros((1, 1, 32, 32, 3))
    ids = jnp.asarray(np.array([[1, 2, 3, EOS]]))
    out = {}
    for prompt in (False, True):
        jm = JE.ViFiCLIPModel(vision_cfg=JVC, text_cfg=JTC, **_model_kw(prompt=prompt))
        out[prompt] = jax.eval_shape(jm.init, jax.random.PRNGKey(0), frames, ids)["params"]
    return out


@pytest.mark.parametrize("prompt", [False, True])
def test_vificlip_model_matches_jax(jax_trees, rng, prompt):
    """The port's tree has JAX's paths, shapes and dtypes; ``vificlip_model``
    and ``to_flax`` invert each other bit for bit; the forward (video and
    text features, the scales) within 1e-5 of max|JAX|, and without ids the
    text feature is None."""
    kw = _model_kw(prompt=prompt)
    m = _port_model(**kw)
    tree = _perturbed(FF.to_flax(m), rng)
    jshape = jax.tree.map(lambda a: (a.shape, np.dtype(a.dtype)), jax_trees[prompt])
    assert jax.tree.map(lambda a: (np.shape(a), a.dtype), tree) == jshape
    m = FF.vificlip_model(tree, TVC, TTC, device="cpu", **kw)
    _tree_equal(FF.to_flax(m), tree)
    frames = rng.normal(size=(2, 3, 32, 32, 3)).astype(np.float32)
    ids, mask = _ids(rng, B=2)
    jm = JE.ViFiCLIPModel(vision_cfg=JVC, text_cfg=JTC, **kw)
    jv, jt, js = jax.jit(jm.apply)({"params": tree}, jnp.asarray(frames), jnp.asarray(ids),
                                   jnp.asarray(mask))
    with torch.no_grad():
        v, t, s = m(_t(frames), _t(ids), _t(mask))
        assert m(_t(frames))[1] is None
    _close(v.numpy(), _np(jv))
    _close(t.numpy(), _np(jt))
    assert float(s["tactile"]) == float(js["tactile"]) and float(s["text"]) == float(js["text"])


def test_projections_map_each_pooled_feature(rng):
    """``projection_dim`` (which JAX's model lacks) adds HF CLIP's bias-free
    ``visual_projection`` and ``text_projection``: each pooled feature is
    projected before its frame mean and normalisation; the converter and
    ``to_flax`` carry them; towers of unequal widths need them."""
    kw = dict(_model_kw(), projection_dim=16)
    m = _port_model(**kw)
    tree = _perturbed(FF.to_flax(m), rng)
    assert tree["visual_projection"]["kernel"].shape == (32, 16)
    m = FF.vificlip_model(tree, TVC, TTC, device="cpu", **kw)
    _tree_equal(FF.to_flax(m), tree)
    frames = rng.normal(size=(2, 3, 32, 32, 3)).astype(np.float32)
    ids, mask = _ids(rng, B=2)
    with torch.no_grad():
        v, t, _ = m(_t(frames), _t(ids), _t(mask))
        f = m.visual_projection(m.vision(_t(frames).reshape(6, 32, 32, 3))).reshape(2, 3, 16)
        f = f.mean(dim=1)
        p = m.text_projection(m.text(_t(ids), _t(mask))[1])
    np.testing.assert_allclose(v.numpy(), (f / f.norm(dim=-1, keepdim=True)).numpy(), atol=1e-6)
    np.testing.assert_allclose(t.numpy(), (p / p.norm(dim=-1, keepdim=True)).numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="projection_dim"):
        TE.ViFiCLIPModel(TVC, dataclasses.replace(TTC, hidden_size=64))


@pytest.mark.parametrize("scale_tactile", [float(np.log(1 / 0.07)), float(np.log(150.0))])
def test_contrastive_loss_and_grads_match_jax(rng, scale_tactile):
    """The symmetric cross-entropy with one scale per direction, clipped at
    100 (log 150 > log 100: that scale gets no gradient): loss and
    gradients within 1e-5 of max|JAX|."""
    v = rng.normal(size=(5, 8)).astype(np.float32)
    t = rng.normal(size=(5, 8)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    sc = {"tactile": np.float32(scale_tactile), "text": np.float32(2.0)}
    jl, jg = jax.value_and_grad(JE.vificlip_contrastive_loss, argnums=(0, 1, 2))(
        jnp.asarray(v), jnp.asarray(t), {k: jnp.asarray(x) for k, x in sc.items()})
    tv, tt = _t(v).requires_grad_(), _t(t).requires_grad_()
    ts = {k: _t(x).requires_grad_() for k, x in sc.items()}
    loss = TE.vificlip_contrastive_loss(tv, tt, ts)
    loss.backward()
    _close(loss.detach().numpy(), _np(jl))
    _close(tv.grad.numpy(), _np(jg[0]))
    _close(tt.grad.numpy(), _np(jg[1]))
    for k in sc:
        np.testing.assert_allclose(float(ts[k].grad), float(jg[2][k]), rtol=1e-5, atol=1e-7)
    if scale_tactile > np.log(100.0):
        assert float(ts["tactile"].grad) == 0.0


def test_bf16_compute_matches_jax_bf16(rng):
    """Master weights in float32 computing in bf16 (``master_weights_``)
    against flax's ``dtype=bfloat16`` over the same float32 tree: video
    and text features at corr >= 0.9999; the parameters stay float32."""
    kw = _model_kw()
    m = _port_model(**kw)
    tree = _perturbed(FF.to_flax(m), rng)
    m = TV.master_weights_(FF.vificlip_model(tree, TVC, TTC, device="cpu", **kw), torch.bfloat16)
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    frames = rng.normal(size=(2, 2, 32, 32, 3)).astype(np.float32)
    ids, mask = _ids(rng, B=2)
    jm = JE.ViFiCLIPModel(vision_cfg=JVC, text_cfg=JTC, dtype=jnp.bfloat16, **kw)
    jv, jt, _ = jax.jit(jm.apply)({"params": tree}, jnp.asarray(frames), jnp.asarray(ids),
                                  jnp.asarray(mask))
    with torch.no_grad():
        v, t, _ = m(_t(frames), _t(ids), _t(mask))
    assert _corr(v.numpy(), _np(jv)) >= 0.9999
    assert _corr(t.numpy(), _np(jt)) >= 0.9999


# ---- the contrastive trainer ------------------------------------------------------------

def _contrastive_batches(rng, n=3):
    out = []
    for _ in range(n):
        ids, mask = _ids(rng, B=3, eos_at=(9, 11, 6))
        out.append({"frames": rng.normal(size=(3, 2, 32, 32, 3)).astype(np.float32),
                    "input_ids": ids, "attention_mask": mask})
    return out


@pytest.mark.parametrize("prompt,freeze", [(True, True), (False, False)])
def test_contrastive_steps_match_jax(rng, monkeypatch, prompt, freeze):
    """Three steps of ``train_vificlip_contrastive`` (float32, the trainer's
    lr 1e-4) against JAX's jitted trainer from the same tree: per-step
    losses within 1e-4
    relative, every parameter after them within 1e-5.  The attention key
    biases are the exception: softmax is invariant to a shift along the
    keys, so their gradient is 0 up to rounding and Adam turns each
    package's rounding noise into steps of up to lr; they are held to
    2 x 3 x lr.  A frozen text tower stays bit for bit what it was in both
    packages, and the optimizer holds no state for it (the vision tower
    and the scales train)."""
    kw = _model_kw(prompt=prompt)
    tree = _perturbed(FF.to_flax(_port_model(**kw)), rng)
    batches = _contrastive_batches(rng)
    jp, jl = JTE.train_vificlip_contrastive(
        batches, vision_cfg=JVC, text_cfg=JTC, freeze_text_encoder=freeze, params=tree,
        lr=1e-4, **kw)
    made = []

    class Recording(TTE.AdamW):
        def __init__(self, params, **a):
            params = list(params)
            super().__init__(params, **a)
            made.append(self)

    monkeypatch.setattr(TTE, "AdamW", Recording)
    m = FF.vificlip_model(tree, TVC, TTC, device="cpu", **kw)
    m, tl = TTE.train_vificlip_contrastive(batches, model=m, freeze_text_encoder=freeze,
                                           lr=1e-4, compute_dtype=torch.float32)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    got = FF.to_flax(m)
    for (path, g), (_, w) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                 jax.tree_util.tree_flatten_with_path(jax.tree.map(_np, jp))[0]):
        key_bias = [p.key for p in path[-2:]] == ["key", "bias"]
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * 3 * 1e-4 if key_bias else 1e-5,
                                   err_msg=str(path))
    (opt,) = made
    trained = {id(p) for p in opt.params}
    text = {id(p) for p in m.text.parameters()}
    assert (trained & text == set()) if freeze else (text <= trained)
    assert id(m.logit_scale_tactile) in trained and id(next(m.vision.parameters())) in trained
    if freeze:
        _tree_equal(got["text"], tree["text"])
        _tree_equal(jax.tree.map(_np, jp["text"]), tree["text"])
    assert not any(p.requires_grad for p in m.parameters())


# ---- data on disk: frames, samples, QA ---------------------------------------------------

def _frames_dir(path, n, seed, size=(32, 32), jump_at=None):
    """``n`` PNG frames that OpenCV writes (BGR on disk); from ``jump_at``
    on a brightness ramp (an active span for the salient-frame reduction)."""
    r = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    base = r.integers(60, 120, size=size + (3,)).astype(np.int32)
    for i in range(n):
        img = base + (0 if jump_at is None or i < jump_at else 25 * (i - jump_at + 1))
        cv2.imwrite(os.path.join(path, f"{i:03d}.png"), np.clip(img, 0, 255).astype(np.uint8))


def _write_sample(root, name, split, hardness, roughness, n_frames, seed):
    _frames_dir(os.path.join(root, name, "tactile"), n_frames, seed)
    with open(os.path.join(root, name, "data.json"), "w") as f:
        json.dump({"split": split, "properties": {"hardness": hardness, "roughness": roughness},
                   "object": name}, f)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """Five train samples of 3-6 frames (max_frames 4 spaces out the
    6-frame one; the 3-frame ones are padded), two test samples, one of
    another dataset."""
    root = str(tmp_path_factory.mktemp("samples"))
    specs = [(2.0, 8.0, 4), (8.0, 2.0, 3), (5.0, 5.0, 6), (3.5, 6.5, 4), (9.0, 1.0, 3)]
    for i, (h, r, n) in enumerate(specs):
        _write_sample(root, f"physiclear_obj{i}_0", "train", h, r, n, seed=i)
    _write_sample(root, "physiclear_objT_0", "test", 7.0, 3.0, 4, seed=10)
    _write_sample(root, "physiclear_objU_0", "test", 1.5, 9.0, 4, seed=11)
    _write_sample(root, "otherset_objX_0", "train", 1.0, 1.0, 4, seed=12)
    return root


def test_load_video_frames_shared_crop_matches_jax(tmp_path):
    """Frames OpenCV wrote, read as RGB in name order, ``max_frames``
    spaced out, and one random crop shared by the frames: equal arrays, and
    the generators end in the same state (the same draws, y then x)."""
    d = str(tmp_path / "v")
    _frames_dir(d, 7, seed=3, size=(40, 48))
    for max_frames, crop in ((None, 32), (4, 32), (4, None), (None, 48)):
        rj, rt = np.random.default_rng(5), np.random.default_rng(5)
        want = JD.load_video_frames(d, max_frames, rj, crop)
        got = TD.load_video_frames(d, max_frames, rt, crop)
        np.testing.assert_array_equal(got, want)
        assert rt.integers(1 << 30) == rj.integers(1 << 30)


def test_regression_dataset_batches_match_jax(data_root):
    """Two epochs of shuffled batches with both flips at p = 0.5 (padding
    by the first frame, the 6-frame sample spaced out), then the unshuffled
    test split: frames, properties, datasets and paths equal."""
    kw = dict(frame_size=32, max_frames=4, flip_p=0.5, seed=7)
    jd = JD.TactilePropertyRegressionDataset(data_root, "train", ["physiclear"], **kw)
    td = TD.TactilePropertyRegressionDataset(data_root, "train", ["physiclear"], **kw)
    assert len(td) == len(jd) == 5
    for _ in range(2):
        for jb, tb in zip(jd.batches(2), td.batches(2), strict=True):
            assert set(tb) == set(jb)
            for k in jb:
                np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(jb[k]), err_msg=k)
    kw = dict(frame_size=32, max_frames=4)
    jt = list(JD.TactilePropertyRegressionDataset(data_root, "test", ["physiclear"], **kw)
              .batches(8, shuffle=False))
    tt = list(TD.TactilePropertyRegressionDataset(data_root, "test", ["physiclear"], **kw)
              .batches(8, shuffle=False))
    np.testing.assert_array_equal(tt[0]["frames"], jt[0]["frames"])
    assert tt[0]["paths"] == jt[0]["paths"]


def test_llm_dataset_rows_match_jax(tmp_path, rng):
    """The split filter (a row without a split is a training row) and the
    RAG prefix of the nearest known objects: equal rows."""
    feats = rng.normal(size=(4, 8)).astype(np.float32)
    bank = TE.generate_rag_embeddings(feats, ["a", "b", "c", "d"])
    rows = [{"question": "q0 <tact>", "answer": "x", "tactile": ["t0"], "split": "train",
             "rag_query": feats[2].tolist()},
            {"question": "q1", "answer": "y", "tactile": ["t1"], "split": "test"},
            {"question": "q2 <tact>", "answer": "z", "tactile": ["t2"]}]
    path = TQA.write_qa_file(rows, str(tmp_path / "qa.json"))
    for split in ("train", "test"):
        for rag in (None, bank):
            jd = JD.TactileLLMDataset([path, path], split, rag_bank=rag, retrieval_num=2)
            td = TD.TactileLLMDataset([path, path], split, rag_bank=rag, retrieval_num=2)
            assert len(td) == len(jd)
            assert [td[i] for i in range(len(td))] == [jd[i] for i in range(len(jd))]


def test_physiclear_tables_match_jax(tmp_path):
    """The port's copy of the JSON is the JAX package's byte for byte, and
    every module attribute, bucketing, ranking string, split and registry
    is equal."""
    assert filecmp.cmp(TPC._DATA_PATH, JPC._DATA_PATH, shallow=False)
    for name in ("OBJECTS_WITH_PARTS", "TRAIN_OBJECTS", "VAL_OBJECTS", "TEST_OBJECTS",
                 "OBJECTS_PART_NAMES", "OPEN_SET_TEXTURES", "HARDNESS_RANK_REGRESSION",
                 "ROUGHNESS_RANK_REGRESSION", "SCENARIOS", "RATINGS"):
        assert getattr(TPC, name) == getattr(JPC, name), name
    with pytest.raises(AttributeError):
        TPC.NO_SUCH_TABLE
    for bins in (2, 3, 4, 5):
        for v in np.arange(-1.0, 11.5, 0.25):
            assert TPC.get_categorical_labels(float(v), bins) == \
                JPC.get_categorical_labels(float(v), bins)
    r = np.random.default_rng(4)
    names = list(JPC.HARDNESS_RANK_REGRESSION)
    for _ in range(20):
        ids = list(r.choice(names, size=int(r.integers(1, 6)), replace=False))
        labels = [f"{i + 1}" for i in range(len(ids))]
        for prop in ("hardness", "roughness"):
            for dec in (True, False):
                assert TPC.property_order(ids, labels, prop, dec) == \
                    JPC.property_order(ids, labels, prop, dec)
    for split in ("train", "val", "test"):
        assert TPC.split_objects(split) == JPC.split_objects(split)
        assert TPC.object_registry(split, str(tmp_path)) == \
            JPC.object_registry(split, str(tmp_path))


def test_simple_qa_rows_and_files_match_jax(tmp_path):
    """Description, ranking (seeded groups, both properties) and scenario
    rows equal, and ``write_qa_file`` writes the same bytes."""
    objects = JPC.object_registry("test", "t")
    rows = {}
    for pkg, Q in (("jax", JQA), ("port", TQA)):
        rows[pkg] = (Q.generate_description_qa(objects, "val")
                     + Q.generate_ranking_qa(objects, "hardness", 3, 5, "train", seed=3)
                     + Q.generate_ranking_qa(objects, "roughness", 4, 3, "test", seed=4)
                     + Q.generate_scenario_qa(objects))
        Q.write_qa_file(rows[pkg], str(tmp_path / pkg / "qa.json"))
    assert rows["port"] == rows["jax"]
    assert filecmp.cmp(tmp_path / "port" / "qa.json", tmp_path / "jax" / "qa.json",
                       shallow=False)


@pytest.fixture(scope="module")
def samples():
    """Every train and test object with 1-3 recording dirs (a
    ``{split}_samples.json`` registry)."""
    r = np.random.default_rng(9)
    return {o: [f"/d/{o}_{k}" for k in range(int(r.integers(1, 4)))]
            for o in JPC.TRAIN_OBJECTS + JPC.TEST_OBJECTS}


@pytest.mark.parametrize("use_parts", [False, True])
def test_physiclear_description_ranking_qa_matches_jax(samples, tmp_path, use_parts):
    """60 chat rows per seed (1-5 objects, optional 2-part objects; shuffled
    textures, rankings with ties), their LLM rows and their files: equal."""
    for seed, split in ((0, "train"), (5, "test")):
        kw = dict(split=split, use_parts=use_parts, seed=seed)
        want = JQA.generate_physiclear_description_ranking_qa(samples, 60, **kw)
        got = TQA.generate_physiclear_description_ranking_qa(samples, 60, **kw)
        assert got == want
        assert TQA.chat_rows_to_llm_rows(got) == JQA.chat_rows_to_llm_rows(want)
    TQA.write_qa_file(got, str(tmp_path / "p.json"))
    JQA.write_qa_file(want, str(tmp_path / "j.json"))
    assert filecmp.cmp(tmp_path / "p.json", tmp_path / "j.json", shallow=False)
    with pytest.raises(ValueError, match="no val objects"):
        TQA.generate_physiclear_description_ranking_qa(samples, 1, split="val")


def test_physiclear_scenario_qa_matches_jax(samples, caplog):
    """Scenario rows (target recording, lettered candidates, the follow-up
    turn) equal for two seeds and a scenario subset, and both warn alike
    when the unique recordings run out."""
    for seed, scen in ((0, None), (3, ["guess_touch_from_objects_balls"])):
        want = JQA.generate_physiclear_scenario_qa(samples, 6, scenarios=scen, seed=seed)
        got = TQA.generate_physiclear_scenario_qa(samples, 6, scenarios=scen, seed=seed)
        assert got == want
        assert TQA.chat_rows_to_llm_rows(got) == JQA.chat_rows_to_llm_rows(want)
    few = {o: v[:1] for o, v in samples.items()}
    with caplog.at_level("WARNING", logger="qa"):
        got = TQA.generate_physiclear_scenario_qa(few, 400, seed=1)
    assert got == JQA.generate_physiclear_scenario_qa(few, 400, seed=1)
    assert "exhausted" in caplog.text


# ---- raw corpora -> sample dirs -> registries ------------------------------------------------

def _tree_bytes(root):
    """relative path -> bytes of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def raw_root(tmp_path_factory):
    """A PhysiCLeAR layout (two procedures; train, val and test objects, one
    object the tables lack, a non-frame file), a hardness corpus (frame
    dirs and one MJPG video) and an ObjectFolder-real tree (a backup sample,
    a non-numeric id)."""
    root = str(tmp_path_factory.mktemp("raw"))
    pc = os.path.join(root, "physiclear")
    for e, ep in enumerate(("pressing", "sliding")):
        for j, (obj, k) in enumerate((("potato", 0), ("blanket", 1), ("eraser", 0),
                                      ("millet", 2), ("unknownthing", 0))):
            _frames_dir(os.path.join(pc, ep, f"{obj}_{k}"), 4 + j % 2, seed=10 * e + j,
                        jump_at=2)
        with open(os.path.join(pc, ep, "notes.txt"), "w") as f:
            f.write("x")
    hd = os.path.join(root, "hardness")
    for c, coll in enumerate(("c0", "c1")):
        for j in range(2):
            _frames_dir(os.path.join(hd, coll, f"gel{c}_{j}_x"), 3, seed=40 + 2 * c + j)
    video = cv2.VideoWriter(os.path.join(hd, "c1", "gel9_9_v.avi"),
                            cv2.VideoWriter_fourcc(*"MJPG"), 10, (32, 24))
    for i in range(5):
        video.write(np.full((24, 32, 3), 40 * i, np.uint8))
    video.release()
    of = os.path.join(root, "objectfolder")
    for oid in ("3", "17", "notanid"):
        for s in ("s0", "s1_backup"):
            _frames_dir(os.path.join(of, oid, "tactile_data", s, "0", "gelsight"), 3,
                        seed=60 + len(oid))
    return root


def _extract_both(raw_root, tmp_path):
    out = {}
    for pkg, P in (("jax", JPD), ("port", TPD)):
        o = str(tmp_path / pkg)
        counts = (P.extract_physiclear(os.path.join(raw_root, "physiclear"), o),
                  P.extract_hardness(os.path.join(raw_root, "hardness"), o),
                  P.extract_objectfolder(os.path.join(raw_root, "objectfolder"), o))
        out[pkg] = (o, counts)
    return out


def test_extract_corpora_match_jax(raw_root, tmp_path):
    """The three walkers write the same sample trees (frame files and
    ``data.json`` bytes, the video's frames through OpenCV) and return the
    same counts; ObjectFolder's names are equal."""
    out = _extract_both(raw_root, tmp_path)
    assert out["port"][1] == out["jax"][1] == (8, 5, 2)
    assert _tree_bytes(out["port"][0]) == _tree_bytes(out["jax"][0])
    assert TPD.objectfolder_names() == JPD.objectfolder_names()
    assert TPD.extract_recording(os.path.join(raw_root, "hardness", "c0", "gel0_0_x"),
                                 str(tmp_path / "one"), max_frames=2) == 2


def test_salient_reduction_and_registries_match_jax(raw_root, tmp_path):
    """``reduce_to_salient_spans`` keeps the same frames, and
    ``build_samples_json`` (the tables' splits, a seeded per-object holdout
    for the unrated corpora) writes the same registries."""
    out = _extract_both(raw_root, tmp_path)
    reduced = {pkg: P.reduce_to_salient_spans(out[pkg][0], threshold=2.0, top_k=3)
               for pkg, P in (("jax", JPD), ("port", TPD))}
    assert reduced["port"] == reduced["jax"] > 0
    assert _tree_bytes(out["port"][0]) == _tree_bytes(out["jax"][0])
    shutil.rmtree(out["jax"][0])
    o = out["port"][0]
    regs = {}
    for pkg, P in (("jax", JPD), ("port", TPD)):
        paths = [str(tmp_path / "reg" / pkg / f"{s}_samples.json") for s in ("train", "val", "test")]
        regs[pkg] = P.build_samples_json(o, *paths, holdout_frac=0.5, seed=2)
    assert regs["port"] == regs["jax"]
    assert _tree_bytes(tmp_path / "reg" / "port") == _tree_bytes(tmp_path / "reg" / "jax")


def test_eval_metrics_match_jax(rng):
    """Ranking parse and Kendall tau, scenario accuracy, threshold accuracy
    and pairwise success (with ties) equal."""
    items = ["cup", "sponge", "rock"]
    texts = ["The ROCK is harder than the cup, the sponge is softest", "cup then rock",
             "sponge, cup, rock"]
    preds = [TEV.parse_ranking(t, items) for t in texts]
    assert preds == [JEV.parse_ranking(t, items) for t in texts]
    gt = [["rock", "cup", "sponge"]] * 3
    assert TEV.evaluate_ranking(preds, gt) == JEV.evaluate_ranking(preds, gt)
    assert TEV.evaluate_ranking([], []) == JEV.evaluate_ranking([], [])
    reasoning = (["Answer: object A is it", "object b", None, "the sponge"],
                 ["object a", "object c", "object a", "sponge"])
    assert TEV.evaluate_reasoning(*reasoning) == JEV.evaluate_reasoning(*reasoning)
    p = np.round(rng.uniform(0, 10, 12), 1)
    lab = np.round(rng.uniform(0, 10, 12))
    for th in (2.0, 5.0):
        assert TEV.threshold_classification_accuracy(p, lab, th) == \
            JEV.threshold_classification_accuracy(p, lab, th)
    assert TEV.pairwise_comparison_success(p, lab) == JEV.pairwise_comparison_success(p, lab)
    assert TEV.pairwise_comparison_success([1.0], [2.0]) == 1.0


# ---- the property trainer, evaluation and the encoder's directory -------------------------

def _jax_state(st):
    """The port's ``TactileEncoderState`` as the JAX package's (float32
    trees through ``to_flax``)."""
    return JE.TactileEncoderState(
        cfg=JVC, clip_params=FF.to_flax(st.clip),
        adapter_params={s: FF.to_flax(a) for s, a in st.adapters.items()},
        classifier_params=FF.to_flax(st.classifier), feature_dim=st.feature_dim)


def _state_trees(st):
    return {"clip": FF.to_flax(st.clip),
            "adapters": {s: FF.to_flax(a) for s, a in st.adapters.items()},
            "classifier": FF.to_flax(st.classifier)}


@pytest.fixture(scope="module")
def trained(data_root, tmp_path_factory):
    """Both packages' property trainers, 2 epochs of batch 2 (6 steps: the
    log holds steps 0 and 5) from one seeded state."""
    out = tmp_path_factory.mktemp("trained")
    st = TE.init_tactile_encoder(TVC, seed=3, device="cpu", dtype=torch.float32)
    kw = dict(datasets=("physiclear",), epochs=2, batch_size=2, lr=1e-3, frame_size=32,
              max_frames=4, seed=5, sensor="plain")
    js = JTE.train_property_encoder(data_root, str(out / "jax"), cfg=JVC, state=_jax_state(st),
                                    **kw)
    ts = TTE.train_property_encoder(data_root, str(out / "port"), state=st, **kw)
    return js, ts, out


def test_property_trainer_matches_jax(trained):
    """The logged losses within 1e-4 relative and every adapter (the other
    sensor's decays alone) and classifier leaf after 6 steps within 1e-5;
    the CLIP tower untouched; the same log lines."""
    js, ts, out = trained

    def log(pkg):
        with open(out / pkg / "training.jsonl") as f:
            return [json.loads(line) for line in f]

    jl, tl = log("jax"), log("port")
    assert [(r["step"], r["epoch"]) for r in tl] == [(r["step"], r["epoch"]) for r in jl] == \
        [(0, 0), (5, 1)]
    np.testing.assert_allclose([r["loss"] for r in tl], [r["loss"] for r in jl], rtol=1e-4)
    got = _state_trees(ts)
    want = {"clip": js.clip_params, "adapters": js.adapter_params,
            "classifier": js.classifier_params}
    for (path, g), (_, w) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                 jax.tree_util.tree_flatten_with_path(
                                     jax.tree.map(_np, want))[0]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=str(path))
    assert not any(p.requires_grad for p in ts.classifier.parameters())


def test_evaluate_encoder_matches_jax(trained, data_root):
    """Threshold accuracy, both pairwise successes and the sample count
    equal, the MSE within 1e-5 relative."""
    js, ts, _ = trained
    kw = dict(datasets=("physiclear",), split="test", frame_size=32, max_frames=4,
              sensor="plain")
    want, got = JTE.evaluate_encoder(js, data_root, **kw), TTE.evaluate_encoder(ts, data_root, **kw)
    assert set(got) == set(want)
    np.testing.assert_allclose(got.pop("mse"), want.pop("mse"), rtol=1e-5)
    assert got == want and got["num_samples"] == 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_encoder_directory_loads_across_packages(trained, writer):
    """An encoder directory written by either package (the trainers' saves)
    loads in the other bit for bit, and the port writes JAX's bytes."""
    js, ts, out = trained
    path = str(out / writer / "encoder")
    if writer == "port":
        got = JE.load_tactile_encoder(path)
        want = _state_trees(ts)
        _tree_equal({"clip": jax.tree.map(np.asarray, got.clip_params),
                     "adapters": jax.tree.map(np.asarray, got.adapter_params),
                     "classifier": jax.tree.map(np.asarray, got.classifier_params)}, want)
        JE.save_tactile_encoder(str(out / "again"), got)
        for f in ("clip.msgpack", "adapters.msgpack", "classifier.msgpack", "meta.json"):
            assert filecmp.cmp(os.path.join(path, f), out / "again" / f, shallow=False), f
    else:
        got = TE.load_tactile_encoder(path, device="cpu", dtype=torch.float32)
        assert got.cfg == TVC and got.feature_dim == js.feature_dim
        _tree_equal(_state_trees(got), {"clip": jax.tree.map(_np, js.clip_params),
                                        "adapters": jax.tree.map(_np, js.adapter_params),
                                        "classifier": jax.tree.map(_np, js.classifier_params)})


# ---- hygiene --------------------------------------------------------------------------------

def test_tactile_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch, trained,
                                                                 data_root, tmp_path):
    """Without CUDA the trainers, the model's init and converter and the
    encoder loader raise unless given the CPU (or a CPU state / model)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ts, out = trained
    batch = _contrastive_batches(np.random.default_rng(0), 1)
    for call in (lambda: TE.init_vificlip_model(TVC, TTC),
                 lambda: TTE.train_vificlip_contrastive(batch, vision_cfg=TVC, text_cfg=TTC),
                 lambda: TTE.train_property_encoder(data_root, str(tmp_path), cfg=TVC),
                 lambda: TE.load_tactile_encoder(str(out / "port" / "encoder")),
                 lambda: FF.vificlip_model(FF.to_flax(_port_model()), TVC, TTC)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    m, losses = TTE.train_vificlip_contrastive(
        batch, vision_cfg=TVC, text_cfg=TTC, num_prompts=N_PROMPTS, prompt_depth_vision=2,
        prompt_depth_text=2, device="cpu", compute_dtype=torch.float32)
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert TE.load_tactile_encoder(str(out / "port" / "encoder"), device="cpu").clip is not None
    with pytest.raises(ValueError, match="no contrastive batches"):
        TTE.train_vificlip_contrastive([], device="cpu")
