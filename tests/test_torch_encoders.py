"""PyTorch port, the encoders off the control tick: the T5 v1.1 encoder (RDT's
language tower), the instruction-embedding tools, and the Sparsh tactile
ViT, against the JAX package on the same numpy-seeded weights (CPU).

Small widths: ``t5_tiny`` and a 3-layer T5 (d_model 48, d_kv 16, d_ff 80,
4 heads, vocabulary 96); Sparsh at 32^2, one layer, 32 wide, 6 channels.
Tolerances: T5 float32 2e-5 abs (the same float32 arithmetic in another
order); bf16 one bf16 step at the outputs' top, 2^-7 x max|JAX| (JAX and
the port round the same operations to bf16; the measured worst is one ulp
of a 0.5..1 value); the bucket map exactly; Sparsh's CLS 1e-5.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

from vla_touch_tpu.models.encoders import t5 as JT5
from vla_touch_tpu.models.encoders import t5_native as JT
from vla_touch_tpu_torch.models.encoders import t5 as TT5
from vla_touch_tpu_torch.models.encoders import t5_native as TT
from vla_touch_tpu_torch.utils import from_flax as FF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=96, d_model=48, d_kv=16, d_ff=80, num_layers=3, num_heads=4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(name):
    if name == "tiny":
        return JT.t5_tiny(), TT.t5_tiny()
    return JT.T5EncoderConfig(**SMALL), TT.T5EncoderConfig(**SMALL)


def _port_t5(cfg, params):
    with torch.device("meta"):
        m = TT.T5Encoder(cfg)
    m = FF.load_into(m.to_empty(device="cpu"), FF.t5_encoder(_np_tree(params)))
    return m.eval().requires_grad_(False)


@pytest.fixture(scope="module", params=["tiny", "small"])
def t5_pair(request):
    jcfg, tcfg = _configs(request.param)
    params = _np_tree(JT.init_t5_encoder(jcfg, jax.random.PRNGKey(3)))
    return jcfg, tcfg, params, _port_t5(tcfg, params)


class FakeTok:
    """``tests/test_t5_native.py``'s tokenizer: bytes folded into the
    vocabulary, EOS (1) appended."""

    def __call__(self, text, truncation=True, max_length=1024):
        ids = [ord(c) % 90 + 3 for c in text][: max_length - 1] + [1]
        return {"input_ids": ids, "attention_mask": [1] * len(ids)}


# ---- T5 ------------------------------------------------------------------------------


@pytest.mark.parametrize("q,k", [(23, 23), (1024, 1024), (1, 77), (77, 1)])
def test_bucket_map_equals_jax_exactly(q, k):
    got = TT.relative_position_buckets(q, k, 32, 128)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JT.relative_position_buckets(q, k, 32, 128)))


def test_bucket_map_lands_on_the_boundaries_as_jax():
    """At relative distances 16, 32 and 64 the float32 log lands on a bucket
    boundary: JAX's order keeps it there (buckets 10, 12, 14 forward), which
    dividing first does not."""
    b = TT.relative_position_buckets(1, 129, 32, 128)[0].numpy()
    assert [b[16], b[32], b[64], b[15], b[128]] == [26, 28, 30, 25, 31]
    assert int(TT.relative_position_buckets(17, 1, 32, 128)[16, 0]) == 10


def _ids(rng, cfg, B=2, L=17):
    ids = rng.integers(0, cfg.vocab_size, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 11:] = 0
    return ids, mask


def test_t5_encode_float32_matches_jax(t5_pair, rng):
    jcfg, tcfg, params, module = t5_pair
    ids, mask = _ids(rng, jcfg)
    want = np.asarray(JT.t5_encode(jcfg, params, jnp.asarray(ids), jnp.asarray(mask)))
    got = TT.t5_encode(tcfg, module, torch.as_tensor(ids), torch.as_tensor(mask))
    assert got.dtype == torch.float32
    got = got.numpy()
    # the padded row on its valid positions (padded positions attend
    # differently in HF and carry no meaning)
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=0)
    np.testing.assert_allclose(got[1, :11], want[1, :11], atol=2e-5, rtol=0)
    # the module's forward is the same program
    np.testing.assert_array_equal(module(torch.as_tensor(ids), torch.as_tensor(mask)).numpy(),
                                  got)


def test_t5_encode_bf16_matches_jax(t5_pair, rng):
    jcfg, tcfg, params, module = t5_pair
    ids, mask = _ids(rng, jcfg)
    want = np.asarray(JT.t5_encode(jcfg, params, jnp.asarray(ids), jnp.asarray(mask),
                                   dtype=jnp.bfloat16)).astype(np.float32)
    for mod, dtype in ((module, torch.bfloat16),
                       (TT.set_dtype_(_port_t5(tcfg, params), torch.bfloat16), None)):
        got = TT.t5_encode(tcfg, mod, torch.as_tensor(ids), torch.as_tensor(mask), dtype)
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        tol = 2.0 ** -7 * np.abs(want).max()
        np.testing.assert_allclose(got[0], want[0], atol=tol, rtol=0)
        np.testing.assert_allclose(got[1, :11], want[1, :11], atol=tol, rtol=0)
    bf = TT.set_dtype_(_port_t5(tcfg, params), torch.bfloat16)
    assert bf.embed.dtype == bf.layers[0].q.weight.dtype == torch.bfloat16
    assert bf.rel_bias.dtype == bf.layers[0].norm1.dtype == bf.final_norm.dtype == torch.float32


def _t5_state_from_manifest(layers):
    """The T5-XXL manifest's keys of its first ``layers`` blocks, each a
    seeded array of the key's rank with every dimension cut to at most 5."""
    import json
    import re

    man = json.load(open(os.path.join(ROOT, "vla_touch_tpu_torch", "data", "hf_manifests",
                                      "t5_v1_1_xxl.json")))
    r = np.random.default_rng(11)
    out = {}
    for k, shape in man.items():
        m = re.search(r"block\.(\d+)\.", k)
        if m and int(m.group(1)) >= layers:
            continue
        out[k] = r.normal(size=[min(d, 5) for d in shape]).astype(np.float32)
    return man, out


def test_t5_from_hf_covers_the_manifest_and_equals_jax():
    man, sd = _t5_state_from_manifest(layers=3)
    seen = set()

    class Tracked(dict):
        def __getitem__(self, k):
            seen.add(k)
            return dict.__getitem__(self, k)

    tree = TT.t5_from_hf(Tracked(sd), num_layers=3)
    # shared.weight is the embedding; encoder.embed_tokens.weight is its tie
    assert set(sd) - seen == {"encoder.embed_tokens.weight"}
    want = JT.t5_from_hf(sd, num_layers=3)
    assert jax.tree.structure(_np_tree(want)) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(_np_tree(want))):
        np.testing.assert_array_equal(a, b)
    # at full width: every manifest key lands in a T5Encoder(t5_v1_1_xxl) leaf of its shape
    cfg = TT.t5_v1_1_xxl()
    empty = {k: np.empty(v, np.dtype([])) for k, v in man.items()}
    got = {k: v.shape for k, v in FF.t5_encoder(TT.t5_from_hf(empty, 24)).items()}
    with torch.device("meta"):
        meta = {k: tuple(v.shape) for k, v in TT.T5Encoder(cfg).state_dict().items()}
    assert got == meta
    n = sum(int(np.prod(s)) for s in meta.values())
    assert 4.7e9 < n < 4.8e9                      # 4.76 B parameters


def test_t5_init_is_seeded_and_keeps_norms_in_float32():
    cfg = TT.t5_tiny()
    a = TT.init_t5_encoder(cfg, seed=4, device="cpu", dtype=torch.bfloat16)
    b = TT.init_t5_encoder(cfg, seed=4, device="cpu", dtype=torch.bfloat16)
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k
    assert a.embed.dtype == torch.bfloat16 and a.layers[1].wo.weight.dtype == torch.bfloat16
    assert a.layers[0].norm2.dtype == a.rel_bias.dtype == torch.float32
    assert float(a.layers[0].norm1.min()) == float(a.final_norm.max()) == 1.0
    assert 0.8 < float(a.embed.float().std()) < 1.2          # N(0, 1), as JAX's init
    assert 0.05 < float(a.rel_bias.std()) < 0.15             # N(0, 0.1^2)
    assert not any(p.requires_grad for p in a.parameters())


def test_load_t5_encoder_reads_an_hf_file(tmp_path):
    from vla_touch_tpu_torch.utils import safetensors_io as ST

    _, tcfg = _configs("small")
    params = _np_tree(JT.init_t5_encoder(JT.T5EncoderConfig(**SMALL), jax.random.PRNGKey(1)))
    hf = {"shared.weight": params["embed"],
          "encoder.final_layer_norm.weight": params["final_norm"],
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
              params["rel_bias"]}
    for i, lp in enumerate(params["layers"]):
        p = f"encoder.block.{i}.layer"
        hf[f"{p}.0.layer_norm.weight"] = lp["norm1"]
        hf[f"{p}.1.layer_norm.weight"] = lp["norm2"]
        for n in "qkvo":
            hf[f"{p}.0.SelfAttention.{n}.weight"] = lp[n].T
        for n in ("wi_0", "wi_1", "wo"):
            hf[f"{p}.1.DenseReluDense.{n}.weight"] = lp[n].T
    path = str(tmp_path / "model.safetensors")
    ST.save_file({k: torch.from_numpy(np.array(v)) for k, v in hf.items()}, path)
    m = TT.load_t5_encoder(path, tcfg, device="cpu", dtype=torch.float32)
    want = _port_t5(tcfg, params).state_dict()
    for k, v in m.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_native_embedder_and_language_encoder_match_jax(tmp_path):
    jcfg, tcfg = _configs("small")
    params = _np_tree(JT.init_t5_encoder(jcfg, jax.random.PRNGKey(2)))
    jemb = JT.NativeT5Embedder(jcfg, params, FakeTok(), dtype=jnp.float32)
    temb = TT.NativeT5Embedder(tcfg, _port_t5(tcfg, params), FakeTok(), dtype=torch.float32,
                               device="cpu")
    jenc, tenc = JT5.LanguageEncoder(jemb), TT5.LanguageEncoder(temb)
    texts = ["wipe the table", "pick up the mango", "x"]
    want, got = jenc.encode_instructions(texts), tenc.encode_instructions(texts)
    assert got["all_instructions"] == texts
    for t in texts:
        assert got[t].dtype == np.float32 and got[t].shape == (len(t) + 1, jcfg.d_model)
        np.testing.assert_allclose(got[t], want[t], atol=2e-5, rtol=0)
    np.testing.assert_array_equal(tenc.encode_instruction(texts[1]), got[texts[1]])
    # truncation at max_length
    short = TT.NativeT5Embedder(tcfg, temb.module, FakeTok(), max_length=5,
                                dtype=torch.float32, device="cpu")
    assert short.get_text_embeddings(["a long instruction"])[0].shape == (5, jcfg.d_model)
    # the directory surface
    for root in ("jax", "port"):
        for i, t in enumerate(["open the drawer", "", "press the button"]):
            d = tmp_path / root / f"episode_{i}"
            d.mkdir(parents=True)
            if t:
                (d / "instruction.txt").write_text(t + "\n")
        (tmp_path / root / "notes.txt").write_text("not an episode")
    jw, tw = jenc.encode_directory(str(tmp_path / "jax")), tenc.encode_directory(
        str(tmp_path / "port"))
    assert [os.path.relpath(p, tmp_path / "port") for p in tw] == \
        [os.path.relpath(p, tmp_path / "jax") for p in jw] == \
        ["episode_0/instruct_lang.npy", "episode_2/instruct_lang.npy"]
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(np.load(a), np.load(b), atol=2e-5, rtol=0)


def test_instruction_dicts_cross_the_packages(tmp_path, rng):
    d = {"all_instructions": ["wipe", "pick up the mango"],
         "wipe": rng.normal(size=(5, 8)).astype(np.float32),
         "pick up the mango": rng.normal(size=(18, 8)).astype(np.float32)}
    TT5.save_instruction_dict(str(tmp_path / "port.npz"), d)
    JT5.save_instruction_dict(str(tmp_path / "jax.npz"), d)
    for got in (JT5.load_instruction_dict(str(tmp_path / "port.npz")),
                TT5.load_instruction_dict(str(tmp_path / "jax.npz")),
                TT5.load_instruction_dict(str(tmp_path / "port.npz"))):
        assert got["all_instructions"] == d["all_instructions"]
        for k in d["all_instructions"]:
            np.testing.assert_array_equal(got[k], d[k])


def test_language_cli_writes_the_dict_and_the_directory(tmp_path, capsys):
    _, tcfg = _configs("tiny")
    emb = TT.NativeT5Embedder(tcfg, TT.init_t5_encoder(tcfg, 0, device="cpu"), FakeTok(),
                              dtype=torch.float32, device="cpu")
    (tmp_path / "eps" / "ep0").mkdir(parents=True)
    (tmp_path / "eps" / "ep0" / "instruction.txt").write_text("stack the cups")
    out = str(tmp_path / "ins.npz")
    TT5.main(["--instruction", "a", "--instruction", "bb", "--episodes_dir",
              str(tmp_path / "eps"), "--out", out], embedder=emb)
    d = JT5.load_instruction_dict(out)
    assert d["all_instructions"] == ["a", "bb"] and d["bb"].shape == (3, tcfg.d_model)
    assert np.load(tmp_path / "eps" / "ep0" / "instruct_lang.npy").shape == (15, tcfg.d_model)
    assert "wrote 2 instructions" in capsys.readouterr().out


def test_hf_t5_embedder_matches_the_native_encoder(tmp_path, rng):
    """``T5Embedder`` over a tiny random ``transformers.T5EncoderModel`` (given,
    and read from a local directory) equals the port's encoder on the
    model's weights through ``t5_from_hf``."""
    transformers = pytest.importorskip("transformers")

    torch.manual_seed(0)
    ref = transformers.T5EncoderModel(transformers.T5Config(
        vocab_size=96, d_model=48, d_kv=16, d_ff=80, num_layers=3, num_heads=4,
        relative_attention_num_buckets=32, relative_attention_max_distance=128,
        feed_forward_proj="gated-gelu", dropout_rate=0.0, is_encoder_decoder=False,
        use_cache=False)).eval()
    _, tcfg = _configs("small")
    sd = {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    native = TT.NativeT5Embedder(tcfg, _port_t5(tcfg, TT.t5_from_hf(sd, 3)), FakeTok(),
                                 dtype=torch.float32, device="cpu")

    class PtTok(FakeTok):
        def __call__(self, text, return_tensors=None, truncation=True, max_length=1024):
            return {k: torch.tensor([v]) for k, v in super().__call__(
                text, truncation, max_length).items()}

    ref.save_pretrained(str(tmp_path / "t5"))
    texts = ["wipe the table", "pick up the mango"]
    want = native.get_text_embeddings(texts)
    for emb in (TT5.T5Embedder(model=ref, tokenizer=PtTok(), device="cpu"),
                TT5.T5Embedder(str(tmp_path / "t5"), tokenizer=PtTok(), device="cpu")):
        for g, w in zip(emb.get_text_embeddings(texts), want):
            np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-3)


def test_hf_t5_embedder_needs_transformers_without_a_model(monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="transformers"):
        TT5.T5Embedder("some/dir", device="cpu")


# ---- Sparsh ---------------------------------------------------------------------------


def _sparsh_cfgs():
    from vla_touch_tpu.models.encoders.vit import ViTConfig as JViT
    from vla_touch_tpu_torch.models.encoders.vit import ViTConfig as TViT

    kw = dict(hidden_size=32, num_layers=1, num_heads=4, mlp_dim=64, patch_size=16,
              image_size=32, num_channels=6, use_layerscale=False)
    return JViT(**kw), TViT(**kw)


def test_sparsh_cls_matches_jax(rng):
    from vla_touch_tpu.models.encoders import sparsh as JS
    from vla_touch_tpu_torch.models.encoders import sparsh as TS

    jcfg, tcfg = _sparsh_cfgs()
    params = JS.load_pretrained_encoder(None, cfg=jcfg)
    x = rng.normal(size=(2, 32, 32, 6)).astype(np.float32)
    want = np.asarray(JS.SparshEncoder(jcfg).apply({"params": params}, jnp.asarray(x)))
    m = TS.load_pretrained_encoder(None, cfg=tcfg, device="cpu", dtype=torch.float32)
    m = FF.load_into(m, FF.vit(_np_tree(params)))
    got = m(torch.as_tensor(x)).numpy()
    assert got.shape == (2, 32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert TS.SPARSH_VIT_B == TS.ViTConfig(hidden_size=768, num_layers=12, num_heads=12,
                                            mlp_dim=3072, patch_size=16, image_size=240,
                                            num_channels=6, use_layerscale=False)
    with torch.device("meta"):
        assert TS.SparshEncoder().vit.pos_embed.shape == (1, 226, 768)   # 15^2 + CLS


def _timm_state(seed=0, D=32, F=64, p=16, C=6, n=4):
    r = np.random.default_rng(seed)

    def a(*s):
        return torch.from_numpy(r.normal(size=s).astype(np.float32))

    sd = {"model.patch_embed.proj.weight": a(D, C, p, p), "model.patch_embed.proj.bias": a(D),
          "module.pos_embed": a(1, n + 1, D), "cls_token": a(1, 1, D),
          "model.norm.weight": a(D), "model.norm.bias": a(D),
          "model.mask_token": a(1, 1, D)}     # an MAE leaf the ViT has not: both ignore it
    pre = "module.blocks.0."
    for n_, s in (("norm1", (D,)), ("norm2", (D,))):
        sd[pre + n_ + ".weight"], sd[pre + n_ + ".bias"] = a(*s), a(*s)
    sd[pre + "attn.qkv.weight"], sd[pre + "attn.qkv.bias"] = a(3 * D, D), a(3 * D)
    sd[pre + "attn.proj.weight"], sd[pre + "attn.proj.bias"] = a(D, D), a(D)
    sd[pre + "mlp.fc1.weight"], sd[pre + "mlp.fc1.bias"] = a(F, D), a(F)
    sd[pre + "mlp.fc2.weight"], sd[pre + "mlp.fc2.bias"] = a(D, F), a(D)
    return sd


def test_sparsh_loader_reads_a_timm_checkpoint_as_jax(tmp_path, rng):
    from vla_touch_tpu.models.encoders import sparsh as JS
    from vla_touch_tpu_torch.models.encoders import sparsh as TS

    jcfg, tcfg = _sparsh_cfgs()
    path = str(tmp_path / "sparsh.pth")
    sd = _timm_state()
    torch.save(sd, path)
    jparams = _np_tree(JS.load_pretrained_encoder(path, cfg=jcfg))
    m = TS.load_pretrained_encoder(path, cfg=tcfg, device="cpu", dtype=torch.float32)
    want = FF.vit(jparams)
    got = m.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    np.testing.assert_array_equal(got["vit.blocks.0.attention.key.weight"].numpy(),
                                  sd["module.blocks.0.attn.qkv.weight"][32:64].numpy())
    x = rng.normal(size=(2, 32, 32, 6)).astype(np.float32)
    np.testing.assert_allclose(
        m(torch.as_tensor(x)).numpy(),
        np.asarray(JS.SparshEncoder(jcfg).apply({"params": jparams}, jnp.asarray(x))),
        atol=1e-5, rtol=0)


def test_sparsh_strip_prefix_equals_jax():
    from vla_touch_tpu.models.encoders import sparsh as JS
    from vla_touch_tpu_torch.models.encoders import sparsh as TS

    sd = {"model.blocks.0.norm1.weight": 1, "module.pos_embed": 2, "cls_token": 3,
          "model.module.encoder.norm.bias": 4, "encoder.model.x": 5}
    assert TS.strip_prefix(sd) == JS.strip_prefix(sd)
    assert set(TS.strip_prefix(sd)) == {"blocks.0.norm1.weight", "pos_embed", "cls_token",
                                        "norm.bias", "model.x"}


# ---- imports and devices ----------------------------------------------------------------

NEW_MODULES = ["models.encoders.t5_native", "models.encoders.t5", "models.encoders.sparsh",
               "utils.hub", "utils.filelock", "utils.geometry", "eval.visualize",
               "eval.warm_quality", "eval.bridge_test", "eval.lstm_step_test",
               "ops.marker_tracking", "train.rdt_loop", "utils.checkpoint_manifest"]


def test_new_modules_import_no_jax_and_no_optional_package():
    """Importing the slice's modules loads neither JAX, the JAX package, nor
    ``transformers``, ``huggingface_hub`` or ``matplotlib``."""
    code = ("import importlib, sys\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    importlib.import_module('vla_touch_tpu_torch.' + m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'vla_touch_tpu', 'transformers', 'huggingface_hub',\n"
            "              'matplotlib', 'flax'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], check=True, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=ROOT)).stdout
    assert out.strip() == "[]"
    for m in NEW_MODULES:
        src = open(os.path.join(ROOT, "vla_touch_tpu_torch", *m.split(".")) + ".py").read()
        assert "vla_touch_tpu." not in src and "import jax" not in src, m


def test_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    from vla_touch_tpu_torch.eval import warm_quality as WQ
    from vla_touch_tpu_torch.models.encoders import sparsh as TS

    cfg = TT.t5_tiny()
    cpu = TT.init_t5_encoder(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TT.init_t5_encoder(cfg),
                 lambda: TT.NativeT5Embedder(cfg, cpu, FakeTok()),
                 lambda: TT.load_t5_encoder(str(tmp_path / "none.safetensors"), cfg),
                 lambda: TT5.T5Embedder(model=torch.nn.Linear(1, 1), tokenizer=FakeTok()),
                 lambda: TT5.main(["--instruction", "a"]),
                 lambda: TS.load_pretrained_encoder(None, cfg=_sparsh_cfgs()[1]),
                 lambda: WQ.run()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    emb = TT.NativeT5Embedder(cfg, cpu, FakeTok(), device="cpu")
    assert emb.get_text_embeddings(["hi"])[0].shape == (3, cfg.d_model)
    assert TS.load_pretrained_encoder(None, cfg=_sparsh_cfgs()[1], device="cpu") \
        .vit.pos_embed.device.type == "cpu"
