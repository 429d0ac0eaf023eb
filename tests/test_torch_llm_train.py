"""PyTorch port, the planner's LLM training against the JAX package on the
CPU: K8's and K9's autograd Functions against JAX's custom_vjps (the Pallas
kernels in interpret mode), the amax-only gradient of the quantized
products pinned in both packages, LoRA's init, ``lm_loss`` and its
gradients, ``make_llm_interface().loss_fn`` on spliced embeddings,
``train_lm``, ``train_projection``, ``train_projection_and_lora`` on a
float32 and a grouped-int4 base, ``test_llm`` and the msgpack files both
ways.

Inputs come from numpy seeds and JAX's own draws; JAX trees convert through
``utils/from_flax.py``.  Tolerances are stated per test.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vla_touch_tpu.models.encoders import vit as JV
from vla_touch_tpu.ops import pallas_matmul as JPM
from vla_touch_tpu.ops import quant as JQ
from vla_touch_tpu.planning import datasets as JD
from vla_touch_tpu.planning import encoder as JE
from vla_touch_tpu.planning import llm as JL
from vla_touch_tpu.planning import llm_splice as JS
from vla_touch_tpu.planning import run_llm as JR
from vla_touch_tpu.utils import checkpoint as JC
from vla_touch_tpu_torch.ops import quant as TQ
from vla_touch_tpu_torch.ops import quant_matmul as QM
from vla_touch_tpu_torch.ops import w4_fused as W4F
from vla_touch_tpu_torch.planning import datasets as TD
from vla_touch_tpu_torch.planning import llm as TL
from vla_touch_tpu_torch.planning import llm_splice as TS
from vla_touch_tpu_torch.planning import run_llm as TR
from vla_touch_tpu_torch.utils import checkpoint as TC
from vla_touch_tpu_torch.utils import from_flax as FF

CFG = JL.qwen2_tiny()
TCFG = TL.qwen2_tiny()
# a base whose every projection quantizes to grouped int4 (K 256 and 512:
# group 128, even group counts)
W4_KW = dict(hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2, mlp_dim=512)
CLIP_KW = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128, patch_size=16,
               image_size=32, use_layerscale=False, quick_gelu=True, use_pre_norm=True,
               layernorm_eps=1e-5, patch_bias=False)
FRAME = 32
BF16 = jnp.bfloat16


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _t(a, dtype=None):
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def _leaf(qp):
    return FF._llm_leaf(dict(qp), "cpu")


def _w4_leaf(rng, K, N, bias=True):
    p = {"kernel": rng.normal(size=(K, N)).astype(np.float32) * 0.05}
    if bias:
        p["bias"] = rng.normal(size=(N,)).astype(np.float32) * 0.01
    return JQ.quantize_linear_w4(p)


# ---- K8 and K9 under autograd -------------------------------------------------------

@pytest.mark.parametrize("M", [3, 600])
def test_w4a8_fn_grad_matches_jax_custom_vjp(rng, M):
    """``qdense_kernel_w4`` under grad (M 3: ``W4A8MatmulFn``, K8's plain
    version forward, the plain vjp backward; M 600: the plain dequantized
    route) against ``jax.grad`` of ``qdense_pallas_w4(..., interpret=True)``
    (M 3: ``_w4a8_matmul_diff``; M 600: XLA's ``qdense_w4``) at
    ``tests/test_quant.py``'s shapes, bf16 out, a fixed cotangent: x's and
    the bias's gradients, rtol 1e-6, atol 1e-7 (the float32 sum over N in
    another order)."""
    K, N = 256, 128
    qp = _w4_leaf(rng, K, N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    c = rng.normal(size=(M, N)).astype(np.float32)

    def f(xx, bb):
        q = dict(qp, bias=bb)
        return jnp.sum(JPM.qdense_pallas_w4(xx, q, out_dtype=BF16, interpret=True)
                       .astype(jnp.float32) * c)

    gx, gb = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), qp["bias"])
    leaf = _leaf(qp)
    tx = _t(x).requires_grad_(True)
    bias = leaf.bias.clone().requires_grad_(True)
    y = QM.qdense_kernel_w4(tx, TQ.QLinearW4(leaf.w4_pack, leaf.scale4, bias))
    assert y.dtype == torch.bfloat16
    assert (y.grad_fn.name() == "W4A8MatmulFnBackward") == (M <= 512)
    (y.float() * _t(c)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), _np(gx), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bias.grad.numpy(), _np(gb), rtol=1e-6, atol=1e-7)


def test_w4_swiglu_fn_grad_matches_jax_custom_vjp(rng):
    """``qdense_kernel_swiglu`` under grad (``W4SwigluFn``: K9's plain
    version forward, the vjp of ``w4_swiglu_plain`` backward) against
    ``jax.grad`` of ``qdense_pallas_swiglu(..., interpret=True)``
    (``_w4_swiglu_diff``) at ``tests/test_quant.py``'s K 256, F 512, N 256,
    M 2, bf16 out, a fixed cotangent: rtol 1e-6, atol 1e-7; the forward
    within one bf16 step of the interpret kernel's."""
    K, F, N = 256, 512, 256
    gu = _w4_leaf(rng, K, 2 * F, bias=False)
    down = _w4_leaf(rng, F, N, bias=False)
    x = rng.normal(size=(2, K)).astype(np.float32)
    c = rng.normal(size=(2, N)).astype(np.float32)

    def f(xx):
        return jnp.sum(JPM.qdense_pallas_swiglu(xx, gu, down, out_dtype=BF16, interpret=True)
                       .astype(jnp.float32) * c)

    want_y = _np(JPM.qdense_pallas_swiglu(jnp.asarray(x), gu, down, out_dtype=BF16,
                                          interpret=True))
    gx = jax.grad(f)(jnp.asarray(x))
    tx = _t(x).requires_grad_(True)
    y = W4F.qdense_kernel_swiglu(tx, _leaf(gu), _leaf(down))
    assert y.grad_fn.name() == "W4SwigluFnBackward"
    np.testing.assert_allclose(y.detach().float().numpy(), want_y, rtol=0,
                               atol=2 ** -7 * np.abs(want_y).max())
    (y.float() * _t(c)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), _np(gx), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind,M,full", [("w4", 3, False), ("w4", 512, False),
                                         ("w4", 600, True), ("int8", 3, False),
                                         ("int8", 600, False)])
def test_quantized_grad_is_amax_only(rng, kind, M, full):
    """The JAX reference's gradient through a quantized product, copied on
    purpose: x is rounded to int8 codes (``round`` has a zero derivative),
    so the gradient reaches x only through each row's ``amax`` — one
    nonzero a row, at the row's largest |x| — in grouped int4 up to 512
    rows and in int8 at every M; above 512 rows the int4 product
    dequantizes the weight and the gradient is full.  Both packages, the
    nonzeros' places equal and their values within rtol 1e-6."""
    K, N = 256, 128
    w = rng.normal(size=(K, N)).astype(np.float32) * 0.05
    qp = JQ.quantize_linear_w4({"kernel": w}) if kind == "w4" else \
        JQ.quantize_linear({"kernel": w})
    jfn = JQ.qdense_w4 if kind == "w4" else JQ.qdense
    x = rng.normal(size=(M, K)).astype(np.float32)
    gj = _np(jax.grad(lambda xx: jnp.sum(jfn(xx, qp, out_dtype=jnp.float32)))(jnp.asarray(x)))
    leaf = _leaf(qp)
    tx = _t(x).requires_grad_(True)
    TQ.qdense_any(tx, leaf, out_dtype=torch.float32).sum().backward()
    gt = tx.grad.numpy()
    nz = (gt != 0).sum(axis=1)
    if full:
        assert (nz == K).all()
    else:
        assert (nz == 1).all()
        np.testing.assert_array_equal(np.abs(gt).argmax(1), np.abs(x).argmax(1))
    np.testing.assert_array_equal(gt != 0, gj != 0)
    np.testing.assert_allclose(gt, gj, rtol=1e-6, atol=1e-6 * np.abs(gj).max())


def test_kernel_wrappers_compute_plain_on_the_cpu_under_grad(rng):
    """On CPU tensors the raw-pointer wrappers stay plain under grad: K9
    and K10's outputs carry the plain program's graph (their card
    launches refuse a grad-requiring operand: ``tests/test_torch_cuda.py``)."""
    gu, down, o = (_leaf(_w4_leaf(rng, 256, 1024, False)), _leaf(_w4_leaf(rng, 512, 256, False)),
                   _leaf(_w4_leaf(rng, 256, 256, False)))
    x = _t(rng.normal(size=(2, 256)).astype(np.float32), torch.bfloat16).requires_grad_(True)
    assert W4F.w4_swiglu_mlp(x, gu, down).grad_fn is not None
    assert W4F.w4_postattn_fused(x, x, o, gu, down, torch.ones(256)).grad_fn is not None


# ---- the decoder's training pieces ------------------------------------------------------

@pytest.fixture(scope="module")
def jparams():
    p = JL.init_llm(CFG, jax.random.PRNGKey(0))
    p["embed"] = p["embed"] * 50.0
    return p


def _random_b(lora, rng):
    """JAX LoRA factors with B drawn (init_lora's B is 0, so A would get no
    gradient)."""
    layers = [{t: {"A": ab["A"], "B": jnp.asarray(rng.normal(size=ab["B"].shape)
                                                  .astype(np.float32) * 0.1)}
               for t, ab in lp.items()} for lp in lora["layers"]]
    return {"layers": layers, "scale": lora["scale"]}


def test_init_lora_matches_jax_layout_and_starts_at_the_base(jparams, rng):
    """The port's ``init_lora`` has JAX's layout (targets, (din, r) / (r,
    dout) float32, scale alpha / r, A's spread din^-0.5); JAX's draw
    converted (B = 0) leaves the port's forward exactly the base's, and a
    nonzero B gives JAX's adapted hidden states within 1e-5."""
    jl = JL.init_lora(CFG, jax.random.PRNGKey(1), rank=4)
    tl = TL.init_lora(TCFG, rank=4, seed=1, device="cpu")
    assert TL.LORA_TARGETS == JL.LORA_TARGETS and tl["scale"] == jl["scale"] == 4.0
    for jlp, tlp in zip(jl["layers"], tl["layers"]):
        assert list(jlp) == list(tlp)
        for t in jlp:
            for k in ("A", "B"):
                assert tuple(tlp[t][k].shape) == jlp[t][k].shape
                assert tlp[t][k].dtype == torch.float32
            assert not tlp[t]["B"].any()
    a = torch.cat([lp["gate"]["A"].flatten() for lp in tl["layers"]])
    assert abs(float(a.std()) * CFG.hidden_size ** 0.5 - 1.0) < 0.05
    tt = FF.llm(jparams, TCFG, device="cpu")
    e = rng.normal(size=(1, 5, CFG.hidden_size)).astype(np.float32)
    base = TL.llm_forward(TCFG, tt, _t(e))
    assert torch.equal(TL.llm_forward(TCFG, tt, _t(e), lora=FF.llm_lora(jl, device="cpu")), base)
    jb = _random_b(jl, rng)
    want = _np(JL.llm_forward(CFG, jparams, jnp.asarray(e), lora=jb))
    got = TL.llm_forward(TCFG, tt, _t(e), lora=FF.llm_lora(jb, device="cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _lora_leaves(lora):
    return [ab[k] for lp in lora["layers"] for ab in lp.values() for k in ("A", "B")]


@pytest.mark.parametrize("tree", ["float", "int4"])
def test_lm_loss_and_grads_match_jax(jparams, rng, tree):
    """``lm_loss`` (float32 activations) and its gradients w.r.t. the
    embeddings and every LoRA factor (B drawn nonzero), on the float tree
    and its grouped-int4 quantization: the loss 1e-5 relative, each
    gradient within 1e-4 of its largest element (float32 in other
    orders), and a half mask's denominator."""
    jt = jparams if tree == "float" else JL.quantize_llm_params(jparams, "int4")
    tt = FF.llm(jt, TCFG, device="cpu")
    jl = _random_b(JL.init_lora(CFG, jax.random.PRNGKey(4), rank=4), rng)
    e = rng.normal(size=(2, 6, CFG.hidden_size)).astype(np.float32)
    tgt = rng.integers(0, CFG.vocab_size, size=(2, 6))
    msk = (rng.random((2, 6)) < 0.5).astype(np.float32)

    def jloss(ee, layers):
        return JL.lm_loss(CFG, jt, ee, jnp.asarray(tgt), jnp.asarray(msk),
                          lora={"layers": layers, "scale": jl["scale"]})

    lj, (ge, gl) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(e), jl["layers"])
    tl = FF.llm_lora(jl, device="cpu")
    leaves = _lora_leaves(tl)
    for t in leaves:
        t.requires_grad_(True)
    te = _t(e).requires_grad_(True)
    lt = TL.lm_loss(TCFG, tt, te, _t(tgt), _t(msk), lora=tl)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    want = [_np(ge)] + [_np(jlp[t][k]) for jlp, tlp in zip(gl, tl["layers"]) for t in tlp
                        for k in ("A", "B")]
    got = [te.grad.numpy()] + [t.grad.numpy() for t in leaves]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())
    zero = TL.lm_loss(TCFG, tt, _t(e), _t(tgt), torch.zeros(2, 6))
    assert float(zero) == 0.0


def test_w4_bf16_loss_grads_through_the_fns_equal_the_plain_autograd(rng, monkeypatch):
    """On a bf16 grouped-int4 fused tree, ``lm_loss``'s gradients w.r.t. the
    embeddings and the LoRA factors through the kernels' autograd Functions
    (every linear: ``W4A8MatmulFn``; the LoRA-free MLPs at M <= 32:
    ``W4SwigluFn``, the K9 route taken as on the card) equal, bit for bit,
    the plain program differentiated by autograd (the dispatchers swapped
    for ``qdense_w4`` and ``w4_swiglu_plain``)."""
    jt = JL.fuse_quantized_layers(JL.quantize_llm_params(
        JL.init_llm(JL.qwen2_tiny(**W4_KW), jax.random.PRNGKey(5)), "int4"))
    jt["embed"] = jt["embed"].astype(BF16)
    cfg = TL.qwen2_tiny(**W4_KW)
    tt = FF.llm(jt, cfg, device="cpu")
    lora = TL.init_lora(cfg, rank=4, seed=2, device="cpu", targets=("q", "v", "o"))
    for lp in lora["layers"]:
        for ab in lp.values():
            ab["B"].normal_(0.0, 0.1)
    e = rng.normal(size=(1, 9, cfg.hidden_size)).astype(np.float32)
    tgt = _t(rng.integers(0, cfg.vocab_size, size=(1, 9)))

    def grads():
        leaves = _lora_leaves(lora)
        for t in leaves:
            t.grad = None
            t.requires_grad_(True)
        te = _t(e, torch.bfloat16).requires_grad_(True)
        loss = TL.lm_loss(cfg, tt, te, tgt, torch.ones(1, 9),
                          lora=TR.lora_in(lora, torch.bfloat16))
        loss.backward()
        names, seen, stack = set(), set(), [loss.grad_fn]
        while stack:
            fn = stack.pop()
            if fn is not None and fn not in seen:
                seen.add(fn)
                names.add(fn.name())
                stack += [f for f, _ in fn.next_functions]
        return float(loss.detach()), [te.grad] + [t.grad.clone() for t in leaves], names

    monkeypatch.setattr(TL, "MEGAKERNELS", True)
    monkeypatch.setattr(TL, "_kernel_device", lambda t: True)
    l_fn, g_fn, names = grads()
    assert {"W4A8MatmulFnBackward", "W4SwigluFnBackward"} <= names
    monkeypatch.setattr(QM, "qdense_kernel_w4", lambda x, qp: TQ.qdense_w4(x, qp))
    monkeypatch.setattr(W4F, "qdense_kernel_swiglu", W4F.w4_swiglu_plain)
    l_plain, g_plain, names = grads()
    assert not names & {"W4A8MatmulFnBackward", "W4SwigluFnBackward"}
    assert l_fn == l_plain
    for a, b in zip(g_fn, g_plain):
        assert torch.equal(a, b)
    assert all(bool(g.any()) for g in g_fn)


def test_loss_fn_on_spliced_embeddings_matches_jax(jparams, rng):
    """``make_llm_interface().loss_fn`` on ``process_user_input``'s splice of
    a projected feature (float32): the loss 1e-5 relative, the projector's
    gradient (as the flax tree) within 1e-4 of each leaf's largest
    element."""
    jif = JR.make_llm_interface(CFG, jparams)
    tif = TR.make_llm_interface(TCFG, FF.llm(jparams, TCFG, device="cpu"))
    jp = JS.TactileProjector(CFG.hidden_size).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 64)))["params"]
    proj = FF.tactile_projector(jp, device="cpu").requires_grad_(True)
    feat = rng.normal(size=(64,)).astype(np.float32)
    q, answer = "Object <tact> is", "soft."

    def jloss(p):
        e = JS.process_user_input(q, [feat], jif.embed_text, lambda f: f,
                                  lambda f: JS.TactileProjector(CFG.hidden_size).apply(
                                      {"params": p}, jnp.asarray(f))[None],
                                  jif.start_embed, jif.end_embed)
        return jif.loss_fn(jnp.asarray(e), answer)

    lj, gj = jax.value_and_grad(jloss)(jp)
    e = TS.process_user_input(q, [_t(feat)], tif.embed_text, lambda f: f,
                              TR._projected(proj, tif.start_embed), tif.start_embed,
                              tif.end_embed)
    assert e.requires_grad and e.shape == (len("Object ") + 3 + len(" is"), CFG.hidden_size)
    lt = tif.loss_fn(e, answer)
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    got = FF.to_flax(proj, {n: p.grad for n, p in proj.named_parameters()})
    for layer in ("fc1", "fc2"):
        for k in ("kernel", "bias"):
            w = _np(gj[layer][k])
            np.testing.assert_allclose(got[layer][k], w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_train_lm_matches_jax(jparams):
    """Three full-parameter Adam steps (lr 1e-2) of the tiny float32
    decoder on two texts against JAX's jitted trainer: the last loss 1e-5
    relative; every parameter within 2e-5 (measured 1.5e-5 at most), but
    the attention key biases within 2 x 3 x lr (measured 1.0e-3): softmax
    is shift-invariant along the keys, so their gradient is 0 up to
    rounding, and Adam turns that noise into steps of about lr either
    way."""
    texts = ["soft and smooth", "hard"]
    jp, jl = JL.train_lm(CFG, jparams, texts, steps=3, lr=1e-2)
    tt = FF.llm(jparams, TCFG, device="cpu")
    tt, tl = TL.train_lm(TCFG, tt, texts, steps=3, lr=1e-2)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert not any(p.requires_grad for p in tt.parameters())
    want = FF.llm(jp, TCFG, device="cpu").state_dict()
    for name, t in tt.state_dict().items():
        tol = 2 * 3 * 1e-2 if name.endswith("k.bias") else 2e-5
        assert float((t - want[name]).abs().max()) <= tol, name


# ---- the projector and LoRA trainers, end to end ----------------------------------------

def _write_video(d, rng, n=5):
    d.mkdir(parents=True)
    for i in range(n):
        f = np.clip(100 + 25 * i * (i > 1) + rng.normal(0, 8, (FRAME, FRAME, 3)), 0, 255)
        Image.fromarray(f.astype(np.uint8)).save(str(d / f"{i:03d}.png"))
    return str(d)


@pytest.fixture(scope="module")
def planning(tmp_path_factory):
    """The tiny CLIP encoder (JAX's draw and the port's conversion), two
    recordings and a QA file of two rows (one and two videos)."""
    root = tmp_path_factory.mktemp("llm_train")
    rng = np.random.default_rng(11)
    vids = [_write_video(root / f"obj_{i}" / "tactile", rng) for i in range(2)]
    rows = [{"question": "Describe <tact>.", "answer": "soft", "tactile": vids[:1]},
            {"question": "Is <tact> harder than <tact>?", "answer": "no, it is softer",
             "tactile": vids}]
    qa = str(root / "qa.json")
    with open(qa, "w") as f:
        json.dump(rows, f)
    jst = JE.init_tactile_encoder(JV.ViTConfig(**CLIP_KW), jax.random.PRNGKey(1))
    return dict(root=root, jst=jst, tst=FF.tactile_encoder(jst, device="cpu"),
                jds=JD.TactileLLMDataset([qa]), tds=TD.TactileLLMDataset([qa]))


def _log_losses(path):
    with open(path) as f:
        return [(r["step"], r["epoch"], r["loss"]) for r in map(json.loads, f)]


def _assert_tree_close(got, want, atol, what):
    if isinstance(want, (dict, list)):
        for k in (want if isinstance(want, dict) else range(len(want))):
            _assert_tree_close(got[k], want[k], atol, f"{what}/{k}")
        return
    np.testing.assert_allclose(np.asarray(got, np.float32), _np(want), rtol=0, atol=atol,
                               err_msg=what)


def test_train_projection_matches_jax(jparams, planning):
    """``train_projection`` (AdamW, lr 1e-3, decay 1e-4; 3 epochs of 2 rows)
    from JAX's projector draw on the frozen tiny float32 decoder: the
    logged losses (steps 0 and 5) 1e-5 relative, the trained projector
    within 1e-5 of JAX's (both files' trees), ``projection.msgpack`` read
    by JAX bit for bit as the port's tree."""
    jif = JR.make_llm_interface(CFG, jparams)
    tif = TR.make_llm_interface(TCFG, FF.llm(jparams, TCFG, device="cpu"))
    jp0 = JS.TactileProjector(CFG.hidden_size).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64)))["params"]
    jdir, tdir = planning["root"] / "jax_proj", planning["root"] / "port_proj"
    jp = JR.train_projection(planning["jst"], jif, planning["jds"], str(jdir), epochs=3,
                             lr=1e-3, frame_size=FRAME, proj_params=jp0)
    proj = TR.train_projection(planning["tst"], tif, planning["tds"], str(tdir), epochs=3,
                               lr=1e-3, frame_size=FRAME,
                               projector=FF.tactile_projector(jp0, device="cpu"))
    lj, lt = _log_losses(jdir / "llm_training.jsonl"), _log_losses(tdir / "llm_training.jsonl")
    assert [r[:2] for r in lt] == [r[:2] for r in lj] == [(0, 0), (5, 2)]
    np.testing.assert_allclose([r[2] for r in lt], [r[2] for r in lj], rtol=1e-5)
    mine = FF.to_flax(proj)
    _assert_tree_close(mine, jp, 1e-5, "projector")
    back = JC.load_pytree(str(tdir / "projection.msgpack"), jp)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), back, mine)


@pytest.fixture(scope="module")
def joint(jparams, planning):
    """``train_projection_and_lora`` in both packages (2 epochs of 2 rows,
    rank 8 on all seven targets, lr 1e-3), on the tiny float32 decoder and
    on a grouped-int4 base, from JAX's draws (its ``split(PRNGKey(0))``)."""
    out = {}
    w4cfg = JL.qwen2_tiny(**W4_KW)
    bases = {"float": (CFG, TCFG, jparams),
             "w4": (w4cfg, TL.qwen2_tiny(**W4_KW), JL.quantize_llm_params(
                 JL.init_llm(w4cfg, jax.random.PRNGKey(6)), "int4"))}
    for name, (jcfg, tcfg, jt) in bases.items():
        k1, k2 = jax.random.split(jax.random.PRNGKey(0))
        jp0 = JS.TactileProjector(jcfg.hidden_size).init(k1, jnp.zeros((1, 64)))["params"]
        jl0 = JL.init_lora(jcfg, k2, rank=8)
        jdir, tdir = planning["root"] / f"jax_{name}", planning["root"] / f"port_{name}"
        jres = JR.train_projection_and_lora(planning["jst"], jcfg, jt, planning["jds"],
                                            str(jdir), epochs=2, frame_size=FRAME)
        tt = FF.llm(jt, tcfg, device="cpu")
        tres = TR.train_projection_and_lora(planning["tst"], tcfg, tt, planning["tds"],
                                            str(tdir), epochs=2, frame_size=FRAME,
                                            projector=FF.tactile_projector(jp0, device="cpu"),
                                            lora=FF.llm_lora(jl0, device="cpu"))
        out[name] = dict(jcfg=jcfg, tcfg=tcfg, jt=jt, tt=tt, jres=jres, tres=tres, jdir=jdir,
                         tdir=tdir, jl0=jl0)
    return out


@pytest.mark.parametrize("base", ["float", "w4"])
def test_train_projection_and_lora_matches_jax(joint, base):
    """Four steps (lr 1e-3) against JAX's trainer.  Float base: every
    step's loss 1e-5 relative, the projector and every LoRA factor within
    1e-5 (measured 2.4e-7).  Grouped-int4 base (float32 activations: the
    plain quantized products, amax-only input gradients in both): steps
    1-3 1e-5 relative; from there the trainables differ at rounding level
    and an activation's int8 code can fall the other way (the forward is
    piecewise constant in them), measured at step 4 as 2.1e-4 of the loss
    and a changed gradient that Adam turns into steps of about lr: so step
    4 within 1e-3, the projector within 1e-4 (measured 4.4e-5), the LoRA
    factors within 2 x 4 x lr and at most 1 % of their elements beyond 1e-4
    (measured 0.27 %, at most 2.8e-3).  The factors moved (B no longer 0),
    the masters are left without grad, and the base is untouched."""
    r = joint[base]
    lj = _log_losses(r["jdir"] / "llm_training.jsonl")
    lt = _log_losses(r["tdir"] / "llm_training.jsonl")
    assert [x[:2] for x in lt] == [x[:2] for x in lj] == [(0, 0), (1, 0), (2, 1), (3, 1)]
    gl, wl = np.array([x[2] for x in lt]), np.array([x[2] for x in lj])
    exact = 4 if base == "float" else 3
    np.testing.assert_allclose(gl[:exact], wl[:exact], rtol=1e-5)
    np.testing.assert_allclose(gl, wl, rtol=1e-3)
    (jp, jl), (tp, tl) = r["jres"], r["tres"]
    _assert_tree_close(FF.to_flax(tp), jp, 1e-5 if base == "float" else 1e-4, "projector")
    got = FF.llm_lora_to_flax(tl)["layers"]
    if base == "float":
        _assert_tree_close(got, jl["layers"], 1e-5, "lora")
    else:
        d = np.concatenate([np.abs(got[i][t][k] - _np(jlp[t][k])).ravel()
                            for i, jlp in enumerate(jl["layers"]) for t in jlp for k in "AB"])
        assert d.max() <= 2 * 4 * 1e-3 and (d > 1e-4).mean() <= 0.01, (d.max(), (d > 1e-4).mean())
    assert all(bool(ab["B"].any()) for lp in tl["layers"] for ab in lp.values())
    assert not any(t.requires_grad for t in _lora_leaves(tl))
    want = FF.llm(r["jt"], r["tcfg"], device="cpu").state_dict()
    for name, t in r["tt"].state_dict().items():
        assert torch.equal(t, want[name]), name


@pytest.mark.parametrize("base", ["float", "w4"])
def test_trainer_files_read_across_packages(joint, base):
    """``projection.msgpack`` and ``lora.msgpack``: the port's read by JAX's
    ``load_pytree`` into JAX's trees bit for bit as the port wrote them, and
    JAX's read by the port (``load_pytree`` -> ``llm_lora`` /
    ``tactile_projector``) bit for bit as JAX trained them."""
    r = joint[base]
    (jp, jl), (tp, tl) = r["jres"], r["tres"]
    back = JC.load_pytree(str(r["tdir"] / "projection.msgpack"), jp)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b), back,
                 FF.to_flax(tp))
    back = JC.load_pytree(str(r["tdir"] / "lora.msgpack"), jl)
    assert float(back["scale"]) == tl["scale"] == jl["scale"]
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                 back["layers"], FF.llm_lora_to_flax(tl)["layers"])
    lora = FF.llm_lora(TC.load_pytree(str(r["jdir"] / "lora.msgpack")), device="cpu")
    assert lora["scale"] == jl["scale"]
    for jlp, tlp in zip(jl["layers"], lora["layers"]):
        assert set(jlp) == set(tlp)
        for t in jlp:
            for k in ("A", "B"):
                np.testing.assert_array_equal(tlp[t][k].numpy(), np.asarray(jlp[t][k]))
    proj = FF.tactile_projector(TC.load_pytree(str(r["jdir"] / "projection.msgpack")),
                                device="cpu")
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                 jp, FF.to_flax(proj))


@pytest.mark.parametrize("base", ["float", "w4"])
def test_test_llm_decodes_as_jax(joint, planning, base):
    """``test_llm`` with each package's trained projector and LoRA: the
    same predictions (greedy, 8 tokens), written to ``predictions.json``."""
    r = joint[base]
    (jp, jl), (tp, tl) = r["jres"], r["tres"]
    jif = JR.make_llm_interface(r["jcfg"], r["jt"], lora=jl, max_new_tokens=8)
    tif = TR.make_llm_interface(r["tcfg"], r["tt"], lora=tl, max_new_tokens=8)
    jpred = JR.test_llm(planning["jst"], jif, jp, planning["jds"], str(r["jdir"]),
                        frame_size=FRAME)
    tpred = TR.test_llm(planning["tst"], tif, tp, planning["tds"], str(r["tdir"]),
                        frame_size=FRAME)
    assert [p["prediction"] for p in tpred] == [p["prediction"] for p in jpred]
    with open(r["tdir"] / "predictions.json") as f:
        assert json.load(f) == tpred
