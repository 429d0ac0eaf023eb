"""PyTorch port, RDT finetuning, against the JAX package on the same inputs
(CPU): K1's autograd route, the DDPM forward process and sampler, the
training loss and its gradients (float32 and bf16), the train step
(accumulation, clipping, AdamW and 8-bit AdamW, EMA, the bf16-parameter
recipe), the learning-rate schedules, the data pipeline, the trainer's
checkpoints both ways and the command line.

Small widths throughout: ``rdt_tiny`` (hidden 128, depth 2, horizon 8),
batch 2 x accumulation 2, SigLIP at one layer and 28^2.  JAX's draws
(noise, timesteps, the stochastic-rounding bits) are passed to the port.
Tolerances are stated per test.
"""

import argparse
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from vla_touch_tpu.config import DataConfig as JDC
from vla_touch_tpu.config import TrainConfig as JTC
from vla_touch_tpu.config import rdt_tiny as j_rdt_tiny
from vla_touch_tpu.data import consumer as JCons
from vla_touch_tpu.data import episode as JE
from vla_touch_tpu.models.rdt import runner as JR
from vla_touch_tpu.ops import adam8bit as JA8
from vla_touch_tpu.ops import schedulers as JS
from vla_touch_tpu.train import rdt_train as JT
from vla_touch_tpu_torch import config as TC
from vla_touch_tpu_torch.data import consumer as TCons
from vla_touch_tpu_torch.data import episode as TE
from vla_touch_tpu_torch.models.rdt import runner as TR
from vla_touch_tpu_torch.ops import adam8bit as TA8
from vla_touch_tpu_torch.ops import attention as TA
from vla_touch_tpu_torch.ops import flash_attention as FA
from vla_touch_tpu_torch.ops import schedulers as TS
from vla_touch_tpu_torch.train import optim as TO
from vla_touch_tpu_torch.train import rdt_train as TT
from vla_touch_tpu_torch.utils import from_flax as FF

# bf16 parity of a loss + gradient (chip_smoke.py holds the card's step to
# the CPU's with the same numbers).  The port and JAX round the same bf16
# operations; where a float32 sum in another order lands on the other side
# of a bf16 rounding boundary, the flip spreads through the layers after it.
# Over six seeds: loss 2.0e-7..7.5e-5 relative, worst leaf's max |diff| /
# max |grad| 1.3e-2..2.7e-2, gradient L2 3.2e-3..4.2e-3; between JAX's bf16
# and float32 programs 1.7e-4 / - / 9.0e-3; with the RmsNorm scales cast to
# bf16 (a wrong cast map) 4.8e-4 / 3.3e-2 / 7.4e-3.  The cast map itself is
# held leaf by leaf in test_bf16_cast_map_equals_flax.
LOSS_RTOL_BF16 = 2e-4
GRAD_LEAF_TOL_BF16 = 5e-2
GRAD_L2_TOL_BF16 = 6e-3
A, B, LL = 2, 2, 7          # micro-batches, rows a micro-batch, language tokens


def _t(a):
    return torch.as_tensor(np.array(a))


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float64)


@functools.lru_cache(maxsize=None)
def _base_params():
    """JAX's init of rdt_tiny (jitted: one compile), as numpy."""
    cfg = JR.RDTRunnerConfig(model=j_rdt_tiny())
    return jax.tree.map(np.asarray, jax.jit(lambda k: JR.init_rdt(cfg, k))(
        jax.random.PRNGKey(0)))


def _jparams(cfg, rng):
    """JAX's init, every leaf perturbed (so zero-initialised heads train)."""
    return jax.tree.map(lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32),
                        _base_params())


def _port_module(jparams, dtype="float32"):
    mod = TR.init_rdt_train(TR.RDTRunnerConfig(model=TC.rdt_tiny(dtype=dtype)), device="cpu")
    return FF.load_into(mod, FF.rdt_runner(jparams))


def _batch(m, rng, lead=()):
    lens = rng.integers(1, LL + 1, lead + (1,))
    return dict(
        lang_tokens=rng.normal(size=lead + (LL, m.lang_token_dim)).astype(np.float32),
        lang_mask=np.arange(LL) < lens,
        img_tokens=rng.normal(size=lead + (m.img_cond_len, m.img_token_dim)).astype(np.float32),
        state_tokens=rng.normal(size=lead + (1, 128)).astype(np.float32),
        action_gt=rng.normal(size=lead + (m.horizon, 128)).astype(np.float32),
        action_mask=(rng.random(lead + (1, 128)) > 0.3).astype(np.float32),
        ctrl_freqs=rng.choice([0.0, 10.0, 25.0], lead).astype(np.float32))


def _loss_draws(key, m, batch_rows):
    """The noise and timesteps ``rdt_compute_loss`` draws from ``key``."""
    k_noise, k_t = jax.random.split(key)
    return (np.asarray(jax.random.normal(k_noise, (batch_rows, m.horizon, 128), jnp.float32)),
            np.asarray(jax.random.randint(k_t, (batch_rows,), 0, 1000)))


# ---- (a) K1 under autograd -------------------------------------------------------


@pytest.mark.parametrize("mask_kind", [None, "ragged"])
def test_k1_function_gradient_equals_plain_autograd(mask_kind):
    """dot_product_attention with grad-requiring operands goes through
    FlashAttentionFn; its q/k/v gradients equal attention_plain's autograd
    (the backward is that program recomputed), with a ragged key mask and a
    row with no valid key too."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(3, n, 4, 16, generator=g).requires_grad_(True) for n in (5, 11, 11))
    mask = None
    if mask_kind:
        mask = torch.arange(11)[None] < torch.tensor([[11], [4], [0]])
    cot = torch.randn(3, 5, 4, 16, generator=g)
    out = TA.dot_product_attention(q, k, v, kv_mask=mask)
    assert out.grad_fn is not None and "FlashAttentionFn" in type(out.grad_fn).__name__
    got = torch.autograd.grad((out * cot).sum(), (q, k, v))
    want = torch.autograd.grad((FA.attention_plain(q, k, v, kv_mask=mask) * cot).sum(),
                               (q, k, v))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert TA.dot_product_attention(q, k, v, kv_mask=mask).grad_fn is None


def test_k1_function_gradient_of_a_frozen_operand_is_none():
    """Only the operands that require grad get one."""
    q = torch.randn(1, 3, 2, 8, requires_grad=True)
    k, v = torch.randn(1, 6, 2, 8), torch.randn(1, 6, 2, 8)
    out = TA.dot_product_attention(q, k, v)
    (gq,) = torch.autograd.grad(out.sum(), (q,))
    (want,) = torch.autograd.grad(FA.attention_plain(q, k, v).sum(), (q,))
    assert torch.equal(gq, want)


# ---- (b) the DDPM forward process and sampler ------------------------------------


def test_add_noise_and_velocity_match_jax(rng):
    """Bit for bit: the same float32 operations."""
    js = JS.DiffusionSchedule.create(1000, "squaredcos_cap_v2")
    ts = TS.DiffusionSchedule.create(1000, "squaredcos_cap_v2")
    x0 = rng.normal(size=(4, 8, 128)).astype(np.float32)
    eps = rng.normal(size=x0.shape).astype(np.float32)
    t = np.array([0, 17, 500, 999])
    for fn in ("add_noise", "velocity"):
        want = np.asarray(getattr(js, fn)(jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(t)))
        got = getattr(ts, fn)(_t(x0), _t(eps), _t(t)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prediction_type", ["sample", "epsilon"])
def test_sample_ddpm_matches_jax(rng, prediction_type):
    """The 1000-step ancestral sampler with JAX's per-step noise given:
    float32 to 1e-5 relative after 1000 steps of the same arithmetic."""
    T = 1000
    js = JS.DiffusionSchedule.create(T, "squaredcos_cap_v2")
    ts = TS.DiffusionSchedule.create(T, "squaredcos_cap_v2")
    w = rng.normal(size=(6, 6)).astype(np.float32) * 0.3
    x_init = rng.normal(size=(2, 3, 6)).astype(np.float32)
    key = jax.random.PRNGKey(5)

    def jfn(x, t):
        return jnp.tanh(x @ jnp.asarray(w)) * (1.0 + t[:, None, None] / T)

    def tfn(x, t):
        return torch.tanh(x @ _t(w)) * (1.0 + t[:, None, None] / T)

    want = np.asarray(JS.sample_ddpm(jfn, jnp.asarray(x_init), js, key,
                                     prediction_type=prediction_type, clip_sample=True))
    noises, k = [], key
    for _ in range(T):
        k, sub = jax.random.split(k)
        noises.append(np.asarray(jax.random.normal(sub, x_init.shape, jnp.float32)))
    got = TS.sample_ddpm(tfn, _t(x_init), ts, prediction_type=prediction_type,
                         clip_sample=True, noises=np.stack(noises)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---- (c) the loss and its gradients ------------------------------------------------


def _loss_and_grads(dtype, rng):
    m = j_rdt_tiny(dtype=dtype)
    rcfg = JR.RDTRunnerConfig(model=m)
    params = _jparams(j_rdt_tiny(), rng)
    batch = _batch(m, rng, (3,))
    key = jax.random.PRNGKey(3)
    grad_fn = jax.value_and_grad(lambda p, b: JR.rdt_compute_loss(rcfg, p, key, b))
    # under jit, XLA's fusions would drop bf16 roundings the program has
    # (as the port does not): excess precision off
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(grad_fn).lower(params, jb).compile(
        compiler_options={"xla_allow_excess_precision": False})(params, jb)
    noise, ts = _loss_draws(key, m, 3)
    mod = _port_module(params, dtype)
    tcfg = TR.RDTRunnerConfig(model=TC.rdt_tiny(dtype=dtype))
    loss = TR.rdt_compute_loss(tcfg, mod, {k: _t(v) for k, v in batch.items()},
                               noise=_t(noise), timesteps=_t(ts))
    names = [n for n, _ in mod.named_parameters()]
    grads = torch.autograd.grad(loss, list(mod.parameters()))
    want = FF.rdt_runner(jax.tree.map(np.asarray, jg))
    return float(jl), float(loss.detach()), dict(zip(names, grads)), want


def test_rdt_loss_and_gradients_match_jax_float32(rng):
    """rdt_tiny in float32: loss to 1e-5 relative, each gradient leaf's max
    abs error to 1e-4 of its max |grad|."""
    jl, tl, got, want = _loss_and_grads("float32", rng)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    for n, w in want.items():
        assert np.abs(_np(got[n]) - w).max() <= 1e-4 * np.abs(w).max(), n


def test_rdt_loss_and_gradients_match_jax_bfloat16(rng):
    """rdt_tiny in bf16 with float32 masters: the cast map leaf by leaf as
    flax's (Linear weights, biases and positional tables cast at use,
    RmsNorm scales not).  Tolerances: LOSS_RTOL_BF16, GRAD_LEAF_TOL_BF16,
    GRAD_L2_TOL_BF16 (measured values in the module's comment)."""
    jl, tl, got, want = _loss_and_grads("bfloat16", rng)
    assert abs(tl - jl) <= LOSS_RTOL_BF16 * abs(jl)
    num = sum(((_np(got[n]) - w) ** 2).sum() for n, w in want.items())
    den = sum((w.astype(np.float64) ** 2).sum() for w in want.values())
    assert (num / den) ** 0.5 <= GRAD_L2_TOL_BF16
    for n, w in want.items():
        assert got[n].dtype == torch.float32
        assert np.abs(_np(got[n]) - w).max() <= GRAD_LEAF_TOL_BF16 * np.abs(w).max(), n


def _flax_cast_leaves(m, params) -> set:
    """The flax paths of the parameter leaves JAX's bf16 forward casts to
    bf16 (a ``convert_element_type`` of the leaf, or of a slice or reshape
    of it), read off the jaxpr."""
    B = 2
    args = (jnp.zeros((B, 5, m.lang_token_dim)), jnp.zeros((B, m.img_cond_len, m.img_token_dim)),
            jnp.zeros((B, m.horizon + 1, 256)), jnp.zeros((B,)), jnp.zeros((B,), jnp.int32))
    closed = jax.make_jaxpr(lambda p: JR.RDTRunnerModule(m).apply(
        {"params": p}, *args, lang_mask=jnp.ones((B, 5), bool)))(params)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    origin = {v: tuple(k.key for k in path)
              for v, (path, _) in zip(closed.jaxpr.invars, leaves)}
    cast = set()
    for e in closed.jaxpr.eqns:
        src = [origin[v] for v in e.invars if not hasattr(v, "val") and v in origin]
        if not src:
            continue
        if e.primitive.name in ("slice", "reshape", "squeeze", "broadcast_in_dim"):
            origin[e.outvars[0]] = src[0]
        elif (e.primitive.name == "convert_element_type"
              and e.params["new_dtype"] == jnp.bfloat16):
            cast.add(src[0])
    return cast


def _port_cast_leaves(mod, inputs) -> set:
    """The names of the port module's parameters its forward casts to bf16
    (``Tensor.to`` of the parameter, or of a view of it)."""
    from torch.overrides import TorchFunctionMode

    names = {id(p): n for n, p in mod.named_parameters()}
    cast = set()

    class Watch(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            src = names.get(id(args[0])) if args else None
            if src is not None and func is torch.Tensor.__getitem__:
                names[id(out)] = src
            elif src is not None and func is torch.Tensor.to and out.dtype == torch.bfloat16 \
                    and args[0].dtype != torch.bfloat16:
                cast.add(src)
            return out

    with Watch(), torch.no_grad():
        mod(*inputs)
    return cast


def test_bf16_cast_map_equals_flax(rng):
    """In bf16 with float32 masters the port casts exactly the leaves flax
    casts: every Dense kernel and bias, the three positional tables; not
    the RmsNorm scales."""
    m = j_rdt_tiny(dtype="bfloat16")
    params = _jparams(j_rdt_tiny(), rng)
    paths = FF.flax_paths(_port_module(params, "bfloat16"))
    flax_cast = _flax_cast_leaves(m, params)
    want = {n for n, (p, _) in paths.items() if p in flax_cast}
    batch = _batch(m, rng, (2,))
    inputs = (_t(batch["lang_tokens"]), _t(batch["img_tokens"]),
              torch.randn(2, m.horizon + 1, 256), _t(batch["ctrl_freqs"]),
              torch.tensor([3, 500]))
    got = _port_cast_leaves(_port_module(params, "bfloat16"), inputs)
    assert got == want
    assert {n for n in paths if "norm" in n} & got == set()
    assert {"model.x_pos_embed", "model.lang_cond_pos_embed",
            "model.img_cond_pos_embed"} <= got


def test_remat_blocks_gives_the_same_gradients(rng):
    """remat_blocks recomputes each block in the backward pass
    (torch.utils.checkpoint): the same loss and gradients bit for bit."""
    m = TC.rdt_tiny()
    params = _jparams(j_rdt_tiny(), rng)
    batch = {k: _t(v) for k, v in _batch(j_rdt_tiny(), rng, (2,)).items()}
    noise, ts = torch.randn(2, m.horizon, 128), torch.tensor([3, 700])
    out = []
    for remat in (False, True):
        cfg = TR.RDTRunnerConfig(model=dataclasses.replace(m, remat_blocks=remat))
        mod = _port_module(params)
        mod.model.cfg = cfg.model
        loss = TR.rdt_compute_loss(cfg, mod, batch, noise=noise, timesteps=ts)
        out.append((loss, torch.autograd.grad(loss, list(mod.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# ---- (d) the train step ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _randint16(shape):
    return jax.jit(lambda k: jax.random.randint(k, shape, 0, 1 << 16, dtype=jnp.uint32))


def _jax_step_draws(key, m, state, tcfg, paths):
    """What JAX's train_step draws from ``key``: the per-micro-batch noise
    and timesteps and, for bf16 parameters / EMA, the rounding bits (one
    compile a leaf shape)."""
    key, k_ema, k_apply = jax.random.split(key, 3)
    draws = [_loss_draws(k, m, B) for k in jax.random.split(key, A)]
    out = {"noise": _t(np.stack([d[0] for d in draws])),
           "timesteps": _t(np.stack([d[1] for d in draws]))}
    leaves, treedef = jax.tree.flatten(state.params)

    def bits(k):
        tree = jax.tree.unflatten(treedef, [
            np.asarray(_randint16(x.shape)(kk)).astype(np.int64)
            for kk, x in zip(jax.random.split(k, len(leaves)), leaves)])
        return FF.unnest(paths, tree)
    if tcfg.param_dtype == "bfloat16":
        out["apply_bits"] = bits(k_apply)
    if tcfg.ema_dtype == "bfloat16":
        out["ema_bits"] = bits(k_ema)
    return out


@functools.lru_cache(maxsize=None)
def _jax_step(m, jt):
    return jax.jit(lambda s, k, b: JT.train_step(JR.RDTRunnerConfig(model=m), jt, s, k, b))


def _run_steps(recipe, n_steps, rng):
    kw = dict(batch_size=B, grad_accum=A, lr_warmup_steps=0, learning_rate=1e-3)
    if recipe == "bf16":
        kw.update(use_8bit_adam=True, param_dtype="bfloat16", accum_dtype="bfloat16",
                  ema_dtype="bfloat16")
    m = j_rdt_tiny()
    rcfg = JR.RDTRunnerConfig(model=m)
    jt, tt = JTC(**kw), TC.TrainConfig(**kw)
    params = _jparams(m, rng)
    js = JT.init_train_state(rcfg, jt, jax.random.PRNGKey(1), params=params)
    trcfg = TR.RDTRunnerConfig(model=TC.rdt_tiny())
    ts = TT.init_train_state(trcfg, tt, module=_port_module(params))
    opt = TT.make_optimizer(tt, ts.module)
    paths = FF.flax_paths(ts.module)
    step = _jax_step(m, jt)
    metrics = []
    for i in range(n_steps):
        batch = _batch(m, rng, (A, B))
        key = jax.random.PRNGKey(100 + i)
        draws = _jax_step_draws(key, m, js, jt, paths)
        js, jm = step(js, key, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = TT.train_step(trcfg, tt, ts, {k: _t(v) for k, v in batch.items()},
                               draws=draws, optimizer=opt)
        metrics.append((jm, tm))
    return js, ts, opt, metrics, kw["learning_rate"]


def _leaves(a, b, path=""):
    if isinstance(b, dict):
        assert set(map(str, a)) == set(map(str, b)), path
        for k in b:
            yield from _leaves(a[str(k)], b[k], f"{path}/{k}")
    else:
        yield path, _np(a), np.asarray(jnp.asarray(b, jnp.float32), np.float64)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_step_float32_recipe_matches_jax(rng, n_steps):
    """The default recipe (float32 master, AdamW, float32 accumulator and
    EMA) at accumulation 2 against JAX's jitted train_step: loss and
    gradient norm to 1e-5 relative; parameters and EMA to 0.2 x lr after
    the steps (Adam's normalised update turns the last float32 bits of a
    near-zero gradient into up to one lr; measured 0.068 lr); the moments
    mu / nu to 1e-4 of each leaf's max; the counts exactly."""
    js, ts, opt, metrics, lr = _run_steps("f32", n_steps, rng)
    for jm, tm in metrics:
        for k in ("loss", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    tree = FF.rdt_train_state_to_flax(ts, opt)
    assert tree["meta"] == {"step": n_steps, "ema_num_updates": n_steps}
    for name, want in (("params", js.params), ("ema", js.ema.shadow)):
        for path, a, b in _leaves(tree[name], want):
            assert np.abs(a - b).max() <= 0.2 * lr, (name, path)
    jopt = serialization.to_state_dict(js.opt_state)
    for path, a, b in _leaves(tree["opt_state"], jopt):
        if path.endswith("count"):
            assert a == b == n_steps
        else:
            assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(), 1e-30), path


def test_train_step_bf16_recipe_matches_jax(rng):
    """The bf16 recipe (8-bit Adam, bf16 parameters, accumulator and EMA,
    JAX's rounding bits given), three steps: metrics to 1e-4 relative; each
    bf16 parameter and EMA value within one bf16 step or 2 lr of JAX's,
    at most 2 % more than a step off; the int8 moment codes equal but for
    at most 1 % (measured 0.4 %).  The jitted JAX step divides by 127 as a
    product with the reciprocal (the port keeps the IEEE quotient of JAX's
    eager program, held bit for bit in test (e)), so a few codes differ, and
    with them a few updates by up to lr."""
    js, ts, opt, metrics, lr = _run_steps("bf16", 3, rng)
    for jm, tm in metrics:
        for k in ("loss", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-4 * abs(float(jm[k])), k
    tree = FF.rdt_train_state_to_flax(ts, opt)
    assert all(p.dtype == torch.bfloat16 for p in ts.params.values())
    for name, want in (("params", js.params), ("ema", js.ema.shadow)):
        off = total = 0
        for path, a, b in _leaves(tree[name], want):
            step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
            assert np.all(np.abs(a - b) <= np.maximum(step, 2 * lr)), (name, path)
            off, total = off + int((np.abs(a - b) > step).sum()), total + a.size
        assert off <= 0.02 * total, name
    jopt = serialization.to_state_dict(js.opt_state)
    assert int(tree["opt_state"]["1"]["count"]) == int(jopt["1"]["count"]) == 3
    for k in ("m_q", "v_q"):
        pairs = list(_leaves(FF.nest(FF.flax_paths(ts.module),
                                     FF.unnest(FF.flax_paths(ts.module),
                                               tree["opt_state"]["1"][k], transpose=False),
                                     transpose=False), jopt["1"][k]))
        off = sum(int((a != b).sum()) for _, a, b in pairs)
        assert off <= 0.01 * sum(a.size for _, a, _ in pairs), k


@pytest.mark.parametrize("scheduler", ["constant", "cosine"])
def test_float32_optimizer_update_matches_optax_chain(rng, scheduler):
    """RDTOptimizer.update (the float32 recipe) against the JAX package's
    make_optimizer chain (clip_by_global_norm + optax.adamw, eager) on the
    same gradients and parameters, three updates: the first clips (global
    norm about 60 over a max of 1), the others do not; weight decay 0.5, so
    a dropped or sign-flipped decay moves each update by about its own
    size.  Each leaf's updates and moments to 1e-6 of its largest value
    (where two terms nearly cancel, an element may differ in its last bits
    relative to itself: measured 5e-4 relative, 1.7e-10 absolute, in an
    update), counts exactly."""
    shapes = {"w": (37, 30), "b": (30,), "s": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(lr_scheduler=scheduler, learning_rate=1e-3, lr_warmup_steps=1,
              max_train_steps=10, max_grad_norm=1.0, weight_decay=0.5)
    jopt, topt = JT.make_optimizer(JTC(**kw)), TO.RDTOptimizer(TC.TrainConfig(**kw))
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: _t(v) for k, v in params.items()}
    js, ts = jopt.init(jparams), topt.init(tparams)
    for i, scale in enumerate([2.0, 1e-2, 2e-2]):
        g = {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
        norm = np.sqrt(sum(np.sum(np.square(v, dtype=np.float64)) for v in g.values()))
        assert (norm > kw["max_grad_norm"]) == (i == 0), norm
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jparams)
        tu, ts = topt.update({k: _t(v) for k, v in g.items()}, ts, tparams)
        adam = serialization.to_state_dict(js)["1"]["0"]
        assert ts.count == int(adam["count"]) == i + 1
        for k in shapes:
            want = np.asarray(ju[k])
            np.testing.assert_allclose(tu[k].numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"update {k} at {i}")
            for name in ("mu", "nu"):
                want = np.asarray(adam[name][k])
                np.testing.assert_allclose(getattr(ts, name)[k].numpy(), want, rtol=0,
                                           atol=1e-6 * np.abs(want).max(),
                                           err_msg=f"{name} {k} at {i}")
        jparams = {k: jparams[k] + ju[k] for k in shapes}
        tparams = {k: tparams[k] + tu[k] for k in shapes}


def test_param_dtype_bf16_requires_8bit_adam():
    with pytest.raises(ValueError, match="use_8bit_adam"):
        TT.init_train_state(TR.RDTRunnerConfig(model=TC.rdt_tiny()),
                            TC.TrainConfig(param_dtype="bfloat16"), device="cpu")


@pytest.mark.parametrize("scheduler", ["constant", "constant_with_warmup", "linear", "cosine"])
def test_learning_rate_schedules_match_optax(scheduler):
    """make_schedule against the JAX package's optax schedule under jit, at
    counts across the warm-up, its end and the decay: float32 to 2 ulps
    (XLA may contract a multiply-add into one FMA; the cosine is numpy's)."""
    kw = dict(lr_scheduler=scheduler, learning_rate=3e-4, lr_warmup_steps=7,
              max_train_steps=50)
    import optax

    sched = TO.make_schedule(TC.TrainConfig(**kw))
    # the schedules as rdt_train.make_optimizer builds them
    lr, warm = kw["learning_rate"], kw["lr_warmup_steps"]
    warmup = optax.schedules.linear_schedule(0.0, lr, warm)
    if scheduler in ("constant", "constant_with_warmup"):
        jfn = optax.schedules.join_schedules([warmup, optax.schedules.constant_schedule(lr)],
                                             [warm])
    elif scheduler == "linear":
        jfn = optax.schedules.join_schedules(
            [warmup, optax.schedules.linear_schedule(lr, 0.0, 50 - warm)], [warm])
    else:
        jfn = optax.schedules.warmup_cosine_decay_schedule(0.0, lr, warm, 50)
    jit_fn = jax.jit(jfn)
    for c in [0, 1, 3, 6, 7, 8, 20, 49, 50, 60]:
        want = np.float32(jit_fn(jnp.asarray(c, jnp.int32)))
        got = sched(c)
        assert abs(got - want) <= 2 * np.spacing(np.float32(max(abs(want), 1e-30))), (c, got, want)


# ---- (e) 8-bit Adam ---------------------------------------------------------------


def test_adamw8bit_moments_match_jax_bit_for_bit(rng):
    """Three updates of adamw8bit on the same gradients (a 2-D leaf in the
    transposed layout, a ragged 1-D leaf, a block of zeros): the int8 codes
    and float32 scales equal JAX's (eager) bit for bit, the updates to
    1e-6 relative."""
    shapes = {"w": (37, 300), "b": (300,), "z": (5, 9)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=1e-3)
    sched = TO.make_schedule(TC.TrainConfig(lr_warmup_steps=2, learning_rate=1e-3))
    jopt = JA8.adamw8bit(lambda c: jnp.float32(sched(int(c))), **kw)
    # JAX holds "w" as the flax kernel (300, 37), the port as (37, 300)^T
    jparams = {"w": jnp.asarray(params["w"].T), "b": jnp.asarray(params["b"]),
               "z": jnp.asarray(params["z"])}
    tparams = {k: _t(v) for k, v in params.items()}
    js, ts = jopt.init(jparams), TA8.init({**tparams, "w": tparams["w"].t()})
    for i in range(3):
        g = {k: rng.normal(size=s).astype(np.float32) * 10.0 ** -i for k, s in shapes.items()}
        g["z"][:] = 0.0
        ju, js = jopt.update({"w": jnp.asarray(g["w"].T), "b": jnp.asarray(g["b"]),
                              "z": jnp.asarray(g["z"])}, js, jparams)
        tu, ts = TA8.update({k: _t(v) for k, v in g.items()}, ts, tparams, sched,
                            transposed={"w"}, **kw)
        assert ts.count == int(js.count) == i + 1
        for name in ("m_q", "m_s", "v_q", "v_s"):
            for k in shapes:
                np.testing.assert_array_equal(getattr(ts, name)[k].numpy(),
                                              np.asarray(getattr(js, name)[k]))
        np.testing.assert_allclose(tu["w"].numpy(), np.asarray(ju["w"]).T, rtol=1e-6,
                                   atol=1e-12)
        np.testing.assert_allclose(tu["b"].numpy(), np.asarray(ju["b"]), rtol=1e-6,
                                   atol=1e-12)


# ---- (f) the data pipeline ----------------------------------------------------------


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    """Two npz episodes by the port's writer and two h5 episodes by JAX's,
    40 x 40 frames (the pad-and-resize to 28 runs cv2 in both)."""
    root = tmp_path_factory.mktemp("rdt_episodes")
    kw = dict(num_steps=48, img_size=40, chunk=8, lang_len=6, lang_dim=32)
    npz = TE.make_synthetic_dataset(str(root / "npz"), n_episodes=2, **kw)
    h5 = JE.make_synthetic_dataset(str(root / "h5"), n_episodes=2, **kw)
    return {"npz": npz, "h5": h5, "root": str(root)}


def test_synthetic_npz_episode_equals_jax_h5_episode(episodes):
    """The port's npz writer draws JAX's arrays for the same seed."""
    with TE.EpisodeFile(episodes["npz"][1]) as t, JE.EpisodeFile(episodes["h5"][1]) as j:
        for key in ("ee_poses", "gripper_pos", "camera1/camera1", "camera2/camera2",
                    "instruct_embeddings", "gelsight_force/forces",
                    "gelsight_force/displacement", "vla_action", "camera1_resized"):
            np.testing.assert_array_equal(np.asarray(t[key]), np.asarray(j[key]))


def test_list_episode_files_prefers_h5(tmp_path):
    for name in ("episode_2.npz", "episode_10.h5", "episode_2.h5", "episode_1.npz"):
        (tmp_path / name).write_bytes(b"")
    got = [os.path.basename(p) for p in TE.list_episode_files(str(tmp_path), (".h5", ".npz"))]
    assert got == ["episode_1.npz", "episode_2.h5", "episode_10.h5"]
    assert [os.path.basename(p) for p in TE.list_episode_files(str(tmp_path))] == [
        "episode_2.h5", "episode_10.h5"]


@pytest.mark.parametrize("fmt", ["npz", "h5"])
def test_consumer_batches_equal_jax_bit_for_bit(episodes, fmt):
    """VLAConsumerDataset + collate with condition masking, state noise and
    image augmentation on (cv2's blurs included): three batches of 6 equal
    JAX's bit for bit for the same seed and files."""
    kw = dict(chunk_size=8, image_size=28, cond_mask_prob=0.3, state_noise_snr=30.0,
              image_aug=True, cam_ext_mask_prob=0.5)
    jd = JCons.VLAConsumerDataset(JDC(**kw), seed=5, file_paths=episodes[fmt])
    td = TCons.VLAConsumerDataset(TC.DataConfig(**kw), seed=5, file_paths=episodes[fmt])
    for _ in range(3):
        want = JCons.collate([jd.sample() for _ in range(6)], max_lang_len=16)
        got = TCons.collate([td.sample() for _ in range(6)], max_lang_len=16)
        assert set(got) == set(want)
        for k, v in want.items():
            if k == "dataset_names":
                assert got[k] == v
            else:
                assert got[k].dtype == v.dtype, k
                np.testing.assert_array_equal(got[k], v, err_msg=k)


# ---- (g) the trainer: checkpoints both ways --------------------------------------------


TINY_KW = dict(batch_size=B, grad_accum=A, lr_warmup_steps=0, checkpointing_period=2,
               sample_period=3, checkpoints_total_limit=2, prefetch_workers=1)


def _tiny_trainer(out, **kw):
    from vla_touch_tpu_torch.train import rdt_loop as TRL

    tcfg = TC.TrainConfig(**dict(TINY_KW, **kw))
    dcfg = TC.DataConfig(chunk_size=8, image_size=28, image_aug=True, cond_mask_prob=0.2)
    return TRL.RDTTrainer(TR.RDTRunnerConfig(model=TC.rdt_tiny()), tcfg, dcfg, out,
                          vision_cfg=TRL.TINY_VIT, device="cpu")


def _jax_trainer(out, **kw):
    from vla_touch_tpu.models.encoders.vit import ViTConfig
    from vla_touch_tpu.train import rdt_loop as JRL

    vit = ViTConfig(hidden_size=48, num_layers=1, num_heads=4, mlp_dim=96, image_size=28,
                    patch_size=14, use_cls_token=False, use_layerscale=False, gelu_tanh=True)
    tcfg = JTC(**dict(TINY_KW, **kw))
    return JRL.RDTTrainer(JR.RDTRunnerConfig(model=j_rdt_tiny()), tcfg,
                          JDC(chunk_size=8, image_size=28), out, vision_cfg=vit)


def test_trainer_data_stream_is_a_function_of_the_seed(episodes, tmp_path, monkeypatch):
    """The batches the trainer hands to its step (image augmentation on)
    are the same with 0, 1 and 3 prefetch threads, the builders slowed at
    random so that later batches finish first; another seed gives others."""
    import random
    import time

    from vla_touch_tpu_torch.data.consumer import VLAConsumerDataset

    def stream(workers, seed=7):
        trainer = _tiny_trainer(str(tmp_path / f"w{workers}s{seed}"), prefetch_workers=workers)
        seen = []
        monkeypatch.setattr(trainer, "_step", lambda state, batch, *a: seen.append(batch))
        trainer.train(file_paths=episodes["npz"], max_steps=5, resume_from=None, seed=seed)
        return seen

    sample = VLAConsumerDataset.sample
    monkeypatch.setattr(VLAConsumerDataset, "sample",
                        lambda self: (time.sleep(random.random() * 0.02), sample(self))[1])
    want = stream(0)
    assert len(want) == 5
    for workers in (1, 3):
        got = stream(workers)
        for a, b in zip(got, want, strict=True):
            assert a.keys() == b.keys()
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{workers} threads: {k}")
    other = stream(3, seed=8)
    assert not all(np.array_equal(a["images"], b["images"]) for a, b in zip(other, want))


def _assert_state_equals_jax(tree, jstate):
    for name, want in (("params", jstate.params), ("ema", jstate.ema.shadow),
                       ("opt_state", serialization.to_state_dict(jstate.opt_state))):
        for path, a, b in _leaves(tree[name], want):
            np.testing.assert_array_equal(a, b, err_msg=f"{name}{path}")
    assert tree["meta"] == {"step": int(jstate.step),
                            "ema_num_updates": int(jstate.ema.num_updates)}


@pytest.mark.parametrize("use_8bit_adam", [False, True])
def test_trainer_resumes_prunes_and_checkpoints_load_in_both_packages(episodes, tmp_path,
                                                                      use_8bit_adam):
    """The port's trainer: 4 steps (checkpoints at 2 and 4, a sampling eval
    at 3), then resume from the latest to 5 (the limit of 2 prunes step 2).
    JAX's RDTTrainer.load_checkpoint reads the port's final checkpoint and
    gets its state bit for bit; a checkpoint JAX writes loads into the
    port's trainer bit for bit."""
    import json

    from vla_touch_tpu_torch.utils.checkpoint import list_checkpoints

    out = str(tmp_path / "port")
    trainer = _tiny_trainer(out, use_8bit_adam=use_8bit_adam)
    state = trainer.train(file_paths=episodes["npz"], max_steps=4, resume_from=None)
    assert state.step == 4 and [s for s, _ in list_checkpoints(out)] == [2, 4]
    rows = [json.loads(line) for line in open(trainer.metrics_log)]
    assert any(r.get("kind") == "sample_eval" and np.isfinite(r["sample_mse"]) for r in rows)
    state = _tiny_trainer(out, use_8bit_adam=use_8bit_adam).train(
        file_paths=episodes["npz"], max_steps=5)
    assert state.step == 5 and [s for s, _ in list_checkpoints(out)] == [4, 5]
    tree = FF.rdt_train_state_to_flax(state, trainer.optimizer)

    jtrainer = _jax_trainer(str(tmp_path / "jax"), use_8bit_adam=use_8bit_adam)
    rcfg = JR.RDTRunnerConfig(model=j_rdt_tiny())
    jstate = JT.init_train_state(rcfg, jtrainer.tcfg, None, params=_base_params())
    jstate = jtrainer.load_checkpoint(jstate, os.path.join(out, "checkpoint-5"))
    _assert_state_equals_jax(tree, jstate)

    # the other way: a JAX state (the loaded one, perturbed) saved by JAX
    jstate = dataclasses.replace(
        jstate, params=jax.tree.map(lambda p: np.asarray(p) * 1.5, jstate.params),
        step=jnp.asarray(9, jnp.int32))
    jtrainer.save_checkpoint(jstate, 9)
    back = _tiny_trainer(str(tmp_path / "port2"), use_8bit_adam=use_8bit_adam)
    pstate = TT.init_train_state(back.rcfg, back.tcfg, device="cpu")
    back.optimizer = TT.make_optimizer(back.tcfg, pstate.module)
    pstate = back.load_checkpoint(pstate, os.path.join(str(tmp_path / "jax"), "checkpoint-9"))
    assert pstate.step == 9
    _assert_state_equals_jax(FF.rdt_train_state_to_flax(pstate, back.optimizer), jstate)


def test_sample_metrics_match_jax(rng):
    """sample_metrics on the training parameters (the serving rollout, the
    starting noise given) against JAX's: float32 to 1e-5 relative."""
    from vla_touch_tpu.train import rdt_loop as JRL
    from vla_touch_tpu_torch.train import rdt_loop as TRL

    m = j_rdt_tiny()
    params = _jparams(m, rng)
    batch = _batch(m, rng, (3,))
    batch["state_norm"] = np.abs(rng.normal(size=(3, 128))).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want = JRL.sample_metrics(JR.RDTRunnerConfig(model=m), params, key, batch,
                              jnp.asarray(batch["img_tokens"]))
    init = np.asarray(jax.random.normal(key, (3, m.horizon, m.output_dim), jnp.float32))
    got = TRL.sample_metrics(TR.RDTRunnerConfig(model=TC.rdt_tiny()), _port_module(params),
                             {k: _t(v) for k, v in batch.items()}, _t(batch["img_tokens"]),
                             init_noise=_t(init))
    for k in ("sample_mse", "sample_l2err"):
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k


# ---- (h) the command line ------------------------------------------------------------


class _Parsed(Exception):
    pass


def _jax_parser():
    from vla_touch_tpu.train import rdt_loop as JRL

    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def capture(self, *a, **kw):
        seen["p"] = self
        raise _Parsed

    argparse.ArgumentParser.parse_args = capture
    try:
        JRL.main([])
    except _Parsed:
        pass
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen["p"]


def _surface(p):
    return {tuple(a.option_strings): (a.dest, a.default, a.choices, a.type, a.const, a.nargs)
            for a in p._actions if a.option_strings and a.dest != "help"}


def test_cli_flag_surface_equals_jax_plus_device():
    from vla_touch_tpu_torch.train import rdt_loop as TRL

    port = _surface(TRL.build_parser())
    assert port.pop(("--device",))[1] is None          # None: CUDA
    assert port == _surface(_jax_parser())


@pytest.mark.parametrize("flags,item", [
    (["--coordinator", "h:1"], "A11"), (["--num_processes", "2"], "A11"),
    (["--process_id", "0"], "A11"), (["--zero3"], "A11"),
    (["--pretrained_model_name_or_path", "x.bin"], "A9"),
    (["--siglip_checkpoint", "x.safetensors"], "A9"), (["--push_to_hub"], "A9"),
    (["--data_format", "epc"], "A6")])
def test_cli_flags_left_out_raise(flags, item, tmp_path):
    from vla_touch_tpu_torch.train import rdt_loop as TRL

    with pytest.raises(NotImplementedError, match=item):
        TRL.main(flags + ["--output_dir", str(tmp_path), "--device", "cpu"])


def test_cli_trains_saves_and_resumes_on_cpu(episodes, tmp_path):
    """python -m vla_touch_tpu_torch.train.rdt_loop --model_scale tiny ...
    --device cpu on npz episodes: trains, saves, resumes; its checkpoint
    loads in JAX's RDTTrainer."""
    import shutil

    from vla_touch_tpu_torch.train import rdt_loop as TRL

    data = tmp_path / "data" / "mango_hdf5_gelsight"
    data.mkdir(parents=True)
    for p in episodes["npz"]:
        shutil.copy(p, data)
    out = str(tmp_path / "out")
    args = ["--model_scale", "tiny", "--data_root", str(tmp_path / "data"),
            "--output_dir", out, "--batch_size", "2", "--grad_accum", "2",
            "--lr_warmup_steps", "0", "--checkpointing_period", "2", "--sample_period", "2",
            "--image_aug", "--dataloader_num_workers", "1", "--device", "cpu"]
    assert TRL.main(args + ["--max_train_steps", "2"]).step == 2
    state = TRL.main(args + ["--max_train_steps", "3"])
    assert state.step == 3
    jtrainer = _jax_trainer(str(tmp_path / "jax"))
    jstate = JT.init_train_state(JR.RDTRunnerConfig(model=j_rdt_tiny()), jtrainer.tcfg, None,
                                 params=_base_params())
    jstate = jtrainer.load_checkpoint(jstate, os.path.join(out, "checkpoint-3"))
    assert int(jstate.step) == 3
    np.testing.assert_array_equal(
        np.asarray(jstate.params["model"]["final_ffn"]["fc2"]["kernel"]),
        state.module.model.final_ffn.fc2.weight.detach().numpy().T)
