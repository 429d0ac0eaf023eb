"""PyTorch port, RDT-170M's widths against the JAX package on the CPU: the
quantized chunk of an RDT-170M cut to 2 blocks (hidden 1152, 16 heads, head
dim 72, horizon 64, T5-XXL and SigLIP token widths) over a short image
context, through ``rdt_predict_action_quant`` with the int8 condition cache
(K3 at D 72; JAX's kernel pads D to 128 lanes, the port's cache rows are
72 wide in 80-byte storage) and with the bf16 one.  The JAX side runs its
Pallas kernels in interpret mode, the port its plain versions (CPU
tensors).  The JAX chunk draws its starting noise from its key; the port is
handed the same draw as ``init_noise``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (caps torch's threads under xdist)
from jax.experimental.pallas import tpu as pltpu

from vla_touch_tpu.config import NoiseSchedulerConfig, rdt_170m
from vla_touch_tpu.models.rdt import quant_serve as JQS
from vla_touch_tpu.models.rdt import runner as JR
from vla_touch_tpu_torch import config as TC
from vla_touch_tpu_torch.models.rdt import quant_serve as TQS
from vla_touch_tpu_torch.models.rdt import runner as TR
from vla_touch_tpu_torch.utils import from_flax as FF

# RDT-170M at depth 2, 2 frames x 3 cameras x 16 patches of image context
CUT = dict(depth=2, img_cond_len=96, img_pos_embed_grid=(2, -3, 16), dtype="float32")
STEPS = 2
RCFG = JR.RDTRunnerConfig(model=dataclasses.replace(rdt_170m(), **CUT),
                          noise=NoiseSchedulerConfig(num_inference_timesteps=STEPS))
TCFG = TR.RDTRunnerConfig(model=dataclasses.replace(TC.rdt_170m(), **CUT),
                          noise=TC.NoiseSchedulerConfig(num_inference_timesteps=STEPS))


@pytest.fixture(scope="module")
def runners():
    """JAX's RDT-170M cut (final projection made non-zero) and the port's
    float32 copy of it through ``from_flax``."""
    params = JR.init_rdt(RCFG, jax.random.PRNGKey(0))
    r = np.random.default_rng(0)
    fc2 = params["model"]["final_ffn"]["fc2"]
    fc2["kernel"] = jnp.asarray(r.normal(size=fc2["kernel"].shape) * 0.02, jnp.float32)
    port = FF.load_into(TR.RDTRunnerModule(TCFG.model), FF.rdt_runner(params)).eval()
    return params, port.requires_grad_(False)


def _inputs(seed=0):
    m = RCFG.model
    r = np.random.default_rng(seed)
    B, Ll = 1, 12
    lang = r.normal(size=(B, Ll, m.lang_token_dim)).astype(np.float32)
    lang_mask = np.ones((B, Ll), bool)
    lang_mask[0, 9:] = False
    img = r.normal(size=(B, m.img_cond_len, m.img_token_dim)).astype(np.float32)
    state = r.normal(size=(B, 1, m.state_token_dim)).astype(np.float32)
    amask = np.ones((B, 1, m.output_dim), np.float32)
    freqs = np.asarray([10.0], np.float32)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(1), (B, m.horizon, m.output_dim),
                                       jnp.float32))
    return (lang, lang_mask, img, state, amask, freqs), noise


def test_rdt_170m_widths_are_the_published_ones():
    """The cut keeps RDT-170M's widths (hidden 1152, 16 heads of 72,
    horizon 64, T5-XXL and SigLIP token widths) in both packages."""
    for m in (RCFG.model, TCFG.model):
        assert (m.lang_token_dim, m.img_token_dim, m.depth) == (4096, 1152, 2)
        assert (m.hidden_size, m.num_heads, m.horizon) == (1152, 16, 64)
        assert m.hidden_size // m.num_heads == 72


def test_rdt_170m_int8_cache_is_row_aligned(runners):
    """The int8 condition cache at D 72: codes (B, L, 16, 72) in storage
    80 wide (K3's 16-byte rows), zero past 72, scales (B, 16, 72)."""
    _, port = runners
    tqp = TQS.quantize_rdt_params(port, weights="int8")
    args, _ = _inputs()
    lc = TQS._adaptor(tqp.lang_adaptor, torch.as_tensor(args[0]).to(torch.bfloat16))
    ic = TQS._adaptor(tqp.img_adaptor, torch.as_tensor(args[2]).to(torch.bfloat16))
    kv = TQS.compute_cond_kv_quant(tqp.model, TCFG.model, lc, ic, kv_cache="int8")
    for (kind, k_i8, sk, v_i8, sv), L in zip(kv, (12, 96)):
        assert kind == "int8"
        for codes in (k_i8, v_i8):
            assert codes.shape == (1, L, 16, 72) and codes.stride() == (L * 16 * 80, 16 * 80,
                                                                      80, 1)
            assert not torch.as_strided(codes, (1, L, 16, 80), codes.stride())[..., 72:].any()
        assert sk.shape == sv.shape == (1, 16, 72)


@pytest.mark.parametrize("kv_cache", ["int8", "bf16"])
def test_rdt_170m_predict_action_quant_matches_jax(runners, kv_cache):
    """The 2-step int8-weight chunk of the RDT-170M cut vs JAX's on the same
    weights and noise, with the int8 condition cache (K3 at D 72) and the
    bf16 one.  As the tiny config's chunk test (``test_torch_quant.py``):
    the float32 solver state and timestep embeddings differ in the last
    bits, which flips a few per-token int8 codes; gate <= 5e-2 x max|jax|
    and corr > 0.999."""
    params, port = runners
    jqp = JQS.quantize_rdt_params(params, weights="int8")
    tqp = TQS.quantize_rdt_params(port, weights="int8")
    args, noise = _inputs()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JQS.rdt_predict_action_quant(
            RCFG, jqp, jax.random.PRNGKey(1), *args, kv_cache=kv_cache,
            init_noise=noise)).astype(np.float32)
    got = TQS.rdt_predict_action_quant(TCFG, tqp, *(torch.as_tensor(a) for a in args),
                                       kv_cache=kv_cache,
                                       init_noise=torch.as_tensor(noise)).numpy()
    assert got.shape == want.shape == (1, 64, 128)
    assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999
