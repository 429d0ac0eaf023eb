"""What the controllers' test files share (``tests/test_torch_controllers*.py``):
the sizes, the JAX-side draws, the port modules built from JAX parameters,
and the fixtures (BRIDGeR, the LSTM, DinoV2 shrunk to one layer at 28^2,
synthetic h5 episodes).  Each test file that uses a module-scoped fixture
builds it once for itself."""

import dataclasses
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vla_touch_tpu.config import BridgeControllerConfig as JBC
from vla_touch_tpu.config import BridgeTrainConfig as JBTC
from vla_touch_tpu.config import InterpolantConfig as JIC
from vla_touch_tpu.config import LSTMControllerConfig as JLC
from vla_touch_tpu.models.controllers import bridge as JB
from vla_touch_tpu.models.controllers import interpolants as JI
from vla_touch_tpu.models.controllers import lstm as JL
from vla_touch_tpu.models.encoders import dinov2_runtime as JD
from vla_touch_tpu.models.encoders.vit import ViTConfig as JViT
from vla_touch_tpu.train import bridge_train as JBT
from vla_touch_tpu.utils import ema as JE
from vla_touch_tpu_torch import config as TC
from vla_touch_tpu_torch.models.controllers import bridge as TB
from vla_touch_tpu_torch.models.controllers import interpolants as TI
from vla_touch_tpu_torch.models.controllers import lstm as TL
from vla_touch_tpu_torch.models.encoders import dinov2_runtime as TD
from vla_touch_tpu_torch.models.encoders.vit import ViTConfig as TViT
from vla_touch_tpu_torch.train import bridge_train as TBT
from vla_touch_tpu_torch.train import lstm_train as TLT
from vla_touch_tpu_torch.train.optim import AdamW
from vla_touch_tpu_torch.utils import checkpoint as TCK
from vla_touch_tpu_torch.utils import ema as TE
from vla_touch_tpu_torch.utils import from_flax as FF


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BKW = dict(hidden_dim=32, horizon=8, unet_down_dims=(16, 32))
B, H, D = 4, 8, 10
DINO_KW = dict(hidden_size=384, num_layers=1, num_heads=6, mlp_dim=64, image_size=28,
               patch_size=14)
TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def _jax_draws(key, shape):
    """The t and z that ``si_training_loss`` draws from ``key``."""
    k_t, k_z, _, _ = jax.random.split(key, 4)
    return {"t": _t(jax.random.uniform(k_t, (shape[0],), jnp.float32)),
            "z": _t(jax.random.normal(k_z, shape, jnp.float32))}


def _sde_noise(key, n, shape):
    """The Brownian draws of the JAX ``sde_sample`` scan for ``key``."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


def _stats(seed=7):
    r = np.random.default_rng(seed)
    return {"vla_mins": r.normal(size=10).astype(np.float32) - 1,
            "vla_maxs": r.normal(size=10).astype(np.float32) + 1,
            "action_mins": r.normal(size=10).astype(np.float32) - 1,
            "action_maxs": r.normal(size=10).astype(np.float32) + 1}


def _batch(rng):
    out = {"state": rng.normal(size=(B, D)), "vla_act": rng.normal(size=(B, H, D)),
           "expert_act": rng.normal(size=(B, H, D)), "forces": rng.normal(size=(B, 3)),
           "cam1_feat": rng.normal(size=(B, 384)), "cam2_feat": rng.normal(size=(B, 384))}
    return {k: v.astype(np.float32) for k, v in out.items()}


def _port_bridge(params, cfg):
    with torch.device("meta"):
        m = TB.BridgeControllerModule(cfg, force_decoder=True)
    m = m.to_empty(device="cpu")
    return FF.load_into(m, FF.bridge_controller_full(_np_tree(params)))


@pytest.fixture(scope="module")
def bridge():
    """A small BRIDGeR (force and visual on) in both frameworks on the same
    parameters."""
    jcfg, tcfg = JBC(**BKW), TC.BridgeControllerConfig(**BKW)
    z = jnp.zeros
    params = jax.jit(JB.BridgeControllerModule(jcfg).init)(
        jax.random.PRNGKey(0), z((1, D)), z((1, H, D)), cam1_feat=z((1, 384)),
        cam2_feat=z((1, 384)), forces=z((1, 3)))["params"]
    return jcfg, tcfg, params


@pytest.fixture
def small_dino(monkeypatch):
    """DinoV2-small shrunk to one layer at 28^2 in both packages, and the
    same weights in each (the port's in float32)."""
    monkeypatch.setitem(JD._CONFIGS, "dinov2-small", JViT(**DINO_KW))
    monkeypatch.setitem(TD._CONFIGS, "dinov2-small", TViT(**DINO_KW))
    params = jax.jit(lambda k: JD.init_params("dinov2-small", k))(jax.random.PRNGKey(5))
    with torch.device("meta"):
        enc = TD.DinoV2Encoder(TD.config_for("dinov2-small"))
    enc = FF.load_into(enc.to_empty(device="cpu"), FF.dinov2_runtime(_np_tree(params)))
    return params, enc.eval().requires_grad_(False)


LKW = dict(hidden_dim=32)


@pytest.fixture(scope="module")
def lstm():
    jcfg, tcfg = JLC(**LKW), TC.LSTMControllerConfig(**LKW)
    st = JL.init_lstm_controller(jcfg, jax.random.PRNGKey(1))
    with torch.device("meta"):
        m = TL.LSTMControllerModule(tcfg)
    m = FF.load_into(m.to_empty(device="cpu"), FF.lstm_controller(_np_tree(st.params)))
    return jcfg, tcfg, st.params, m


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    from vla_touch_tpu.data.episode import make_synthetic_dataset

    root = str(tmp_path_factory.mktemp("episodes"))
    make_synthetic_dataset(root, n_episodes=4, num_steps=30, img_size=28, chunk=8,
                           lang_len=2, lang_dim=8, resized_size=28)
    return root
