"""The yardstick's arithmetic against hand counts and against the
reference's own products counted as they run."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import roofline as RL
from benchmark.drivers import common as C
from benchmark.reference import model as M
from benchmark.reference import serve as RS
from benchmark.tests.portbench_tiny import tiny_config


def test_k1_bound_by_hand():
    # RDT-1B's image cross-attention at bucket 8: q, k, v, out in bf16
    b, f = RL.k1_bound_s(8, 67, 4374, 32, 64, False)
    nbytes = 2 * (2 * 8 * 67 * 32 * 64 + 2 * 8 * 4374 * 32 * 64)
    assert b == pytest.approx(nbytes / 3.35e12, rel=1e-12)
    assert f == pytest.approx(4 * 8 * 32 * 67 * 4374 * 64 / 989e12, rel=1e-12)
    # SigLIP at its true head dim 72, 48 frames
    b, f = RL.k1_bound_s(48, 729, 729, 16, 72, False)
    assert f > b
    total, binds = RL.least_s([(1.0, 2.0), (3.0, 1.0), (0.5, 0.1)])
    assert total == 5.5 and binds == "bytes"


def test_siglip_flops_by_hand():
    v = {"hidden_size": 1152, "num_layers": 27, "num_heads": 16, "mlp_dim": 4304,
         "patch_size": 14, "image_size": 384, "num_channels": 3}
    n, D = 729, 1152
    layer = 2 * n * D * 3 * D + 4 * n * n * D + 2 * n * D * D + 2 * 2 * n * D * 4304
    assert RL.siglip_flops(v, 6) == 6 * (2 * n * 588 * D + 27 * layer)


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_served_chunk_flops_match_the_reference_as_it_runs():
    """The reference recomputes every block's condition K/V at each solver
    step, which the count (the condition once a chunk) leaves out."""
    config = tiny_config()
    cfg = config["rdt"]
    ref = M.Ref({**C.rdt_weights(config, 3, "cpu", torch.float32),
                 **C.siglip_weights(config, 3, "cpu", torch.float32)})
    rng = np.random.default_rng(0)
    L = 11
    req = {"proprio": rng.standard_normal(10).astype(np.float32),
           "images": rng.integers(0, 256, (6, 28, 28, 3), dtype=np.uint8),
           "image_mask": np.ones(6, bool),
           "text_embeds": rng.standard_normal((L, 32)).astype(np.float32)}
    noise = torch.randn(cfg["horizon"], cfg["output_dim"])
    got = _counted(lambda: RS.served_chunk(ref, config, req, noise))
    steps = config["noise"]["num_inference_timesteps"]
    H = cfg["hidden_size"]
    kv_again = (steps - 1) * sum(2 * (L if i % 2 == 0 else cfg["img_cond_len"]) * H * 2 * H
                                 for i in range(cfg["depth"]))
    assert got == RL.served_chunk_flops(config, L) + kv_again


def test_train_flops_match_the_reference_forward():
    from benchmark.reference import train as RT

    config = tiny_config()
    cfg = config["rdt"]
    ref = M.Ref(C.rdt_weights(config, 3, "cpu", torch.float32))
    B, L, S = 2, 9, cfg["state_token_dim"]
    mb = {"lang_tokens": torch.randn(B, 16, 32), "lang_mask": torch.arange(16)[None].repeat(B, 1) < L,
          "state_tokens": torch.randn(B, 1, S), "action_gt": torch.randn(B, cfg["horizon"], S),
          "action_mask": torch.ones(B, 1, S), "ctrl_freqs": torch.full((B,), 10.0)}
    tokens = torch.randn(B, cfg["img_cond_len"], cfg["img_token_dim"])
    got = _counted(lambda: RT.diffusion_loss(ref, config, mb, tokens,
                                             torch.randn(B, cfg["horizon"], S),
                                             torch.tensor([3, 700], dtype=torch.int32)))
    assert 3 * got == RL.train_step_flops(config, [L] * B, 0)["rdt"]
