"""Warm-start replan quality on the port (the protocol of
``tests/test_warm_quality.py``, slow as JAX's): a tiny RDT trained on
sinusoid trajectories, then cold, warm (skip 2) and prior chunks over four
replans shifted by 4 ticks.  ``chip_smoke.py`` runs the same check on the
card with K1 in the model's attention."""

import importlib.util
import os

import numpy as np
import pytest
import torch_threads  # noqa: F401  (caps torch's threads under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_protocol():
    spec = importlib.util.spec_from_file_location(
        "jax_warm_quality", os.path.join(ROOT, "tests", "test_warm_quality.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_protocol_data_and_prior_equal_jax():
    """The batches (the numpy stream, field by field), the ground-truth
    chunks and the control loop's shifted prior equal the JAX protocol's
    exactly."""
    from vla_touch_tpu.config import rdt_tiny as jax_rdt_tiny
    from vla_touch_tpu_torch.config import rdt_tiny
    from vla_touch_tpu_torch.eval import warm_quality as WQ
    from vla_touch_tpu_torch.runtime.control_loop import shift_prior

    J = _jax_protocol()
    assert (WQ.ADIM, WQ.H, WQ.SHIFT, WQ.W) == (J.ADIM, J.H, J.SHIFT, J.W)
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for B, kw in ((WQ.BATCH, {}), (WQ.BATCH, {}), (WQ.ROWS, {"t": np.full((WQ.ROWS,), 20.0)})):
        phase, t, b = WQ.make_batch(rng, rdt_tiny(), B, **kw)
        jphase, jt, jb = J._batch(jrng, jax_rdt_tiny(), B, **kw)
        np.testing.assert_array_equal(phase, jphase)
        np.testing.assert_array_equal(t, jt)
        assert b.keys() == jb.keys()
        for k in b:
            assert b[k].dtype == jb[k].dtype and b[k].shape == jb[k].shape, k
            np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
    t_next = np.full((WQ.ROWS,), 28.0)
    np.testing.assert_array_equal(WQ.chunk_gt(phase, t_next), J._chunk_gt(phase, t_next))
    chunk = np.random.default_rng(1).standard_normal((WQ.ROWS, WQ.H, 128)).astype(np.float32)
    want = np.concatenate([chunk[:, J.SHIFT:], np.repeat(chunk[:, -1:], J.SHIFT, axis=1)], axis=1)
    np.testing.assert_array_equal(np.stack([shift_prior(c, WQ.SHIFT) for c in chunk]), want)


def test_protocol_rejects_an_unknown_draw_source():
    from vla_touch_tpu_torch.eval import warm_quality as WQ

    with pytest.raises(ValueError, match="draws"):
        WQ.Protocol("cpu", draws="disk")


@pytest.mark.slow
def test_warm_replan_quality_matches_cold():
    from vla_touch_tpu_torch.eval import warm_quality as WQ

    WQ.check(WQ.run(device="cpu"))
