"""The trace's reduction and the per-layer readers on made-up events and
batches."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import harness as HN
from benchmark import trace as TR


def _event(name, start_us, dur_us, dev):
    return SimpleNamespace(name=lambda: name, start_ns=lambda: int(start_us * 1000),
                           duration_ns=lambda: int(dur_us * 1000),
                           device_type=lambda: DeviceType.CUDA if dev else DeviceType.CPU)


def test_busy_is_the_union_of_device_intervals():
    events = [_event("k1", 0, 10, True), _event("HtoD copy", 5, 10, True),   # overlap
              _event("k2", 30, 5, True), _event("cudaStreamSynchronize", 14, 20, False),
              _event("k3", 50, 5, True)]
    s = TR.summarize(events, window_s=100e-6)
    assert s["busy_s"] == pytest.approx(25e-6)
    # the gap 15..30 lies in the synchronise; 35..50 under no host event
    assert dict(s["idle_gaps"]) == pytest.approx({"cudaStreamSynchronize": 15e-6, "host": 15e-6})
    assert TR.kernel_s(s, "k1", "k3") == (pytest.approx(15e-6), 2)


def test_busy_needs_device_activity():
    with pytest.raises(RuntimeError):
        TR.summarize([_event("x", 0, 1, False)], 1.0)


def _batch(t0, t1, traced=False, toggle=False, rows=8):
    return {"t0": t0, "t1": t1, "traced": traced, "after_toggle": toggle,
            "rows": list(range(rows)), "lens": [30] * rows}


def test_host_spans_leave_out_the_traced_batches():
    b = [_batch(0.0, 0.5), _batch(0.6, 1.1), _batch(1.5, 2.0, toggle=True),
         _batch(2.1, 2.9, traced=True), _batch(3.4, 3.9, toggle=True), _batch(4.0, 4.5, rows=4)]
    ctx = {"batches": b}
    assert HN.reader("serve.pool_ms").read(ctx) == pytest.approx(100.0)
    assert HN.reader("serve.step_ms").read(ctx) == pytest.approx(500.0)
    assert HN.reader("serve.rows_per_batch").read(ctx) == pytest.approx(44 / 6)
    lat = {"latencies_ms": [float(i) for i in range(1, 101)]}
    assert HN.reader("serve.chunk_p95_ms").read(lat) == pytest.approx(95.05)
    # nothing to read in a finetuning run's context
    assert HN.reader("serve.pool_ms").read({"traced_steps": [[30] * 16]}) is None
    assert HN.reader("serve.chunk_p95_ms").read({"traced_steps": [[30] * 16]}) is None
    assert HN.reader("idle_pct.serve").read({"traced_steps": [], "trace": {}}) is None
