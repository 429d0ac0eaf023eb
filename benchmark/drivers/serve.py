"""Serving cells: robots in a closed loop through the program's serving
pool (``runtime/serving_pool.py::from_policy`` over
``runtime/policy.py::policy_step``).

Set-up makes the weights and the requests from the seed, warms the pool's
batch shapes (every bucket, by direct calls with their own noise, so the
pool's noise stream starts untouched) and starts the pool.  The window
starts the robots, each submitting its next request the moment its last
returns, and stops them once ``seconds`` have passed; requests still out
are waited for.  A wrapper around the pool's batched step (as the pool
calls it) records each batch: its span, bucket, real rows (those with a
frame present) and which request each row holds.

``correct``: a sample of the finished requests drawn from the seed (the
longest instruction always in it) is served again by the plain reference,
with the noise row the pool drew for it (its stream replayed from the seed
in dispatch order), and the widest relative gap of a chunk, in the policy's
units, is held to its limit.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from benchmark import harness as HN
from benchmark import traffic as TR
from benchmark.drivers import common as C
from benchmark.reference import model as M
from benchmark.reference import serve as RS
from benchmark.trace import Tracer


def padded(reqs: list, bucket: int, text_len: int) -> dict:
    """The arrays the pool hands its step: spare rows zero, text padded."""
    def stack(key, length=None):
        rows = []
        for r in reqs:
            a = r[key]
            if length is not None:
                a = np.concatenate([a, np.zeros((length - a.shape[0],) + a.shape[1:], a.dtype)])
            rows.append(a)
        rows += [np.zeros_like(rows[0])] * (bucket - len(rows))
        return np.stack(rows)

    return {"proprio": stack("proprio"), "images": stack("images"),
            "image_mask": stack("image_mask"), "text_embeds": stack("text_embeds", text_len),
            "text_mask": stack("text_mask", text_len)}


class Recorder:
    """Wraps the pool's batched step; finishes each batch as the pool
    would (its rows copied to the host) and records it.  Starts and stops
    the tracer on batch boundaries, in the dispatcher's thread, so that it
    covers whole cycles; a batch records whether it ran traced and whether
    the tracer was started or stopped just before it (host spans leave
    those out)."""

    def __init__(self, inner, ids: dict, tracer=None, trace_from=0, trace_n=0):
        self.inner, self.ids = inner, ids
        self.batches = []
        self.tracer, self.trace_from, self.trace_n = tracer, trace_from, trace_n
        self.trace_first = None
        self.window_open = False
        self._toggled = False

    def _maybe_trace(self):
        tr, n = self.tracer, len(self.batches)
        if tr is None or tr.done:
            return
        if tr.t0 is None and self.window_open and n >= self.trace_from:
            self.trace_first = n
            tr.start()
            self._toggled = True
        elif tr.t0 is not None and (n >= self.trace_first + self.trace_n or not self.window_open):
            tr.stop()
            self._toggled = True

    def __call__(self, proprio, images, image_mask, text_embeds, text_mask):
        traced = self.tracer is not None and self.tracer.t0 is not None and not self.tracer.done
        t0 = time.perf_counter()
        out = self.inner(proprio, images, image_mask, text_embeds, text_mask)
        out = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
        t1 = time.perf_counter()
        real = np.flatnonzero(image_mask.any(axis=1))
        self.batches.append({"t0": t0, "t1": t1, "bucket": int(proprio.shape[0]),
                             "rows": [self.ids.get(proprio[i].tobytes()) for i in real],
                             "lens": [int(text_mask[i].sum()) for i in real],
                             "in_window": self.window_open, "traced": traced,
                             "after_toggle": self._toggled})
        self._toggled = False
        self._maybe_trace()
        return out


def warm(pcfg, rdt, vision, reqs, buckets, device, calls: int):
    """Each bucket's shapes through ``policy_step``, with noise of their own."""
    from vla_touch_tpu_torch.runtime import policy as P

    m = pcfg.rdt.model
    gen = torch.Generator(device=device).manual_seed(0)
    for b in buckets:
        batch = padded(reqs[:b], b, m.max_lang_cond_len)
        for _ in range(calls):
            noise = torch.randn((b, m.horizon, m.output_dim), generator=gen, device=device)
            P.policy_step(pcfg, rdt, vision, *(torch.as_tensor(v, device=device)
                                               for v in batch.values()),
                          init_noise=noise).cpu()


def run(cell: dict, seed: int, seconds: float, trace: bool, device="cuda",
        control: str = None) -> dict:
    """One run: set-up, the window, then the check.  ``control`` "fp8"
    puts the reference in fp8 in the program's place for the check: its
    chunks, from the same requests and noise rows, are judged instead of
    the served ones (the control, which must come out not correct)."""
    from vla_touch_tpu_torch.runtime import serving_pool as SP

    config, traffic = cell["config"], cell["traffic"]
    pcfg = C.policy_config(config)
    rdt, vision, _ = C.modules(config, seed, device, C.DTYPES[config["rdt"]["dtype"]])
    reqs = TR.serve_requests(traffic, config, seed)
    pool_cfg = traffic["pool"]
    warm(pcfg, rdt, vision, reqs, pool_cfg["buckets"], device, traffic["warmup_calls"])
    pool_seed = TR.sub_seed(seed, "pool")
    pool = SP.from_policy(pcfg, rdt, vision, seed=pool_seed, max_batch=pool_cfg["max_batch"],
                          max_wait_ms=pool_cfg["max_wait_ms"], buckets=pool_cfg["buckets"],
                          text_pad_len=pool_cfg["text_pad_len"], device=device)
    ids = {r["proprio"].tobytes(): i for i, r in enumerate(reqs)}
    tracer = Tracer() if trace else None
    rec = Recorder(pool._fn, ids, tracer, trace_from=3, trace_n=traffic["trace_batches"])
    pool._fn = rec
    timer = C.TowerTimer(vision) if trace else None
    robots = traffic["robots"]
    records = [[] for _ in range(robots)]
    errors = []
    stop = threading.Event()

    def robot(r):
        mine = list(range(r, len(reqs), robots))
        k = 0
        while not stop.is_set():
            q = mine[k % len(mine)]
            k += 1
            t_sub = time.perf_counter()
            try:
                res = pool.submit(**reqs[q]).result(timeout=traffic["result_timeout_s"])
            except Exception as e:                  # noqa: BLE001 - counted as failed
                records[r].append((q, t_sub, None, None))
                errors.append(repr(e))
                continue
            records[r].append((q, t_sub, time.perf_counter(), res))

    setup_s = HN.process_age_s()
    threads = [threading.Thread(target=robot, args=(r,), daemon=True) for r in range(robots)]
    rec.window_open = True
    t_start = time.perf_counter()
    t_end = t_start + seconds
    for th in threads:
        th.start()
    while time.perf_counter() < t_end:
        time.sleep(min(0.05, max(0.0, t_end - time.perf_counter())))
    stop.set()
    rec.window_open = False
    for th in threads:
        th.join(timeout=traffic["result_timeout_s"] + 60)
    alive = sum(th.is_alive() for th in threads)
    pool.close()
    siglip_ms = timer.ms() if timer else []
    peak = C.memory_peak(device)

    flat = [(r, q, ts, td, res) for r in range(robots) for (q, ts, td, res) in records[r]]
    attempted = [x for x in flat if x[2] < t_end]
    done_in = [x for x in attempted if x[3] is not None and x[3] <= t_end]
    failed = sum(1 for x in attempted if x[3] is None) + alive
    lat_ms = [1e3 * (x[3] - x[2]) for x in done_in]
    e2e = {"setup_s": setup_s, "chunks_per_s": len(done_in) / seconds}
    window = [b for b in rec.batches if b["in_window"]]
    ctx = {"config": config, "traffic": traffic, "batches": window, "latencies_ms": lat_ms,
           "siglip_ms": siglip_ms, "trace": tracer.reduce() if tracer and tracer.done else None,
           "traced_batches": [b for b in rec.batches if b["traced"]]}
    finished = [x for x in flat if x[3] is not None]
    noise_log = [(b["bucket"], b["rows"]) for b in rec.batches]
    del pool, rec, rdt, vision, timer
    C.free(device)
    numbers = check(config, traffic, seed, reqs, flat, noise_log, pool_seed, device, control)
    C.free(device)
    return {"e2e": e2e, "ctx": ctx, "numbers": numbers, "attempted": len(attempted),
            "failed": failed, "memory_peak": peak, "errors": errors[:3]}


def sample(traffic: dict, seed: int, reqs: list, finished: list) -> list:
    """The finished requests to check: drawn from the seed, the one of the
    longest instruction first."""
    rng = np.random.default_rng(TR.sub_seed(seed, "check"))
    n = min(traffic["check"]["sample"], len(finished))
    if n == 0:
        return []
    longest = max(range(len(finished)), key=lambda i: reqs[finished[i][1]]["text_mask"].sum())
    rest = [i for i in rng.permutation(len(finished)) if i != longest]
    return [finished[i] for i in [longest] + rest[:n - 1]]


def noise_rows(log: list, pool_seed: int, horizon: int, dim: int, device) -> dict:
    """(request, its n-th occurrence) -> the noise row the pool drew: the
    pool's stream replayed from its seed, one (bucket, horizon, dim) draw
    per dispatched batch, in dispatch order."""
    gen = torch.Generator(device=device).manual_seed(pool_seed)
    out, seen = {}, {}
    for bucket, rows in log:
        noise = torch.randn((bucket, horizon, dim), generator=gen, device=device)
        for j, q in enumerate(rows):
            n = seen.get(q, 0)
            seen[q] = n + 1
            out[(q, n)] = noise[j].clone()
    return out


def check(config, traffic, seed, reqs, submitted, noise_log, pool_seed, device,
          control: str = None) -> dict:
    """The widest relative gap, in the policy's units, between a checked
    chunk and the reference's.  ``submitted``: every request sent, as
    (robot, request, submitted, returned or None, chunk or None); a
    request is sent by one robot at a time, so its n-th submission is its
    n-th row in the dispatch log.  ``control`` "fp8" judges the reference
    in fp8 in the served chunks' place."""
    M.float32_matmuls()
    finished = [x for x in submitted if x[3] is not None]
    picked = sample(traffic, seed, reqs, finished)
    if not picked:
        return {"chunk_rel_gap": float("inf")}
    cfg = config["rdt"]
    occurrence, index = {}, {}
    for r, q, ts, td, res in sorted(submitted, key=lambda x: x[2]):
        index[(r, q, ts)] = occurrence.get(q, 0)
        occurrence[q] = index[(r, q, ts)] + 1
    noise = noise_rows(noise_log, pool_seed, cfg["horizon"], cfg["output_dim"], device)
    vdt = C.DTYPES[config["vision"]["dtype"]]
    # the served dtype's values, widened once
    ref = M.Ref({k: v.float() for k, v in
                 {**C.rdt_weights(config, seed, device, C.DTYPES[cfg["dtype"]]),
                  **C.siglip_weights(config, seed, device, vdt)}.items()})
    scale = np.asarray(config["policy"]["action_scale"] or config["policy"]["state_scale"],
                       np.float32)
    if control not in (None, "fp8"):
        raise ValueError(control)
    low = M.Ref(ref.weights, control) if control else None
    worst = 0.0
    for r, q, ts, td, res in picked:
        key = (q, index[(r, q, ts)])
        if key not in noise:
            return {"chunk_rel_gap": float("inf")}
        want = RS.served_chunk(ref, config, reqs[q], noise[key]).cpu().numpy() / scale
        if low is not None:
            res = RS.served_chunk(low, config, reqs[q], noise[key]).cpu().numpy()
        got = np.asarray(res, np.float64) / scale
        gap = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
        worst = max(worst, gap if np.isfinite(gap) else float("inf"))
    return {"chunk_rel_gap": worst}
