"""Multi-robot serving pool: dynamic batching over the batched policy step
(counterpart of ``vla_touch_tpu/runtime/serving_pool.py``).

The reference serves one robot per process (its ROS loop owns the model);
this pool lets several robots share one card:

- robot sessions ``submit()`` single requests from their own threads;
- a dispatcher thread coalesces requests for up to ``max_wait_ms``, pads
  the batch up to the next size in ``buckets`` (a fixed set, so the card
  sees a few batch shapes only), runs the batched step and resolves each
  request's Future with its row;
- text conditions are padded to a fixed length (``text_pad_len``, the
  model's ``max_lang_cond_len`` in :func:`from_policy`) with their masks,
  so robots with different instructions batch together.

The pool's spare rows are zero: every frame and every language key of such
a row is masked.  The pool is policy-agnostic: it wraps any batched
callable ``fn(proprio, images, image_mask, text_embeds, text_mask) ->
chunk`` on numpy arrays; :func:`from_policy` builds one over
:func:`runtime.policy.policy_step` with a seeded noise stream.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from queue import Empty, Queue
from typing import Callable, Optional, Sequence

import numpy as np
import torch


@dataclass
class _Request:
    proprio: np.ndarray        # (D,)
    images: np.ndarray         # (nf, S, S, 3)
    image_mask: np.ndarray     # (nf,)
    text_embeds: np.ndarray    # (L, Dt)
    text_mask: np.ndarray      # (L,)
    future: Future = field(default_factory=Future)


def _pad_rows(rows: Sequence[np.ndarray], pad_to: int,
              pad_len: Optional[int] = None) -> np.ndarray:
    """Stack per-request arrays, padding the leading (length) axis of each
    to ``pad_len`` (default: the batch max) and the batch axis to
    ``pad_to`` with zero rows."""
    max_l = pad_len if pad_len is not None else max(r.shape[0] for r in rows)
    if any(r.shape[0] > max_l for r in rows):
        raise ValueError(
            f"request length {max(r.shape[0] for r in rows)} exceeds the "
            f"pool's fixed pad length {max_l}")
    padded = []
    for r in rows:
        if r.shape[0] < max_l:
            pad = np.zeros((max_l - r.shape[0],) + r.shape[1:], r.dtype)
            r = np.concatenate([r, pad], axis=0)
        padded.append(r)
    while len(padded) < pad_to:
        padded.append(np.zeros_like(padded[0]))
    return np.stack(padded)


class PolicyServingPool:
    """Dynamic-batching dispatcher over a batched policy step."""

    def __init__(self, batched_step: Callable, max_batch: int = 8,
                 max_wait_ms: float = 3.0,
                 buckets: Sequence[int] = (1, 2, 4, 8),
                 text_pad_len: Optional[int] = None):
        if sorted(buckets) != list(buckets) or max_batch != buckets[-1]:
            raise ValueError("buckets must be sorted and end at max_batch")
        self._fn = batched_step
        self._max_batch = max_batch
        self._max_wait = max_wait_ms / 1e3
        self._buckets = tuple(buckets)
        # text is padded to this fixed length, not the batch's longest: the
        # step sees one text shape per bucket whatever the instructions
        self._text_pad_len = text_pad_len
        self._queue: Queue = Queue()
        self._closed = False
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self._serve, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- client --
    def submit(self, proprio, images, image_mask, text_embeds,
               text_mask) -> Future:
        """Enqueue one robot's request; returns a Future of its
        (horizon, D_low) action chunk."""
        req = _Request(np.asarray(proprio), np.asarray(images),
                       np.asarray(image_mask), np.asarray(text_embeds),
                       np.asarray(text_mask))
        # the closed-check and the enqueue are atomic with close(), so no
        # request slips in behind the shutdown sentinel unresolved
        with self._lock:
            if self._closed:
                raise RuntimeError("pool is closed")
            self._queue.put(req)
        return req.future

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)      # wake the dispatcher
        self._worker.join(timeout=10)
        while True:                    # never strand a Future
            try:
                req = self._queue.get_nowait()
            except Empty:
                break
            if req is not None and not req.future.done():
                req.future.set_exception(RuntimeError("pool is closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --------------------------------------------------------- dispatcher --
    def _collect(self):
        """Block for the first request, then coalesce for up to max_wait."""
        first = self._queue.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self._max_wait
        while len(batch) < self._max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except Empty:
                break
            if nxt is None:
                self._queue.put(None)  # re-post the shutdown sentinel
                break
            batch.append(nxt)
        return batch

    def _serve(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            try:
                self._run(batch)
            except Exception as e:                # noqa: BLE001
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)

    def _run(self, batch) -> None:
        n = len(batch)
        bucket = next(b for b in self._buckets if b >= n)
        proprio = _pad_rows([r.proprio for r in batch], bucket)
        images = _pad_rows([r.images for r in batch], bucket)
        image_mask = _pad_rows([r.image_mask for r in batch], bucket)
        text = _pad_rows([r.text_embeds for r in batch], bucket,
                         pad_len=self._text_pad_len)
        tmask = _pad_rows([r.text_mask for r in batch], bucket,
                          pad_len=self._text_pad_len)
        chunk = self._fn(proprio, images, image_mask, text, tmask)
        chunk = chunk.cpu().numpy() if isinstance(chunk, torch.Tensor) else np.asarray(chunk)
        for i, req in enumerate(batch):
            req.future.set_result(chunk[i])


def from_policy(cfg, rdt, vision, seed: int = 0, max_batch: int = 8,
                max_wait_ms: float = 3.0, buckets: Sequence[int] = (1, 2, 4, 8),
                text_pad_len: Optional[int] = None, device=None) -> PolicyServingPool:
    """Pool over :func:`runtime.policy.policy_step` on ``device`` (default
    CUDA; the CPU only when asked for).  ``rdt`` is the bf16 runner or a
    quantized twin (``QuantRDTRunner``, run with its bf16 condition cache),
    ``vision`` the SigLIP tower or its serving twin, both on ``device``.

    The starting noise comes from one ``torch.Generator`` on ``device``,
    seeded with ``seed``: one (bucket, horizon, 128) draw per dispatched
    batch, taken under a lock before the batch runs, so two pools with the
    same seed and the same dispatch pattern give the same rows.

    ``text_pad_len`` defaults to the model's ``max_lang_cond_len`` (always
    safe); deployments whose instructions are known to be short may pass a
    tighter bound, since the language condition's work is linear in it.
    On CUDA every kernel library is built before the dispatcher starts.
    """
    from vla_touch_tpu_torch.runtime import policy as P
    from vla_touch_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    for what, module in (("rdt", rdt), ("vision", vision)):
        if P._device_of(module).type != dev.type:
            raise ValueError(f"{what} lies on {P._device_of(module)}, the pool on {dev}")
    if dev.type == "cuda":
        from vla_touch_tpu_torch.csrc import build

        build.build_all()
    m = cfg.rdt.model
    gen = torch.Generator(device=dev).manual_seed(seed)
    lock = threading.Lock()

    def step(proprio, images, image_mask, text_embeds, text_mask):
        with lock:
            noise = torch.randn((proprio.shape[0], m.horizon, m.output_dim),
                                generator=gen, device=dev)
        return P.policy_step(cfg, rdt, vision, *(torch.as_tensor(a, device=dev) for a in (
            proprio, images, image_mask, text_embeds, text_mask)), init_noise=noise)

    if text_pad_len is None:
        text_pad_len = m.max_lang_cond_len
    elif text_pad_len > m.max_lang_cond_len:
        raise ValueError(
            f"text_pad_len {text_pad_len} exceeds the model's max_lang_cond_len "
            f"{m.max_lang_cond_len} (the positional-embedding table has no rows past it)")
    return PolicyServingPool(step, max_batch=max_batch, max_wait_ms=max_wait_ms,
                             buckets=buckets, text_pad_len=text_pad_len)
