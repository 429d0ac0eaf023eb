"""Host-side prefetch pipeline feeding the device (counterpart of
``vla_touch_tpu/data/pipeline.py``).

A thread pool builds batches ahead of the training loop while the device
runs the previous step::

    loader = PrefetchLoader(lambda i: build_batch(i), depth=2, workers=2,
                            num_batches=n)
    for batch in loader:         # batches arrive pre-built, in index order
        metrics = train_step(state, batch)

Threads (not processes) suffice: batch assembly is numpy/cv2/h5py work
that releases the GIL.

Unlike the JAX package's loader, whose free-running builders call one
``make_batch()`` and hand batches out in the order they finish, this one
calls ``make_batch(i)`` for batch ``i`` and hands them out in index order:
when ``make_batch`` draws batch ``i`` from generators seeded by ``i``, the
stream is a function of the seed, whatever the threads' timing.
"""

from __future__ import annotations

import collections
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional


class PrefetchLoader:
    """Yield ``make_batch(0)``, ``make_batch(1)``, ... built ahead on
    ``workers`` threads, at most ``depth`` batches beyond the workers in
    flight; ``workers`` 0 builds each batch when it is asked for.
    ``num_batches``: stop after N (None = infinite).  A builder's error is
    raised where its batch would have been yielded."""

    def __init__(self, make_batch: Callable[[int], dict], depth: int = 2,
                 workers: int = 1, num_batches: Optional[int] = None):
        self.make_batch = make_batch
        self._indices = (itertools.count() if num_batches is None
                         else iter(range(num_batches)))
        self._inflight = workers + max(0, depth)
        self._pool = ThreadPoolExecutor(max_workers=workers) if workers > 0 else None
        self._futures: collections.deque = collections.deque()
        self._fill()

    def _fill(self):
        while self._pool is not None and len(self._futures) < self._inflight:
            i = next(self._indices, None)
            if i is None:
                return
            self._futures.append(self._pool.submit(self.make_batch, i))

    def __iter__(self):
        return self

    def __next__(self):
        if self._pool is None:
            i = next(self._indices, None)
            if i is None:
                raise StopIteration
            return self.make_batch(i)
        self._fill()
        if not self._futures:
            raise StopIteration
        out = self._futures.popleft().result()
        self._fill()
        return out

    def close(self):
        for f in self._futures:
            f.cancel()
        self._futures.clear()
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
