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

Both loaders are one pool, :class:`OrderedPrefetcher`, which maps a
function over a task list the same way: results in task order, a bounded
number in flight (the controller datasets' epoch batches);
:class:`PrefetchLoader` is it over the batch indices.
"""

from __future__ import annotations

import collections
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Optional

_END = object()


class OrderedPrefetcher:
    """Map ``fn`` over ``tasks`` on ``workers`` threads, yielding the results
    in task order with at most ``workers + depth`` tasks in flight;
    ``workers`` 0 runs each task when its result is asked for.  A task's
    error is raised where its result would have been yielded.  The output
    is that of ``map(fn, tasks)``, with the work overlapped."""

    def __init__(self, fn: Callable, tasks: Iterable, workers: int = 2, depth: int = 2):
        self._fn = fn
        self._tasks = iter(tasks)
        self._inflight = workers + max(0, depth)
        self._pool = ThreadPoolExecutor(max_workers=workers) if workers > 0 else None
        self._futures: collections.deque = collections.deque()

    def _fill(self):
        while self._pool is not None and len(self._futures) < self._inflight:
            task = next(self._tasks, _END)
            if task is _END:
                return
            self._futures.append(self._pool.submit(self._fn, task))

    def __iter__(self):
        return self

    def __next__(self):
        if self._pool is None:
            task = next(self._tasks, _END)
            if task is _END:
                raise StopIteration
            return self._fn(task)
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


class PrefetchLoader(OrderedPrefetcher):
    """Yield ``make_batch(0)``, ``make_batch(1)``, ... built ahead on
    ``workers`` threads, at most ``depth`` batches beyond the workers in
    flight, the first ones started at once; ``workers`` 0 builds each batch
    when it is asked for.  ``num_batches``: stop after N (None =
    infinite)."""

    def __init__(self, make_batch: Callable[[int], dict], depth: int = 2,
                 workers: int = 1, num_batches: Optional[int] = None):
        super().__init__(make_batch, itertools.count() if num_batches is None
                         else range(num_batches), workers, depth)
        self.make_batch = make_batch
        self._fill()
