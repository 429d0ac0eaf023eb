"""Caps torch's CPU threads in every test process that imports it (each
``tests/test_torch_*.py`` does).

The driver's run spreads the test files over 6 pytest-xdist workers on
one machine; torch's default, one intra-op thread per core in each worker,
oversubscribes the cores (ROADMAP's Tier-1 budget line gives the
measurement).  The cap is the machine's cores shared out over the workers
(``PYTEST_XDIST_WORKER_COUNT``), at least 1; a run in one process keeps
torch's default.

``torch.set_num_threads`` sets the calling thread's OpenMP and MKL thread
counts; a thread started later would run MKL at the process default, and
a GEMM at another thread count can round differently.  So every Python
thread started after this import sets the cap first: a pool's dispatcher
computes with the bits of a direct call on the main thread, as it does
uncapped.
"""

import os
import threading

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
CAP = max(1, (os.cpu_count() or 1) // _WORKERS)

if _WORKERS > 1 and torch.get_num_threads() > CAP:
    torch.set_num_threads(CAP)
    try:
        torch.set_num_interop_threads(CAP)
    except RuntimeError:  # inter-op work already ran in this process
        pass
    _run = threading.Thread.run

    def _capped_run(self):
        torch.set_num_threads(CAP)
        _run(self)

    threading.Thread.run = _capped_run
