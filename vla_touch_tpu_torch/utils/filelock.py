"""fcntl file locks (counterpart of ``vla_touch_tpu/utils/filelock.py``):
shared read and exclusive write ``flock``s, blocking or not, for processes
that share files at the host-IO edge."""

from __future__ import annotations

import fcntl


class FileLock:
    def __init__(self, f):
        """``f``: an open file object (kept open for the lock lifetime)."""
        self._f = f

    def read_lock(self, blocking: bool = True) -> None:
        """Shared lock; non-blocking raises ``BlockingIOError`` when held
        exclusively elsewhere."""
        fcntl.flock(self._f.fileno(), fcntl.LOCK_SH | (0 if blocking else fcntl.LOCK_NB))

    def write_lock(self, blocking: bool = True) -> None:
        """Exclusive lock; non-blocking raises ``BlockingIOError`` when held
        elsewhere."""
        fcntl.flock(self._f.fileno(), fcntl.LOCK_EX | (0 if blocking else fcntl.LOCK_NB))

    def release(self) -> None:
        fcntl.flock(self._f.fileno(), fcntl.LOCK_UN)

    def __enter__(self):
        self.write_lock()
        return self

    def __exit__(self, *exc):
        self.release()
        return False
