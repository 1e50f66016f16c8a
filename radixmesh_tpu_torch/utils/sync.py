"""Small thread-synchronization primitives.

The reference keeps a lock-wrapped dict (``util/thread.py:4-78``) plus
multiprocessing latches/barriers (``test/test_util.py:35-74``). Here tree
mutation is serialized behind a single per-node lock owned by the cache (see
``cache/mesh_cache.py``), so the only primitives needed are a latch for
startup barriers and an atomic counter for tick/op ids.
"""

from __future__ import annotations

import threading


class AtomicCounter:
    """Monotonic thread-safe counter (reference: ``radix_mesh.py:431-433``
    ``logic_op_counter``; ``util/thread.py:98-103`` ``incOrDefault``)."""

    def __init__(self, start: int = 0):
        self._value = start
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value

    def add(self, n: int = 1) -> int:
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class CountDownLatch:
    """Block until ``count`` calls to :meth:`count_down` (in-process version of
    the reference's Manager-backed latch, ``test_util.py:35-49``)."""

    def __init__(self, count: int):
        self._count = count
        self._cond = threading.Condition()

    def count_down(self) -> None:
        with self._cond:
            if self._count > 0:
                self._count -= 1
                if self._count == 0:
                    self._cond.notify_all()

    def wait(self, timeout: float | None = None) -> bool:
        with self._cond:
            return self._cond.wait_for(lambda: self._count == 0, timeout=timeout)
