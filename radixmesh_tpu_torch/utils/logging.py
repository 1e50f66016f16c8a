"""Node-rank-prefixed logging (the JAX package's ``utils/logging.py``, kept
as this package's own copy: the port imports nothing of the JAX package).

Capability parity with the reference's ``util/log.py:5-13`` (a
``configure_logger(prefix)`` that stamps ``[timestamp][node@rank]`` on every
line), extended with per-module child loggers so subsystems can be filtered,
and a per-key rate limiter (:func:`throttled`) for repeated fault logs —
a stuck ring successor re-fires failure detection every timeout cycle for
hours during a soak, and an unthrottled warning per cycle floods stderr
until the interesting lines are unfindable.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Hashable

_ROOT_NAME = "radixmesh_tpu_torch"

_throttle_lock = threading.Lock()
_throttle_last: dict[Hashable, float] = {}


def throttled(key: Hashable, interval_s: float = 10.0, now: float | None = None) -> bool:
    """True at most once per ``interval_s`` per ``key`` — gate for
    repeated warning/error logs::

        if throttled(("succ_dead", rank)):
            log.warning(...)

    The first call for a key always returns True. Thread-safe; ``now``
    is injectable for tests."""
    t = time.monotonic() if now is None else now
    with _throttle_lock:
        last = _throttle_last.get(key)
        if last is not None and t - last < interval_s:
            return False
        _throttle_last[key] = t
        return True


def reset_throttle() -> None:
    """Forget all throttle state (test isolation)."""
    with _throttle_lock:
        _throttle_last.clear()


def configure_logger(prefix: str = "", level: int = logging.INFO) -> logging.Logger:
    """Configure the framework root logger with a node-identity prefix.

    ``prefix`` is typically ``f"{role}@{rank}"`` so multi-process logs
    interleave legibly.
    """
    fmt = f"[%(asctime)s][{prefix}][%(levelname)s] %(message)s" if prefix else (
        "[%(asctime)s][%(levelname)s] %(message)s"
    )
    logging.basicConfig(level=level, format=fmt, force=True)
    logger = logging.getLogger(_ROOT_NAME)
    logger.setLevel(level)
    return logger


def get_logger(name: str = "") -> logging.Logger:
    return logging.getLogger(f"{_ROOT_NAME}.{name}" if name else _ROOT_NAME)
