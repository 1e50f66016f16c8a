"""The shared ``Retry-After`` spreader (this package's copy of
``jittered_retry_after`` from the JAX package's ``policy/retry.py``; the
retry, hedging and deadline-budget policy of that module belongs to the
request-recovery plane, which is not ported yet).

Every ``Retry-After`` the serving edge emits (SLO sheds) passes through it,
so clients shed in one instant do not come back in one instant.
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["jittered_retry_after"]


def jittered_retry_after(
    base_s: float,
    rng: np.random.Generator | None = None,
    frac: float = 0.25,
) -> float:
    """``base_s`` spread uniformly over ``[base*(1-frac), base*(1+frac)]``.

    Bounded (never more than ``frac`` away from the advertised base, so
    SLO math stays honest) and strictly positive. The shared default RNG
    is deliberately not seeded: two clients shed in the same instant must
    come back at different ones; tests that need determinism pass their
    own generator."""
    if base_s <= 0:
        return base_s
    if rng is None:
        # HTTP handler threads share the default generator, and numpy
        # Generators are not thread-safe.
        with _default_rng_lock:
            u = _default_rng.random()
    else:
        u = rng.random()
    return float(base_s * (1.0 + frac * (2.0 * u - 1.0)))


_default_rng = np.random.default_rng()
_default_rng_lock = threading.Lock()
