"""Retry, hedging, and deadline-budget policy for crash-tolerant serving.

Pure policy (no I/O, no threads): the serving edge's request-recovery
plane (``server/recovery.py``) composes these pieces into the actual
failover machinery; the router, the SLO shed paths, and the chaos
workload all read the same knobs so backoff behavior cannot drift
between layers.

Three pieces:

- :class:`RetryPolicy` — per-hop timeouts, capped exponential backoff
  with bounded jitter, a retry cap, and the optional tail-latency
  hedging threshold (duplicate a straggling hop to a second node,
  first-writer-wins).
- :class:`DeadlineBudget` — a request's end-to-end deadline, stamped at
  admission and THREADED through every subsequent hop: no hop (route,
  prefill, decode wait, retry backoff, hedge wait) may wait longer than
  the remaining budget, so a crash-recovery sequence can overshoot the
  admission deadline by at most one already-started backoff — never by
  an unbounded retry tail.
- :class:`RecoveryRecord` — everything needed to resurrect a request on
  a surviving node: the prompt ids, every token delivered so far (the
  byte-exact SSE prefix the client already holds), and the sampling
  params + seed (so a seeded replay redraws the same continuation).
  ``resume_key()`` is ``prompt + delivered`` — exactly the prefix the
  replicated radix tree makes a near-pure cache hit on re-prefill.

:func:`jittered_retry_after` is the shared Retry-After spreader: every
``Retry-After`` the stack emits (SLO sheds, drain 503s, recovery retry
hints) passes through it so synchronized clients cannot form a retry
storm against a recovering fleet.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "RetryPolicy",
    "DeadlineBudget",
    "RecoveryRecord",
    "jittered_retry_after",
]


def jittered_retry_after(
    base_s: float,
    rng: np.random.Generator | None = None,
    frac: float = 0.25,
) -> float:
    """``base_s`` spread uniformly over ``[base*(1-frac), base*(1+frac)]``.

    Bounded (never more than ``frac`` away from the advertised base, so
    SLO math stays honest) and strictly positive. A shared default RNG
    is deliberately NOT seeded: in production the whole point is that
    two clients shed in the same instant come back at different ones;
    tests that need determinism pass their own generator."""
    if base_s <= 0:
        return base_s
    if rng is None:
        # The shared default generator is hit from concurrent HTTP
        # handler threads (every shed response) and numpy Generators are
        # not thread-safe — an unguarded race can hand two "jittered"
        # sheds the identical draw, exactly the synchronization this
        # function exists to break.
        with _default_rng_lock:
            u = _default_rng.random()
    else:
        u = rng.random()
    return float(base_s * (1.0 + frac * (2.0 * u - 1.0)))


_default_rng = np.random.default_rng()
_default_rng_lock = threading.Lock()


@dataclass(frozen=True)
class RetryPolicy:
    """Router-side retry/hedging knobs for one class of traffic.

    ``hop_timeout_s`` is the failure-detection trigger the edge owns: a
    hop that produces no progress for this long is declared dead —
    independent of (and usually far faster than) the mesh's
    ``failure_timeout_s`` ring detection, whose ``cause=dead`` view
    transition is the other resurrection trigger."""

    hop_timeout_s: float = 2.0
    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 2.0
    jitter_frac: float = 0.25
    # Tail-latency hedging: a hop still unfinished after this long gets
    # duplicated to a second node, first-writer-wins. None = off.
    hedge_after_s: float | None = None

    def __post_init__(self):
        if self.hop_timeout_s <= 0:
            raise ValueError("hop_timeout_s must be > 0")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError("backoff_factor must be >= 1")
        if not 0.0 <= self.jitter_frac <= 1.0:
            raise ValueError("jitter_frac must be in [0, 1]")

    def backoff_s(
        self, attempt: int, rng: np.random.Generator | None = None
    ) -> float:
        """Backoff before retry ``attempt`` (1-based): capped exponential
        with bounded jitter — the jitter keeps a fleet of edges that all
        saw the same node die from re-converging on the survivor in one
        synchronized wave."""
        base = min(
            self.backoff_max_s,
            self.backoff_base_s * self.backoff_factor ** max(0, attempt - 1),
        )
        return jittered_retry_after(base, rng, self.jitter_frac)


class DeadlineBudget:
    """End-to-end deadline budget, stamped once at admission.

    Threaded (by reference) from admission through routing, prefill,
    decode, disagg handoff, and every recovery hop: callers clamp each
    wait with :meth:`clamp` so no single hop can spend time the request
    no longer has. ``total_s=None`` means no deadline (every clamp
    passes through, ``expired()`` is always False)."""

    def __init__(
        self,
        total_s: float | None,
        clock=time.monotonic,
        start: float | None = None,
    ):
        self._clock = clock
        self.total_s = total_s
        self.admitted_at = clock() if start is None else start

    def elapsed(self) -> float:
        return self._clock() - self.admitted_at

    def remaining(self) -> float:
        if self.total_s is None:
            return float("inf")
        return self.total_s - self.elapsed()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def clamp(self, want_s: float) -> float:
        """``want_s`` bounded by the remaining budget (never negative).
        THE hop rule: every wait in the recovery path goes through
        here."""
        return max(0.0, min(want_s, self.remaining()))

    def overrun_s(self) -> float:
        """Seconds past the admission deadline (0 while inside it)."""
        if self.total_s is None:
            return 0.0
        return max(0.0, -self.remaining())


@dataclass
class RecoveryRecord:
    """Everything the serving edge needs to resurrect one request.

    Kept at the edge from admission until the final token: the prompt,
    the tokens already delivered to the client (appended as they
    stream — this list IS the byte-exact prefix a resumed stream must
    never re-emit or contradict), the sampling params + seed, and the
    deadline budget. ``addr`` tracks the node currently serving the
    request so failure detection can find every request pinned to a
    dead node."""

    rid: int
    prompt: np.ndarray  # int32 token ids
    sampling: object = None  # SamplingParams (opaque here: policy layer)
    seed: int | None = None
    budget: DeadlineBudget = field(
        default_factory=lambda: DeadlineBudget(None)
    )
    delivered: list[int] = field(default_factory=list)
    addr: str | None = None  # node currently serving this request
    # Cross-node trace stitching (obs/trace_plane.py): the 64-bit
    # trace id every hop of this request — including resume/hedge
    # re-routes — carries, so the whole multi-node journey lands under
    # ONE id in the stitched Perfetto view. 0 = tracing off.
    trace_id: int = 0
    # -- recovery telemetry (the chaos gates read these) --
    retries: int = 0
    resurrections: int = 0
    hedges: int = 0
    max_backoff_s: float = 0.0
    failed: bool = False
    done: bool = False

    def deliver(self, token: int) -> None:
        self.delivered.append(int(token))

    def resume_key(self) -> np.ndarray:
        """``prompt + delivered`` — the resurrection routing/replay key.
        Surviving replicas hold (a prefix of) exactly this sequence, so
        re-prefill is a near-pure cache hit."""
        if not self.delivered:
            return self.prompt
        return np.concatenate(
            [self.prompt, np.asarray(self.delivered, dtype=np.int32)]
        )

    def overrun_within_one_backoff(self) -> bool:
        """The budget gate the chaos artifact pins: a recovered request
        may overshoot its admission deadline by AT MOST one retry
        backoff (the one that was already sleeping when the budget ran
        out) — never by an unbounded retry tail."""
        return self.budget.overrun_s() <= self.max_backoff_s + 1e-9
