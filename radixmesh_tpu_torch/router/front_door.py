"""Multi-router front door: client-side failover over N routers.

The router was the last single point of failure the self-healing mesh
could not absorb: repair and recovery make node death a latency blip for the RING,
but every request still traversed one rank-only router replica — a
router crash took the whole front door with it. With the single-router
cap lifted (``config.py``), N routers each hold an independently-fed
replica (per-shard summaries and digests already ride the master
fan-out to EVERY router), so any of them can answer any routing
question. What was missing is the CLIENT half: something that notices a
dead router and moves on without losing the request.

:class:`RouterFrontDoor` is that client. It is transport-agnostic (the
same callable-seam design as ``server/recovery.py``): each router edge
is an ``(addr, route_fn)`` pair — in-proc router objects for the chaos
workload, HTTP ``POST /route`` wrappers for a real deployment — and the
front door owns:

- **Sticky preference**: requests ride one router until it fails (its
  load tracker and prefetch dedupe windows stay warm), then the
  preference moves to the survivor.
- **Hedged retry on timeout**: a route hop that exceeds
  ``hop_timeout_s`` fires the NEXT router while the slow leg keeps
  running — first successful answer wins, exactly the tail-latency
  discipline the recovery plane applies to serving hops. A leg that
  raises indicts its router (declared dead, skipped until revived).
- **Retry-After awareness**: a router that sheds with a Retry-After is
  ALIVE — the front door honors the pacing (bounded by
  ``retry_after_cap_s``) and retries instead of declaring it dead;
  failover is for failure, not for flow control.
- **Revival**: a dead router returns to rotation after
  ``revive_after_s`` (a restarted process should not need an operator
  to readmit it), and :meth:`revive` readmits it immediately.

Every seam is injectable (clock, sleep) so the failover logic is
virtual-time testable.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Sequence

from radixmesh_tpu_torch.obs.metrics import get_registry
from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = ["RouterDied", "RetryAfter", "RouterFrontDoor"]


class RouterDied(RuntimeError):
    """A router edge failed in a way that indicts the ROUTER (refused
    connection, hop timeout, chaos kill): declared dead, skipped."""


class RetryAfter(Exception):
    """The router answered with a retriable shed + pacing hint: it is
    alive and flow-controlling. Honor the wait; never declare dead."""

    def __init__(self, seconds: float, message: str = "router shedding"):
        super().__init__(message)
        self.seconds = max(0.0, float(seconds))


class RouterFrontDoor:
    """Client-side failover over an ordered set of router edges.

    ``edges``: ``(addr, route_fn)`` pairs; ``route_fn(*args, **kwargs)``
    returns the routing answer, raises :class:`RetryAfter` on a
    retriable shed, and raises anything else on failure (timeouts the
    transport surfaces, connection errors, chaos kills).

    Thread-safe: ``route`` may run on many request threads; the dead
    set, preference cursor, and counters share one lock. Hedge legs run
    on daemon threads and are never joined — a wedged router's leg
    costs one idle thread, not a stuck request."""

    def __init__(
        self,
        edges: Sequence[tuple[str, Callable]],
        *,
        hop_timeout_s: float = 1.0,
        retry_after_cap_s: float = 2.0,
        max_shed_waits: int = 3,
        revive_after_s: float = 30.0,
        name: str = "frontdoor",
        clock=time.monotonic,
        sleep=time.sleep,
    ):
        if not edges:
            raise ValueError("front door needs at least one router edge")
        self._edges = [(str(a), fn) for a, fn in edges]
        self.hop_timeout_s = float(hop_timeout_s)
        self.retry_after_cap_s = float(retry_after_cap_s)
        self.max_shed_waits = int(max_shed_waits)
        self.revive_after_s = float(revive_after_s)
        self.name = name
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()
        self._dead: dict[str, float] = {}  # addr -> declared-at
        self._preferred = 0  # index of the sticky edge
        # Reusable daemon leg workers: the healthy N>=2 path fires one
        # leg per route, and paying a Thread spawn per REQUEST puts
        # ~100us of scheduler churn on the routing hot path. Workers
        # park on an event between jobs; a wedged leg strands exactly
        # one worker (the same cost a spawned thread had) and a fresh
        # one is created on demand. Each slot is [job, wake event].
        self._workers_lock = threading.Lock()
        self._idle_workers: list[list] = []
        # Lifetime counts mirrored off the metric children (chaos-gate
        # telemetry — counters are process-global, these are per-door).
        self.failovers = 0
        self.hedges = 0
        self.shed_waits = 0
        self.log = get_logger(f"router.{name}")
        # Observers of front-door death declarations (addr, cause) —
        # the chaos workload hooks here, mirroring RecoveryCoordinator.
        self.on_router_dead: list = []

        reg = get_registry()
        lbl = {"node": name}
        self._m_failovers = reg.counter(
            "radixmesh_frontdoor_failovers_total",
            "route calls answered by a non-preferred router after the "
            "preferred one failed or timed out",
            ("node",),
        ).labels(**lbl)
        self._m_hedges = reg.counter(
            "radixmesh_frontdoor_hedges_total",
            "route hops duplicated to the next router after exceeding "
            "the hop timeout (first successful answer wins)",
            ("node",),
        ).labels(**lbl)
        self._m_shed_waits = reg.counter(
            "radixmesh_frontdoor_retry_after_waits_total",
            "Retry-After pacing waits honored instead of declaring the "
            "shedding router dead",
            ("node",),
        ).labels(**lbl)

    # -- membership -----------------------------------------------------

    def addrs(self) -> list[str]:
        return [a for a, _ in self._edges]

    def dead_addrs(self) -> set[str]:
        with self._lock:
            self._sweep_revivals_locked()
            return set(self._dead)

    def declare_dead(self, addr: str, cause: str = "died") -> None:
        with self._lock:
            if addr in self._dead:
                return
            self._dead[addr] = self._clock()
            observers = list(self.on_router_dead)
        self.log.warning("declared router %s dead (cause=%s)", addr, cause)
        for fn in observers:
            try:
                fn(addr, cause)
            except Exception:  # noqa: BLE001 — an observer must not break failover
                self.log.exception("on_router_dead observer failed")

    def revive(self, addr: str) -> None:
        with self._lock:
            self._dead.pop(addr, None)

    def _sweep_revivals_locked(self) -> None:
        if self.revive_after_s <= 0:
            return
        now = self._clock()
        for addr in [
            a for a, t in self._dead.items()
            if now - t >= self.revive_after_s
        ]:
            del self._dead[addr]

    def _candidates(self) -> list[tuple[int, str, Callable]]:
        """Live edges in preference order (sticky edge first, then the
        rest of the ring order)."""
        with self._lock:
            self._sweep_revivals_locked()
            dead = set(self._dead)
            start = self._preferred
        n = len(self._edges)
        out = []
        for k in range(n):
            i = (start + k) % n
            addr, fn = self._edges[i]
            if addr not in dead:
                out.append((i, addr, fn))
        return out

    # -- the failover loop ---------------------------------------------

    def route(self, *args, **kwargs):
        """One front-door routing decision, surviving router death.

        Raises :class:`RouterDied` only when EVERY router is dead or
        shedding past the pacing budget — the "front door down" case N
        routers exist to make unreachable."""
        shed_waits = 0
        while True:
            cands = self._candidates()
            if not cands:
                raise RouterDied("no live router edge")
            try:
                if len(cands) == 1:
                    # Sole-live-edge fast path: no hedge is possible,
                    # so the leg runs inline — no per-route thread
                    # spawn. The transport's own timeout is the bound
                    # (route_fns should carry one, as an HTTP edge
                    # does); there is nothing to race it against.
                    idx, addr, result = self._single_leg(
                        cands[0], args, kwargs
                    )
                else:
                    idx, addr, result = self._hedged_round(
                        cands, args, kwargs
                    )
            except RetryAfter as ra:
                shed_waits += 1
                if shed_waits > self.max_shed_waits:
                    raise RouterDied(
                        "every router shedding past the pacing budget"
                    ) from ra
                self._m_shed_waits.inc()
                with self._lock:
                    self.shed_waits += 1
                self._sleep(min(ra.seconds, self.retry_after_cap_s))
                continue
            with self._lock:
                if idx != self._preferred:
                    self._preferred = idx
                    self.failovers += 1
                    self._m_failovers.inc()
            return result

    def _submit_leg(self, job: Callable[[], None]) -> None:
        """Run ``job`` on a reusable daemon worker (pop an idle one or
        start a new one). Jobs never raise — ``leg`` handles its own
        outcomes — so a worker always returns to the idle pool when its
        job completes."""
        with self._workers_lock:
            if self._idle_workers:
                slot = self._idle_workers.pop()
                slot[0] = job
                slot[1].set()
                return
        slot = [job, threading.Event()]

        def _worker_loop(slot=slot):
            while True:
                job = slot[0]
                slot[0] = None
                try:
                    job()
                except Exception:  # noqa: BLE001 — legs handle their own errors
                    self.log.exception("front-door leg worker failed")
                with self._workers_lock:
                    self._idle_workers.append(slot)
                # meshcheck: ok[timeout-audit] idle-pool park: a daemon worker waiting for its next job blocks on purpose; there is no peer to time out on
                slot[1].wait()
                slot[1].clear()

        threading.Thread(
            target=_worker_loop, daemon=True, name="frontdoor-leg"
        ).start()

    def _single_leg(self, cand, args, kwargs) -> tuple[int, str, object]:
        idx, addr, fn = cand
        try:
            return idx, addr, fn(*args, **kwargs)
        except RetryAfter:
            raise  # alive and flow-controlling: route() paces + retries
        except Exception as e:  # noqa: BLE001 — a failed leg indicts its router
            self.declare_dead(
                addr,
                cause="hop_timeout" if isinstance(e, TimeoutError)
                else "died",
            )
            raise RouterDied(
                f"sole live router edge {addr} failed"
            ) from e

    def _hedged_round(self, cands, args, kwargs) -> tuple[int, str, object]:
        """Fire the preferred edge; hedge to each next edge after a hop
        timeout; first successful leg wins. Legs that raise are declared
        dead (except :class:`RetryAfter`). Raises the collected
        RetryAfter (shortest pacing) when every leg shed; RouterDied
        when every leg failed."""
        done = threading.Event()
        lock = threading.Lock()
        state = {"winner": None, "failed": set(), "shed": {}}
        n = len(cands)

        def leg(idx: int, addr: str, fn: Callable):
            try:
                result = fn()
            except RetryAfter as ra:
                with lock:
                    state["shed"][idx] = ra
                done.set()
                return
            except Exception as e:  # noqa: BLE001 — a failed leg indicts its router
                self.declare_dead(
                    addr,
                    cause="hop_timeout" if isinstance(e, TimeoutError)
                    else "died",
                )
                with lock:
                    state["failed"].add(idx)
                done.set()
                return
            with lock:
                if state["winner"] is None:
                    state["winner"] = (idx, addr, result)
            done.set()

        started = 0

        def fire_next() -> bool:
            nonlocal started
            if started >= n:
                return False
            idx, addr, fn = cands[started]
            started += 1
            self._submit_leg(
                lambda i=idx, a=addr, f=fn: leg(
                    i, a, lambda: f(*args, **kwargs)
                )
            )
            return True

        fire_next()
        next_hedge = self._clock() + self.hop_timeout_s
        while True:
            with lock:
                if state["winner"] is not None:
                    return state["winner"]
                failed = set(state["failed"])
                shed = dict(state["shed"])
            resolved = len(failed) + len(shed)
            if resolved >= started and started >= n:
                # Every fired leg resolved without a winner.
                if shed:
                    raise min(shed.values(), key=lambda ra: ra.seconds)
                raise RouterDied("every router edge failed")
            now = self._clock()
            if resolved >= started or now >= next_hedge:
                # The in-flight legs all resolved badly, or the newest
                # leg is straggling past the hop timeout: hedge.
                if fire_next():
                    if now >= next_hedge:
                        self._m_hedges.inc()
                        with self._lock:
                            self.hedges += 1
                    next_hedge = self._clock() + self.hop_timeout_s
                    continue
                # Nothing left to fire: a straggler may still win, but
                # only within one more hop timeout. Only UNRESOLVED
                # legs are declared dead — an edge that answered with
                # RetryAfter is alive and flow-controlling, and its
                # pacing hint wins over the stragglers' silence. The
                # failed/shed sets are keyed by each edge's GLOBAL
                # index (the first tuple element of a cands row, NOT
                # its position — the two differ whenever the sticky
                # preference has moved off edge 0).
                if now >= next_hedge + self.hop_timeout_s:
                    for idx, addr, _fn in cands[:started]:
                        if idx not in failed and idx not in shed:
                            self.declare_dead(addr, cause="hop_timeout")
                    if shed:
                        raise min(
                            shed.values(), key=lambda ra: ra.seconds
                        )
                    raise RouterDied(
                        "every router edge timed out without answering"
                    )
            # Park until the NEXT relevant deadline: the hedge point
            # while edges remain to fire, else the straggler deadline —
            # waiting against an already-passed next_hedge would
            # degrade to 1 ms busy-polling for the whole grace window.
            wake_at = (
                next_hedge
                if started < n
                else next_hedge + self.hop_timeout_s
            )
            done.wait(timeout=max(0.001, min(0.05, wake_at - now)))
            done.clear()

    def __call__(self, *args, **kwargs):
        return self.route(*args, **kwargs)
