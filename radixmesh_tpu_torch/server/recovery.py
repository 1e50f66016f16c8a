"""Request-recovery plane: resurrection, failover retries, and hedging.

The serving edge's answer to unclean node death. The lifecycle plane
makes *planned* scale-in graceful and the repair plane makes the *ring*
heal — but an unplanned crash
still killed every in-flight request on the dead node. This plane closes
that gap with the one recovery the replicated radix tree makes nearly
free: ``prompt + tokens-delivered-so-far`` is a prefix surviving
replicas already hold, so a dead request re-prefills on a survivor as a
near-pure cache hit and its stream continues from token *k*.

:class:`RecoveryCoordinator` lives at the serving edge (wherever
requests are submitted and streams consumed — an API gateway, the
workload harness, a test) and owns:

- **Recovery records** (``policy/retry.py::RecoveryRecord``): one per
  in-flight request — prompt ids, every delivered token (the byte-exact
  SSE prefix), sampling params + seed, and the end-to-end
  :class:`~radixmesh_tpu_torch.policy.retry.DeadlineBudget` stamped at
  admission.
- **Failure detection**, two triggers: a per-hop timeout the edge owns
  (``RetryPolicy.hop_timeout_s`` — a hop with no progress for that long
  is dead to THIS request), and the mesh's ``cause=dead`` successor
  transition surfaced through :meth:`watch_mesh` (ring-level detection
  of the same death, usually slower but authoritative).
- **The resurrection loop** (:meth:`run_to_completion`): declared-dead
  node → capped exponential backoff with bounded jitter (clamped to the
  remaining budget — no hop may wait longer than the request has left)
  → re-route over ``prompt+delivered`` via the router's failover path
  (longest surviving cached prefix) → resume-mode re-admission
  (``Engine.make_request(resume_tokens=...)`` suppresses re-emission of
  delivered tokens) → the stream continues from token *k*.
- **Tail-latency hedging** (:meth:`hedged`): a hop still unfinished
  after ``hedge_after_s`` is duplicated to a second node. First
  SUCCESSFUL writer wins; the loser is cancelled (its pages release via
  the engine's normal cancel path). A provisional leader that crashes
  never wins — the trailing leg is adopted instead, which is exactly
  the hedged-winner-crash edge case.

Transport-agnostic by design: the loop takes ``route_fn``/``serve_fn``
callables, so the same machinery drives the in-proc chaos workload, the
engine-level tests, and an HTTP edge.

Metrics: ``radixmesh_request_{retries,resurrections,hedges}_total`` and
the ``radixmesh_request_recovery_seconds`` histogram (death detected →
request completed or resumed). Spans: ``resurrect`` and ``hedge`` on the
``edge:<name>`` recorder lane.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Sequence

import numpy as np

from radixmesh_tpu_torch.obs.metrics import RECOVERY_SECONDS_BUCKETS, get_registry
from radixmesh_tpu_torch.obs.trace_plane import get_recorder, new_trace_id
from radixmesh_tpu_torch.policy.retry import (
    DeadlineBudget,
    RecoveryRecord,
    RetryPolicy,
)
from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = [
    "BudgetExhausted",
    "HopTimeout",
    "NodeDied",
    "RecoveryCoordinator",
]


class NodeDied(RuntimeError):
    """A serving hop failed in a way that indicts the NODE (connection
    refused/reset, hop timeout, chaos kill) — the addr gets declared
    dead and the request resurrects elsewhere."""


class HopTimeout(NodeDied):
    """The per-hop deadline fired with no progress: the edge-owned
    failure-detection trigger (a dead process stops acking — this is
    what that looks like from the edge)."""


class BudgetExhausted(RuntimeError):
    """The request's end-to-end deadline budget ran out mid-recovery."""


class RecoveryCoordinator:
    """Serving-edge owner of recovery records + the failover machinery.

    Thread-safe: records register/unregister under a lock, hedged legs
    run on their own threads, and dead-declaration may arrive from a
    mesh view-change callback thread."""

    def __init__(
        self,
        policy: RetryPolicy | None = None,
        *,
        name: str = "edge",
        seed: int = 0,
        clock=time.monotonic,
        sleep=time.sleep,
    ):
        self.policy = policy or RetryPolicy()
        self.name = name
        self._clock = clock
        self._sleep = sleep
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self.records: dict[int, RecoveryRecord] = {}
        self.dead_addrs: set[str] = set()
        # Observers of edge-side death declarations (addr, cause) — the
        # chaos workload and tests hook here.
        self.on_node_dead: list[Callable[[str, str], None]] = []
        self.log = get_logger("server.recovery")
        self._rid_seq = 0

        reg = get_registry()
        lbl = {"node": name}
        self._m_retries = reg.counter(
            "radixmesh_request_retries_total",
            "request hops retried after a failure or hop timeout",
            ("node",),
        ).labels(**lbl)
        self._m_resurrections = reg.counter(
            "radixmesh_request_resurrections_total",
            "requests resumed on a surviving node after their serving "
            "node died mid-stream",
            ("node",),
        ).labels(**lbl)
        self._m_hedges = reg.counter(
            "radixmesh_request_hedges_total",
            "straggling hops duplicated to a second node "
            "(first-writer-wins)",
            ("node",),
        ).labels(**lbl)
        self._m_recovery = reg.histogram(
            "radixmesh_request_recovery_seconds",
            "death detected to request completed (or budget exhausted)",
            ("node",),
            buckets=RECOVERY_SECONDS_BUCKETS,
        ).labels(**lbl)
        self._trace_lane = f"edge:{name}"

    # ------------------------------------------------------------------
    # record lifecycle
    # ------------------------------------------------------------------

    def admit(
        self,
        prompt: Sequence[int],
        sampling=None,
        *,
        deadline_s: float | None = None,
        seed: int | None = None,
        rid: int | None = None,
        trace_id: int | None = None,
    ) -> RecoveryRecord:
        """Open a recovery record: THE admission instant — the deadline
        budget starts here and is threaded through every later hop.

        The record also owns the request's 64-bit trace id (cross-node
        stitching): minted here when tracing is on (or adopted
        from ``trace_id``), and carried by every hop — serve_fn threads
        it into ``/generate``/``mesh.insert`` so a resurrected request's
        whole multi-node journey stitches under one id."""
        if trace_id is None and get_recorder().enabled:
            trace_id = new_trace_id()
        with self._lock:
            if rid is None:
                self._rid_seq += 1
                rid = self._rid_seq
            rec = RecoveryRecord(
                rid=rid,
                prompt=np.asarray(prompt, dtype=np.int32),
                sampling=sampling,
                seed=seed,
                budget=DeadlineBudget(deadline_s, clock=self._clock),
                trace_id=trace_id or 0,
            )
            self.records[rid] = rec
            return rec

    def finish(self, record: RecoveryRecord) -> None:
        record.done = True
        with self._lock:
            self.records.pop(record.rid, None)

    # ------------------------------------------------------------------
    # failure detection
    # ------------------------------------------------------------------

    def declare_dead(self, addr: str, cause: str = "hop_timeout") -> None:
        """Edge-side death declaration: ``addr`` gets no more traffic
        from this edge, and every record pinned to it becomes
        resurrection-eligible immediately (later hops skip their own
        timeout — the detection already happened)."""
        with self._lock:
            if addr in self.dead_addrs:
                return
            self.dead_addrs.add(addr)
            observers = list(self.on_node_dead)
        self.log.warning("declared node %s dead (cause=%s)", addr, cause)
        for fn in observers:
            try:
                fn(addr, cause)
            except Exception:  # noqa: BLE001 — an observer must not break detection
                self.log.exception("on_node_dead observer failed")

    def revive(self, addr: str) -> None:
        """Operator seam: a replaced/rebooted address may serve again."""
        with self._lock:
            self.dead_addrs.discard(addr)

    def watch_mesh(self, mesh, addr_of_rank: Callable[[int], str]) -> None:
        """Subscribe to a mesh replica's epoch-numbered view changes:
        a rank that drops from the alive set via failure detection
        (``cause=dead`` successor transition ring-side) is declared dead
        here too — the authoritative trigger when per-hop timeouts
        haven't fired yet (e.g. a request between tokens)."""

        def _on_view_change(old, new):
            for rank in set(old.alive) - set(new.alive):
                try:
                    self.declare_dead(addr_of_rank(rank), cause="view_dead")
                except Exception:  # noqa: BLE001 — unmapped rank: nothing to do
                    pass
            # Ring membership is explicitly reversible (a falsely-removed
            # member re-includes with a fresh view; a crashed node
            # reincarnates via bootstrap): a rank back in the alive set
            # serves again — without this, dead_addrs accumulates across
            # partition/heal cycles until a healthy fleet reads as "no
            # surviving node".
            for rank in set(new.alive) - set(old.alive):
                try:
                    self.revive(addr_of_rank(rank))
                except Exception:  # noqa: BLE001
                    pass

        mesh.on_view_change.append(_on_view_change)

    def pinned_to(self, addr: str) -> list[RecoveryRecord]:
        """Records currently served by ``addr`` — the set a death there
        interrupts."""
        with self._lock:
            return [r for r in self.records.values() if r.addr == addr]

    def hop_deadline_s(self, record: RecoveryRecord) -> float:
        """THE hop rule: a hop may wait the per-hop timeout or the
        remaining budget, whichever is less."""
        return record.budget.clamp(self.policy.hop_timeout_s)

    # ------------------------------------------------------------------
    # the resurrection loop
    # ------------------------------------------------------------------

    def run_to_completion(
        self,
        record: RecoveryRecord,
        route_fn: Callable[[np.ndarray, frozenset], str | None],
        serve_fn: Callable[[str, RecoveryRecord, float], None],
    ) -> dict:
        """Drive ``record`` to completion across node deaths.

        ``route_fn(resume_key, exclude) -> addr | None`` places the
        request on the node with the longest surviving cached prefix
        over ``prompt + delivered`` (the router's failover path).
        ``serve_fn(addr, record, hop_deadline_s)`` serves from
        ``len(record.delivered)`` onward, calling ``record.deliver`` per
        token as it streams; it raises :class:`NodeDied` /
        :class:`HopTimeout` when the node fails mid-hop (tokens
        delivered before the failure stay in the record — that prefix
        is what the resumed stream must extend byte-identically).

        Returns a per-request report (attempt addrs, retries,
        resurrections, recovery seconds)."""
        report = {
            "addrs": [],
            "retries": 0,
            "resurrections": 0,
            "recovery_s": 0.0,
        }
        state = {"t_death": None}
        try:
            return self._recovery_loop(record, route_fn, serve_fn, report, state)
        except BudgetExhausted:
            # A FAILED recovery episode is still an episode: the
            # histogram covers it (its help text promises as much), or
            # recovery-latency SLO math reads biased optimistic —
            # the worst episodes would be the invisible ones.
            if state["t_death"] is not None:
                self._m_recovery.observe(self._clock() - state["t_death"])
            raise

    def _recovery_loop(
        self, record, route_fn, serve_fn, report, state
    ) -> dict:
        attempt = 0
        while True:
            if record.budget.expired():
                record.failed = True
                raise BudgetExhausted(
                    f"request {record.rid}: budget exhausted after "
                    f"{record.budget.elapsed():.3f}s "
                    f"({len(record.delivered)} tokens delivered)"
                )
            with self._lock:
                pinned_dead = record.addr in self.dead_addrs
                exclude = frozenset(self.dead_addrs)
            if pinned_dead:
                # Failure detection fired between hops (view change or a
                # sibling request's timeout): resurrect without waiting
                # out a timeout of our own.
                if state["t_death"] is None:
                    state["t_death"] = self._clock()
                record.addr = None  # handled: don't re-count next loop
                attempt, _ = self._note_failure(
                    record, report, attempt, cause="already_dead"
                )
            addr = route_fn(record.resume_key(), exclude)
            if addr is None:
                record.failed = True
                raise BudgetExhausted(
                    f"request {record.rid}: no surviving node to "
                    "resurrect on"
                )
            record.addr = addr
            report["addrs"].append(addr)
            try:
                serve_fn(addr, record, self.hop_deadline_s(record))
                if state["t_death"] is not None:
                    # Death detected → stream completed elsewhere: the
                    # latency blip the plane exists to keep small.
                    report["recovery_s"] = round(
                        self._clock() - state["t_death"], 6
                    )
                    self._m_recovery.observe(report["recovery_s"])
                self.finish(record)
                return report
            except (NodeDied, HopTimeout) as e:
                self.declare_dead(
                    addr,
                    cause=(
                        "hop_timeout" if isinstance(e, HopTimeout) else "died"
                    ),
                )
                state["t_death"] = self._clock()
                record.addr = None  # handled: don't re-count next loop
                attempt, _ = self._note_failure(
                    record, report, attempt, cause="died"
                )
            except BudgetExhausted:
                record.failed = True
                raise
            except Exception:
                # A non-death failure (shed, transient): retry elsewhere
                # without declaring the node dead.
                attempt, _ = self._note_failure(
                    record, report, attempt, cause="error", dead=False
                )

    def _note_failure(
        self,
        record: RecoveryRecord,
        report: dict,
        attempt: int,
        *,
        cause: str,
        dead: bool = True,
    ) -> tuple[int, bool]:
        """Shared retry bookkeeping: cap check, budget-clamped jittered
        backoff (slept here), counters, and the resurrect span."""
        attempt += 1
        if attempt > self.policy.max_retries:
            record.failed = True
            raise BudgetExhausted(
                f"request {record.rid}: {attempt - 1} retries exhausted "
                f"(cause={cause})"
            )
        record.retries += 1
        report["retries"] += 1
        self._m_retries.inc()
        back = self.policy.backoff_s(attempt, self._rng)
        record.max_backoff_s = max(record.max_backoff_s, back)
        back = record.budget.clamp(back)
        resurrect = dead and bool(record.delivered)
        if resurrect:
            record.resurrections += 1
            report["resurrections"] += 1
            self._m_resurrections.inc()
            rec = get_recorder()
            if rec.enabled:
                rec.event(
                    self._trace_lane, "resurrect", self._clock(), 0.0,
                    cat="recovery", trace_id=record.trace_id,
                    node=self.name, rid=record.rid, cause=cause,
                    delivered=len(record.delivered),
                    budget_left_s=round(
                        min(record.budget.remaining(), 1e9), 4
                    ),
                )
        if back > 0:
            self._sleep(back)
        return attempt, resurrect

    # ------------------------------------------------------------------
    # tail-latency hedging
    # ------------------------------------------------------------------

    def hedged(
        self,
        record: RecoveryRecord,
        primary: tuple[str, Callable[[], object], Callable[[], None]],
        secondary: tuple[str, Callable[[], object], Callable[[], None]],
        *,
        hedge_after_s: float | None = None,
    ) -> dict:
        """First-writer-wins hedge of one hop (typically a prefill).

        ``primary``/``secondary`` are ``(addr, run, cancel)``: ``run()``
        performs the hop and returns its result; ``cancel()`` aborts the
        leg on the node (releasing its batch row and pages — the
        engine's normal cancel path). The secondary fires only if the
        primary is still unfinished after ``hedge_after_s`` (clamped to
        the remaining budget).

        Win rule: the first leg to COMPLETE SUCCESSFULLY wins and the
        other leg is cancelled. A leg that raises never wins — so a
        provisional leader that crashes before the loser was cancelled
        simply loses the race and the trailing leg's result is adopted
        (the hedged-winner-crash edge case). Returns
        ``{result, winner, hedged, loser_cancelled}``."""
        hedge_after = (
            self.policy.hedge_after_s
            if hedge_after_s is None
            else hedge_after_s
        )
        if hedge_after is None:
            raise ValueError("hedging is off (hedge_after_s is None)")
        done = threading.Event()
        state = {"winner": None, "result": None, "errors": {}}
        lock = threading.Lock()

        def leg(which: str, addr: str, run: Callable[[], object]):
            try:
                result = run()
            except Exception as e:  # noqa: BLE001 — a crashed leg just loses
                with lock:
                    state["errors"][which] = e
                done.set()  # wake the waiter to re-check liveness
                return
            with lock:
                if state["winner"] is None:
                    state["winner"] = which
                    state["result"] = result
            done.set()

        legs = {"primary": primary, "secondary": secondary}
        threads = {
            "primary": threading.Thread(
                target=leg, args=("primary",) + primary[:2], daemon=True
            )
        }
        threads["primary"].start()
        fired = False
        deadline = self._clock() + record.budget.clamp(
            max(self.policy.hop_timeout_s, hedge_after * 4)
        )
        hedge_at = self._clock() + record.budget.clamp(hedge_after)
        while True:
            with lock:
                if state["winner"] is not None:
                    break
                failed = set(state["errors"])
            now = self._clock()
            if now >= deadline:
                # Abandoning the hop must not abandon its WORK: every
                # started leg still holds a batch row and pages on its
                # node — cancel both before surfacing the timeout (the
                # same discipline the loser-cancel rule enforces on the
                # win path).
                for which in threads:
                    try:
                        legs[which][2]()
                    except Exception:  # noqa: BLE001
                        self.log.warning(
                            "hedge leg cancel failed on %s", legs[which][0]
                        )
                raise HopTimeout(
                    f"request {record.rid}: hedged hop exceeded its "
                    "deadline"
                )
            if not fired and (now >= hedge_at or "primary" in failed):
                # Primary is straggling (or already dead): duplicate it.
                # One duplicate only — hedging is a tail-latency tool,
                # not a fan-out.
                fired = True
                record.hedges += 1
                self._m_hedges.inc()
                rec = get_recorder()
                if rec.enabled:
                    rec.event(
                        self._trace_lane, "hedge", now, 0.0,
                        cat="recovery", trace_id=record.trace_id,
                        node=self.name, rid=record.rid,
                        primary=primary[0], secondary=secondary[0],
                    )
                threads["secondary"] = threading.Thread(
                    target=leg, args=("secondary",) + secondary[:2],
                    daemon=True,
                )
                threads["secondary"].start()
                continue
            if failed >= set(threads):
                # Every started leg failed — nothing left to win.
                record.failed = True
                raise NodeDied(
                    f"request {record.rid}: all hedge legs failed "
                    f"({ {k: str(v) for k, v in state['errors'].items()} })"
                )
            done.wait(
                timeout=max(
                    0.001,
                    min(
                        (hedge_at - now) if not fired else 0.05,
                        deadline - now,
                    ),
                )
            )
            done.clear()
        winner = state["winner"]
        loser = "secondary" if winner == "primary" else "primary"
        loser_cancelled = False
        if loser in threads:
            # First-writer-wins: the losing leg's work is aborted so its
            # batch row and pages release. Cancel failures are
            # non-fatal — the loser's node may itself be the dead one.
            try:
                legs[loser][2]()
                loser_cancelled = True
            except Exception:  # noqa: BLE001
                self.log.warning(
                    "hedge loser cancel failed on %s", legs[loser][0]
                )
        return {
            "result": state["result"],
            "winner": legs[winner][0],
            "hedged": fired,
            "loser_cancelled": loser_cancelled,
        }
