"""Membership lifecycle plane: warm join, graceful drain, autoscale policy.

Production traffic is diurnal, so the fleet must grow and shrink LIVE —
and a planned topology change is not a failure. Before this module the
mesh had every ingredient (gossiped ``FleetView`` health, the
fingerprint-driven repair plane, streamed KV movement, seeded fault
injection) but composed none of them: a new node started with a cold
replica and served misses for minutes while gossip trickled in, and a
departing node simply died — stranding parked restores and in-flight
decodes until failure detection and anti-entropy cleaned up after the
fact. This module makes scale-out/scale-in a first-class state machine::

    BOOTSTRAPPING ──► ACTIVE ──► DRAINING ──► LEFT
          └───────────────────────┘ (drain during bootstrap)

- **Warm join** (``BOOTSTRAPPING``): the node announces ``JOIN`` as
  always, but additionally opens a *bulk repair session* against a
  healthy donor chosen from the ``FleetView`` (the anti-entropy
  probe/summary/re-emit protocol of ``cache/repair_plane.py`` with
  raised per-session bucket/key budgets over a dedicated bootstrap
  channel), and gossips its state in the ``NodeDigest`` so the router
  withholds cache-hit routing to it — hash-ring fallback only — until
  its tree fingerprint converges with the donor's.
- **Graceful drain** (``DRAINING`` → ``LEFT``): admission closes (the
  SLO runner sheds new work with a retriable 503 + Retry-After pointing
  back at the router), in-flight decodes run to completion under a
  deadline, parked ``RESTORING`` requests are cancelled-and-flagged for
  requeue at the router, hot prefixes are written back to the host tier
  through the fused write-back lane, and a ``LEAVE`` oplog
  (``cache/oplog.py``) lets peers drop the node from the view without
  tripping ``_declare_successor_dead``'s failure path or poisoning
  ``FleetView`` convergence/min-score.
- **Autoscale recommender**: :class:`AutoscalePolicy` is PURE policy —
  it consumes ``FleetView`` health scores, queue depth, and the SLO
  degradation tier and emits add/remove recommendations (surfaced on
  ``GET /cluster/health``; consumed by the workload harness — no actual
  process spawning here).

**Single-writer contract** (lint-pinned by ``tests/test_mesh_lint.py``):
this module is the ONLY place lifecycle state is assigned. Everything
else — router, fleet plane, frontends, the engine — only *reads* it
(via ``LifecyclePlane.state`` / the gossiped digest field). A plane that
anyone could flip to ``ACTIVE`` mid-bootstrap would silently re-enable
cold hit-routing.

**Deflake contract**: every timer (bootstrap convergence wait, drain
deadline, the plane's tick) runs on an injectable clock + wait seam,
like ``comm/faults.py`` — tests drive lifecycle logic in virtual time,
and no wait is unbounded.

Import-light on purpose (stdlib + the obs registry — no jax): router
nodes and the chaos workload use it without pulling in a backend.
"""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass

__all__ = [
    "LifecycleState",
    "LifecycleError",
    "LifecycleConfig",
    "LifecyclePlane",
    "AutoscaleConfig",
    "AutoscalePolicy",
    "lifecycle_code",
    "lifecycle_from_code",
]



class LifecycleState(enum.Enum):
    """One node's membership lifecycle (ARCHITECTURE.md "Membership
    lifecycle"). String values are the wire/gossip vocabulary — the
    digest, ``/cluster/health``, and the router compare these strings so
    readers never need to import this module."""

    BOOTSTRAPPING = "bootstrapping"
    ACTIVE = "active"
    DRAINING = "draining"
    LEFT = "left"


# Compact digest encoding (rides the NodeDigest tier byte's high nibble,
# obs/fleet_plane.py): code 0 == ACTIVE so every pre-lifecycle encoder —
# which writes 0 there — reads back as the state it factually was in.
_STATE_CODES = {
    LifecycleState.ACTIVE: 0,
    LifecycleState.BOOTSTRAPPING: 1,
    LifecycleState.DRAINING: 2,
    LifecycleState.LEFT: 3,
}
_CODE_STATES = {v: k for k, v in _STATE_CODES.items()}


def lifecycle_code(state: str) -> int:
    """State string → 4-bit wire code (unknown → ACTIVE's 0)."""
    try:
        return _STATE_CODES[LifecycleState(state)]
    except ValueError:
        return 0


def lifecycle_from_code(code: int) -> str:
    """4-bit wire code → state string (unknown → "active": a NEWER
    peer's state must degrade to normal routing, not an error)."""
    return _CODE_STATES.get(int(code), LifecycleState.ACTIVE).value


# Imported AFTER the state enum + wire-code helpers on purpose: obs
# (fleet_plane) imports those helpers back from this module, so they
# must exist before this import re-enters us mid-initialization —
# otherwise the first import of radixmesh_tpu_torch.policy.* from a cold
# process dies on the cycle.
from radixmesh_tpu_torch.obs.metrics import get_registry  # noqa: E402
from radixmesh_tpu_torch.obs.trace_plane import get_recorder  # noqa: E402
from radixmesh_tpu_torch.utils.logging import get_logger  # noqa: E402

# The legal transition edges. Anything else is a bug in the caller —
# e.g. LEFT is terminal (a rejoin is a NEW plane on a NEW MeshCache),
# and nothing un-drains.
_VALID_TRANSITIONS = {
    (LifecycleState.BOOTSTRAPPING, LifecycleState.ACTIVE),
    (LifecycleState.BOOTSTRAPPING, LifecycleState.DRAINING),
    (LifecycleState.ACTIVE, LifecycleState.DRAINING),
    (LifecycleState.DRAINING, LifecycleState.LEFT),
}


class LifecycleError(RuntimeError):
    """Illegal lifecycle transition or re-entrant drain."""


@dataclass
class LifecycleConfig:
    """Timers + budgets. Production-cadence defaults; tests and the
    chaos workload shrink them (all waits run on the plane's injectable
    clock, so quick tests can also drive them in virtual time)."""

    # How long a BOOTSTRAPPING node waits for a donor candidate (any
    # ACTIVE peer digest) before concluding there is nothing to learn
    # from and going ACTIVE — a cold cluster boot must not withhold
    # every node forever. Must exceed the digest interval (and any
    # partition a chaos drill runs across the join).
    bootstrap_grace_s: float = 15.0
    # Hard ceiling on the whole bootstrap: past it the node goes ACTIVE
    # cold (serving misses beats never serving) with a warning.
    bootstrap_deadline_s: float = 120.0
    # Pacing between bulk-repair probe rounds against the donor.
    bootstrap_probe_interval_s: float = 0.5
    # The join chaos gate: a bootstrap must converge within this many
    # probe rounds (the bulk budgets are sized so a full replica moves
    # in a handful of rounds).
    bootstrap_round_budget: int = 16
    # Drain: how long in-flight decodes get to run to completion before
    # the stragglers are cancelled. launch.py --drain-timeout overrides.
    drain_timeout_s: float = 30.0
    # Retry-After handed to shed clients during a drain (they re-route
    # via the router immediately; the hint bounds dumb retry loops).
    drain_retry_after_s: float = 1.0
    # How many times the LEAVE announcement is re-broadcast if this
    # node does not observe its own exclusion (a lossy wire can eat the
    # frame; re-announcing is idempotent — the view is epoch-guarded).
    leave_retries: int = 3
    leave_confirm_s: float = 1.0
    # The plane thread's scan cadence while BOOTSTRAPPING.
    tick_interval_s: float = 0.25


class LifecyclePlane:
    """Per-node owner of the lifecycle state machine.

    Seams (all optional — the chaos workload runs mesh-only nodes, the
    serving path wires everything):

    - ``repair``: the node's :class:`~radixmesh_tpu_torch.cache.repair_plane.
      RepairPlane`; warm bootstrap drives bulk sessions through it.
    - ``runner``: the node's ``EngineRunner``/``SLORunner``; drain
      closes admission, requeues parked restores, waits out decodes,
      and flushes hot prefixes through it.
    - ``fleet_plane``: the node's digest publisher; state changes
      publish immediately so routers react within one fold, not one
      gossip interval.
    - ``requeue_fn`` / ``writeback_fn``: engine-less stand-ins for the
      drain's requeue and hot-prefix flush steps (the mesh-level chaos
      workload supplies these; with a ``runner`` they are ignored).
    - ``blackbox``: the node's :class:`~radixmesh_tpu_torch.obs.blackbox.
      BlackBox`; the drain sequence flushes it (step 5c) once in-flight
      work has settled, so every planned departure leaves a complete
      post-mortem artifact behind.
    - ``clock`` / ``wait``: virtual-time injection (deflake contract).
    """

    def __init__(
        self,
        mesh,
        repair=None,
        runner=None,
        fleet_plane=None,
        cfg: LifecycleConfig | None = None,
        bootstrap: bool = False,
        requeue_fn=None,
        writeback_fn=None,
        blackbox=None,
        clock=time.monotonic,
        wait=None,
    ):
        self.mesh = mesh
        self.repair = repair
        self.runner = runner
        self.fleet_plane = fleet_plane
        self.blackbox = blackbox
        self.cfg = cfg or LifecycleConfig()
        self.requeue_fn = requeue_fn
        self.writeback_fn = writeback_fn
        self.clock = clock
        self._stop = threading.Event()
        # Injectable wait: default parks on the stop event so close()
        # interrupts sleeps; virtual-time tests pass their own.
        self._wait = wait or (lambda t: self._stop.wait(t))
        self.log = get_logger(f"lifecycle.{mesh._node_label}")
        self._lock = threading.Lock()
        self._state = (
            LifecycleState.BOOTSTRAPPING if bootstrap else LifecycleState.ACTIVE
        )
        self._t_enter = self.clock()
        self._thread: threading.Thread | None = None
        self._drain_thread: threading.Thread | None = None
        # Exactly-one-drain claim, taken under the lock: request_drain's
        # thread and a direct drain() call (SIGTERM exit path) can race,
        # and both passing an unlocked state check would double-run the
        # sequence — the loser's illegal DRAINING→DRAINING transition
        # would abort the graceful exit mid-way.
        self._drain_claimed = False
        self._next_probe = 0.0
        # Bootstrap accounting (the join chaos gates read these).
        self.bootstrap_donor: int | None = None
        self.bootstrap_rounds = 0
        self.bootstrap_converge_s: float | None = None
        self.drain_stats: dict | None = None

        reg = get_registry()
        node = mesh._node_label
        self._g_state = reg.gauge(
            "radixmesh_lifecycle_state",
            "membership lifecycle state code (0=active, 1=bootstrapping, "
            "2=draining, 3=left)",
            ("node",),
        ).labels(node=node)
        trans = reg.counter(
            "radixmesh_lifecycle_transitions_total",
            "lifecycle state transitions, by entered state",
            ("node", "state"),
        )
        self._m_trans = {
            s: trans.labels(node=node, state=s.value) for s in LifecycleState
        }
        self._g_state.set(float(_STATE_CODES[self._state]))
        # Register as the mesh's (read-only to everyone else) lifecycle
        # source: the fleet plane folds .state into the digest, the
        # receive path consults is_departing, frontends snapshot status.
        mesh.lifecycle = self

    # -- state machine (the ONLY writer — see module docstring) ---------

    @property
    def state(self) -> LifecycleState:
        return self._state

    @property
    def is_departing(self) -> bool:
        """True once the node is on its way out (DRAINING or LEFT): the
        mesh receive path uses this to suppress the falsely-declared-
        dead auto-rejoin — a planned exclusion view is not a false
        declaration — and the housekeeper suppresses self-assertion
        JOINs the same way."""
        return self._state in (LifecycleState.DRAINING, LifecycleState.LEFT)

    def _transition(self, new: LifecycleState) -> None:
        with self._lock:
            cur = self._state
            if (cur, new) not in _VALID_TRANSITIONS:
                raise LifecycleError(
                    f"illegal lifecycle transition {cur.value} -> {new.value}"
                )
            self._state = new
            t_prev, self._t_enter = self._t_enter, self.clock()
        self._g_state.set(float(_STATE_CODES[new]))
        self._m_trans[new].inc()
        rec = get_recorder()
        if rec.enabled:
            # One span per state dwelled in, on this node's lifecycle
            # lane — scale events line up against request timelines.
            rec.event(
                f"lifecycle:{self.mesh._node_label}", cur.value,
                t_prev, max(0.0, self.clock() - t_prev),
                cat="lifecycle", to=new.value,
            )
        self.log.info("lifecycle %s -> %s", cur.value, new.value)
        if new is not LifecycleState.LEFT:
            # LEFT is announced by the LEAVE oplog, not a digest: peers
            # FORGET a departed node's telemetry, and a final "left"
            # digest racing the LEAVE would just be refused (FleetView
            # fold guard) or, worse on old receivers, re-pin a frozen
            # fingerprint in the convergence audit.
            self._publish_state()

    def _publish_state(self) -> None:
        """Gossip the new state NOW (one extra digest frame) so routers
        react within a fold instead of a full digest interval."""
        if self.fleet_plane is None:
            return
        try:
            self.fleet_plane.publish_once()
        except Exception:  # noqa: BLE001 — gossip lag degrades, never blocks
            self.log.exception("lifecycle digest publish failed")

    # -- warm bootstrap -------------------------------------------------

    def choose_donor(self) -> int | None:
        """The healthiest ACTIVE peer the FleetView knows (ties → the
        freshest digest, then the lowest rank). Health-aware on purpose:
        during a join-under-partition drill the partitioned peer's
        digest goes stale, its score drops, and the joiner bootstraps
        from a reachable donor instead of wedging on a dead one."""
        fleet = self.mesh.fleet
        health = fleet.health()
        best_rank, best_key = None, None
        for rank, d in fleet.digests().items():
            if rank == self.mesh.rank or d.role == "router":
                continue
            if d.lifecycle != LifecycleState.ACTIVE.value:
                continue
            score = health.get(rank, {}).get("score", 0.0)
            key = (score, d.ts, -rank)
            if best_key is None or key > best_key:
                best_rank, best_key = rank, key
        return best_rank

    def bootstrap_status(self) -> dict:
        return {
            "state": self._state.value,
            "donor_rank": self.bootstrap_donor,
            "rounds": self.bootstrap_rounds,
            "round_budget": self.cfg.bootstrap_round_budget,
            "converge_s": self.bootstrap_converge_s,
        }

    def tick(self) -> None:
        """One bootstrap scan (the plane thread calls this on its timer;
        tests drive it directly, in virtual time when they want). ACTIVE/
        DRAINING/LEFT ticks are no-ops."""
        if self._state is not LifecycleState.BOOTSTRAPPING:
            return
        now = self.clock()
        mesh = self.mesh
        donor = self.choose_donor()
        if donor is None:
            # No ACTIVE peer to learn from. If every KNOWN peer replica
            # already equals ours, there is nothing to pull — the cold-
            # cluster case, where every node boots BOOTSTRAPPING at the
            # same instant and a donor requirement would deadlock them
            # all into the full grace window for no benefit (an empty
            # fleet has no hits to withhold). Otherwise gossip may still
            # be in flight: wait out the grace window, then serve.
            # (Convergence is the mesh's call — scalar fingerprints full
            # replica, per-co-owned-shard under sharding.)
            peers = mesh.convergence_peers()
            if peers and all(
                mesh.bootstrap_converged_with(r) for r in peers
            ):
                self.log.info(
                    "bootstrap: all %d known peers already converged with "
                    "this replica — going active", len(peers),
                )
                self._become_active(now)
                return
            if now - self._t_enter >= self.cfg.bootstrap_grace_s:
                self.log.info(
                    "bootstrap: no donor after %.1fs grace — going active",
                    now - self._t_enter,
                )
                self._become_active(now)
            return
        self.bootstrap_donor = donor
        if mesh.bootstrap_converged_with(donor):
            self.log.info(
                "bootstrap: converged with donor rank %d after %d rounds",
                donor, self.bootstrap_rounds,
            )
            self._become_active(now)
            return
        if now - self._t_enter > self.cfg.bootstrap_deadline_s:
            self.log.warning(
                "bootstrap deadline (%.0fs) exceeded after %d rounds — "
                "going active COLD (steady-state repair will finish the "
                "fill)", self.cfg.bootstrap_deadline_s, self.bootstrap_rounds,
            )
            self._become_active(now)
            return
        if self.repair is not None and now >= self._next_probe:
            self._next_probe = now + self.cfg.bootstrap_probe_interval_s
            if self.repair.bootstrap_probe(donor):
                self.bootstrap_rounds += 1

    def _become_active(self, now: float) -> None:
        self.bootstrap_converge_s = max(0.0, now - self._t_enter)
        self._transition(LifecycleState.ACTIVE)

    # -- graceful drain -------------------------------------------------

    def request_drain(self, deadline_s: float | None = None) -> bool:
        """Kick an asynchronous drain (the ``POST /admin/drain`` entry
        point — the HTTP handler must not block for the full deadline).
        Returns False when a drain is already running/complete."""
        with self._lock:
            if (
                self._drain_thread is not None
                or self._drain_claimed
                or self._state is LifecycleState.LEFT
            ):
                return False
            self._drain_thread = threading.Thread(
                target=self._drain_guarded, args=(deadline_s,),
                daemon=True, name="lifecycle-drain",
            )
        self._drain_thread.start()
        return True

    def _drain_guarded(self, deadline_s: float | None) -> None:
        try:
            self.drain(deadline_s)
        except Exception:  # noqa: BLE001 — a drain bug must not kill the node silently
            self.log.exception("drain failed")

    def drain(self, deadline_s: float | None = None) -> dict:
        """The full drain sequence, synchronously. Idempotent once LEFT
        (returns the recorded stats); raises :class:`LifecycleError` if
        called re-entrantly mid-drain from a second thread."""
        deadline_s = (
            self.cfg.drain_timeout_s if deadline_s is None else float(deadline_s)
        )
        # Claim the drain under the lock: exactly one caller runs the
        # sequence; a racing caller (SIGTERM exit vs an accepted
        # /admin/drain) WAITS for the winner instead of truncating the
        # graceful exit with an illegal double transition.
        with self._lock:
            if self._state is LifecycleState.LEFT:
                return dict(self.drain_stats or {})
            if self._drain_claimed:
                waited = self._drain_thread
                if waited is None or waited is threading.current_thread():
                    raise LifecycleError("drain already in progress")
            else:
                self._drain_claimed = True
                waited = None
        if waited is not None:
            waited.join(timeout=deadline_s + 10.0)
            return dict(self.drain_stats or {})
        try:
            return self._drain_sequence(deadline_s)
        except BaseException:
            # Release the claim so a RETRY is possible: a failed drain
            # wedged in DRAINING with the claim held would leave the
            # node permanently out of rotation (routers shed it) with
            # no way to finish leaving short of a kill — exactly the
            # failure-detection exit the drain exists to avoid. The
            # state stays DRAINING (nothing un-drains); a retried
            # drain() resumes from there.
            with self._lock:
                self._drain_claimed = False
                self._drain_thread = None
            raise

    def _drain_sequence(self, deadline_s: float) -> dict:
        t0 = self.clock()
        # 1. DRAINING is visible first: the state gossips immediately
        #    (publish in _transition), so the router stops handing this
        #    node NEW work before anything below runs. A RETRY after a
        #    failed attempt is already DRAINING and skips the transition.
        if self._state is not LifecycleState.DRAINING:
            self._transition(LifecycleState.DRAINING)
        stats: dict = {
            "requeued": 0,
            "completed_in_flight": True,
            "writeback_tokens": 0,
            "writeback_flushed": False,
        }
        # 2. Close local admission: new submits shed retriably (503 +
        #    Retry-After; the body names the router to retry through).
        runner = self.runner
        if runner is not None:
            runner.begin_drain(self.cfg.drain_retry_after_s)
        # 2b. Quiesce this node's repair plane: a departing replica must
        #     neither originate probes nor keep feeding peers entries
        #     that are about to leave the fleet. Peers' in-flight
        #     sessions against us abort cleanly on their side — the
        #     LEAVE drops us from their fleet view, and their next scan
        #     prunes the peer state (backoff, budgets) with it.
        if self.repair is not None:
            self.repair.close()
        # 3. Cancel-and-requeue queued + parked-RESTORING requests: they
        #    have produced nothing, so bouncing them to the router loses
        #    no work — while in-flight decodes are left to finish.
        if runner is not None:
            stats["requeued"] = runner.drain_requeue()
        elif self.requeue_fn is not None:
            stats["requeued"] = int(self.requeue_fn() or 0)
        # 4. In-flight decodes run to completion under the deadline
        #    (stragglers are cancelled — partial output returns, flagged).
        if runner is not None:
            stats["completed_in_flight"] = runner.drain_wait_idle(deadline_s)
        # 5. Hot prefixes → host tier through the fused write-back lane,
        #    so a warm rejoin (or a sibling's restore) finds them.
        #    flushed reports the WRITE BARRIER's verdict, not intent: a
        #    timed-out or failed arena write must not read as durably
        #    flushed on /debug/state or in the chaos drain gate.
        if runner is not None:
            tokens, flushed = runner.drain_flush()
            stats["writeback_tokens"] = tokens
            stats["writeback_flushed"] = bool(flushed)
        elif self.writeback_fn is not None:
            stats["writeback_tokens"] = int(self.writeback_fn() or 0)
            stats["writeback_flushed"] = True
        # 5a. Hot subtrees → DISK (cache/kv_tier.py): the host flush
        #     above only survives this process; forcing the arena's
        #     working set into checksummed extents makes the departure
        #     survivable even if the whole cell later loses power
        #     before anyone rejoins. committed reports the spill
        #     commits' verdict (the write-back discipline of step 5).
        #     No-op (0, True) on runners without a disk tier.
        if runner is not None and hasattr(runner, "drain_flush_disk"):
            try:
                spilled, committed = runner.drain_flush_disk()
                stats["disk_spill_nodes"] = int(spilled)
                stats["disk_spill_committed"] = bool(committed)
            except Exception:  # noqa: BLE001 — a tier bug must not wedge the drain
                self.log.exception("disk-tier drain flush failed")
                stats["disk_spill_nodes"] = 0
                stats["disk_spill_committed"] = False
        # 5b. Sharded ownership transfer (cache/sharding.py): hand each
        #     owned shard's entries to the ranks that BECOME owners once
        #     this node leaves — the RF invariant must survive the
        #     departure without waiting out anti-entropy. No-op on a
        #     full-replica mesh (everyone already has everything).
        mesh = self.mesh
        if getattr(mesh, "sharded", False):
            try:
                stats["shard_transfer"] = mesh.handoff_owned_shards()
                mesh.flush_outbound(self.cfg.leave_confirm_s)
            except Exception:  # noqa: BLE001 — a transfer bug must not wedge the drain
                self.log.exception("shard handoff failed")
                stats["shard_transfer"] = {"shards": 0, "entries": 0,
                                           "targets": 0}
        # 5c. Black-box flush (obs/blackbox.py): in-flight work has
        #     settled and the write-back verdict is known — record the
        #     full telemetry history + findings + state NOW, while the
        #     node can still write. A flush failure must not block the
        #     LEAVE (the dump is evidence, not a durability barrier).
        if self.blackbox is not None:
            try:
                stats["blackbox"] = self.blackbox.flush("drain")["path"]
            except Exception:  # noqa: BLE001 — a dump bug must not wedge the drain
                self.log.exception("black-box drain flush failed")
                stats["blackbox"] = None
        # 6. LEAVE: peers drop this node from the view as a PLANNED
        #    departure (cause="left" — failure detection never fires,
        #    FleetView state is forgotten, not left to rot). The frame
        #    is droppable like any oplog — and once the FIRST copy lands
        #    anywhere, peers retarget AWAY from this node, so no
        #    confirmation can ever flow back. Redundant spaced
        #    announcements stand in for an ack: each carries the same
        #    exclusion view (epoch-guarded — duplicates are exact
        #    no-ops on peers that already adopted it), so surviving any
        #    ONE of them suffices, and tick-piggybacked view gossip
        #    spreads it from there.
        retries = max(1, self.cfg.leave_retries)
        for i in range(retries):
            mesh.broadcast_leave()
            mesh.flush_outbound(self.cfg.leave_confirm_s)
            if i + 1 < retries:
                self._wait(self.cfg.leave_confirm_s)
        stats["leave_announcements"] = retries
        self._transition(LifecycleState.LEFT)
        stats["drain_s"] = max(0.0, self.clock() - t0)
        self.drain_stats = stats
        return stats

    # -- misc -----------------------------------------------------------

    def router_hint(self) -> str | None:
        """Where shed clients should retry: the cluster's router node
        (cache address; its serving API derives from it)."""
        nodes = getattr(self.mesh.cfg, "router_nodes", None)
        return nodes[0] if nodes else None

    def status(self) -> dict:
        """The ``/debug/state`` lifecycle block."""
        out = {"state": self._state.value, "is_departing": self.is_departing}
        if self._state is LifecycleState.BOOTSTRAPPING or self.bootstrap_donor is not None:
            out["bootstrap"] = self.bootstrap_status()
        if self.drain_stats is not None:
            out["drain"] = dict(self.drain_stats)
        return out

    # -- thread ---------------------------------------------------------

    def start(self) -> "LifecyclePlane":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="lifecycle-plane"
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        dt = self._drain_thread
        if dt is not None:
            dt.join(timeout=2)
        # Detach ONLY when not departing: the mesh keeps receiving for a
        # beat after close() on the exit path, and clearing the
        # reference would drop the is_departing guard — a straggling
        # exclusion view would then re-trigger the falsely-declared-dead
        # auto-rejoin JOIN moments before the process exits, forcing
        # peers into the failure-detection churn the drain avoided.
        if (
            getattr(self.mesh, "lifecycle", None) is self
            and not self.is_departing
        ):
            self.mesh.lifecycle = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — lifecycle must not kill the node
                self.log.exception("lifecycle tick failed")
            if self._state is not LifecycleState.BOOTSTRAPPING:
                # Nothing periodic to do outside bootstrap; park until
                # close (drains run on their own thread).
                self._stop.wait(max(1.0, self.cfg.tick_interval_s))
            else:
                self._wait(self.cfg.tick_interval_s)


# ---------------------------------------------------------------------------
# autoscale recommender (pure policy — no threads, no process spawning)
# ---------------------------------------------------------------------------


@dataclass
class AutoscaleConfig:
    """Thresholds for the recommender. Deliberately coarse: autoscaling
    reacts in minutes, so hair-trigger thresholds just flap."""

    min_nodes: int = 2
    max_nodes: int = 64
    # Add capacity when queued demand per HEALTHY serving node exceeds
    # this, or when any node sits at/above the SLO degradation tier.
    scale_up_waiting_per_node: float = 8.0
    scale_up_slo_tier: int = 2
    # Remove capacity only when the fleet is comfortably idle.
    scale_down_waiting_per_node: float = 1.0
    scale_down_occupancy: float = 0.3
    # A node scoring below this does not count as capacity.
    healthy_threshold: float = 0.5


class AutoscalePolicy:
    """Pure-policy add/remove recommendations from fleet telemetry.

    ``recommend`` consumes a :class:`~radixmesh_tpu_torch.obs.fleet_plane.
    FleetView` (health scores, per-node queue depth, SLO tiers — all
    already gossiped) and returns a verdict dict. It never spawns or
    kills anything: the workload harness (or an operator reading
    ``/cluster/health``) acts on it, typically by joining a warm node
    (``LifecyclePlane(bootstrap=True)``) or draining the named
    candidate (``POST /admin/drain``)."""

    def __init__(self, cfg: AutoscaleConfig | None = None):
        self.cfg = cfg or AutoscaleConfig()

    def recommend(self, fleet, alive_ring: int | None = None) -> dict:
        cfg = self.cfg
        health = fleet.health()
        serving = {
            r: d
            for r, d in fleet.digests().items()
            if d.role != "router"
            and d.lifecycle in ("active", "bootstrapping")
        }
        n = len(serving) if serving else int(alive_ring or 0)
        healthy = [
            r for r in serving
            if health.get(r, {}).get("score", 0.0) >= cfg.healthy_threshold
        ]
        waiting = sum(d.waiting for d in serving.values())
        occupancy = (
            sum(d.batch_occupancy for d in serving.values()) / n if n else 0.0
        )
        tier = max((d.slo_tier for d in serving.values()), default=0)
        waiting_per_healthy = waiting / max(1, len(healthy))
        signals = {
            "serving_nodes": n,
            "healthy_nodes": len(healthy),
            "waiting": waiting,
            "waiting_per_healthy_node": round(waiting_per_healthy, 3),
            "mean_batch_occupancy": round(occupancy, 3),
            "max_slo_tier": tier,
        }

        def verdict(action: str, reason: str, remove_candidate=None) -> dict:
            return {
                "action": action,
                "reason": reason,
                "remove_candidate": remove_candidate,
                "signals": signals,
            }

        if not serving:
            # No serving digests at all (gossip disabled, or none folded
            # yet): the policy has NO signal — recommending anything
            # would scale a healthy fleet on noise. Hold until telemetry
            # exists.
            return verdict("hold", "no_telemetry")
        if n < cfg.min_nodes:
            return verdict("add", "below_min_nodes")
        if n < cfg.max_nodes:
            if len(healthy) < max(cfg.min_nodes, (n + 1) // 2):
                return verdict("add", "unhealthy_majority")
            if tier >= cfg.scale_up_slo_tier:
                return verdict("add", "slo_degraded")
            if waiting_per_healthy > cfg.scale_up_waiting_per_node:
                return verdict("add", "queue_depth")
        if (
            n > cfg.min_nodes
            and tier == 0
            and len(healthy) == n
            and waiting_per_healthy < cfg.scale_down_waiting_per_node
            and occupancy < cfg.scale_down_occupancy
        ):
            # Drain the least-loaded healthy node (ties → highest rank,
            # so the rank space stays dense at the bottom).
            candidate = max(
                healthy,
                key=lambda r: (-serving[r].waiting, -serving[r].batch_occupancy, r),
            )
            return verdict("remove", "idle_capacity", remove_candidate=candidate)
        return verdict("hold", "steady")
