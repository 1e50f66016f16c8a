"""Deterministic chaos/fault-injection plane for the oplog transports.

Jepsen-style adversarial conditions — frame loss, delay/jitter,
duplication, reordering, scheduled one-way/symmetric partitions, and
channel crashes — injected at the :func:`create_communicator` seam
(``comm/communicator.py``), so ANY test, workload, or soak run can
subject the ring, spine, router fan-out, and prefetch/repair channels to
faults **without touching product code**: the mesh sees an ordinary
:class:`Communicator` that happens to misbehave.

Design constraints (satellite "deflake guard" + the repair plane's
acceptance test both depend on them):

- **Seeded and deterministic.** Every edge (src addr → dst addr) derives
  its own ``numpy`` RNG from ``FaultPlan.seed`` and the edge name, so a
  given plan produces the same drop/dup/delay decisions for the same
  per-edge send sequence on every run — chaos failures reproduce from
  the seed.
- **Virtual-time friendly.** Scheduled faults (partitions, drop
  windows) read a relative clock started at :func:`install` time; tests
  can inject ``now_fn`` to drive schedules without real sleeps.
- **Sender-side only.** Faults apply where the frame leaves the node
  (the only place a real network loses it); inbound delivery is
  untouched, so receiver-side logic is exactly production code.

Fault semantics:

- *drop*: the send reports success but the frame is never delivered —
  the silent loss mode that permanently diverges replicas (what the
  anti-entropy repair plane exists to heal).
- *partition*: ``try_send`` blocks (bounded by its timeout) while the
  window is open, exactly like a blackholed TCP peer — so the mesh's
  failure detection sees the same signal it would in production.
- *delay/jitter/reorder/duplicate*: frames detour through a scheduler
  thread and land late / twice / out of order.
- *crash_after_sends*: the edge dies permanently after its Nth send
  (subsequent sends raise), simulating a connection torn mid-stream.
- *kill (process-level)*: :meth:`FaultPlan.kill` declares a NODE dead —
  not one channel. Every edge INTO the killed address blackholes
  (``try_send`` blocks out its timeout, like a peer whose process
  stopped acking), and every edge OUT of it raises (a dead process
  sends nothing) — permanently, with no scheduled end. This is the
  unclean-death mode the request-recovery plane
  (``server/recovery.py``) exists to survive; a partition ends, a kill
  does not.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
import zlib
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from radixmesh_tpu_torch.comm.communicator import Communicator

__all__ = [
    "PartitionSpec",
    "FaultPlan",
    "FaultyCommunicator",
    "install",
    "uninstall",
    "injected",
    "rebase",
    "active_plan",
    "maybe_wrap",
]


@dataclass(frozen=True)
class PartitionSpec:
    """One scheduled partition: traffic involving ``addrs`` is cut while
    ``start_s <= rel_now < end_s``. ``one_way=True`` cuts only traffic
    INTO ``addrs`` (the asymmetric-partition case where a node can talk
    but not hear); symmetric cuts both directions."""

    start_s: float
    end_s: float
    addrs: tuple[str, ...]
    one_way: bool = False

    def to_dict(self) -> dict:
        return {
            "start_s": self.start_s,
            "end_s": self.end_s,
            "addrs": list(self.addrs),
            "one_way": self.one_way,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PartitionSpec":
        return cls(
            start_s=float(d["start_s"]),
            end_s=float(d["end_s"]),
            addrs=tuple(d.get("addrs", ())),
            one_way=bool(d.get("one_way", False)),
        )


@dataclass
class FaultPlan:
    """A complete seeded fault schedule (JSON-serializable: the
    ``launch.py --chaos-plan`` file format is ``to_dict()``'s output).

    ``targets`` (when set) restricts probabilistic faults — drop / delay
    / dup / reorder — to edges whose destination is listed; partitions
    and crashes always name their own addresses."""

    seed: int = 0
    drop_p: float = 0.0
    drop_start_s: float = 0.0
    drop_end_s: float = float("inf")
    delay_s: float = 0.0
    jitter_s: float = 0.0
    dup_p: float = 0.0
    reorder_p: float = 0.0
    reorder_delay_s: float = 0.02
    partitions: tuple[PartitionSpec, ...] = ()
    # dst addr → edge dies permanently after this many sends to it.
    crash_after_sends: dict = field(default_factory=dict)
    # Addresses whose PROCESS is dead (``kill``): inbound edges
    # blackhole, outbound edges raise, forever. A set so a workload can
    # kill mid-run; every wrapped edge shares this object.
    killed: set = field(default_factory=set)
    targets: tuple[str, ...] | None = None
    # Observability for tests/workloads (not serialized): per-outcome
    # frame counts across every wrapped edge.
    counters: dict = field(default_factory=dict, repr=False, compare=False)

    def count(self, what: str, n: int = 1) -> None:
        self.counters[what] = self.counters.get(what, 0) + n

    def kill(self, addr: str) -> None:
        """Process-level kill: ``addr`` stops serving AND stops acking
        from this instant — permanent, unscheduled, unlike a partition.
        Takes effect immediately on every already-wrapped edge (they all
        share this plan object)."""
        self.killed.add(addr)
        self.count("kills")

    def is_killed(self, addr: str | None) -> bool:
        return addr is not None and addr in self.killed

    def to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "drop_p": self.drop_p,
            "drop_start_s": self.drop_start_s,
            "drop_end_s": (
                None if self.drop_end_s == float("inf") else self.drop_end_s
            ),
            "delay_s": self.delay_s,
            "jitter_s": self.jitter_s,
            "dup_p": self.dup_p,
            "reorder_p": self.reorder_p,
            "reorder_delay_s": self.reorder_delay_s,
            "partitions": [p.to_dict() for p in self.partitions],
            "crash_after_sends": dict(self.crash_after_sends),
            "killed": sorted(self.killed),
            "targets": None if self.targets is None else list(self.targets),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        end = d.get("drop_end_s")
        return cls(
            seed=int(d.get("seed", 0)),
            drop_p=float(d.get("drop_p", 0.0)),
            drop_start_s=float(d.get("drop_start_s", 0.0)),
            drop_end_s=float("inf") if end is None else float(end),
            delay_s=float(d.get("delay_s", 0.0)),
            jitter_s=float(d.get("jitter_s", 0.0)),
            dup_p=float(d.get("dup_p", 0.0)),
            reorder_p=float(d.get("reorder_p", 0.0)),
            reorder_delay_s=float(d.get("reorder_delay_s", 0.02)),
            partitions=tuple(
                PartitionSpec.from_dict(p) for p in d.get("partitions", ())
            ),
            crash_after_sends=dict(d.get("crash_after_sends", {})),
            killed=set(d.get("killed", ())),
            targets=(
                None
                if d.get("targets") is None
                else tuple(d["targets"])
            ),
        )


# ---------------------------------------------------------------------------
# module install state (the create_communicator seam reads it)
# ---------------------------------------------------------------------------

class _Clock:
    """Shared schedule clock: every edge wrapped under one install reads
    the SAME relative time, and :func:`rebase` restarts the schedule for
    all of them at once (a workload builds its cluster first, then
    starts the fault window when traffic begins)."""

    def __init__(self, now_fn: Callable[[], float]):
        self.now_fn = now_fn
        self.t0 = now_fn()

    def rel(self) -> float:
        return self.now_fn() - self.t0


_state_lock = threading.Lock()
_plan: FaultPlan | None = None
_clock: _Clock | None = None


def install(plan: FaultPlan, now_fn: Callable[[], float] | None = None) -> None:
    """Arm ``plan``: every communicator created from now on is wrapped.
    Schedules (partitions, drop windows) are relative to this instant —
    or to the last :func:`rebase` call."""
    global _plan, _clock
    with _state_lock:
        _clock = _Clock(now_fn or time.monotonic)
        _plan = plan


def rebase() -> None:
    """Restart the armed plan's schedule clock at 'now' — already-
    wrapped edges follow along (they share the clock object)."""
    with _state_lock:
        if _clock is not None:
            _clock.t0 = _clock.now_fn()


def uninstall() -> None:
    global _plan
    with _state_lock:
        _plan = None


def active_plan() -> FaultPlan | None:
    with _state_lock:
        return _plan


@contextmanager
def injected(plan: FaultPlan, now_fn: Callable[[], float] | None = None):
    """Scoped install — the test/workload idiom. Already-created
    communicators are unaffected; communicators created inside the scope
    keep their faults for their lifetime (a node outliving the scope
    keeps misbehaving until closed — close the cluster inside)."""
    install(plan, now_fn)
    try:
        yield plan
    finally:
        uninstall()


def maybe_wrap(
    comm: Communicator, src: str | None, dst: str | None
) -> Communicator:
    """The :func:`create_communicator` hook: identity when no plan is
    armed (one lock-free-ish branch on the happy path), else a
    :class:`FaultyCommunicator` bound to the armed plan + clock."""
    if _plan is None:
        return comm
    with _state_lock:
        plan, clock = _plan, _clock
    if plan is None or clock is None:
        return comm
    return FaultyCommunicator(comm, plan, src=src, dst=dst, clock=clock)


# ---------------------------------------------------------------------------
# delayed-delivery scheduler (one daemon thread, shared by every edge)
# ---------------------------------------------------------------------------


class _Scheduler:
    _default: "_Scheduler | None" = None
    _default_lock = threading.Lock()

    def __init__(self):
        self._heap: list = []
        self._seq = itertools.count()
        self._cond = threading.Condition()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="chaos-scheduler"
        )
        self._thread.start()

    @classmethod
    def default(cls) -> "_Scheduler":
        with cls._default_lock:
            if cls._default is None:
                cls._default = cls()
            return cls._default

    def submit(self, delay_s: float, fn) -> None:
        due = time.monotonic() + max(0.0, delay_s)
        with self._cond:
            heapq.heappush(self._heap, (due, next(self._seq), fn))
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._heap:
                    # meshcheck: ok[timeout-audit] chaos-scheduler
                    # condition, notified on every submit; exists only
                    # under an armed fault plan, never on a serving path.
                    self._cond.wait()
                due, _, fn = self._heap[0]
                wait = due - time.monotonic()
                if wait > 0:
                    self._cond.wait(timeout=wait)
                    continue
                heapq.heappop(self._heap)
            try:
                fn()
            except Exception:  # noqa: BLE001 — a dead edge must not kill the clock
                pass


class FaultyCommunicator(Communicator):
    """A :class:`Communicator` that misbehaves per an armed
    :class:`FaultPlan`. Wraps the real transport; every non-fault path
    delegates, so behavior with an all-zero plan is bit-identical."""

    def __init__(
        self,
        inner: Communicator,
        plan: FaultPlan,
        src: str | None,
        dst: str | None,
        clock: _Clock,
    ):
        self._inner = inner
        self._plan = plan
        self._src = src
        self._dst = dst
        self._clock = clock
        # Per-edge deterministic stream: same plan seed + same edge name
        # + same send sequence → same decisions, every run.
        edge = f"{src or '?'}→{dst or '?'}"
        self._rng = np.random.default_rng(
            (plan.seed << 32) ^ zlib.crc32(edge.encode())
        )
        self._sent = 0
        self._crashed = False

    # -- schedule reads -------------------------------------------------

    def _rel(self) -> float:
        return self._clock.rel()

    def _dst_now(self) -> str | None:
        # retarget() may move the edge; faults follow the CURRENT target.
        t = self._inner.target_address()
        return t if t is not None else self._dst

    def _partitioned(self, rel: float) -> bool:
        dst = self._dst_now()
        for p in self._plan.partitions:
            if not p.start_s <= rel < p.end_s:
                continue
            if dst is not None and dst in p.addrs:
                return True  # traffic INTO the isolated set
            if not p.one_way and self._src is not None and self._src in p.addrs:
                return True  # symmetric: traffic OUT of it too
        return False

    def _in_scope(self) -> bool:
        t = self._plan.targets
        if t is None:
            return True
        dst = self._dst_now()
        return dst is not None and dst in t

    def _check_crash(self) -> None:
        if self._crashed:
            raise RuntimeError("chaos: channel crashed")
        if self._plan.is_killed(self._src):
            # A dead process sends nothing: outbound edges raise.
            self._plan.count("killed_send")
            raise RuntimeError(f"chaos: process {self._src} is killed")
        dst = self._dst_now()
        n = self._plan.crash_after_sends.get(dst)
        if n is not None and self._sent >= int(n):
            self._crashed = True
            self._plan.count("crashes")
            raise RuntimeError(f"chaos: channel to {dst} crashed on send {self._sent}")

    # -- faulted delivery ----------------------------------------------

    def _deliver(self, data: bytes) -> None:
        """Post-decision delivery: apply delay/jitter/reorder/duplicate,
        then hand to the real transport."""
        plan, rng = self._plan, self._rng
        delay = 0.0
        if plan.delay_s > 0.0 or plan.jitter_s > 0.0:
            delay = plan.delay_s + plan.jitter_s * float(rng.random())
        if plan.reorder_p > 0.0 and rng.random() < plan.reorder_p:
            # Hold this frame long enough for a successor to overtake it.
            delay += plan.reorder_delay_s
            plan.count("reordered")
        copies = 1
        if plan.dup_p > 0.0 and rng.random() < plan.dup_p:
            copies = 2
            plan.count("duplicated")
        for _ in range(copies):
            if delay > 0.0:
                plan.count("delayed")
                inner = self._inner
                _Scheduler.default().submit(
                    delay, lambda d=bytes(data): _quiet_send(inner, d)
                )
            else:
                self._inner.send(data)

    def send(self, data: bytes) -> None:
        self._check_crash()
        rel = self._rel()
        self._sent += 1
        if self._plan.is_killed(self._dst_now()):
            self._plan.count("killed_blocked")
            raise RuntimeError("chaos: peer process is killed")
        if self._partitioned(rel):
            self._plan.count("partition_blocked")
            raise RuntimeError("chaos: partitioned")
        if self._should_drop(rel):
            return
        self._deliver(data)

    def try_send(self, data: bytes, timeout_s: float) -> bool:
        self._check_crash()
        self._sent += 1
        deadline = time.monotonic() + timeout_s
        # A partition — or a KILLED peer — behaves like a blackholed
        # process that stopped acking: the send BLOCKS (bounded by the
        # caller's timeout) — the same signal real failure detection
        # keys on — and succeeds iff the window closes before the
        # deadline. A kill never closes.
        while self._partitioned(self._rel()) or self._plan.is_killed(
            self._dst_now()
        ):
            if time.monotonic() >= deadline:
                self._plan.count(
                    "killed_blocked"
                    if self._plan.is_killed(self._dst_now())
                    else "partition_blocked"
                )
                return False
            # meshcheck: ok[sleep-audit] partition-blocked backoff inside
            # the fault injector's bounded deadline loop (chaos only).
            time.sleep(0.002)
        if self._should_drop(self._rel()):
            return True  # silent loss: the sender believes it delivered
        remaining = max(0.0, deadline - time.monotonic())
        self._deliver_or_try(data, remaining)
        return True

    def _deliver_or_try(self, data: bytes, timeout_s: float) -> None:
        plan = self._plan
        if plan.delay_s > 0.0 or plan.jitter_s > 0.0 or plan.reorder_p > 0.0 \
                or plan.dup_p > 0.0:
            self._deliver(data)
            return
        if not self._inner.try_send(data, timeout_s):
            # The REAL transport timed out (not a fault): surface it.
            raise RuntimeError("chaos: inner transport timed out")

    def _should_drop(self, rel: float) -> bool:
        plan = self._plan
        if (
            plan.drop_p > 0.0
            and self._in_scope()
            and plan.drop_start_s <= rel < plan.drop_end_s
            and self._rng.random() < plan.drop_p
        ):
            plan.count("dropped")
            return True
        plan.count("delivered")
        return False

    # -- passthrough ----------------------------------------------------

    def retarget(self, target_addr: str | None) -> None:
        self._inner.retarget(target_addr)

    def connected(self) -> bool:
        return self._inner.connected()

    def register_rcv_callback(self, fn: Callable[[bytes], None]) -> None:
        self._inner.register_rcv_callback(fn)

    def is_ordered(self) -> bool:
        return self._inner.is_ordered()

    def target_address(self) -> str | None:
        return self._inner.target_address()

    def close(self) -> None:
        self._inner.close()


def _quiet_send(inner: Communicator, data: bytes) -> None:
    """Delayed-delivery landing: by the time the scheduler fires, the
    edge may be closed/retargeted — a late frame into a dead channel is
    just a lost frame, exactly like the real network."""
    try:
        inner.send(data)
    except Exception:  # noqa: BLE001
        pass
