"""Async KV-movement plane: every bulk KV copy between the tiers, off the
engine's scheduling thread (this package's port of the JAX package's
``cache/kv_transfer.py``). Three lanes over one staged executor:

- **restore** (host arena or disk extent → pool): admission splits into a
  non-blocking ``match_prefix`` plus a staged restore. The engine parks the
  request in ``RESTORING`` and keeps decoding; the worker thread copies
  each chunk into a staging buffer and starts its host→device copy, and the
  engine applies the pool scatters at its next :meth:`KVTransferPlane.pump`.
- **write-back** (pool → host arena): an eviction sweep enqueues ONE fused
  gather on the compute stream (``host_cache.py``); the worker moves it to
  the host and writes the arena.
- **spill** (host arena → disk extent, ``cache/kv_tier.py``): the worker
  reads the arena and writes a checksummed extent; the engine commits it.

The handoff lane (``submit_task``/``note_handoff``) carries the
disaggregated handoff (``engine/disagg.py``): a prefill worker's streamed
chunks are copied to the host, packed and sent by ``submit_task`` closures
on the worker, and both sides account their staged blocks with
``note_handoff``.

**What the JAX worker's ``jnp.asarray`` staging becomes on CUDA.** The JAX
plane leans on XLA's async dispatch and buffer donation for its ordering;
here it is built by hand, and the plane raises rather than run a CUDA pool
without it:

- A dedicated **copy stream** on the pool's device; the worker issues every
  host↔device copy on it.
- The host arena is pinned and slot-major (``host_cache.py``), so a run of
  consecutive arena slots is one contiguous range: a restore chunk of
  ``chunk_tokens`` tokens is copied ``non_blocking`` from the arena's runs
  straight into a device staging tensor on the copy stream, with no host
  gather, and an **event** is recorded after it. A disk chunk goes through
  a ring of ``stage_depth`` **pinned** staging buffers of ``chunk_tokens``
  tokens each, allocated once (16 × 512 tokens by default: 1.07 GB at
  Llama-3-8B bf16): the worker copies the extent's rows into a free
  buffer, then into the device staging tensor the same way.
- :meth:`~KVTransferPlane.pump` (engine thread only) applies only chunks
  whose event has completed (``event.query()``), scattering them into the
  pool on the compute stream, so the compute stream never waits on a
  transfer and decode keeps stepping while a restore is parked.
- At most ``stage_depth`` chunks are staged at once. A chunk's slot (and
  its ring buffer) is given back only once its host→device event has
  completed and the pump took it; the device staging tensor, made on the
  copy stream and read by the compute stream's scatter, is marked with
  ``record_stream`` so the allocator cannot reuse it before that scatter
  has run.
- A write-back's gather is enqueued on the compute stream at the end of the
  eviction sweep, before any later write to the recycled slots, with an
  event after it. The worker makes the copy stream wait on that event,
  copies each run of the sweep's arena slots straight into the pinned
  arena, and ``synchronize()``-s an event after the last copy before the
  write-back counts as landed: ``wait_host_ready`` returns True only then.

A CPU pool (the tests) runs the same code with unpinned buffers, no stream
and no events (a CPU copy has completed when it returns).

**Ordering contract.** The worker queue is FIFO except that write-backs
take priority: a node restore is enqueued only after its write-back
(``host_value`` is set when the write-back is reserved), so the priority
can only move an arena write earlier than a dependent arena read.
``wait_host_ready()`` gives the synchronous restore the same guarantee.

**Hints.** :meth:`~KVTransferPlane.note_hint` records a prefix to restore
ahead of its request (no request attached): idempotent (pending nodes are
joined), never evicting, never splitting nodes, droppable everywhere. A
serving node's mesh replica turns the router's ``PREFETCH`` frames into
hints (``launch.py node``).

**Across ranks** (an engine over several ranks, ``parallel/step_sync.py``):
with ``strict`` set, :meth:`~KVTransferPlane.pump` only scatters the chunks
that have landed on this rank, and a unit whose last chunk landed waits in
a local queue. :meth:`~KVTransferPlane.sync_local` reports those units and
the finished spills (each with a failure code) to the step agreement, and
:meth:`~KVTransferPlane.apply_agreed` installs exactly the ones every rank
has, failed where any rank failed. A failed write-back, or a read barrier
that does not come down, raises under ``strict`` instead of dropping the
host copy on one rank only.

**Observability.** The JAX package's ``radixmesh_kv_transfer_*`` series
(bytes and seconds by lane, restored tokens, hints by outcome, and the
``radixmesh_kv_transfer_inflight_tokens`` gauge of tokens queued or staged
per lane) on the port's registry, mirrored as plain counters in
:meth:`~KVTransferPlane.stats`; and, while the flight recorder samples,
the JAX plane's events on the plane's ``kv:<name>`` lane: ``kv_restore``
(per restored node), ``kv_spill``, ``kv_handoff_stage`` and
``kv_writeback``, each with its token count.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from radixmesh_tpu_torch.obs.metrics import TRANSFER_SECONDS_BUCKETS, get_registry
from radixmesh_tpu_torch.obs.trace_plane import get_recorder
from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = ["KVTransferPlane", "RestoreTicket", "kv_token_bytes"]

_LANES = ("restore", "writeback", "handoff", "spill")
_HINT_OUTCOMES = ("started", "noop", "joined", "dropped", "draining")
_MAX_HINTS = 64  # queued prefetch hints; the oldest is dropped past it
# Units and spills one step agreement can settle (the rest wait a pass).
SYNC_ITEMS = 16


def _runs(slots) -> list[tuple[int, int, int]]:
    """``(offset, first slot, length)`` of each run of consecutive ids in
    ``slots``, in order."""
    slots = np.asarray(slots, dtype=np.int64)
    if len(slots) == 0:
        return []
    starts = np.concatenate([[0], np.nonzero(np.diff(slots) != 1)[0] + 1])
    ends = np.concatenate([starts[1:], [len(slots)]])
    return [(int(a), int(slots[a]), int(b - a)) for a, b in zip(starts, ends)]


def kv_token_bytes(pool) -> int:
    """Bytes per token slot of ``pool`` (K and V, all layers, plus int8
    scales): the unit of every lane's byte counter."""
    per = 2 * pool.num_layers * pool.num_kv_heads * pool.head_dim
    n = per * torch.empty((), dtype=pool.dtype).element_size()
    if pool.quant is not None:
        n += 2 * pool.num_layers * pool.num_kv_heads * 4  # f32 scales
    return int(n)


@dataclass
class _RestoreUnit:
    """One host- or disk-resident tree node's restore, shared between
    tickets (a hint and an admission on the same prefix join one unit).
    The source is the host arena (``host_slots``) or a disk extent
    (``extent``, read and checksum-verified on the worker: a corrupt
    extent fails the unit, never installs)."""

    node: object  # TreeNode
    host_slots: np.ndarray
    dev_slots: np.ndarray
    extent: object = None  # kv_tier.ExtentRef for disk-source units
    n_tokens: int = 0
    refs: int = 0  # tickets referencing this unit
    applied: bool = False
    locked: bool = False  # holds an eviction lock until refs drain
    failed: bool = False  # worker staging failed: never install
    attached: bool = False  # node.value was installed
    applied_tokens: int = 0  # tokens of staged chunks the pump has taken
    tickets: list = field(default_factory=list)
    # Under ``strict``: 0 landed, 1 failed, 2 failed and its extent gone.
    code: int = 0


@dataclass
class _Staged:
    """One staged restore chunk: its device tensors (token-major views, on
    the pool's device), the event after their host→device copy (None on the
    CPU), and the ring buffer a disk chunk holds until the pump takes it."""

    unit: _RestoreUnit
    last: bool
    dev_slots: np.ndarray  # empty = a failed unit's sentinel
    kv: torch.Tensor | None
    scales: torch.Tensor | None
    event: object
    buf: int | None
    tree: object


class _ExtentUnreadable(Exception):
    """A disk extent failed verification (torn, corrupt or missing): the
    unit degrades with a warning, not a traceback."""


class RestoreTicket:
    """A parked restore: the ordered units one match's host or disk
    extension needs. ``done`` when every unit has been applied (installed,
    or skipped because it raced, split or detached: the request then
    re-matches a shorter hit)."""

    __slots__ = ("units", "anchor", "t0", "auto_release", "released", "tokens")

    def __init__(self, units, anchor, auto_release: bool):
        self.units = units
        self.anchor = anchor
        self.t0 = time.monotonic()  # the request's kv_restore span starts here
        self.auto_release = auto_release
        self.released = False
        self.tokens = int(sum(u.n_tokens for u in units))

    @property
    def done(self) -> bool:
        return all(u.applied for u in self.units)


@dataclass
class _WritebackTicket:
    """One eviction sweep's fused pool→host copy: the gather was enqueued on
    the compute stream (``gathered``: the event after it, None on the CPU);
    the worker copies it into the arena."""

    kv: torch.Tensor  # [2, L, n, H, D] view of slot-major storage, on the pool's device
    scales: torch.Tensor | None
    n: int
    host_slots: np.ndarray
    host: object = None  # HostKVStore the arena write targets
    gathered: object = None
    failed: bool = False  # the copy raised: arena bytes untrusted
    done: threading.Event = field(default_factory=threading.Event)


class KVTransferPlane:
    """The staged executor behind the lanes.

    Threading model: the ENGINE thread owns the tree and ``pool.kv``: it
    begins restores, enqueues write-back gathers and applies staged
    scatters at :meth:`pump`. The WORKER thread owns host memory, the
    staging buffers, the copy stream and fresh device staging tensors.
    Other threads may only enqueue hints and handoff tasks."""

    def __init__(self, *, chunk_tokens: int = 512, stage_depth: int = 16, name: str = "plane"):
        if chunk_tokens <= 0 or stage_depth <= 0:
            raise ValueError("chunk_tokens and stage_depth must be positive")
        self.chunk_tokens = int(chunk_tokens)
        self.stage_depth = int(stage_depth)
        self.log = get_logger("kvplane")
        self._lock = threading.Lock()
        # Worker input lanes: write-backs drain first (the ordering
        # contract); restores, spills and handoff tasks share the data lane.
        self._wb_q: deque[_WritebackTicket] = deque()
        self._data_q: deque[tuple] = deque()
        self._work_evt = threading.Event()
        # Staging (bind()): the worker runs at most stage_depth chunks ahead
        # of the pump; a chunk's slot, and a disk chunk's ring buffer, come
        # back when the pump takes the completed chunk.
        self._device: torch.device | None = None
        self._layout: tuple | None = None
        self._copy_stream = None
        self._ring: list[tuple[torch.Tensor, torch.Tensor | None]] = []
        self._free_bufs: deque[int] = deque()
        self._stage_sem = threading.Semaphore(self.stage_depth)
        self._staged: deque[_Staged] = deque()
        self._progress = threading.Event()
        # node.id → in-flight _RestoreUnit (dedupe/join, and the host-tier
        # eviction shield: host_cache._evict_host skips pending nodes).
        self._pending_nodes: dict[int, _RestoreUnit] = {}
        # node.id → node with a disk spill in flight (its arena slots stay
        # until the extent commits at pump).
        self._pending_spills: dict[int, object] = {}
        # Worker-finished spills awaiting their engine-thread commit.
        self._spilled: deque[tuple] = deque()
        # Arena slot ids whose write-back FAILED: a node still pointing at
        # them drops its host copy instead of restoring garbage.
        self._poisoned_host: set[int] = set()
        self._tickets: list[RestoreTicket] = []
        self._hints: deque[np.ndarray] = deque(maxlen=_MAX_HINTS)
        self._stop = threading.Event()
        # Test seam: when set, the worker blocks here before staging each
        # restore chunk (a deterministic "restore in flight" window).
        self.stage_barrier: threading.Event | None = None
        self.hints_seen = 0
        self.hints_joined = 0  # admissions that found a hint's restore in flight
        # Across ranks (module docstring): units whose last chunk landed
        # here, waiting for the step agreement, and failed write-backs.
        self.strict = False
        self._landed: deque[_RestoreUnit] = deque()
        self.writeback_failures = 0
        # The JAX package's radixmesh_kv_transfer_* series, on the registry
        # and as plain counters for stats() (/stats).
        self.lane_bytes = {ln: 0 for ln in _LANES}
        self.lane_seconds = {ln: 0.0 for ln in _LANES}
        self.restored_tokens = 0
        self.hint_outcomes = {o: 0 for o in _HINT_OUTCOMES}
        reg = get_registry()
        lbl = {"plane": name}
        bytes_total = reg.counter(
            "radixmesh_kv_transfer_bytes_total",
            "bulk KV bytes moved by the async plane, by lane",
            ("plane", "lane"),
        )
        seconds = reg.histogram(
            "radixmesh_kv_transfer_seconds",
            "blocking-side duration of one plane operation (arena "
            "read/write, gather materialization, handoff stage), by lane",
            ("plane", "lane"),
            buckets=TRANSFER_SECONDS_BUCKETS,
        )
        depth = reg.gauge(
            "radixmesh_kv_transfer_inflight_tokens",
            "tokens currently queued/staged in the plane, by lane "
            "(the lane queue-depth signal)",
            ("plane", "lane"),
        )
        self._m_bytes = {ln: bytes_total.labels(lane=ln, **lbl) for ln in _LANES}
        self._m_seconds = {ln: seconds.labels(lane=ln, **lbl) for ln in _LANES}
        self._m_depth = {ln: depth.labels(lane=ln, **lbl) for ln in _LANES}
        self._m_restored = reg.counter(
            "radixmesh_kv_transfer_restored_tokens_total",
            "host-tier tokens restored to HBM by the staged lane",
            ("plane",),
        ).labels(**lbl)
        hints = reg.counter(
            "radixmesh_kv_transfer_prefetch_hints_total",
            "prefetch hints by outcome (started = restore launched, "
            "noop = already device-resident/unknown, joined = an "
            "admission found the hinted restore already in flight, "
            "dropped = hint queue overflow, draining = discarded "
            "because the node is mid-drain)",
            ("plane", "outcome"),
        )
        self._m_hint = {o: hints.labels(outcome=o, **lbl) for o in _HINT_OUTCOMES}
        self._trace_lane = f"kv:{name}"
        self._worker = threading.Thread(target=self._run, daemon=True, name="kv-transfer")
        self._worker.start()

    # ------------------------------------------------------------------
    # staging resources
    # ------------------------------------------------------------------

    def bind(self, pool) -> None:
        """Allocate the staging ring and (for a CUDA pool) the copy stream
        for ``pool``'s token layout, once. Pinned behind a CUDA pool; raises
        if pinning fails. Called on the engine thread (the engine binds at
        construction; the lanes bind lazily)."""
        layout = (pool.device, pool.dtype, pool.quant, pool.num_layers,
                  pool.num_kv_heads, pool.head_dim)
        if self._layout is not None:
            if self._layout != layout:
                raise ValueError("a KV-transfer plane serves one pool layout")
            return
        cuda = pool.device.type == "cuda"
        _, dtype, quant, L, H, D = layout
        c = self.chunk_tokens

        # One flat block per kind, cut into stage_depth chunk buffers: a
        # chunk of c' <= c tokens is the contiguous prefix view of its buffer.
        n = self.stage_depth
        kv = torch.empty(n * c * 2 * L * H * D, dtype=dtype, pin_memory=cuda)
        sc = None if quant is None else torch.empty(n * c * 2 * L * H, dtype=torch.float32,
                                                    pin_memory=cuda)
        if cuda and not all(t.is_pinned() for t in (kv, sc) if t is not None):
            raise RuntimeError("the KV-transfer staging buffers could not be pinned")
        ring = [(kv.narrow(0, i * c * 2 * L * H * D, c * 2 * L * H * D),
                 None if sc is None else sc.narrow(0, i * c * 2 * L * H, c * 2 * L * H))
                for i in range(n)]
        stream = torch.cuda.Stream(device=pool.device) if cuda else None
        # Published under the lock: stats() reads the ring from caller
        # threads while a lane binds lazily.
        with self._lock:
            self._ring = ring
            self._free_bufs = deque(range(self.stage_depth))
            self._copy_stream = stream
            self._device = pool.device
            self._layout = layout

    @property
    def pinned(self) -> bool:
        return bool(self._ring) and self._ring[0][0].is_pinned()

    def _views(self, buf, n: int) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Slot-major ``[n, 2, L, H, D]`` (+ ``[n, 2, L, H]``) contiguous
        views of the first ``n`` tokens of a ring buffer."""
        _, _, _, L, H, D = self._layout
        kv, sc = buf
        return (kv[: n * 2 * L * H * D].view(n, 2, L, H, D),
                None if sc is None else sc[: n * 2 * L * H].view(n, 2, L, H))

    def _on_copy_stream(self):
        """The worker's device context: the pool's device and the copy
        stream (nothing on the CPU)."""
        if self._copy_stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self._device))
        stack.enter_context(torch.cuda.stream(self._copy_stream))
        return stack

    def _record(self):
        """An event after the copy stream's work so far (None on the CPU)."""
        if self._copy_stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self._copy_stream)
        return ev

    # ------------------------------------------------------------------
    # lifecycle / introspection
    # ------------------------------------------------------------------

    def close(self) -> None:
        self._stop.set()
        self._work_evt.set()
        self._worker.join(timeout=2)

    def idle(self) -> bool:
        with self._lock:
            return (
                not self._wb_q
                and not self._data_q
                and not self._staged
                and not self._pending_nodes
                and not self._pending_spills
                and not self._spilled
                and not self._tickets
                and not self._hints
            )

    def stats(self) -> dict:
        """Plane state under the JAX package's ``stats()`` keys, plus the
        staging resources and the counters of its series."""
        with self._lock:
            return {
                "chunk_tokens": self.chunk_tokens,
                "writebacks_queued": len(self._wb_q),
                "restores_queued": len(self._data_q),
                "staged_chunks": len(self._staged),
                "pending_restore_nodes": len(self._pending_nodes),
                "pending_spills": len(self._pending_spills),
                "spills_uncommitted": len(self._spilled),
                "active_tickets": len(self._tickets),
                "hints_queued": len(self._hints),
                "hints_seen": self.hints_seen,
                "hints_joined": self.hints_joined,
                "stage_depth": self.stage_depth,
                "stage_free": len(self._free_bufs),
                "pinned": self.pinned,
                "copy_stream": self._copy_stream is not None,
                "restored_tokens": self.restored_tokens,
                "lane_bytes": dict(self.lane_bytes),
                "lane_seconds": dict(self.lane_seconds),
                "hint_outcomes": dict(self.hint_outcomes),
            }

    def wait_progress(self, timeout: float = 0.002) -> None:
        """Engine idle-wait: block briefly until the worker stages or
        completes something (no busy spin while the only live work is an
        in-flight restore)."""
        self._progress.wait(timeout)
        self._progress.clear()

    def _count(self, lane: str, nbytes: int, seconds: float) -> None:
        with self._lock:
            self.lane_bytes[lane] += int(nbytes)
            self.lane_seconds[lane] += seconds
        self._m_bytes[lane].inc(int(nbytes))
        self._m_seconds[lane].observe(seconds)

    # ------------------------------------------------------------------
    # restore lane (engine thread: begin/pump/finish; worker: staging)
    # ------------------------------------------------------------------

    def is_pending(self, node) -> bool:
        with self._lock:
            return node.id in self._pending_nodes

    def has_engine_work(self) -> bool:
        """True while the plane holds work only the ENGINE thread can
        advance: unconverted hints, staged chunks awaiting their scatter,
        open tickets, or uncommitted spills. ``Engine.has_work`` folds it
        in so an otherwise idle scheduler keeps pumping."""
        with self._lock:
            if self.strict:
                # What the engine threads of every rank hold alike: open
                # tickets and uncommitted spills (the hints are the step
                # agreement's).
                return bool(self._tickets or self._pending_spills)
            return bool(self._hints or self._staged or self._tickets or self._spilled)

    def host_slots_ok(self, slots) -> bool:
        """False if any of ``slots`` belongs to a FAILED write-back. Slots
        reported bad are retired from the poison set: the caller's drop
        frees them, and fresh writes make them trustworthy again. The
        unlocked empty read is a fast path: new poison is only enqueued
        behind this same engine thread's sweeps."""
        if not self._poisoned_host:
            return True
        with self._lock:
            return self._host_slots_ok_locked(slots)

    def _host_slots_ok_locked(self, slots) -> bool:
        """``host_slots_ok`` for callers already holding the plane lock (it
        is not reentrant)."""
        if not self._poisoned_host:
            return True
        bad = [int(s) for s in slots if int(s) in self._poisoned_host]
        if not bad:
            return True
        self._poisoned_host.difference_update(bad)
        return False

    def begin_restore(self, tree, match, alloc, auto_release: bool = False):
        """Start (or join) a staged restore of ``match``'s host and disk
        extension. ``alloc(n) -> slots | None`` supplies pool slots (the
        engine's evict-and-retry allocator; hints pass the pool's plain
        ``alloc``: hints never evict). Units already in flight are JOINED.
        Returns a :class:`RestoreTicket`, or None when nothing is
        restorable."""
        self.bind(tree.pool)
        anchor = (
            match.last_node
            if match.last_node is not None and match.last_node is not tree.root
            else None
        )
        # Shield the device prefix BEFORE any allocation: ``alloc`` may
        # evict, and an unlocked anchor is itself a candidate whose removal
        # would strand the host subtree being read.
        if anchor is not None:
            tree.inc_lock_ref(anchor)
        units: list[_RestoreUnit] = []
        new_units: list[_RestoreUnit] = []
        joined_hint = False
        disk_tier = getattr(tree, "disk", None)
        with self._lock:
            for node in match.restorable_nodes():
                u = self._pending_nodes.get(node.id)
                if u is not None:
                    u.refs += 1
                    units.append(u)
                    # Credit a hint only when a PREFETCH ticket started the
                    # unit: two admissions sharing a prefix are dedupe.
                    joined_hint |= any(t.auto_release for t in u.tickets)
                    continue
                if node.value is not None:
                    break  # raced: already restored
                if node.host_value is not None:
                    if not self._host_slots_ok_locked(node.host_value):
                        # Failed write-back: retire the host copy (the check
                        # consumed the poison entry) and stop here.
                        tree._drop_poisoned_host(node)
                        break
                    host_slots = np.asarray(node.host_value, dtype=np.int32)
                    n = len(host_slots)
                    dev = alloc(n)
                    if dev is None:
                        break  # no room: the hit is shorter
                    u = _RestoreUnit(node, host_slots, dev[:n], n_tokens=n, refs=1)
                elif node.disk_value is not None and disk_tier is not None:
                    n = len(node.disk_value)
                    dev = alloc(n)
                    if dev is None:
                        break
                    u = _RestoreUnit(node, np.empty(0, dtype=np.int32), dev[:n],
                                     extent=node.disk_value, n_tokens=n, refs=1)
                else:
                    break  # detached mid-walk / tier unreachable
                self._pending_nodes[node.id] = u
                units.append(u)
                new_units.append(u)
            if not units:
                if anchor is not None:
                    tree.dec_lock_ref(anchor)
                return None
            ticket = RestoreTicket(units, anchor=anchor, auto_release=auto_release)
            for u in units:
                u.tickets.append(ticket)
            self._tickets.append(ticket)
            for u in new_units:
                self._data_q.append(("restore", u, tree))
            self._m_depth["restore"].inc(sum(u.n_tokens for u in new_units))
            if joined_hint:
                self.hints_joined += 1
                self.hint_outcomes["joined"] += 1
                self._m_hint["joined"].inc()
        self._work_evt.set()
        return ticket

    def pump(self, tree) -> bool:
        """ENGINE-THREAD drain: scatter each staged chunk whose copy has
        completed into the pool on the compute stream (the only place the
        plane touches ``pool.kv``; it never waits on a copy in flight),
        install fully restored nodes, commit finished spills and release
        done auto-release tickets. Returns True when anything progressed.
        Under ``strict`` it only scatters: installs and commits wait for
        :meth:`apply_agreed`."""
        progress = False
        while True:
            with self._lock:
                if not self._staged:
                    break
                item = self._staged[0]
                if item.event is not None and not item.event.query():
                    break  # chunks complete in stream order: the rest wait
                self._staged.popleft()
            if len(item.dev_slots):  # empty = a failed unit's sentinel
                if item.kv.is_cuda:
                    # Made on the copy stream, read by this scatter.
                    stream = torch.cuda.current_stream(item.kv.device)
                    item.kv.record_stream(stream)
                    if item.scales is not None:
                        item.scales.record_stream(stream)
                item.tree.pool.write_raw(item.dev_slots, item.kv, item.scales)
            if item.kv is not None:  # a staged chunk, not a failed unit's sentinel
                self._release_slot(item.buf)
                item.unit.applied_tokens += len(item.dev_slots)
                self._m_depth["restore"].dec(len(item.dev_slots))
            else:  # the failed unit's tokens never staged
                self._m_depth["restore"].dec(item.unit.n_tokens - item.unit.applied_tokens)
            if item.last:
                if self.strict:
                    unit = item.unit
                    if unit.failed:
                        disk = getattr(item.tree, "disk", None)
                        gone = unit.extent is not None and (disk is None or not disk.has(unit.extent))
                        unit.code = 2 if gone else 1
                    self._landed.append(unit)
                else:
                    self._apply_unit(item.tree, item.unit)
            progress = True
        if not self.strict:
            progress |= self._commit_spills(tree, None)
        progress |= self._release_auto(tree)
        return progress

    def sync_local(self) -> list[int]:
        """This rank's part of the step agreement (``strict``): the units
        landed here in order and the spills finished here, at most
        ``SYNC_ITEMS`` of each, each with its code negated (the agreement's
        MIN is the largest code), then the failed write-backs, negated."""
        with self._lock:
            units = [u.code for u in list(self._landed)[:SYNC_ITEMS]]
            spills = [int(it[2] is None) for it in list(self._spilled)[:SYNC_ITEMS]]
        pad = [0] * SYNC_ITEMS
        return ([len(units)] + [-c for c in units] + pad[len(units):]
                + [len(spills)] + [-c for c in spills] + pad[len(spills):]
                + [-self.writeback_failures])

    def apply_agreed(self, tree, agreed: list[int]) -> bool:
        """Install the units and commit the spills that landed on every rank
        (``agreed`` is :meth:`sync_local`'s layout after the agreement's
        MIN), each failed where any rank failed. Raises when a write-back
        failed on any rank: the ranks' arenas no longer hold the same
        bytes."""
        k = SYNC_ITEMS
        if agreed[2 * k + 2] < 0:
            raise RuntimeError(
                f"a KV write-back failed on {-agreed[2 * k + 2]} rank(s) of this engine: the host "
                "tiers of its ranks differ"
            )
        progress = False
        for i in range(agreed[0]):
            with self._lock:
                unit = self._landed.popleft()
            code = -agreed[1 + i]
            unit.failed = code > 0
            self._apply_unit(tree, unit, gone=code == 2 if unit.extent is not None else None)
            progress = True
        codes = [-c for c in agreed[k + 2 : k + 2 + agreed[k + 1]]]
        progress |= self._commit_spills(tree, codes)
        progress |= self._release_auto(tree)
        return progress

    def _commit_spills(self, tree, codes: list[int] | None) -> bool:
        """Commit worker-finished spills: all of them (``codes`` None), or
        the agreed first ``len(codes)``, failed where a code is set."""
        progress = False
        n = 0
        # Commit worker-finished spills (only the engine thread mutates the
        # tree): install the ref when the node is unchanged; a raced node
        # retires the extent instead.
        while codes is None or n < len(codes):
            with self._lock:
                if not self._spilled:
                    break
                node, slots, ref, cause = self._spilled.popleft()
                self._pending_spills.pop(node.id, None)
            disk = getattr(tree, "disk", None)
            if codes is not None and codes[n] and ref is not None:
                # Written here, failed on another rank: no rank keeps it.
                if disk is not None:
                    disk.retire(ref)
                ref, cause = None, "io"
            n += 1
            unchanged = (
                node.host_value is not None
                and len(node.host_value) == len(slots)
                and np.array_equal(node.host_value, slots)
            )
            if ref is not None:
                if unchanged and node.disk_value is None:
                    node.disk_value = ref
                elif disk is not None:
                    disk.retire(ref)
            elif cause == "poisoned" and unchanged:
                # The spill source was a failed write-back's slots: retire
                # the poison entries first (the drop frees the slots, and a
                # stale entry would condemn the next tenant's copy).
                with self._lock:
                    self._poisoned_host.difference_update(int(s) for s in slots)
                tree._drop_poisoned_host(node)
            progress = True
        return progress

    def _release_auto(self, tree) -> bool:
        progress = False
        done_auto = []
        with self._lock:
            for t in self._tickets:
                if t.auto_release and t.done and not t.released:
                    done_auto.append(t)
        for t in done_auto:
            self.finish_ticket(tree, t)
            progress = True
        return progress

    def _apply_unit(self, tree, unit: _RestoreUnit, gone: bool | None = None) -> None:
        """Install one fully scattered unit (engine thread). Nodes split,
        detached or restored since the unit was made are skipped and its
        slots returned: the waiting request re-matches a shorter hit.
        ``gone``: whether a failed extent is gone, as the step agreement
        says (None: this tier's own view)."""
        node = unit.node
        with self._lock:
            self._pending_nodes.pop(node.id, None)
        if unit.extent is not None:
            raced = unit.failed or node.value is not None or node.disk_value is not unit.extent
            if unit.failed and node.disk_value is unit.extent:
                disk = getattr(tree, "disk", None)
                if gone and disk is not None and disk.has(unit.extent):
                    disk.retire(unit.extent)  # gone on another rank: gone on all
                if gone or (gone is None and (disk is None or not disk.has(unit.extent))):
                    # The extent failed VERIFICATION (the tier dropped the
                    # file): clear the dangling ref so the node recomputes.
                    # A transient failure keeps the intact extent attached.
                    node.disk_value = None
        else:
            raced = (
                unit.failed
                or node.host_value is None
                or node.value is not None
                or len(node.host_value) != len(unit.host_slots)
                or not np.array_equal(node.host_value, unit.host_slots)
            )
        if raced:
            tree.pool.free(unit.dev_slots)
        else:
            node.value = unit.dev_slots
            tree.evictable_size_ += len(node.key)
            # Hold the restored node (and its ancestors) until every ticket
            # needing it finishes: device residency stays prefix-closed.
            tree.inc_lock_ref(node)
            unit.locked = True
            unit.attached = True
            n = unit.n_tokens
            with self._lock:
                self.restored_tokens += n
            self._m_restored.inc(n)
            if unit.extent is not None:
                disk = getattr(tree, "disk", None)
                if disk is not None:
                    disk.note_promote(unit.extent)  # the disk copy is kept
            # Draft-ahead: continuation KV arrived that this node did not
            # compute, so re-arm tree drafting for in-flight requests.
            note = getattr(tree, "note_draft_ready", None)
            if note is not None:
                note()
            if hasattr(tree, "restore_tokens"):
                tree.restore_tokens += n
                tree._m_restore.inc(n)
        unit.applied = True
        rec = get_recorder()
        if rec.enabled:
            rec.event(self._trace_lane, "kv_restore", time.monotonic(), 0.0, cat="kv",
                      tokens=int(unit.n_tokens), source="disk" if unit.extent is not None else "host",
                      attached=bool(unit.attached))
        self._progress.set()

    def finish_ticket(self, tree, ticket: RestoreTicket) -> None:
        """Release a DONE ticket's eviction shields (engine thread). Units
        shared with running tickets stay locked until the last reference
        drains."""
        if ticket.released:
            return
        ticket.released = True
        with self._lock:
            try:
                self._tickets.remove(ticket)
            except ValueError:
                pass
        if ticket.anchor is not None:
            tree.dec_lock_ref(ticket.anchor)
        for u in ticket.units:
            u.refs -= 1
            if u.refs <= 0 and u.locked:
                u.locked = False
                tree.dec_lock_ref(u.node)

    # ------------------------------------------------------------------
    # write-back lane
    # ------------------------------------------------------------------

    def submit_writeback(self, pool, host, slots, host_slots):
        """ENGINE THREAD: enqueue one fused gather of an eviction sweep's
        slots on the compute stream (so it reads them before any later
        scatter can recycle them) and an event after it; queue the copy to
        the host and the arena write for the worker."""
        self.bind(pool)
        slots = np.asarray(slots, dtype=np.int32)
        n = len(slots)
        if n == 0:
            return None
        kv, scales = pool.gather_raw(slots)
        gathered = None
        if pool.device.type == "cuda":
            gathered = torch.cuda.Event()
            gathered.record(torch.cuda.current_stream(pool.device))
        ticket = _WritebackTicket(
            kv=kv, scales=scales, n=n, host_slots=np.asarray(host_slots, dtype=np.int32),
            host=host, gathered=gathered,
        )
        with self._lock:
            self._wb_q.append(ticket)
            self._m_depth["writeback"].inc(n)
        self._work_evt.set()
        return ticket

    def wait_host_ready(self, timeout: float = 30.0) -> bool:
        """Block until every write-back queued so far has landed in the
        arena: the synchronous restore's read barrier. False on timeout OR
        if an awaited write-back FAILED (its arena bytes are untrusted)."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                pending = list(self._wb_q)
            if not pending:
                return True
            self._work_evt.set()
            ok = pending[-1].done.wait(max(0.0, deadline - time.monotonic()))
            if ok and not any(t.failed for t in pending):
                continue
            if self.strict:
                raise RuntimeError(
                    "the host tier's read barrier failed on this rank (a write-back "
                    f"{'failed' if ok else f'took over {timeout} s'}): the engine's ranks would "
                    "restore different prefixes"
                )
            return False

    # ------------------------------------------------------------------
    # spill lane (host tier → disk extents, cache/kv_tier.py)
    # ------------------------------------------------------------------

    def spill_pending(self, node) -> bool:
        """True while a disk spill of ``node`` is in flight."""
        with self._lock:
            return node.id in self._pending_spills

    def submit_spill(self, tree, node, prefix_tokens) -> bool:
        """ENGINE THREAD: queue one host-resident node's demotion to a disk
        extent. The worker reads the arena (after the write-back priority
        drain, so the bytes are the landed ones) and writes the fsynced
        extent; the next :meth:`pump` installs ``node.disk_value``. False
        when the node is already spilling or restoring or holds no host
        copy."""
        if getattr(tree, "disk", None) is None or node.host_value is None:
            return False
        with self._lock:
            if node.id in self._pending_spills or node.id in self._pending_nodes:
                return False
            slots = np.asarray(node.host_value, dtype=np.int32).copy()
            seg = np.asarray(node.key, dtype=np.int32).copy()
            self._pending_spills[node.id] = node
            self._data_q.append(
                ("spill", node, np.asarray(prefix_tokens, dtype=np.int32).copy(), seg, slots, tree)
            )
            self._m_depth["spill"].inc(len(slots))
        self._work_evt.set()
        return True

    def _host_slots_poisoned(self, slots) -> bool:
        """Read-only poison check (worker): does NOT consume the entries."""
        if not self._poisoned_host:
            return False
        with self._lock:
            return any(int(s) in self._poisoned_host for s in slots)

    def _run_spill(self, item) -> None:
        """WORKER: one queued spill, arena read + extent write and fsync.
        Every outcome reports back through ``_spilled``."""
        _, node, prefix, seg, slots, tree = item
        t0 = time.monotonic()
        ref = None
        cause = None
        try:
            if self._host_slots_poisoned(slots):
                cause = "poisoned"
            else:
                kv, scales = tree.host.read(slots)
                ref = tree.disk.write_extent(prefix, seg, kv, scales)
                if ref is None:
                    cause = "io"
        except Exception:  # noqa: BLE001 — a failed spill must not kill the lane
            self.log.exception("disk spill failed; node stays volatile")
            cause = "error"
        dur = time.monotonic() - t0
        self._count("spill", 0 if ref is None else ref.nbytes, dur)
        if ref is not None:
            rec = get_recorder()
            if rec.enabled:
                rec.event(self._trace_lane, "kv_spill", t0, dur, cat="kv", tokens=int(len(slots)))
        with self._lock:
            self._m_depth["spill"].dec(len(slots))
            self._spilled.append((node, slots, ref, cause))
        tree.disk.drain_retired()
        self._progress.set()

    def spills_idle(self) -> bool:
        """True when no spill is queued, in flight, or awaiting its commit
        (under ``strict``: awaiting its agreed commit)."""
        with self._lock:
            if self.strict:
                return not self._pending_spills
            if self._pending_spills or self._spilled:
                return False
            return not any(it[0] == "spill" for it in self._data_q)

    # ------------------------------------------------------------------
    # handoff lane (engine/disagg.py)
    # ------------------------------------------------------------------

    def submit_task(self, fn) -> None:
        """Queue a handoff-lane closure on the worker, FIFO with restores
        (``PrefillWorker.prefill_handoff_stream``: one chunk's copy to the
        host, pack and send)."""
        with self._lock:
            self._data_q.append(("task", fn))
        self._work_evt.set()

    def note_handoff(self, n_tokens: int, pool, dur: float) -> None:
        """Account one staged handoff block (any thread)."""
        self._count("handoff", n_tokens * kv_token_bytes(pool), dur)
        rec = get_recorder()
        if rec.enabled:
            rec.event(self._trace_lane, "kv_handoff_stage", time.monotonic() - dur, dur, cat="kv",
                      tokens=int(n_tokens))

    # ------------------------------------------------------------------
    # prefetch hints
    # ------------------------------------------------------------------

    def note_hint(self, key) -> None:
        """Record a PREFETCH hint (any thread). Bounded drop-oldest: losing
        a hint costs a restore overlap, never correctness."""
        with self._lock:
            self.hints_seen += 1
            if len(self._hints) == self._hints.maxlen:
                self.hint_outcomes["dropped"] += 1
                self._m_hint["dropped"].inc()
            self._hints.append(np.asarray(key, dtype=np.int32))
        self._progress.set()

    def take_hints(self) -> list[np.ndarray]:
        with self._lock:
            out = list(self._hints)
            self._hints.clear()
        return out

    def count_hint(self, outcome: str) -> None:
        with self._lock:
            self.hint_outcomes[outcome] += 1
        self._m_hint[outcome].inc()

    # ------------------------------------------------------------------
    # worker
    # ------------------------------------------------------------------

    def _drain_writebacks(self) -> bool:
        """Process every queued write-back (priority lane); runs between
        restore chunks too, so a long restore cannot delay the arena writes
        a synchronous reader may be waiting on."""
        did = False
        while not self._stop.is_set():
            with self._lock:
                ticket = self._wb_q[0] if self._wb_q else None
            if ticket is None:
                return did
            t0 = time.monotonic()
            try:
                with self._on_copy_stream():
                    self._write_back(ticket)
                nbytes = ticket.kv.numel() * ticket.kv.element_size() + (
                    0 if ticket.scales is None else ticket.scales.numel() * 4)
                dur = time.monotonic() - t0
                self._count("writeback", nbytes, dur)
                rec = get_recorder()
                if rec.enabled:
                    rec.event(self._trace_lane, "kv_writeback", t0, dur, cat="kv", tokens=int(ticket.n))
            except Exception:  # noqa: BLE001 — one bad sweep must not kill the lane
                # Retired FAILED (done still fires, so wait_host_ready
                # callers don't hang); its arena slots are poisoned. Copies
                # already issued finish first: they read the gather, which
                # is released below, and write the poisoned slots.
                self.log.exception("write-back failed")
                if self._copy_stream is not None:
                    self._copy_stream.synchronize()
                ticket.failed = True
                with self._lock:
                    self.writeback_failures += 1
                    self._poisoned_host.update(int(s) for s in ticket.host_slots)
            with self._lock:
                if self._wb_q and self._wb_q[0] is ticket:
                    self._wb_q.popleft()
                self._m_depth["writeback"].dec(ticket.n)
            ticket.kv = ticket.scales = None  # the gather's device memory
            ticket.done.set()
            self._progress.set()
            did = True
        return did

    def _write_back(self, ticket: _WritebackTicket) -> None:
        """Copy a sweep's gather into the arena: one copy per run of
        consecutive arena slots, in batch order (a duplicate id's later
        copy lands last), straight into the pinned arena. On CUDA the copy
        stream first waits for the gather's event, and the worker waits for
        an event after the last copy."""
        if ticket.gathered is not None:
            self._copy_stream.wait_event(ticket.gathered)
        kv = ticket.kv.permute(2, 0, 1, 3, 4)  # slot-major [n, 2, L, H, D]
        sc = None if ticket.scales is None else ticket.scales.permute(2, 0, 1, 3)
        for off, first, n in _runs(ticket.host_slots):
            dst_kv, dst_sc = ticket.host.rows(first, n)
            dst_kv.copy_(kv[off : off + n], non_blocking=True)
            if sc is not None:
                dst_sc.copy_(sc[off : off + n], non_blocking=True)
        event = self._record()
        if event is not None:
            event.synchronize()

    def _acquire_slot(self) -> bool:
        """One of the ``stage_depth`` staging slots, draining write-backs
        while waiting; False when the plane stops."""
        while not self._stop.is_set():
            if self._stage_sem.acquire(timeout=0.05):
                return True
            self._drain_writebacks()
        return False

    def _release_slot(self, buf: int | None) -> None:
        if buf is not None:
            with self._lock:
                self._free_bufs.append(buf)
        self._stage_sem.release()

    def _stage_unit(self, unit: _RestoreUnit, tree) -> None:
        """WORKER: stage one restore unit chunk by chunk (see the module
        docstring for the copy stream, the ring and the events)."""
        n = unit.n_tokens
        disk_kv = disk_scales = None
        if unit.extent is not None:
            # One verified extent read up front: the checksum is the serve
            # gate, and a torn extent never installs a byte.
            payload = tree.disk.read_extent(unit.extent)
            if payload is None:
                raise _ExtentUnreadable(unit.extent.path)
            disk_kv, disk_scales = payload
        _, dtype, quant, L, H, D = self._layout
        for lo in range(0, n, self.chunk_tokens):
            self._drain_writebacks()
            if self.stage_barrier is not None:
                self.stage_barrier.wait(timeout=10.0)
            if not self._acquire_slot():
                return
            hi = min(n, lo + self.chunk_tokens)
            buf = None
            try:
                if unit.extent is not None:
                    # The extent's token-major rows, into a pinned ring buffer.
                    with self._lock:
                        buf = self._free_bufs.popleft()
                    src = self._views(self._ring[buf], hi - lo)
                    src[0].copy_(disk_kv[:, :, lo:hi].permute(2, 0, 1, 3, 4))
                    if src[1] is not None:
                        src[1].copy_(disk_scales[:, :, lo:hi].permute(2, 0, 1, 3))
                    runs = [(0, src, hi - lo)]
                else:
                    host = tree.host
                    runs = [(off, host.rows(first, m), m)
                            for off, first, m in _runs(unit.host_slots[lo:hi])]
                with self._on_copy_stream():
                    kv = torch.empty((hi - lo, 2, L, H, D), dtype=dtype, device=self._device)
                    scales = (None if quant is None else
                              torch.empty((hi - lo, 2, L, H), dtype=torch.float32, device=self._device))
                    for off, (src_kv, src_sc), m in runs:
                        kv[off : off + m].copy_(src_kv, non_blocking=True)
                        if scales is not None:
                            scales[off : off + m].copy_(src_sc, non_blocking=True)
                    event = self._record()
            except BaseException:
                self._release_slot(buf)
                raise
            with self._lock:
                self._staged.append(_Staged(
                    unit, hi == n, unit.dev_slots[lo:hi], kv.permute(1, 2, 0, 3, 4),
                    None if scales is None else scales.permute(1, 2, 0, 3), event, buf, tree,
                ))
            self._progress.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            if self._drain_writebacks():
                continue
            with self._lock:
                item = self._data_q.popleft() if self._data_q else None
            if item is None:
                self._work_evt.wait(timeout=0.1)
                self._work_evt.clear()
                continue
            if item[0] == "task":
                try:
                    item[1]()
                except Exception:  # noqa: BLE001 — a failed task must not kill the lane
                    self.log.exception("handoff task failed")
                continue
            if item[0] == "spill":
                self._run_spill(item)
                continue
            _, unit, tree = item
            t0 = time.monotonic()
            try:
                self._stage_unit(unit, tree)
            except Exception as e:  # noqa: BLE001 — a failed stage must not wedge the ticket
                # Hand the unit to the pump as its final "chunk", failed: it
                # applies as raced (slots freed, node left in its source
                # tier, or out of it for an unreadable extent) and the
                # request re-queues with a shorter hit. Chunks already
                # staged are scattered into slots that are then freed.
                if isinstance(e, _ExtentUnreadable):
                    self.log.warning("disk restore degraded: %s failed verification", e)
                else:
                    self.log.exception("restore staging failed; degrading unit")
                unit.failed = True
                with self._lock:
                    self._staged.append(_Staged(unit, True, unit.dev_slots[:0], None, None,
                                                None, None, tree))
                self._progress.set()
            else:
                self._count("restore", unit.n_tokens * kv_token_bytes(tree.pool),
                            time.monotonic() - t0)
            disk = getattr(tree, "disk", None)
            if disk is not None:
                disk.drain_retired()
