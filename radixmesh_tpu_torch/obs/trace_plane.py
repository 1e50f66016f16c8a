"""Request-flight tracing plane: span trees + bounded flight recorder.

The port's own copy of the JAX package's ``obs/trace_plane.py`` (its
recorder is separate from the JAX package's). In the port, as in the JAX
package, the engine, the HTTP edge, the KV-movement plane, the cache mesh,
the repair plane, the disaggregated handoff and the SLO queue record
spans.

``obs/metrics.py`` answers "how is the fleet doing" in aggregate;
nothing in the repo could answer "where did THIS request's 400 ms go?".
This module supplies the per-request causal timeline:

- A :class:`TraceContext` is created per request at the serving edge
  (``Engine.make_request`` / the HTTP frontend) and carried on
  ``Request.trace``; every layer the request crosses — SLO admission,
  routing, prefill waves, decode launches, publish, disagg handoff —
  records completed :class:`Span`\\ s against it.
- Spans land in a :class:`FlightRecorder`: a bounded in-memory ring
  (drop-oldest under pressure, counted) that costs one lock + one deque
  append per span, and exactly ONE branch per call site when tracing is
  off (``trace()``/``event()`` return before touching any span state).
- :meth:`FlightRecorder.chrome_trace` exports Chrome trace-event JSON
  ("traceEvents") loadable in Perfetto / ``chrome://tracing``; lanes map
  to Perfetto threads (one per request, per ring node, per engine), so
  a request's admission wait / prefill wave / decode chunks / publish
  read as one horizontal story, with ring replication-lag spans on the
  mesh lanes below it.
- The async KV-movement plane (``cache/kv_transfer.py``) records its
  lanes here too: ``kv_restore`` (on the request's lane when a parked
  restore completes, and per-node on the plane's ``kv:`` lane),
  ``kv_writeback`` (fused eviction-sweep copies on the worker), and
  ``kv_handoff_stage`` (disagg placement staged off the reader thread)
  — so a KV copy that DOES stall something shows up next to the decode
  chunks it delayed.
- The anti-entropy repair plane (``cache/repair_plane.py``) records one
  ``repair_round`` span per completed session on its ``repair:<node>``
  lane (cat ``repair``: probe → answering summary, with the peer rank,
  bucket count, and keys pushed as args) — so a repair storm, if one
  ever got past the backoff limits, would be visible interleaved with
  the request timelines it competes with.

Cross-node stitching: trace ids are 64-bit and globally unique
(splitmix64 over a process-scoped counter mixed with the pid), so the id
itself can cross the wire. Every inter-node hop now carries it — the
``/generate`` body (resume/hedge re-routes), the disagg handoff packet
header, and data-kind oplog frames (an optional, old-wire-tolerant
trailer — ``cache/oplog.py``) — and receivers open their spans under the
ORIGINATING id instead of minting a new one. Each span additionally
carries the ``node`` label of the process/role that recorded it, and
:meth:`FlightRecorder.merge` folds many nodes' span exports
(``export_spans`` / ``GET /debug/trace?format=spans``) into ONE Perfetto
document with one process-track per node, correcting clock offsets from
each export's wall-vs-monotonic base (plus optional per-node skew
estimates from the fleet plane's digest timestamps) — a resurrected
request's router → prefill → handoff → decode → resurrection journey
reads as a single flame view. Ring replication-lag spans are still
derived receiver-side from the oplog's origin wall-clock timestamp, but
when the frame carries a trace id the lag span lands UNDER it — the
replication edge is part of the request's timeline, not just time
overlap.

Overhead model: sampling off (the default) short-circuits at the first
``if`` in :meth:`FlightRecorder.trace` — no allocation, no lock, no
clock read at any instrumentation site (call sites are all shaped
``tr = req.trace; if tr is not None: ...``). Sampling on costs ~one
dict + one deque append per span under a short lock; the recorder is
bounded, so a trace storm degrades to dropped-oldest spans, never to
unbounded heap growth.

This module is import-light on purpose (stdlib only): it pulls in no
backend.
"""

from __future__ import annotations

import itertools
import json
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass

__all__ = [
    "Span",
    "TraceContext",
    "FlightRecorder",
    "get_recorder",
    "set_recorder",
    "configure",
    "write_trace",
    "new_trace_id",
    "stitch_traces",
    "dropped_spans_counter",
]

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer (the tree-fingerprint mixing family)."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


_id_counter = itertools.count(1)


def dropped_spans_counter():
    """The trace-loss counter family,
    ``radixmesh_trace_dropped_spans_total{node}`` — resolved from the
    CURRENT registry at the drop site (not cached at recorder
    construction) so registry swaps in tests never strand increments on
    a stale registry. A bounded drop-oldest ring is correct storm
    behavior, but a SILENT one lies: every evicted span now lands on a
    scrapeable counter, every export declares its ``dropped`` total, and
    the attributor refuses holed traces (see ``FlightRecorder``)."""
    from radixmesh_tpu_torch.obs.metrics import get_registry

    return get_registry().counter(
        "radixmesh_trace_dropped_spans_total",
        "flight-recorder spans evicted by the ring bound before export "
        "(trace-loss visibility: a stitched artifact from a node with "
        "drops has declared, not silent, coverage gaps)",
        ("node",),
    )


def new_trace_id() -> int:
    """A fresh 64-bit trace id, unique within the process (global
    counter) and collision-resistant across processes (pid mixed in) —
    the id that crosses the wire so receivers stitch their spans under
    the originating request instead of minting node-local ids that
    collide at merge time. Never 0 (0 = "no trace" on every wire)."""
    tid = _mix64(((os.getpid() & 0xFFFFF) << 40) ^ next(_id_counter))
    return tid or 1


@dataclass
class Span:
    """One completed span: monotonic start + duration, on a named lane."""

    name: str
    lane: str  # Perfetto thread lane, e.g. "req:17", "ring:prefill@0"
    t0: float  # time.monotonic() seconds at span start
    dur: float  # seconds
    trace_id: int  # 0 = not tied to a request trace (node-scope events)
    cat: str = "serving"
    args: dict | None = None
    # Node that recorded the span ("" = the recorder's default). The
    # stitched export groups spans into one Perfetto process-track per
    # node — in-process multi-node harnesses share ONE recorder, so the
    # node must ride the span, not the recorder.
    node: str = ""


class TraceContext:
    """Per-request handle: a trace id + the lane its spans land on.

    Intentionally tiny — it is carried on every ``Request`` and tested
    for ``None`` on hot paths; all recording funnels through the owning
    recorder so swap-for-isolation (tests) keeps working.
    """

    __slots__ = ("trace_id", "lane", "node", "_rec")

    def __init__(
        self,
        trace_id: int,
        lane: str,
        rec: "FlightRecorder",
        node: str = "",
    ):
        self.trace_id = trace_id
        self.lane = lane
        self.node = node
        self._rec = rec

    def add(
        self,
        name: str,
        t0: float,
        dur: float,
        cat: str = "serving",
        **args,
    ) -> None:
        """Record a completed span from explicit timestamps (most engine
        spans derive from bookkeeping the scheduler already stamps —
        submit/admit/first-token — so no extra clock reads)."""
        self._rec._record(
            Span(name, self.lane, t0, max(0.0, dur), self.trace_id, cat,
                 args or None, self.node)
        )

    def span(self, name: str, cat: str = "serving", **args) -> "_SpanTimer":
        """``with ctx.span("publish"): ...`` — wall-times the block."""
        return _SpanTimer(self, name, cat, args)


class _SpanTimer:
    __slots__ = ("_ctx", "_name", "_cat", "_args", "_t0")

    def __init__(self, ctx: TraceContext, name: str, cat: str, args: dict):
        self._ctx = ctx
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_SpanTimer":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        self._ctx.add(
            self._name,
            self._t0,
            time.monotonic() - self._t0,
            cat=self._cat,
            **self._args,
        )
        return False


class FlightRecorder:
    """Bounded in-memory span ring with drop-oldest semantics.

    ``sample`` gates everything: 0.0 (default) disables tracing with a
    one-branch fast path; 1.0 traces every request; in between, each
    request (or node-scope event) flips an independent coin. Capacity
    bounds post-mortem memory — a storm past it drops the OLDEST spans
    (the fresh ones are the ones a live debugger wants) and counts the
    drops.

    Drops are never silent: every eviction increments
    ``radixmesh_trace_dropped_spans_total{node}``, every export carries
    the lifetime ``dropped`` count (so a stitched artifact declares its
    coverage), and evicting a trace-id-bearing span marks that trace id
    as HOLED — the phase attributor (``obs/attribution.py``) refuses to
    decompose a holed trace into a waterfall instead of publishing a
    breakdown with interior gaps, and counts the refusal.
    """

    # Bound on the holed-trace-id memory: past it the set stops growing
    # and ``drops_untracked`` flips — attribution then refuses EVERY
    # trace conservatively (a storm that evicted 4k distinct traces has
    # destroyed any per-request story worth telling anyway).
    DROPPED_TRACE_CAP = 4096

    def __init__(
        self, capacity: int = 8192, sample: float = 0.0, node: str = ""
    ):
        if capacity <= 0:
            raise ValueError("trace capacity must be positive")
        self.capacity = int(capacity)
        self.sample = float(sample)
        # Default node label for contexts/events that don't name one
        # (single-node processes set it once via configure(node=...)).
        self.node = node
        # This process's monotonic→wall conversion, captured once: the
        # stitcher shifts every export into a shared wall-clock base
        # with it (per-node clock skew is corrected separately).
        self.wall_offset = time.time() - time.monotonic()
        self._lock = threading.Lock()
        self._buf: deque[Span] = deque(maxlen=self.capacity)
        self._rng = random.Random(0xF117)  # deterministic sampling sequence
        self.recorded = 0  # spans accepted (lifetime)
        self.dropped = 0  # spans evicted by the ring bound (lifetime)
        # Live per-trace span index: every buffered span with a nonzero
        # trace id sits in exactly one list (evictions remove it), so a
        # retire-time waterfall is one dict lookup, not a ring scan.
        self._by_tid: dict[int, list[Span]] = {}
        # Trace ids that LOST at least one span to the ring bound.
        self._dropped_tids: set[int] = set()
        self.drops_untracked = False  # dropped-tid set hit its cap
        # Span-retire hook (obs/attribution.py installs it): called with
        # (retire_span, recorder) AFTER the span landed, outside the
        # buffer lock, whenever a span named in ``retire_spans`` records.
        # None (the default) keeps _record one append — the
        # one-branch contract extends here: sampling off records nothing,
        # so the hook costs zero when tracing is off.
        self.retire_hook = None
        self.retire_spans: frozenset[str] = frozenset()
        # The installed PhaseAttributor (obs/attribution.py), if any —
        # carried on the recorder so a registry/recorder swap in tests
        # gets a fresh one via ensure_attributor().
        self.attributor = None

    # -- the hot-path gates -------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.sample > 0.0

    def trace(
        self,
        lane: str,
        force: bool = False,
        trace_id: int | None = None,
        node: str | None = None,
    ) -> TraceContext | None:
        """New per-request trace context, or None when tracing is off /
        this request lost the sampling coin flip. THE no-op guard: the
        disabled path is one float compare + return. ``force`` skips the
        coin flip (NOT the off switch) — used when an upstream node
        already decided this request is traced (disagg handoff), so a
        fractional sample yields whole cross-node timelines, not halves.
        ``trace_id`` ADOPTS an upstream node's 64-bit id (implies
        ``force`` — the id's existence IS the upstream decision), so the
        receiver's spans stitch under the originating request; None
        mints a fresh globally-unique id (``new_trace_id``)."""
        if self.sample <= 0.0:
            return None
        if (
            not force
            and trace_id is None
            and self.sample < 1.0
            and self._rng.random() >= self.sample
        ):
            return None
        return TraceContext(
            new_trace_id() if not trace_id else int(trace_id) & _M64,
            lane,
            self,
            self.node if node is None else node,
        )

    def event(
        self,
        lane: str,
        name: str,
        t0: float,
        dur: float,
        cat: str = "serving",
        trace_id: int = 0,
        node: str | None = None,
        **args,
    ) -> None:
        """Node-scope span (ring replication lag, eviction sweeps, route
        decisions). Same one-branch guard. A nonzero ``trace_id`` ties
        the span to an (upstream-originated) request trace AND skips the
        sampling coin flip — the sender already decided this request is
        traced, and a receiver flipping its own coin would shear
        cross-node timelines apart at fractional sampling rates."""
        if self.sample <= 0.0:
            return
        if (
            not trace_id
            and self.sample < 1.0
            and self._rng.random() >= self.sample
        ):
            return
        self._record(
            Span(
                name, lane, t0, max(0.0, dur), int(trace_id) & _M64, cat,
                args or None, self.node if node is None else node,
            )
        )

    # -- storage -------------------------------------------------------

    def _record(self, span: Span) -> None:
        evicted: Span | None = None
        with self._lock:
            if len(self._buf) == self.capacity:
                # Peek the victim BEFORE deque(maxlen) evicts it: the
                # drop must be attributed (metric + holed-trace mark),
                # not just counted.
                evicted = self._buf[0]
                self.dropped += 1
                if evicted.trace_id:
                    lst = self._by_tid.get(evicted.trace_id)
                    if lst is not None:
                        # Global FIFO order implies per-trace FIFO order:
                        # the victim is the oldest span of its trace.
                        if lst and lst[0] is evicted:
                            lst.pop(0)
                        if not lst:
                            del self._by_tid[evicted.trace_id]
                    if len(self._dropped_tids) < self.DROPPED_TRACE_CAP:
                        self._dropped_tids.add(evicted.trace_id)
                    elif evicted.trace_id not in self._dropped_tids:
                        self.drops_untracked = True
            self._buf.append(span)
            self.recorded += 1
            if span.trace_id:
                self._by_tid.setdefault(span.trace_id, []).append(span)
        if evicted is not None:
            dropped_spans_counter().labels(
                node=evicted.node or self.node or "node"
            ).inc()
        hook = self.retire_hook
        if hook is not None and span.name in self.retire_spans:
            hook(span, self)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def snapshot(self) -> list[Span]:
        with self._lock:
            return list(self._buf)

    def drain(self) -> list[Span]:
        with self._lock:
            out = list(self._buf)
            self._buf.clear()
            self._by_tid.clear()
            return out

    def spans_for_trace(self, trace_id: int) -> list[Span]:
        """Every buffered span recorded under ``trace_id`` (insertion
        order) — the attributor's per-request input, O(trace spans)."""
        with self._lock:
            return list(self._by_tid.get(int(trace_id) & _M64, ()))

    def trace_has_drops(self, trace_id: int) -> bool:
        """True when ``trace_id`` lost at least one span to the ring
        bound (or the holed-trace set itself overflowed, in which case
        EVERY trace answers True — coverage can no longer be proven).
        The attributor's refusal predicate: a waterfall computed from a
        holed trace would silently misattribute the missing intervals
        to the residual phase."""
        with self._lock:
            return (
                self.drops_untracked
                or (int(trace_id) & _M64) in self._dropped_tids
            )

    # -- export --------------------------------------------------------

    def chrome_trace(self, spans: list[Span] | None = None, drain: bool = False) -> dict:
        """Chrome trace-event JSON (the ``traceEvents`` array format) —
        load in Perfetto (ui.perfetto.dev) or ``chrome://tracing``.

        Lanes become threads of one process, named via ``thread_name``
        metadata events; complete-event (``ph: "X"``) timestamps are
        microseconds from the earliest span, emitted non-decreasing
        within each lane."""
        if spans is None:
            spans = self.drain() if drain else self.snapshot()
        base = min((s.t0 for s in spans), default=0.0)
        lanes: dict[str, int] = {}
        events: list[dict] = []
        # Sort by (lane, t0): within-lane ts monotonicity is part of the
        # artifact contract (bench.validate_trace checks it).
        for s in sorted(spans, key=lambda s: (s.lane, s.t0)):
            tid = lanes.setdefault(s.lane, len(lanes) + 1)
            ev = {
                "name": s.name,
                "cat": s.cat,
                "ph": "X",
                "ts": round((s.t0 - base) * 1e6, 3),
                "dur": round(s.dur * 1e6, 3),
                "pid": 1,
                "tid": tid,
            }
            args = dict(s.args or {})
            if s.trace_id:
                # Hex string: 64-bit ids exceed the 2^53 integer range a
                # JS-based viewer (Perfetto) reads losslessly.
                args["trace_id"] = f"{s.trace_id:#018x}"
            if s.node:
                args["node"] = s.node
            if args:
                ev["args"] = args
            events.append(ev)
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "args": {"name": lane},
            }
            for lane, tid in lanes.items()
        ]
        return {
            "displayTimeUnit": "ms",
            "traceEvents": meta + events,
            "otherData": {
                "recorder": {
                    "capacity": self.capacity,
                    "sample": self.sample,
                    "recorded": self.recorded,
                    "dropped": self.dropped,
                },
            },
        }

    def export_spans(self, drain: bool = False) -> dict:
        """Raw-span export for the cross-node stitcher: the recorder's
        spans as plain dicts plus this process's node label and
        monotonic→wall offset (``GET /debug/trace?format=spans`` serves
        exactly this body; a collector pulls one per node and hands the
        set to :meth:`merge`)."""
        spans = self.drain() if drain else self.snapshot()
        return {
            "node": self.node,
            "wall_offset": self.wall_offset,
            # Coverage declaration: spans this recorder evicted before
            # the export. A collector stitching multiple nodes folds
            # these into the artifact's per-node dropped map — no
            # silent caps.
            "dropped": self.dropped,
            "spans": [
                {
                    "name": s.name,
                    "lane": s.lane,
                    "t0": s.t0,
                    "dur": s.dur,
                    "trace_id": f"{s.trace_id:#018x}" if s.trace_id else "",
                    "cat": s.cat,
                    "args": s.args or {},
                    "node": s.node or self.node,
                }
                for s in spans
            ],
        }

    @staticmethod
    def merge(
        exports: list[dict], clock_offsets: dict[str, float] | None = None
    ) -> dict:
        """Stitch many nodes' span exports into ONE Perfetto document:
        one process-track (pid) per node, one thread per (node, lane),
        every timestamp shifted into a shared wall-clock base.

        Per-export correction: ``t_wall = t0 + wall_offset`` (the
        export's own monotonic→wall conversion). Per-NODE correction:
        ``clock_offsets[node]`` seconds are subtracted — the caller's
        estimate of that node's wall-clock skew vs the collector, e.g.
        ``FleetView.clock_offsets()`` derived from the digest timestamps
        every node already gossips. Skew bends telemetry, never
        correctness — exactly the oplog-lag contract.

        In-process multi-node harnesses produce ONE export whose spans
        carry distinct ``node`` labels; the grouping below handles both
        shapes identically."""
        offsets = clock_offsets or {}
        rows: list[tuple[str, str, float, dict]] = []
        dropped_by_node: dict[str, int] = {}
        for ex in exports:
            base_node = ex.get("node") or "node"
            wall = float(ex.get("wall_offset", 0.0))
            if ex.get("dropped"):
                dropped_by_node[base_node] = (
                    dropped_by_node.get(base_node, 0) + int(ex["dropped"])
                )
            for s in ex.get("spans", ()):
                node = s.get("node") or base_node
                t_wall = (
                    float(s["t0"]) + wall - float(offsets.get(node, 0.0))
                )
                rows.append((node, s.get("lane", "lane"), t_wall, s))
        base = min((t for _, _, t, _ in rows), default=0.0)
        pids: dict[str, int] = {}
        tids: dict[tuple[str, str], int] = {}
        events: list[dict] = []
        for node, lane, t_wall, s in sorted(
            rows, key=lambda r: (r[0], r[1], r[2])
        ):
            pid = pids.setdefault(node, len(pids) + 1)
            tid = tids.setdefault((node, lane), len(tids) + 1)
            ev = {
                "name": s.get("name", "span"),
                "cat": s.get("cat", "serving"),
                "ph": "X",
                "ts": round((t_wall - base) * 1e6, 3),
                "dur": round(float(s.get("dur", 0.0)) * 1e6, 3),
                "pid": pid,
                "tid": tid,
            }
            args = dict(s.get("args") or {})
            if s.get("trace_id"):
                args["trace_id"] = s["trace_id"]
            if args:
                ev["args"] = args
            events.append(ev)
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "args": {"name": node},
            }
            for node, pid in pids.items()
        ] + [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pids[node],
                "tid": tid,
                "args": {"name": lane},
            }
            for (node, lane), tid in tids.items()
        ]
        return {
            "displayTimeUnit": "ms",
            "traceEvents": meta + events,
            "otherData": {
                "stitched": True,
                "nodes": sorted(pids),
                "clock_offsets": {k: round(v, 6) for k, v in offsets.items()},
                # Coverage: spans each contributing node evicted before
                # exporting. A reader of the stitched doc knows exactly
                # which nodes' timelines may have holes.
                "dropped": dropped_by_node,
                "dropped_total": sum(dropped_by_node.values()),
            },
        }

    def stats(self) -> dict:
        """Programmatic recorder state for ``/debug/state``."""
        with self._lock:
            buffered = len(self._buf)
            holed = len(self._dropped_tids)
            drops_untracked = self.drops_untracked
        return {
            "capacity": self.capacity,
            "sample": self.sample,
            "enabled": self.enabled,
            "buffered_spans": buffered,
            "recorded_spans": self.recorded,
            "dropped_spans": self.dropped,
            # Traces that lost spans to the ring bound: the attributor
            # refuses waterfalls for these (obs/attribution.py).
            "holed_traces": holed,
            "drops_untracked": drops_untracked,
        }


_default = FlightRecorder()
_default_lock = threading.Lock()


def get_recorder() -> FlightRecorder:
    """Process-wide default recorder (disabled until configured)."""
    return _default


def set_recorder(rec: FlightRecorder) -> FlightRecorder:
    """Swap the process-wide default (tests use this for isolation)."""
    global _default
    with _default_lock:
        _default = rec
    return rec


def configure(
    capacity: int = 8192, sample: float = 1.0, node: str = ""
) -> FlightRecorder:
    """Enable tracing process-wide: install a fresh recorder with the
    given bound + sampling rate (``launch.py --trace-capacity/-sample``).
    ``node`` labels this process's spans for the cross-node stitcher."""
    # Materialize the trace-loss series at 0 from process start
    # (dashboards never see gaps — the eviction_counters convention).
    dropped_spans_counter().labels(node=node or "node")
    return set_recorder(
        FlightRecorder(capacity=capacity, sample=sample, node=node)
    )


def stitch_traces(
    exports: list[dict], clock_offsets: dict[str, float] | None = None
) -> dict:
    """Module-level alias of :meth:`FlightRecorder.merge` (collectors
    import the function without touching a recorder instance)."""
    return FlightRecorder.merge(exports, clock_offsets)


def write_trace(path: str, drain: bool = True) -> int:
    """Dump the default recorder as a Chrome trace-event artifact.
    Returns the number of spans written."""
    rec = get_recorder()
    spans = rec.drain() if drain else rec.snapshot()
    obj = rec.chrome_trace(spans=spans)
    with open(path, "w") as fh:
        json.dump(obj, fh)
    return len(spans)
