"""Critical-path latency attribution: span DAG → exclusive phase times
(this package's copy of the JAX package's ``obs/attribution.py``).

Every traced request's flight lands as spans in the
:class:`~radixmesh_tpu_torch.obs.trace_plane.FlightRecorder`; this module
reads them per request:

- :func:`waterfall_from_spans` decomposes one request's end-to-end
  window into **exclusive** per-phase times that sum to e2e *exactly*
  (up to float addition): every instant of the window is attributed to
  the most-specific phase active at that instant (the critical-path
  rule: a decode chunk that overlaps its admission envelope is decode,
  not queueing), and instants no span covers land in the residual
  ``edge`` phase instead of vanishing. The phase taxonomy maps the
  span vocabulary the planes already record (SLO queue → admission →
  restore park → prefill waves → decode chunks → publish →
  replication/resurrection edges), so no call site changed to feed it.
- A :class:`PhaseAttributor` rides the recorder's span-retire hook:
  when a request's terminal span lands (``request_done`` from the
  engine's FINISHED funnel, or the frontend's ``http_request``
  envelope), the trace's buffered spans are decomposed and fed into
  ``radixmesh_request_phase_seconds{phase}`` histograms plus a bounded
  recent-waterfall ring and per-shape aggregates. Sampling off records
  no spans, so the whole plane costs one branch; sampling on costs one
  O(trace spans) sweep per retired request.
- **No waterfalls from holed traces**: a trace that lost spans to the
  recorder's drop-oldest bound (``FlightRecorder.trace_has_drops``)
  is refused (a decomposition with interior gaps would silently
  misattribute the missing intervals to ``edge``) and the refusal is
  counted (``radixmesh_trace_waterfall_refusals_total``).
- ``GET /debug/waterfall`` serves :meth:`PhaseAttributor.report`: the
  p50/p99 phase breakdown, the per-shape table, and the recent
  per-request waterfalls.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field

from radixmesh_tpu_torch.obs.metrics import PHASE_SECONDS_BUCKETS, get_registry
from radixmesh_tpu_torch.obs.trace_plane import FlightRecorder, Span, get_recorder

__all__ = [
    "PHASES",
    "PHASE_OF_SPAN",
    "RESIDUAL_PHASE",
    "RETIRE_SPANS",
    "shape_bucket",
    "Waterfall",
    "waterfall_from_spans",
    "PhaseAttributor",
    "ensure_attributor",
]

# The residual phase: window instants no recorded span covers — frontend
# envelope, scheduler gaps between launches, response serialization.
# Present by construction so the decomposition SUMS to e2e instead of
# silently shrinking when instrumentation has gaps.
RESIDUAL_PHASE = "edge"

# Exclusive-attribution priority, most specific LAST-STAGE work first:
# when two phases' spans cover the same instant, the earlier entry wins.
# Compute phases (decode/prefill) beat the movement phase (restore
# park), which beats bookkeeping (publish) and mesh edges, which beat
# the queue envelopes that *contain* all of them — and of the two
# envelopes, slo_queue (the WFQ leg) beats admission (submit→row-
# secured, which CONTAINS the WFQ leg): the inner envelope is the more
# specific story, the outer one keeps only what nothing narrower
# explains.
PHASE_PRIORITY = (
    "decode",
    "prefill",
    "restore_park",
    "publish",
    "replication",
    "resurrection",
    "slo_queue",
    "admission",
)
PHASES = PHASE_PRIORITY + (RESIDUAL_PHASE,)

# Span-name → phase vocabulary (the names the planes already record —
# tests/test_metrics_lint.py pins the span vocabulary; adding a phase
# means adding it HERE and to the priority order above).
PHASE_OF_SPAN = {
    "slo_queue": "slo_queue",
    "slo_shed": "slo_queue",
    "admission_wait": "admission",
    "prefix_match": "admission",
    "kv_restore": "restore_park",
    "prefill_wave": "prefill",
    "decode_chunk": "decode",
    "publish": "publish",
    "mesh_publish": "replication",
    "replication_lag": "replication",
    "resurrect": "resurrection",
    "hedge": "resurrection",
}

# Terminal spans that retire a request's trace: the engine's FINISHED
# funnel records ``request_done`` (every finish path — stop token,
# cancel, shed, deadline — flows through Request.state=FINISHED), and
# the HTTP frontends record the wider ``http_request`` envelope after
# the response flushed. Histograms feed at the FIRST retire (the engine
# window, so phase sums are clock-consistent); a later envelope retire
# only widens the stored waterfall's residual edge.
RETIRE_SPANS = frozenset({"request_done", "http_request"})


def shape_bucket(prompt_tokens: int, floor: int = 32) -> str:
    """Pow2 prompt-length bucket label ("p128" = 65..128 tokens): the
    request-class key the per-shape aggregates and the engine's
    speculative counters share —
    one function so the buckets cannot drift between planes."""
    n = max(1, int(prompt_tokens))
    b = floor
    while b < n and b < 1 << 20:
        b <<= 1
    return f"p{b}"


@dataclass
class Waterfall:
    """One request's exclusive phase decomposition."""

    trace_id: int
    t0: float  # window start (monotonic, the retire span's t0)
    e2e_s: float  # window length == sum(phases.values()) up to float
    phases: dict[str, float]  # phase → exclusive seconds (all PHASES)
    retire: str  # which terminal span closed the window
    node: str = ""
    shape: str = ""  # prompt-length bucket ("" = unknown)
    prompt_tokens: int = 0
    output_tokens: int = 0
    span_count: int = 0
    args: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "trace_id": f"{self.trace_id:#018x}",
            "e2e_s": round(self.e2e_s, 6),
            "phases": {p: round(v, 6) for p, v in self.phases.items()},
            "retire": self.retire,
            "node": self.node,
            "shape": self.shape,
            "prompt_tokens": self.prompt_tokens,
            "output_tokens": self.output_tokens,
            "span_count": self.span_count,
        }


def waterfall_from_spans(spans: list[Span], retire: Span) -> Waterfall:
    """Decompose the retire span's window into exclusive phase times.

    The sweep: clip every phase-mapped span to the window, collect the
    interval endpoints, and attribute each elementary segment between
    consecutive endpoints to the highest-priority phase covering its
    midpoint (none → :data:`RESIDUAL_PHASE`). Exclusive by construction:
    each segment lands in exactly one phase, so the phase times sum to
    the window length, the property the attribution tests prove over
    seeded traces."""
    lo = retire.t0
    hi = retire.t0 + max(0.0, retire.dur)
    prio = {p: i for i, p in enumerate(PHASE_PRIORITY)}
    ivals: list[tuple[float, float, int]] = []  # (start, end, priority)
    prompt_tokens = 0
    for s in spans:
        phase = PHASE_OF_SPAN.get(s.name)
        if s.name == "prefix_match" and s.args:
            prompt_tokens = int(s.args.get("prompt_tokens", 0)) or prompt_tokens
        if phase is None or s.name in RETIRE_SPANS:
            continue
        a, b = max(s.t0, lo), min(s.t0 + max(0.0, s.dur), hi)
        if b > a:
            ivals.append((a, b, prio[phase]))
    phases = {p: 0.0 for p in PHASES}
    # One sorted event sweep, not an all-intervals scan per segment:
    # this runs at retire time ON the engine scheduler thread, and a
    # long generation's trace holds thousands of decode_chunk/publish
    # spans — O(N²) midpoint scanning would stall scheduling for
    # milliseconds per retire. With only len(PHASE_PRIORITY) phases, an
    # active count per priority answers "most specific phase covering
    # this segment" in O(1); an interval [ia, ib) covers the elementary
    # segment [a, b) exactly when ia ≤ a and ib > a, the same membership
    # the midpoint test gives on elementary segments.
    npri = len(PHASE_PRIORITY)
    events: dict[float, list[int]] = {lo: [0] * npri, hi: [0] * npri}
    for ia, ib, pr in ivals:
        events.setdefault(ia, [0] * npri)[pr] += 1
        events.setdefault(ib, [0] * npri)[pr] -= 1
    active = [0] * npri
    points = sorted(events)
    for a, b in zip(points, points[1:]):
        for pr, d in enumerate(events[a]):
            active[pr] += d
        best = next((pr for pr in range(npri) if active[pr] > 0), None)
        phase = RESIDUAL_PHASE if best is None else PHASE_PRIORITY[best]
        phases[phase] += b - a
    args = dict(retire.args or {})
    prompt_tokens = int(args.get("prompt_tokens", prompt_tokens) or 0)
    return Waterfall(
        trace_id=retire.trace_id,
        t0=lo,
        e2e_s=hi - lo,
        phases=phases,
        retire=retire.name,
        node=retire.node,
        shape=shape_bucket(prompt_tokens) if prompt_tokens else "",
        prompt_tokens=prompt_tokens,
        output_tokens=int(args.get("output_tokens", 0) or 0),
        span_count=len(spans),
        args=args,
    )


class PhaseAttributor:
    """Retire-time aggregator: waterfalls → histograms + shape table.

    One instance per recorder (``ensure_attributor`` installs it on the
    retire hook). All state behind one short lock — retires come from
    the engine thread and HTTP handler threads concurrently.
    """

    FED_CAP = 4096  # trace ids remembered as histogram-fed (bounded)

    def __init__(self, recent: int = 256):
        reg = get_registry()
        hist = reg.histogram(
            "radixmesh_request_phase_seconds",
            "exclusive critical-path phase time per retired request "
            "(phases sum to end-to-end; obs/attribution.py)",
            ("phase",),
            buckets=PHASE_SECONDS_BUCKETS,
        )
        # Eager children: every phase series exists at 0 from install.
        self._hist = {p: hist.labels(phase=p) for p in PHASES}
        self._m_refused = reg.counter(
            "radixmesh_trace_waterfall_refusals_total",
            "waterfalls refused because the trace lost spans to the "
            "recorder ring bound (a holed decomposition would "
            "misattribute the missing intervals)",
            ("node",),
        )
        self._lock = threading.Lock()
        self._recent: deque[Waterfall] = deque(maxlen=recent)
        self._fed: deque[int] = deque(maxlen=self.FED_CAP)
        self._fed_set: set[int] = set()
        # shape → {count, e2e_s, phase sums}
        self._by_shape: dict[str, dict] = {}
        self.audited = 0  # waterfalls fed to the histograms
        self.refused = 0  # holed-trace refusals
        self.max_sum_error_s = 0.0  # |sum(phases) - e2e| high-water

    # -- the retire hook ----------------------------------------------

    def install(self, rec: FlightRecorder) -> "PhaseAttributor":
        rec.retire_hook = self.on_retire
        rec.retire_spans = RETIRE_SPANS
        rec.attributor = self
        return self

    def on_retire(self, span: Span, rec: FlightRecorder) -> None:
        tid = span.trace_id
        if not tid:
            return
        if rec.trace_has_drops(tid):
            # No silent caps: the refusal is the datum — but one per
            # TRACE, not per retire (a served request retires twice:
            # request_done, then the http_request envelope), so mark the
            # tid processed in the same ring the fed path uses.
            with self._lock:
                if tid in self._fed_set:
                    return
                if len(self._fed) == self._fed.maxlen:
                    self._fed_set.discard(self._fed[0])
                self._fed.append(tid)
                self._fed_set.add(tid)
                self.refused += 1
            self._m_refused.labels(node=span.node or rec.node or "node").inc()
            return
        wf = waterfall_from_spans(rec.spans_for_trace(tid), span)
        with self._lock:
            if tid not in self._fed_set:
                if len(self._fed) == self._fed.maxlen:
                    self._fed_set.discard(self._fed[0])
                self._fed.append(tid)
                self._fed_set.add(tid)
                self._feed_locked(wf)
            # A later, wider retire (http_request after request_done)
            # REPLACES the stored waterfall — the ring shows the full
            # envelope — but never double-feeds the histograms.
            for i, prev in enumerate(self._recent):
                if prev.trace_id == tid:
                    self._recent[i] = wf
                    break
            else:
                self._recent.append(wf)

    def _feed_locked(self, wf: Waterfall) -> None:
        for phase, secs in wf.phases.items():
            self._hist[phase].observe(secs)
        self.audited += 1
        err = abs(sum(wf.phases.values()) - wf.e2e_s)
        if err > self.max_sum_error_s:
            self.max_sum_error_s = err
        key = wf.shape or "unknown"
        agg = self._by_shape.setdefault(
            key, {"count": 0, "e2e_s": 0.0,
                  "phases": {p: 0.0 for p in PHASES}},
        )
        agg["count"] += 1
        agg["e2e_s"] += wf.e2e_s
        for phase, secs in wf.phases.items():
            agg["phases"][phase] += secs

    # -- reads ---------------------------------------------------------

    def by_shape(self) -> dict[str, dict]:
        """Per-shape totals (count, summed e2e, summed phase seconds) —
        a convoy rule's input."""
        with self._lock:
            return {
                k: {
                    "count": v["count"],
                    "e2e_s": v["e2e_s"],
                    "phases": dict(v["phases"]),
                }
                for k, v in self._by_shape.items()
            }

    def phase_hist(self, phase: str):
        """One phase's histogram child (count/sum/quantile reads) —
        a restore-park rule's input; None for unknown phases."""
        return self._hist.get(phase)

    def phase_totals(self) -> dict[str, float]:
        """phase → summed exclusive seconds across audited requests."""
        return {p: h.sum for p, h in self._hist.items()}

    def stats(self) -> dict:
        with self._lock:
            return {
                "audited": self.audited,
                "refused": self.refused,
                "recent": len(self._recent),
                "max_sum_error_s": self.max_sum_error_s,
            }

    def report(self, recent: int = 32) -> dict:
        """The ``GET /debug/waterfall`` body: histogram-derived p50/p99
        per phase, per-shape mean breakdown, recent waterfalls."""
        with self._lock:
            recents = [wf.as_dict() for wf in list(self._recent)[-recent:]]
            shapes = {
                k: {
                    "count": v["count"],
                    "mean_e2e_s": round(v["e2e_s"] / max(1, v["count"]), 6),
                    "phase_share": {
                        p: round(s / v["e2e_s"], 4) if v["e2e_s"] > 0 else 0.0
                        for p, s in v["phases"].items()
                    },
                }
                for k, v in self._by_shape.items()
            }
            audited, refused = self.audited, self.refused
            max_err = self.max_sum_error_s
        return {
            "phases": {
                p: {
                    "count": h.count,
                    "p50_s": round(h.quantile(0.5), 6),
                    "p99_s": round(h.quantile(0.99), 6),
                    "sum_s": round(h.sum, 6),
                }
                for p, h in self._hist.items()
            },
            "by_shape": shapes,
            "recent": recents,
            "audited": audited,
            "refused": refused,
            "max_sum_error_s": max_err,
        }


def ensure_attributor(rec: FlightRecorder | None = None) -> PhaseAttributor:
    """The recorder's attributor, installing one if absent — the seam
    the frontend and the black box resolve through, so a test-swapped
    recorder transparently gets a fresh attributor (and fresh metric
    children in the current registry)."""
    rec = rec if rec is not None else get_recorder()
    attr = getattr(rec, "attributor", None)
    if attr is None:
        attr = PhaseAttributor().install(rec)
    return attr
