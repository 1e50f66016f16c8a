"""Prometheus-style metrics: counters, gauges, histograms + text exposition.

The port's own copy of the JAX package's ``obs/metrics.py`` (stdlib only;
the port imports nothing of the JAX package). It keeps its own
process-wide registry, separate from the JAX package's, and renders the
same exposition text for the same observations. The engine's series
(TTFT/TPOT, prompt/cached/generated tokens, speculation, preemptions and
evictions), the KV tiers' and the wave scheduler's register here, and the
serving frontend serves :meth:`Registry.render` on ``GET /metrics``.

Design notes: metric families are registered once per (name, type); calling
a registry factory again returns the existing family, so modules can grab
their metrics at construction time without coordinating. Label sets
materialize child series on first use. All mutation is lock-guarded —
series are updated from the engine loop, the KV-movement plane's worker
and HTTP handler threads concurrently.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Iterable, Sequence

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "get_registry",
    "set_registry",
    "DEFAULT_BUCKETS",
    "TOKEN_LEN_BUCKETS",
    "TRANSFER_SECONDS_BUCKETS",
    "REPAIR_SECONDS_BUCKETS",
    "RECOVERY_SECONDS_BUCKETS",
    "PHASE_SECONDS_BUCKETS",
]

# Latency-oriented default buckets (seconds): 1ms .. 60s.
DEFAULT_BUCKETS: tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

# KV-movement buckets (seconds): the async transfer plane's per-op
# blocking costs (arena memcopies, staged chunk reads, handoff packs —
# cache/kv_transfer.py) live in the 10µs–10ms band, below
# DEFAULT_BUCKETS' 1ms floor; a histogram on those buckets would read
# as all-zeros. Shared so every kv_transfer lane bins identically.
TRANSFER_SECONDS_BUCKETS: tuple[float, ...] = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 0.001,
    0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.5, 2.0,
)

# Token-count buckets (powers of two through 32k tokens, the longest
# configured context) — shared by every hit-length/match-length
# histogram so dashboards can compare them bucket-for-bucket.
TOKEN_LEN_BUCKETS: tuple[float, ...] = tuple(float(1 << i) for i in range(16))

# Anti-entropy repair buckets (seconds): a repair round spans probe →
# summary exchange → ring re-publication, so its latency rides the ring
# (ms on inproc/loopback) plus the peer's backoff schedule (seconds to
# a minute) — a wider band than DEFAULT_BUCKETS resolves at the top end
# and than TRANSFER_SECONDS_BUCKETS covers at all. Shared by
# cache/repair_plane.py so every node bins rounds identically.
REPAIR_SECONDS_BUCKETS: tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

# Request-recovery buckets (seconds): a recovery episode spans hop
# timeout (tens of ms to seconds) + jittered backoff + re-route +
# re-prefill — the death-to-first-resumed-token blip the recovery plane
# (server/recovery.py) exists to keep small. Shared so every edge bins
# resurrection latency identically.
RECOVERY_SECONDS_BUCKETS: tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.0, 5.0, 10.0, 30.0, 60.0,
)

# Critical-path phase buckets (seconds): one request's end-to-end time
# decomposes into EXCLUSIVE per-phase slices (obs/attribution.py), and
# those slices span five orders of magnitude — a publish is tens of µs,
# a convoyed prefill wait is seconds, an SLO queue stall under overload
# is tens of seconds. DEFAULT_BUCKETS' 1 ms floor would flatten the fast
# phases to zeros and TRANSFER_SECONDS_BUCKETS tops out at 2 s, below a
# convoy. Shared by every phase of radixmesh_request_phase_seconds so
# p50/p99 phase breakdowns compare bucket-for-bucket.
PHASE_SECONDS_BUCKETS: tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _label_key(labels: dict[str, str]) -> tuple[tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _escape(v: str) -> str:
    """Label-value escaping per the Prometheus exposition spec — an
    unescaped quote/backslash/newline would make the whole scrape
    unparseable, not just this series."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class _Family:
    """One named metric family; holds labeled child series."""

    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children: dict[tuple[tuple[str, str], ...], "_Family"] = {}
        self._labels: tuple[tuple[str, str], ...] = ()

    def labels(self, **labels: str):
        """Child series for a concrete label assignment."""
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got {tuple(labels)}"
            )
        key = _label_key({k: str(v) for k, v in labels.items()})
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                child._labels = key
                self._children[key] = child
            return child

    def _new_child(self) -> "_Family":
        return type(self)(self.name, self.help)

    def _series(self) -> Iterable["_Family"]:
        if self.label_names:
            with self._lock:
                return list(self._children.values())
        return [self]

    # subclasses: _render_lines(self) and snapshot value accessors


class Counter(_Family):
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", label_names: Sequence[str] = ()):
        super().__init__(name, help, label_names)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _render_lines(self) -> list[str]:
        return [
            f"{self.name}{_fmt_labels(s._labels)} {_fmt_value(s._value)}"
            for s in self._series()
        ]


class Gauge(_Family):
    """Value that can go up and down."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "", label_names: Sequence[str] = ()):
        super().__init__(name, help, label_names)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _render_lines(self) -> list[str]:
        return [
            f"{self.name}{_fmt_labels(s._labels)} {_fmt_value(s._value)}"
            for s in self._series()
        ]


class _HistTimer:
    def __init__(self, hist: "Histogram"):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.monotonic() - self._t0)
        return False


class Histogram(_Family):
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations ≤ its upper bound; ``+Inf`` bucket == count)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        label_names: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        # Trace exemplars: bucket index -> (trace_id, value, wall time),
        # the LAST traced observation to land in that bucket. Lazily
        # allocated — an untraced histogram never pays the dict.
        self._exemplars: dict[int, tuple[int, float, float]] | None = None

    def _new_child(self) -> "Histogram":
        return Histogram(self.name, self.help, buckets=self.buckets)

    def observe(self, value: float, trace_id: int | None = None) -> None:
        # bisect_left finds the first bound >= value — the bucket whose
        # "<= upper bound" predicate the value satisfies; past the last
        # bound it lands on the +Inf slot. O(log buckets) instead of the
        # linear scan: observe() sits on per-token serving hot paths
        # (TPOT, oplog lag) where the common sample lands in the upper
        # buckets the scan visited last.
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self._sum += value
            self._counts[i if i < len(self.buckets) else -1] += 1
            # One `is not None` test when tracing is off (the step-
            # accounting hot-path contract); a traced observation pins
            # itself as the bucket's exemplar so a percentile that
            # resolves into this bucket links to a concrete request
            # flight (obs/trace_plane.py stitching).
            if trace_id is not None:
                if self._exemplars is None:
                    self._exemplars = {}
                self._exemplars[min(i, len(self.buckets))] = (
                    int(trace_id), float(value), time.time()
                )

    def time(self) -> _HistTimer:
        """``with hist.time(): ...`` observes the block's wall time."""
        return _HistTimer(self)

    def _le_str(self, i: int) -> str:
        return (
            _fmt_value(self.buckets[i]) if i < len(self.buckets) else "+Inf"
        )

    def exemplars(self) -> dict[str, dict]:
        """Per-bucket trace exemplars of THIS series: ``le`` string →
        ``{trace_id, value, wall_time}`` with the trace id rendered the
        way span exports carry it (``trace_plane.export_spans``), so a
        reader can join straight into a stitched trace. {} when no
        traced observation ever landed."""
        with self._lock:
            ex = dict(self._exemplars) if self._exemplars else {}
        return {
            self._le_str(i): {
                "trace_id": f"{tid:#018x}",
                "value": v,
                "wall_time": round(t, 6),
            }
            for i, (tid, v, t) in sorted(ex.items())
        }

    def bucket_counts(self) -> list[int]:
        """Cumulative per-bucket counts (Prometheus ``le`` semantics:
        entry i counts observations <= buckets[i]; the final entry is
        +Inf == count), read under one lock so the vector is a
        consistent snapshot — the cross-node merge sums these."""
        with self._lock:
            out = []
            cum = 0
            for c in self._counts:
                cum += c
                out.append(cum)
            return out

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Approximate quantile with linear interpolation inside the
        selected bucket (Prometheus ``histogram_quantile`` semantics).
        Returning the bucket's upper bound snapped every estimate to a
        bucket edge — a 1.1 ms median read as 2.5 ms — wherever a
        histogram-derived quantile surfaces (``/debug/state`` latency
        estimates; bench/workload medians come from raw samples and were
        never affected). Still approximate (uniform-within-bucket
        assumption); exact values need the raw samples."""
        with self._lock:
            total = sum(self._counts)
            if total == 0:
                return 0.0
            target = q * total
            acc = 0
            for i, ub in enumerate(self.buckets):
                in_bucket = self._counts[i]
                if acc + in_bucket >= target and in_bucket > 0:
                    # Lower edge: the previous bound, or 0 for the first
                    # bucket of a positive-bounded histogram (latencies/
                    # token counts — every histogram in this repo).
                    lo = self.buckets[i - 1] if i > 0 else min(0.0, ub)
                    return lo + (ub - lo) * (target - acc) / in_bucket
                acc += in_bucket
            # Target falls in the +Inf bucket: no finite upper edge to
            # interpolate toward — report the largest finite bound
            # (what PromQL does) rather than inf.
            return self.buckets[-1] if self.buckets else float("inf")

    def _render_lines(self) -> list[str]:
        lines: list[str] = []
        for s in self._series():
            with s._lock:
                ex = dict(s._exemplars) if s._exemplars else {}
                cum = 0
                for i, ub in enumerate(s.buckets):
                    cum += s._counts[i]
                    lbl = dict(s._labels)
                    lbl["le"] = _fmt_value(ub)
                    lines.append(
                        f"{self.name}_bucket{_fmt_labels(_label_key(lbl))} {cum}"
                    )
                    if i in ex:
                        tid, v, t = ex[i]
                        lines.append(
                            f"# EXEMPLAR {self.name}_bucket"
                            f"{_fmt_labels(_label_key(lbl))} "
                            f"trace_id={tid:#018x} value={_fmt_value(v)} "
                            f"wall_time={t:.6f}"
                        )
                cum += s._counts[-1]
                lbl = dict(s._labels)
                lbl["le"] = "+Inf"
                lines.append(f"{self.name}_bucket{_fmt_labels(_label_key(lbl))} {cum}")
                inf_key = len(s.buckets)
                if inf_key in ex:
                    tid, v, t = ex[inf_key]
                    lines.append(
                        f"# EXEMPLAR {self.name}_bucket"
                        f"{_fmt_labels(_label_key(lbl))} "
                        f"trace_id={tid:#018x} value={_fmt_value(v)} "
                        f"wall_time={t:.6f}"
                    )
                lines.append(f"{self.name}_sum{_fmt_labels(s._labels)} {_fmt_value(s._sum)}")
                lines.append(f"{self.name}_count{_fmt_labels(s._labels)} {cum}")
        return lines


class Registry:
    """Named metric families; idempotent registration."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _get_or_create(self, cls, name: str, help: str, label_names, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind}"
                    )
                # A silent mismatch here would corrupt telemetry far from
                # the bad registration — fail at registration time instead.
                if tuple(label_names) != fam.label_names:
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{fam.label_names}, not {tuple(label_names)}"
                    )
                buckets = kw.get("buckets")
                if buckets is not None and tuple(sorted(buckets)) != fam.buckets:
                    raise ValueError(
                        f"histogram {name!r} already registered with buckets "
                        f"{fam.buckets}"
                    )
                return fam
            fam = cls(name, help, label_names, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", label_names: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, label_names)

    def gauge(self, name: str, help: str = "", label_names: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, label_names)

    def histogram(
        self,
        name: str,
        help: str = "",
        label_names: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, label_names, buckets=buckets)

    def render(self) -> str:
        """Prometheus text exposition format."""
        out: list[str] = []
        with self._lock:
            families = sorted(self._families.values(), key=lambda f: f.name)
        for f in families:
            if f.help:
                out.append(f"# HELP {f.name} {f.help}")
            out.append(f"# TYPE {f.name} {f.kind}")
            out.extend(f._render_lines())
        return "\n".join(out) + "\n"

    def snapshot(
        self, bucket_families: Sequence[str] = ()
    ) -> dict[str, float]:
        """Flat programmatic view: scalar series by rendered name.

        Histograms flatten to ``_count``/``_sum`` scalars; families
        named in ``bucket_families`` ADDITIONALLY emit their cumulative
        per-bucket counts as ``name_bucket{...,le="x"}`` series — the
        transport for cross-node percentile merging (a fleet collector
        sums bucket counts across nodes; averaging per-node quantiles
        is statistically wrong). Opt-in per family on purpose: buckets
        multiply series count ~16x, and only families a fleet view
        merges (the per-tenant request-latency histograms) earn that."""
        bucket_families = set(bucket_families)
        snap: dict[str, float] = {}
        with self._lock:
            families = list(self._families.values())
        for f in families:
            for s in f._series():
                # Rendered key cached per series: labels are fixed at
                # child creation, and the history sampler calls this for
                # every series at every tick — re-formatting hundreds of
                # label strings per sweep was the sampler's top cost.
                key = getattr(s, "_snap_key", None)
                if key is None:
                    key = s._snap_key = f"{f.name}{_fmt_labels(s._labels)}"
                if isinstance(s, Histogram):
                    snap[key + "_count"] = s.count
                    snap[key + "_sum"] = s.sum
                    if f.name in bucket_families:
                        for i, cum in enumerate(s.bucket_counts()):
                            lbl = dict(s._labels)
                            lbl["le"] = s._le_str(i)
                            snap[
                                f"{f.name}_bucket"
                                f"{_fmt_labels(_label_key(lbl))}"
                            ] = float(cum)
                else:
                    snap[key] = s.value
        return snap

    def exemplars(self) -> dict[str, dict[str, dict]]:
        """Every histogram series' trace exemplars, keyed the way
        :meth:`snapshot` keys series (``family{labels}``): the
        ``/debug/state`` exemplar section and the in-proc source a
        fleet collector joins against merged bucket counts. Series
        with no traced observations are omitted."""
        out: dict[str, dict[str, dict]] = {}
        with self._lock:
            families = list(self._families.values())
        for f in families:
            if not isinstance(f, Histogram):
                continue
            for s in f._series():
                ex = s.exemplars()
                if ex:
                    out[f"{f.name}{_fmt_labels(s._labels)}"] = ex
        return out


_default = Registry()
_default_lock = threading.Lock()


def get_registry() -> Registry:
    """Process-wide default registry."""
    return _default


def set_registry(reg: Registry) -> Registry:
    """Swap the process-wide default (tests use this for isolation)."""
    global _default
    with _default_lock:
        _default = reg
    return reg
