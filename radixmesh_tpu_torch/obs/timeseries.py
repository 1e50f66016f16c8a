"""In-process telemetry history: bounded time-series rings over every plane
(this package's copy of the JAX package's ``obs/timeseries.py``).

``/metrics`` is the counter value now and ``/debug/state`` the planes now;
when a serving process dies every gauge it held dies with it. This module
is the history axis:

- A :class:`TelemetryHistory` samples, at a fixed cadence (default 1 s),
  **every registered metric family** (one ``Registry.snapshot()``: the
  same flat series a scraper sees) plus the derived planes a scrape
  cannot reach: the engine's step accounting (MFU, pad fraction), its
  goodput ledger, the SLO controller's per-tenant burn counters, and,
  through the ``mesh`` seam (a node's cache-mesh replica), fleet health
  and shard heat.
- Storage is **fixed-capacity, change-compressed rings**: one global
  sample sequence, one bounded deque of ``(seq, t, value)`` points per
  series appended ONLY when the value changed since its last point, so
  ~15 min of 1 s samples over hundreds of series stays in low
  single-digit MB. Series that vanish from the snapshot for a full
  window are pruned; series past the ``max_series`` cap are dropped and
  counted, never silently.
- ``GET /debug/timeseries?family=&since=&limit=`` serves the rings with
  **cursor pagination**: ``since`` is a sample sequence number, the
  response carries ``next_since`` + ``has_more``, and the limit cut
  lands on a sequence boundary so a paginating client never sees half a
  sample.
- **Self-accounting**: the sampler registers ``radixmesh_history_*``
  families for its own sample count / cost / ring size, so the
  history's overhead is itself visible in the history.
- Burn-rate sinks bound with :meth:`bind_burn_tracker` get the SLO burn
  counters at every sample.
- The black box (``obs/blackbox.py``) rides the ``on_sample`` hook to
  write crash-surviving incremental segments of these rings.

Every read a sample makes is a host value: registry families, the step
plane's and the goodput ledger's Python counters, the controller's
counts. None reads a CUDA tensor, so the sampler thread never
synchronizes the card in the middle of an engine step. The clock is
injectable (virtual-time tests drive :meth:`sample` directly without
starting the thread).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time

from radixmesh_tpu_torch.obs.metrics import (
    TRANSFER_SECONDS_BUCKETS,
    get_registry,
)
from radixmesh_tpu_torch.utils.logging import get_logger, throttled

__all__ = ["TelemetryHistory", "DERIVED_PREFIXES", "BUCKET_FAMILIES"]

# Derived-source series namespaces (everything else in the rings is a
# registry family). Kept distinct from the ``radixmesh_`` scrape
# namespace on purpose: these are *readings of other planes' reports*
# (fleet fold, heat map, step accounting, SLO counters), not registered
# families — a collision would double-count a real series.
DERIVED_PREFIXES = ("fleet:", "shard:", "step:", "slo:", "goodput:")

# Histogram families sampled WITH their cumulative per-bucket counts
# (``Registry.snapshot(bucket_families=...)``): the per-tenant request
# latency distributions a fleet collector merges
# bucket-by-bucket across nodes for true fleet percentiles. Opt-in and
# short on purpose — buckets multiply a family's series count ~16x, and
# change-compression only keeps that cheap for families whose buckets
# move at request cadence, not token cadence.
BUCKET_FAMILIES = (
    "radixmesh_request_ttft_seconds",
    "radixmesh_request_e2e_seconds",
    # Per-tenant inter-token latency (obs/token_timeline.py): token-
    # cadence observations, but the RING only pays per bucket-count
    # CHANGE per sample tick — steady decode moves one or two buckets
    # per second, the same cost profile as the request families under
    # load. Fleet ITL percentiles merge these in obs/aggregator.py.
    "radixmesh_token_itl_seconds",
)


class _Series:
    """One change-compressed ring: ``points`` holds (seq, t, value)
    appended only on value change; ``last_seen_seq`` tracks liveness
    (a series absent from the snapshot for a full window is pruned)."""

    __slots__ = ("points", "last_value", "last_seen_seq")

    def __init__(self, capacity: int):
        from collections import deque

        self.points: "deque[tuple[int, float, float]]" = deque(
            maxlen=capacity
        )
        self.last_value: float | None = None
        self.last_seen_seq = -1


class TelemetryHistory:
    """The sampler + rings. Every input is an optional duck-typed seam
    (the JAX package's doctor convention):

    - ``mesh``: a MeshCache — fleet health scores / ages / lags, shard
      heat + skew.
    - ``engine``: an Engine — step-plane MFU / pad fraction (when step
      accounting is on).
    - ``slo``: an OverloadController — per-tenant admitted/shed burn
      counters (also forwarded to bound burn trackers).

    Construct one per frontend; :meth:`start` runs the sampler thread,
    or call :meth:`sample` directly (tests, virtual time)."""

    def __init__(
        self,
        interval_s: float = 1.0,
        capacity: int = 900,
        mesh=None,
        engine=None,
        slo=None,
        node: str = "",
        max_series: int = 4096,
        registry=None,
        now=time.monotonic,
        bucket_families: tuple = BUCKET_FAMILIES,
    ):
        if capacity <= 0:
            raise ValueError("history capacity must be positive")
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self.mesh = mesh
        self.engine = engine
        self.slo = slo
        self.node = node
        self.max_series = int(max_series)
        self.bucket_families = tuple(bucket_families)
        self._registry = registry
        self._now = now
        # Monotonic→wall conversion for post-mortem readers (the
        # FlightRecorder convention): dumps carry it so crash windows
        # can be reported in operator time.
        self.wall_offset = time.time() - time.monotonic()
        self.log = get_logger("obs.timeseries")
        self._lock = threading.Lock()
        self._series: dict[str, _Series] = {}
        self._seq = -1  # last completed sample sequence
        self._last_sample_t = 0.0
        self._dropped_series = 0
        # Names already counted as refused — the counter means "series
        # dropped", not "sample-writes refused", so a capped series
        # must not re-count on every subsequent tick.
        self._refused: set[str] = set()
        self._sample_seconds_total = 0.0  # this instance's own cost
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Post-sample hook (obs/blackbox.py installs its segment
        # writer): called with the completed sample's seq OUTSIDE the
        # ring lock, on the sampler thread.
        self.on_sample = None
        # Burn-rate sinks: every sample forwards the SLO burn counters
        # here, so a burn tracker's windows are dense regardless of how
        # often anyone reads it.
        self._burn_sinks: list = []

        reg = registry if registry is not None else get_registry()
        self._m_samples = reg.counter(
            "radixmesh_history_samples_total",
            "telemetry-history samples taken (obs/timeseries.py)",
        )
        self._m_sample_seconds = reg.histogram(
            "radixmesh_history_sample_seconds",
            "wall cost of one telemetry-history sample sweep — the "
            "sampler's own overhead, self-accounted so the history's "
            "cost is visible in the history",
            buckets=TRANSFER_SECONDS_BUCKETS,
        )
        self._m_series = reg.gauge(
            "radixmesh_history_series",
            "live series rings held by the telemetry history",
        )
        self._m_points = reg.gauge(
            "radixmesh_history_points",
            "total retained points across all telemetry-history rings",
        )
        self._m_dropped = reg.counter(
            "radixmesh_history_dropped_series_total",
            "series refused because the history hit its max_series cap "
            "(no silent caps: a missing ring is a counted drop)",
        )

    # -- wiring --------------------------------------------------------

    def bind_burn_tracker(self, tracker) -> None:
        """Feed ``tracker.sample(burn_counts, t)`` at every history
        sample (a burn-rate tracker binds here so its windows never
        depend on GET cadence)."""
        with self._lock:
            if tracker not in self._burn_sinks:
                self._burn_sinks.append(tracker)

    # -- the sample sweep ----------------------------------------------

    def sample(self, t: float | None = None) -> int:
        """Take one snapshot of every source into the rings; returns
        the completed sample's sequence number. Thread-safe (the
        sampler thread and a test driving virtual time may interleave;
        folds are serialized by the ring lock)."""
        t0 = time.monotonic()
        t = self._now() if t is None else float(t)
        snap: dict[str, float] = {}
        reg = self._registry if self._registry is not None else get_registry()
        snap.update(reg.snapshot(bucket_families=self.bucket_families))
        self._derived_snapshot(snap)
        burn_counts = None
        if self.slo is not None:
            try:
                burn_counts = self.slo.burn_counts()
            except Exception:  # noqa: BLE001 — a seam bug must not kill sampling
                burn_counts = None
            if burn_counts:
                for tenant, c in burn_counts.items():
                    snap[f'slo:admitted{{tenant="{tenant}"}}'] = float(
                        c.get("admitted", 0)
                    )
                    snap[f'slo:shed{{tenant="{tenant}"}}'] = float(
                        c.get("shed", 0)
                    )
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._last_sample_t = t
            dropped = 0
            for name, value in snap.items():
                s = self._series.get(name)
                if s is None:
                    if len(self._series) >= self.max_series:
                        if name not in self._refused:
                            self._refused.add(name)
                            dropped += 1
                        continue
                    self._refused.discard(name)
                    s = self._series[name] = _Series(self.capacity)
                s.last_seen_seq = seq
                if s.last_value is None or value != s.last_value:
                    s.points.append((seq, t, float(value)))
                    s.last_value = float(value)
            self._dropped_series += dropped
            # Prune series that vanished from the snapshot for a full
            # window (label churn must not grow the dict unboundedly).
            if seq % self.capacity == 0 and seq > 0:
                stale = [
                    n for n, s in self._series.items()
                    if s.last_seen_seq < seq - self.capacity
                ]
                for n in stale:
                    del self._series[n]
                # The refused ledger is bounded the same way: a name
                # still refused a full window later counts again.
                self._refused.clear()
            n_series = len(self._series)
            n_points = sum(len(s.points) for s in self._series.values())
            burn_sinks = list(self._burn_sinks)
        # Self-accounting + hooks outside the ring lock: metric family
        # locks and the black box's file IO must never nest inside it.
        if burn_counts:
            for sink in burn_sinks:
                sink.sample(burn_counts, t=t)
        cost = time.monotonic() - t0
        with self._lock:
            self._sample_seconds_total += cost
        self._m_samples.inc()
        self._m_sample_seconds.observe(cost)
        self._m_series.set(n_series)
        self._m_points.set(n_points)
        if dropped:
            self._m_dropped.inc(dropped)
        hook = self.on_sample
        if hook is not None:
            hook(seq)
        return seq

    def _derived_snapshot(self, snap: dict[str, float]) -> None:
        """Fold the non-registry planes into the sample. Each seam is
        crash-isolated: a broken plane loses its series, never the
        sample."""
        mesh = self.mesh
        if mesh is not None:
            try:
                fleet = mesh.fleet
                health = fleet.health()
                snap["fleet:alive_nodes"] = float(len(health))
                for rank, h in health.items():
                    snap[f'fleet:health_score{{rank="{rank}"}}'] = float(
                        h["score"]
                    )
                    snap[f'fleet:health_age_seconds{{rank="{rank}"}}'] = (
                        float(h["age_s"])
                    )
                for rank, d in fleet.digests().items():
                    snap[
                        f'fleet:replication_lag_seconds{{rank="{rank}"}}'
                    ] = float(d.replication_lag_s)
                    snap[
                        f'fleet:decode_ewma_seconds{{rank="{rank}"}}'
                    ] = float(getattr(d, "decode_ewma_s", 0.0))
            except Exception:  # noqa: BLE001 — seam isolation
                pass
            try:
                if getattr(mesh, "sharded", False):
                    heat = mesh.fleet.shard_heat()
                    snap["shard:skew_ratio"] = float(heat["skew_score"])
                    snap["shard:reporters"] = float(heat["reporters"])
                    for sid, load in heat["shards"].items():
                        snap[f'shard:heat{{shard="{sid}"}}'] = float(load)
            except Exception:  # noqa: BLE001 — seam isolation
                pass
        eng = self.engine
        acct = getattr(eng, "step_acct", None) if eng is not None else None
        if acct is not None:
            try:
                rep = acct.report()
                for kind in ("prefill", "decode"):
                    k = rep.get(kind)
                    if isinstance(k, dict):
                        snap[f'step:mfu{{kind="{kind}"}}'] = float(k["mfu"])
                        snap[f'step:pad_fraction{{kind="{kind}"}}'] = float(
                            k["pad_fraction"]
                        )
                        snap[f'step:waves{{kind="{kind}"}}'] = float(
                            k["waves"]
                        )
            except Exception:  # noqa: BLE001 — seam isolation
                pass
        gp = getattr(eng, "goodput", None) if eng is not None else None
        if gp is not None:
            try:
                rep = gp.report(
                    step_acct=acct, spec=getattr(eng, "spec_ledger", None)
                )
                snap["goodput:tokens_per_second"] = float(
                    rep["tokens_per_second"]
                )
                for tenant, t in rep["tenants"].items():
                    snap[
                        f'goodput:tokens_per_second{{tenant="{tenant}"}}'
                    ] = float(t["tokens_per_second"])
                    snap[
                        f'goodput:stall_seconds{{tenant="{tenant}"}}'
                    ] = float(t["stall_seconds"])
                for kind, frac in rep["waste"].items():
                    snap[f'goodput:waste_fraction{{kind="{kind}"}}'] = (
                        float(frac)
                    )
            except Exception:  # noqa: BLE001 — seam isolation
                pass

    # -- fleet ingest ---------------------------------------------------

    def ingest(self, node: str, body: dict) -> int:
        """Fold one ``/debug/timeseries`` page from a peer into these
        rings, node-labeled — the fleet aggregator's write path. The
        fold is cursor-agnostic: the caller (obs/aggregator.py) owns
        ``since``/``next_since`` bookkeeping; this method just stores
        whatever page it is handed.

        Semantics that keep the store a valid :class:`TelemetryHistory`:

        - **One store sequence per call.** Peer sequence numbers from
          different nodes are incomparable, so every point of the page
          lands under a single local seq — deques stay seq-ordered and
          :meth:`query` pagination cuts stay on whole-ingest boundaries.
        - **Peer time is rebased to this store's clock** via the page's
          ``wall_offset`` (``t + peer_wall_offset - self.wall_offset``),
          so a peer restart (monotonic reset) cannot reorder its points.
        - **Node labels are injected**, never trusted from the wire:
          ``fam{k="v"}`` becomes ``fam{k="v",node="peer"}``, so two
          peers' identical series never collide in one ring.
        - A series with no points in the page but a live ``last`` value
          is seeded once (change-compression: "no point" means "did not
          change", and a merge still needs its current value).
        """
        peer_offset = float(body.get("wall_offset", self.wall_offset))
        shift = peer_offset - self.wall_offset
        series = body.get("series", {})
        t_now = self._now()
        with self._lock:
            self._seq += 1
            seq = self._seq
            dropped = 0
            for name, sdata in series.items():
                if name.endswith("}"):
                    labeled = name[:-1] + f',node="{node}"' + "}"
                else:
                    labeled = f'{name}{{node="{node}"}}'
                s = self._series.get(labeled)
                if s is None:
                    if len(self._series) >= self.max_series:
                        if labeled not in self._refused:
                            self._refused.add(labeled)
                            dropped += 1
                        continue
                    self._refused.discard(labeled)
                    s = self._series[labeled] = _Series(self.capacity)
                s.last_seen_seq = seq
                pts = sdata.get("points") or ()
                for p in pts:
                    s.points.append((seq, float(p[1]) + shift, float(p[2])))
                if pts:
                    s.last_value = float(pts[-1][2])
                elif s.last_value is None:
                    last = sdata.get("last") or (None, None)
                    if last[1] is not None:
                        s.points.append((seq, t_now, float(last[1])))
                        s.last_value = float(last[1])
            self._dropped_series += dropped
        if dropped:
            self._m_dropped.inc(dropped)
        return seq

    # -- reads ---------------------------------------------------------

    def query(
        self,
        family: str | None = None,
        since: int = -1,
        limit: int = 2000,
    ) -> dict:
        """The ``GET /debug/timeseries`` body: every series whose name
        starts with ``family`` (None/"" = all), points with
        ``seq > since``, at most ``limit`` points — cut on a SAMPLE
        boundary (all points of a sequence ship together, so a
        paginating client never reads half a sample). ``next_since``
        is the cursor for the next page; ``has_more`` says whether one
        exists. Change-compressed semantics: a series with no point in
        range did not change — ``last`` carries its current value."""
        since = int(since)
        limit = max(1, int(limit))
        with self._lock:
            seq = self._seq
            matched: dict[str, _Series] = {
                n: s
                for n, s in self._series.items()
                if not family or n.startswith(family)
            }
            # Decide whether the limit can bind BEFORE materializing:
            # the dump()/segment path asks with an unbounded limit
            # every few samples, and building + sorting every retained
            # seq under the ring lock would stall the sampler tick
            # (and the watchdog heartbeat behind it) for nothing. The
            # O(series) deque-length bound clears that path without
            # touching a point; a genuinely bounded query then counts
            # with an early exit at limit+1, never a second full scan.
            cutoff = seq
            has_more = False
            over_limit = False
            # Eligible points (seq > since) are a SUFFIX of each
            # seq-ordered deque, so every scan below walks reversed()
            # and stops at the first pre-cursor point — a paginating
            # client's already-consumed prefix is never re-touched
            # under the ring lock (the sampler tick, and the watchdog
            # heartbeat behind it, sit on this lock).
            if sum(len(s.points) for s in matched.values()) > limit:
                total = 0
                for s in matched.values():
                    if not s.points or s.points[-1][0] <= since:
                        continue
                    for p in reversed(s.points):
                        if p[0] <= since:
                            break
                        total += 1
                        if total > limit:
                            over_limit = True
                            break
                    if over_limit:
                        break
            if over_limit:
                # Bounded selection, not a full sort: the cut only
                # needs the limit-th smallest eligible seq (a heap of
                # size limit), and "anything past the cut" only needs
                # each series' newest point — so a paginating client
                # never makes the lock hold O(P log P).
                cutoff = heapq.nsmallest(
                    limit,
                    (
                        p[0]
                        for s in matched.values()
                        for p in itertools.takewhile(
                            lambda p: p[0] > since, reversed(s.points)
                        )
                    ),
                )[-1]
                newest = max(
                    s.points[-1][0]
                    for s in matched.values()
                    if s.points and s.points[-1][0] > since
                )
                has_more = cutoff < seq and newest > cutoff
            series_out: dict[str, dict] = {}
            n_points = 0
            for name, s in matched.items():
                pts = []
                for p in reversed(s.points):
                    if p[0] <= since:
                        break
                    if p[0] <= cutoff:
                        pts.append([p[0], round(p[1], 6), p[2]])
                pts.reverse()
                n_points += len(pts)
                series_out[name] = {
                    "points": pts,
                    "last": [s.last_seen_seq, s.last_value],
                }
        return {
            "node": self.node,
            "interval_s": self.interval_s,
            "capacity": self.capacity,
            "wall_offset": round(self.wall_offset, 6),
            "seq": seq,
            "since": since,
            "next_since": cutoff,
            "has_more": has_more,
            "series": series_out,
            "points": n_points,
        }

    def dump(self, since: int = -1) -> dict:
        """Everything retained past ``since`` (no pagination) — the
        black box's segment/flush input."""
        return self.query(family=None, since=since, limit=1 << 62)

    def stats(self) -> dict:
        with self._lock:
            return {
                "interval_s": self.interval_s,
                "capacity": self.capacity,
                "seq": self._seq,
                "series": len(self._series),
                "points": sum(
                    len(s.points) for s in self._series.values()
                ),
                "dropped_series": self._dropped_series,
                "last_sample_t": self._last_sample_t,
                # This instance's own cumulative sweep cost (the shared
                # radixmesh_history_sample_seconds histogram folds every
                # sampler in the process; the overhead gate needs THIS
                # one's).
                "sample_seconds_total": self._sample_seconds_total,
            }

    def last_sample_age_s(self, t: float | None = None) -> float:
        """Seconds since the last completed sample (inf before the
        first) — the black box watchdog's liveness signal."""
        t = self._now() if t is None else float(t)
        with self._lock:
            if self._seq < 0:
                return float("inf")
            return max(0.0, t - self._last_sample_t)

    # -- thread --------------------------------------------------------

    def start(self) -> "TelemetryHistory":
        if self.interval_s <= 0:
            raise ValueError("cannot start a sampler with interval <= 0")
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="telemetry-history"
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.sample()
            except Exception:  # noqa: BLE001 — history must not kill the node
                # A repeatable failure here silently halts segment
                # writing and burn feeding while the heartbeat may look
                # live — it must at least be loud (throttled: the loop
                # retries every tick).
                if throttled(("history_sample_failed", id(self))):
                    self.log.exception("telemetry-history sample failed")
            self._stop.wait(self.interval_s)
