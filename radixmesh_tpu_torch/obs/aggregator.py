"""Fleet-wide telemetry aggregation: one store, every node's rings.

Every other observability plane answers for ONE node:
``/debug/timeseries`` is this node's rings, ``/cluster/doctor`` judges
this node's seams, a black box dumps this node's history. At the N=200
scale ringscale already simulates, an operator (or the ROADMAP item-2
autoscale executor) must poll 200 endpoints and merge by hand — and the
one merge that matters most, latency percentiles, is exactly the one
hand-merging gets wrong (an average of per-node p99s is not the fleet
p99; it is not ANY quantile of anything). This module is the control
room:

- A :class:`FleetAggregator`, hosted on router/front-door nodes,
  **cursor-pulls** each peer's change-compressed history ring — the
  existing ``/debug/timeseries`` ``since``/``next_since`` pagination is
  the wire protocol (:class:`HttpPeer`), with a direct in-proc seam for
  tests and workloads (:class:`InprocPeer`) — and folds every page into
  one node-labeled fleet :class:`~radixmesh_tpu_torch.obs.timeseries.TelemetryHistory`
  via :meth:`TelemetryHistory.ingest`. ``GET /cluster/timeseries``
  serves the fleet store with the same query/pagination contract as the
  per-node endpoint, so every existing reader works unchanged.
- **Correct cross-node percentiles**: per-node samplers ship their
  request-latency histograms WITH cumulative bucket counts
  (``timeseries.BUCKET_FAMILIES``); :meth:`FleetAggregator.fleet_slo`
  sums the counts bucket-by-bucket across nodes and interpolates the
  quantile inside the merged distribution (:func:`merge_quantile` —
  the same cumulative interpolation ``Histogram.quantile`` uses), so
  ``/cluster/slo`` reports the TRUE fleet p50/p99 TTFT/e2e per tenant.
- **Trace exemplars**: each pull sweep also collects the peers' last
  per-bucket exemplars (``Histogram.observe(value, trace_id=)``), so
  the merged p99's bucket links straight to a stitched trace —
  "the fleet p99 is 1.2 s" comes with the trace id of a request that
  actually took that long, and which node it ran on.
- **Fleet doctor inputs**: the per-rank signal folds
  (:meth:`rank_signal`), per-peer pull/advance bookkeeping
  (:meth:`peer_status`), and an aggregated multi-window burn tracker
  with slope (:meth:`fleet_burn_report`) feed the three MeshDoctor
  rules only a cross-node view can judge: ``straggler_node``,
  ``fleet_burn_slope``, and ``telemetry_gap`` (obs/doctor.py).

Restart safety: peer sample sequences are per-boot. A pull whose
``seq`` is BELOW the cursor means the peer restarted (prior-boot ring
gone) — the cursor resets to -1 and the new boot's ring is re-pulled
from its start. Nothing double-counts: the old boot's points are
already folded under their ingest sequences, and the new boot starts
its own. Counted, never silent (``radixmesh_agg_peer_resets_total``).

Import-light on purpose (stdlib only): router nodes host this without
a backend; HTTP transport is urllib against the existing debug
endpoints, so any node that serves ``/debug/timeseries`` is already a
valid peer.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from collections import deque

from radixmesh_tpu_torch.obs.metrics import (
    TRANSFER_SECONDS_BUCKETS,
    get_registry,
)
from radixmesh_tpu_torch.obs.timeseries import TelemetryHistory
from radixmesh_tpu_torch.utils.logging import get_logger, throttled

__all__ = [
    "FleetAggregator",
    "InprocPeer",
    "HttpPeer",
    "merge_quantile",
    "merge_bucket_counts",
]


def _parse_labels(name: str) -> dict[str, str]:
    """Label dict off a rendered series name
    (``family{k="v",k2="v2"}``); {} when unlabeled/malformed."""
    i = name.find("{")
    if i < 0 or not name.endswith("}"):
        return {}
    out: dict[str, str] = {}
    for part in name[i + 1 : -1].split(","):
        if "=" not in part:
            continue
        k, v = part.split("=", 1)
        out[k.strip()] = v.strip().strip('"')
    return out


def _le_to_float(le: str) -> float:
    return float("inf") if le == "+Inf" else float(le)


def merge_bucket_counts(
    per_node: "list[dict[str, float]]",
) -> tuple[tuple[float, ...], list[float]]:
    """Sum per-node cumulative bucket vectors (``le`` string → count)
    into one merged ``(bounds, cumulative counts)`` pair. Cumulative
    counts are additive across independent streams, so the merged
    vector is exactly the histogram of the union stream — THE operation
    averaging-of-percentiles gets wrong."""
    les: set[str] = set()
    for d in per_node:
        les.update(d)
    bounds = sorted((_le_to_float(le) for le in les))
    merged = []
    for b in bounds:
        le = "+Inf" if b == float("inf") else None
        total = 0.0
        for d in per_node:
            for k, v in d.items():
                if (le is not None and k == le) or (
                    le is None and _le_to_float(k) == b
                ):
                    total += v
        merged.append(total)
    return tuple(b for b in bounds if b != float("inf")), merged


def merge_quantile(
    bounds: "tuple[float, ...]", cumulative: "list[float]", q: float
) -> tuple[float, str | None]:
    """(quantile estimate, bucket ``le`` string) from a merged
    cumulative bucket vector — the same linear-interpolation-inside-
    the-selected-bucket estimate ``Histogram.quantile`` computes from
    its own counts, so a single-node fleet answers identically to the
    node itself. The returned ``le`` is the selected bucket's upper
    bound as a label string (``"+Inf"`` for the overflow bucket) — the
    join key into the exemplar map."""
    if not cumulative:
        return 0.0, None
    total = cumulative[-1]
    if total <= 0:
        return 0.0, None
    target = q * total
    acc = 0.0
    for i, ub in enumerate(bounds):
        in_bucket = cumulative[i] - (cumulative[i - 1] if i else 0.0)
        if acc + in_bucket >= target and in_bucket > 0:
            if ub == float("inf"):
                # No finite upper edge to interpolate toward: report
                # the largest finite bound (the Histogram.quantile
                # convention) but join exemplars in the +Inf bucket,
                # where the observations actually landed.
                return (bounds[i - 1] if i > 0 else 0.0), "+Inf"
            lo = bounds[i - 1] if i > 0 else min(0.0, ub)
            est = lo + (ub - lo) * (target - acc) / in_bucket
            return est, _fmt_le(ub)
        acc += in_bucket
    # Target falls in the +Inf bucket: report the largest finite bound
    # (the Histogram.quantile convention) and join exemplars there.
    return (bounds[-1] if bounds else float("inf")), "+Inf"


def _fmt_le(v: float) -> str:
    """The exact ``le`` label string the exposition layer renders for a
    bound (obs/metrics.py ``_fmt_value``) — merged-quantile bucket ids
    must join against peer exemplar keys byte-for-byte."""
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


# ---------------------------------------------------------------------------
# peers: where a ring comes from
# ---------------------------------------------------------------------------


class InprocPeer:
    """A peer whose ring lives in this process: direct
    :meth:`TelemetryHistory.query` calls, exemplars straight off the
    registry. The seam tests/workloads drive (no sockets), and the
    N=200 fan-in row's simulated transport."""

    def __init__(self, name: str, history, registry=None, rank=None):
        self.name = str(name)
        self.history = history
        self.registry = registry
        self.rank = rank

    def fetch(self, since: int, limit: int) -> dict:
        return self.history.query(since=since, limit=limit)

    def fetch_exemplars(self) -> dict:
        reg = self.registry
        return reg.exemplars() if reg is not None else {}


class HttpPeer:
    """A peer reached over the existing debug endpoints: the ring via
    ``GET /debug/timeseries`` (the pagination contract IS the wire
    protocol), exemplars via the ``exemplars`` section of
    ``GET /debug/state``. Any serving or router frontend, of either
    package, is a valid peer with zero server-side changes."""

    def __init__(self, name: str, base_url: str, timeout_s: float = 2.0,
                 rank=None):
        self.name = str(name)
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self.rank = rank

    def _get(self, path: str) -> dict:
        with urllib.request.urlopen(
            f"{self.base_url}{path}", timeout=self.timeout_s
        ) as resp:
            return json.loads(resp.read().decode("utf-8"))

    def fetch(self, since: int, limit: int) -> dict:
        return self._get(f"/debug/timeseries?since={int(since)}&limit={int(limit)}")

    def fetch_exemplars(self) -> dict:
        return self._get("/debug/state").get("exemplars", {})


class _PeerState:
    """Per-peer pull bookkeeping (cursor + liveness), all under the
    aggregator lock."""

    __slots__ = (
        "cursor", "seq", "interval_s", "last_advance_t", "last_ok_t",
        "errors", "resets", "pages",
    )

    def __init__(self):
        self.cursor = -1  # next_since to pull from (-1 = ring start)
        self.seq = -1  # peer's last reported sample sequence
        self.interval_s = 1.0  # peer's reported sampler cadence
        self.last_advance_t = 0.0  # store clock when seq last advanced
        self.last_ok_t = 0.0  # store clock of the last successful pull
        self.errors = 0
        self.resets = 0
        self.pages = 0


# ---------------------------------------------------------------------------
# the aggregator
# ---------------------------------------------------------------------------


class FleetAggregator:
    """The collector. Construct with the peer list (mixed
    :class:`InprocPeer`/:class:`HttpPeer`), :meth:`start` the puller
    thread (or drive :meth:`pull_once` directly — tests, virtual time),
    read ``.store`` (a node-labeled :class:`TelemetryHistory`, ingest-
    only, never sampled) for ``/cluster/timeseries`` and
    :meth:`fleet_slo` for ``/cluster/slo``."""

    def __init__(
        self,
        peers=(),
        interval_s: float = 2.0,
        capacity: int = 900,
        node: str = "fleet",
        max_series: int = 16384,
        registry=None,
        now=time.monotonic,
        page_limit: int = 4000,
        max_pages: int = 64,
        burn_budget: float = 0.01,
    ):
        self.interval_s = float(interval_s)
        self.node = node
        self.page_limit = int(page_limit)
        # Bounded pages per peer per sweep: a peer with a deeper backlog
        # finishes over the next sweeps — fan-in latency stays bounded
        # even when one ring is a full capacity behind.
        self.max_pages = int(max_pages)
        self._now = now
        self.log = get_logger("obs.aggregator")
        # The fleet store: ingest-only (never start()ed — its sample()
        # path would re-sample THIS process's registry, which is not
        # fleet data). Same query surface as any per-node history.
        self.store = TelemetryHistory(
            interval_s=interval_s,
            capacity=capacity,
            node=node,
            max_series=max_series,
            registry=registry,
            now=now,
            bucket_families=(),
        )
        self._lock = threading.Lock()
        self._peers: list = list(peers)
        self._state: dict[str, _PeerState] = {
            p.name: _PeerState() for p in self._peers
        }
        # peer name → registry-keyed exemplar map from its last sweep.
        self._exemplars: dict[str, dict] = {}
        # Aggregated multi-window burn over fleet-summed SLO counters,
        # fed once per sweep; per-tenant (t, fast-burn) trail for the
        # slope the item-2 autoscaler pre-scale signal needs.
        self.burn_tracker = None  # lazily built: avoids import cycle
        self._burn_budget = float(burn_budget)
        self._burn_trail: dict[str, deque] = {}
        self._pull_seconds_total = 0.0
        self._sweeps = 0
        self._last_sweep_t = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

        reg = registry if registry is not None else get_registry()
        self._m_pulls = reg.counter(
            "radixmesh_agg_pulls_total",
            "per-peer pull attempts by the fleet aggregator "
            "(obs/aggregator.py)",
        )
        self._m_errors = reg.counter(
            "radixmesh_agg_pull_errors_total",
            "fleet-aggregator pulls that raised (peer down, timeout, "
            "bad body) — the puller retries next sweep",
        )
        self._m_points = reg.counter(
            "radixmesh_agg_points_ingested_total",
            "ring points folded into the fleet store across all peers",
        )
        self._m_resets = reg.counter(
            "radixmesh_agg_peer_resets_total",
            "peer restarts detected by the cursor (reported seq below "
            "the cursor): the cursor rewinds to the new boot's ring "
            "start — counted, never silent",
        )
        self._m_peers = reg.gauge(
            "radixmesh_agg_peers",
            "peers the fleet aggregator is polling",
        )
        self._m_pull_seconds = reg.histogram(
            "radixmesh_agg_pull_seconds",
            "wall cost of one full pull sweep over every peer — the "
            "aggregation-overhead gate input (AGG artifact: < 1% of "
            "run wall time)",
            buckets=TRANSFER_SECONDS_BUCKETS,
        )
        self._m_fleet_nodes = reg.gauge(
            "radixmesh_fleet_nodes",
            "peers with a live ring as of the last sweep (seq advanced "
            "within one gap threshold)",
        )

    # -- wiring --------------------------------------------------------

    def add_peer(self, peer) -> None:
        with self._lock:
            self._peers.append(peer)
            self._state.setdefault(peer.name, _PeerState())

    def peers(self) -> list:
        with self._lock:
            return list(self._peers)

    def _ensure_burn_tracker(self):
        if self.burn_tracker is None:
            from radixmesh_tpu_torch.obs.doctor import BurnRateTracker

            self.burn_tracker = BurnRateTracker(
                self._burn_budget, now=self._now
            )
        return self.burn_tracker

    # -- the pull sweep ------------------------------------------------

    def pull_once(self) -> dict:
        """One sweep: pull every peer's new pages, fold them into the
        fleet store, refresh exemplars + burn windows. Returns the
        sweep summary (the workload's fan-in row input)."""
        t0 = time.monotonic()
        peers = self.peers()
        self._m_peers.set(len(peers))
        points = 0
        errors = 0
        for peer in peers:
            with self._lock:  # add_peer mutates the map concurrently
                st = self._state[peer.name]
            self._m_pulls.inc()
            try:
                reset_seen = False
                for _ in range(self.max_pages):
                    body = peer.fetch(since=st.cursor, limit=self.page_limit)
                    seq = int(body.get("seq", -1))
                    if seq < st.cursor and not reset_seen:
                        # The peer's ring restarted under the cursor
                        # (prior-boot dir rotated away): rewind and
                        # re-pull the new boot's ring from its start.
                        # One rewind per sweep — a peer that reports a
                        # still-lower seq twice is malformed, not
                        # restarting, and must not loop.
                        with self._lock:
                            st.cursor = -1
                            st.seq = -1
                            st.resets += 1
                        self._m_resets.inc()
                        reset_seen = True
                        continue
                    self.store.ingest(peer.name, body)
                    n = int(body.get("points", 0))
                    points += n
                    if n:
                        self._m_points.inc(n)
                    now = self._now()
                    with self._lock:
                        st.pages += 1
                        st.interval_s = float(body.get("interval_s", 1.0))
                        st.cursor = int(body.get("next_since", seq))
                        st.last_ok_t = now
                        if seq > st.seq:
                            st.seq = seq
                            st.last_advance_t = now
                    if not body.get("has_more"):
                        break
                try:
                    ex = peer.fetch_exemplars()
                except Exception:  # noqa: BLE001 — exemplars are best-effort garnish
                    ex = None
                if ex is not None:
                    with self._lock:
                        self._exemplars[peer.name] = ex
            except Exception:  # noqa: BLE001 — a dead peer must not kill the sweep
                errors += 1
                with self._lock:
                    st.errors += 1
                self._m_errors.inc()
                if throttled(("agg_pull_failed", peer.name)):
                    self.log.exception(
                        "fleet pull from peer %r failed", peer.name
                    )
        self._feed_burn()
        now = self._now()
        with self._lock:
            live = sum(
                1
                for st in self._state.values()
                if st.seq >= 0
                and now - st.last_advance_t <= self._gap_threshold(st)
            )
        self._m_fleet_nodes.set(live)
        cost = time.monotonic() - t0
        with self._lock:
            self._pull_seconds_total += cost
            self._sweeps += 1
            self._last_sweep_t = now
        self._m_pull_seconds.observe(cost)
        return {
            "peers": len(peers),
            "errors": errors,
            "points": points,
            "duration_s": cost,
        }

    def _gap_threshold(self, st: _PeerState) -> float:
        """How long a peer's seq may sit still before it counts as
        stalled: several sampler intervals (change-compression never
        stops seq advancing — a live sampler bumps seq every tick even
        when no series changed) plus several pull cadences (the
        aggregator only observes advances when it pulls)."""
        return 3.0 * max(st.interval_s, self.interval_s) + st.interval_s

    def _feed_burn(self) -> None:
        """Sum the per-node ``slo:admitted``/``slo:shed`` counters per
        tenant out of the fleet store and feed the aggregate burn
        tracker; extend each tenant's fast-burn trail for the slope."""
        sums: dict[str, dict[str, float]] = {}
        for kind in ("admitted", "shed"):
            q = self.store.query(family=f"slo:{kind}", limit=1)
            for name, s in q["series"].items():
                tenant = _parse_labels(name).get("tenant")
                if tenant is None or s["last"][1] is None:
                    continue
                c = sums.setdefault(tenant, {"admitted": 0, "shed": 0})
                c[kind] += s["last"][1]
        if not sums:
            return
        tracker = self._ensure_burn_tracker()
        t = self._now()
        tracker.sample(
            {
                tenant: {"admitted": int(c["admitted"]), "shed": int(c["shed"])}
                for tenant, c in sums.items()
            },
            t=t,
        )
        with self._lock:
            for tenant in sums:
                fast, _ = tracker.burn(tenant, 300.0, t=t)
                self._burn_trail.setdefault(
                    tenant, deque(maxlen=512)
                ).append((t, fast))

    # -- fleet reads ---------------------------------------------------

    def fleet_slo(self, quantiles=(0.5, 0.99)) -> dict:
        """The ``GET /cluster/slo`` body: per tenant, the TRUE fleet
        quantiles of TTFT, e2e, and inter-token latency — bucket counts
        summed across nodes, quantile interpolated inside the merged
        distribution — each with the exemplar (trace id + node) of its
        selected bucket, plus the per-tenant speculation acceptance
        panel folded from the ``radixmesh_spec_*`` families."""
        out: dict[str, dict] = {}
        for metric, family in (
            ("ttft", "radixmesh_request_ttft_seconds"),
            ("e2e", "radixmesh_request_e2e_seconds"),
            ("itl", "radixmesh_token_itl_seconds"),
        ):
            q = self.store.query(family=family + "_bucket", limit=1)
            # (tenant, node) → {le: cumulative count}
            per: dict[str, dict[str, dict[str, float]]] = {}
            for name, s in q["series"].items():
                labels = _parse_labels(name)
                le = labels.get("le")
                tenant = labels.get("tenant", "default")
                node = labels.get("node", "?")
                if le is None or s["last"][1] is None:
                    continue
                per.setdefault(tenant, {}).setdefault(node, {})[le] = float(
                    s["last"][1]
                )
            for tenant, by_node in per.items():
                bounds, cum = merge_bucket_counts(list(by_node.values()))
                ent = out.setdefault(tenant, {})[metric] = {
                    "count": int(cum[-1]) if cum else 0,
                    "nodes": sorted(by_node),
                }
                for qq in quantiles:
                    est, le = merge_quantile(
                        bounds + (float("inf"),), cum, qq
                    )
                    key = f"p{int(qq * 100)}"
                    ent[key] = round(est, 6)
                    ent[f"{key}_bucket"] = le
                    ex = self._find_exemplar(family, tenant, le, bounds)
                    if ex is not None:
                        ent[f"{key}_exemplar"] = ex
        self._fold_spec_panel(out)
        with self._lock:
            last_sweep = self._last_sweep_t
        return {
            "node": self.node,
            "tenants": out,
            "peers": self.peer_status(),
            "last_sweep_t": round(last_sweep, 6),
        }

    def _fold_spec_panel(self, out: dict[str, dict]) -> None:
        """Per-tenant speculation acceptance across the fleet (the
        token-speed plane): for every (tenant, shape, draft-source)
        class, the freshest acceptance EWMA and γ-used per node plus
        proposed/accepted totals SUMMED across nodes — so
        ``/cluster/slo`` answers "is speculation paying for tenant X"
        without a per-node walk. Classes land under
        ``tenants[t]["spec"]["classes"]["shape/source"]``."""
        # (tenant, shape, source) → {"ewma": (seq, val), sums…}
        cells: dict[tuple[str, str, str], dict] = {}

        def _fold(family: str, key: str, freshest: bool):
            q = self.store.query(family=family, limit=1)
            for name, s in q["series"].items():
                labels = _parse_labels(name)
                tenant = labels.get("tenant")
                shape = labels.get("shape")
                source = labels.get("source")
                last = s.get("last")
                if tenant is None or shape is None or last is None:
                    continue
                seq, val = last
                if val is None:
                    continue
                cell = cells.setdefault(
                    (tenant, shape, source or "?"), {}
                )
                if freshest:
                    prev = cell.get(key)
                    if prev is None or seq > prev[0]:
                        cell[key] = (seq, float(val))
                else:
                    cell[key] = cell.get(key, 0.0) + float(val)

        _fold("radixmesh_spec_accept_ratio", "ewma", freshest=True)
        _fold("radixmesh_spec_gamma_used_tokens", "gamma", freshest=True)
        _fold("radixmesh_spec_proposed_tokens_total", "proposed", freshest=False)
        _fold("radixmesh_spec_accepted_tokens_total", "accepted", freshest=False)
        for (tenant, shape, source), cell in sorted(cells.items()):
            panel = out.setdefault(tenant, {}).setdefault(
                "spec", {"classes": {}}
            )
            proposed = cell.get("proposed", 0.0)
            accepted = cell.get("accepted", 0.0)
            panel["classes"][f"{shape}/{source}"] = {
                "accept_ewma": (
                    round(cell["ewma"][1], 4) if "ewma" in cell else None
                ),
                "gamma_tokens": (
                    cell["gamma"][1] if "gamma" in cell else None
                ),
                "proposed": int(proposed),
                "accepted": int(accepted),
            }
        # One headline rate per tenant: acceptance weighted by proposal
        # volume (an EWMA mean would overweight idle classes).
        for tenant, sigs in out.items():
            panel = sigs.get("spec")
            if not panel:
                continue
            p = sum(c["proposed"] for c in panel["classes"].values())
            a = sum(c["accepted"] for c in panel["classes"].values())
            panel["proposed"] = p
            panel["accepted"] = a
            panel["accept_rate"] = round(a / p, 4) if p else None

    def _find_exemplar(
        self, family: str, tenant: str, le: str | None, bounds
    ) -> dict | None:
        """The freshest peer exemplar in the quantile's bucket — or, if
        that bucket holds none (exemplars keep only the LAST traced
        observation per bucket), in any bucket above it: an outlier
        past the quantile is still an honest witness for it."""
        if le is None:
            return None
        floor = _le_to_float(le)
        with self._lock:
            by_peer = {p: dict(ex) for p, ex in self._exemplars.items()}
        best = None
        for peer, series in by_peer.items():
            for key, buckets in series.items():
                if not key.startswith(family + "{"):
                    continue
                if _parse_labels(key).get("tenant") != tenant:
                    continue
                for b_le, ex in buckets.items():
                    if _le_to_float(b_le) < floor:
                        continue
                    cand = (float(ex.get("wall_time", 0.0)), peer, b_le, ex)
                    if best is None or cand[0] > best[0]:
                        best = cand
        if best is None:
            return None
        _, peer, b_le, ex = best
        return {**ex, "node": peer, "le": b_le}

    def rank_signal(self, family: str) -> dict[str, float]:
        """Freshest per-rank value of a rank-labeled fleet series (e.g.
        ``fleet:decode_ewma_seconds``) across every reporting node —
        the straggler rule's input. Multiple nodes gossip a view of the
        same rank; the most recently ingested one wins."""
        q = self.store.query(family=family, limit=1)
        best: dict[str, tuple[int, float]] = {}
        for name, s in q["series"].items():
            rank = _parse_labels(name).get("rank")
            seen, val = s["last"]
            if rank is None or val is None:
                continue
            if rank not in best or seen > best[rank][0]:
                best[rank] = (seen, float(val))
        return {rank: v for rank, (_, v) in sorted(best.items())}

    def peer_status(self, t: float | None = None) -> dict[str, dict]:
        """Per-peer pull/advance bookkeeping — the ``telemetry_gap``
        rule's input and the ``/cluster/slo`` liveness section."""
        t = self._now() if t is None else float(t)
        out = {}
        with self._lock:
            for peer in self._peers:
                st = self._state[peer.name]
                out[peer.name] = {
                    "rank": getattr(peer, "rank", None),
                    "seq": st.seq,
                    "cursor": st.cursor,
                    "interval_s": st.interval_s,
                    "errors": st.errors,
                    "resets": st.resets,
                    "stalled_s": round(t - st.last_advance_t, 6)
                    if st.seq >= 0
                    else None,
                    "gap_threshold_s": round(self._gap_threshold(st), 6),
                }
        return out

    def fleet_burn_report(
        self,
        fast_window_s: float = 300.0,
        slow_window_s: float = 3600.0,
        slope_window_s: float = 60.0,
    ) -> dict[str, dict]:
        """Per-tenant aggregated burn over the fleet-summed counters:
        fast/slow window multiples plus the fast-burn SLOPE over the
        trailing trail — rising burn is the pre-scale signal ROADMAP
        item 2 acts on before either page threshold trips."""
        tracker = self.burn_tracker
        if tracker is None:
            return {}
        t = self._now()
        out: dict[str, dict] = {}
        with self._lock:
            trails = {k: list(v) for k, v in self._burn_trail.items()}
        for tenant in tracker.tenants():
            fast, offered = tracker.burn(tenant, fast_window_s, t=t)
            slow, _ = tracker.burn(tenant, slow_window_s, t=t)
            trail = [
                p for p in trails.get(tenant, []) if p[0] >= t - slope_window_s
            ]
            slope = 0.0
            if len(trail) >= 2 and trail[-1][0] > trail[0][0]:
                slope = (trail[-1][1] - trail[0][1]) / (
                    trail[-1][0] - trail[0][0]
                )
            out[tenant] = {
                "burn_fast": round(fast, 4),
                "burn_slow": round(slow, 4),
                "offered": offered,
                "slope_per_s": round(slope, 6),
                "budget": self._burn_budget,
            }
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "interval_s": self.interval_s,
                "peers": len(self._peers),
                "sweeps": self._sweeps,
                "last_sweep_t": self._last_sweep_t,
                # This instance's own cumulative sweep cost — the AGG
                # artifact's < 1% overhead gate input (the shared
                # radixmesh_agg_pull_seconds histogram folds every
                # aggregator in the process).
                "pull_seconds_total": self._pull_seconds_total,
                "store": self.store.stats(),
            }

    # -- thread --------------------------------------------------------

    def start(self) -> "FleetAggregator":
        if self.interval_s <= 0:
            raise ValueError("cannot start a puller with interval <= 0")
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="fleet-aggregator"
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
                self.pull_once()
            except Exception:  # noqa: BLE001 — the control room must not kill the router
                if throttled(("agg_sweep_failed", id(self))):
                    self.log.exception("fleet aggregation sweep failed")
            self._stop.wait(self.interval_s)
