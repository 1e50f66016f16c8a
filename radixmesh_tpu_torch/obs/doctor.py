"""The mesh doctor: a rule engine over the observability planes.

Without it, a diagnosis is a human reading raw artifacts — a prefill
convoy, a hot-shard skew, a small-batch gap — found by eyeball. This
module closes the loop: it CONSUMES the substrate
(FleetView health + shard heat, the phase attributor's per-shape
waterfall aggregates, step accounting, the SLO token-bucket plane,
engine spec counters) and emits **ranked findings, each carrying its
evidence** — metric values, shard ids, owner sets — in a file-format
the DOCTOR artifact schema pins (``bench.validate_doctor``), so "what
is wrong with the mesh" is a GET, not an afternoon.

Rules (each fires at most one finding; evidence fields are part of the
schema contract — see :data:`RULE_EVIDENCE_FIELDS`):

- ``hot_shard`` — fleet skew score over threshold: names the hot shard
  AND its owner set (the item-2 rebalancer's trigger input).
- ``prefill_convoy`` — one request shape's exclusive prefill-phase
  share of e2e over threshold while slower than the rest of the
  traffic: names the convoying shape.
- ``restore_park_stall`` — requests parked in RESTORING behind a slow
  restore lane (live parked count + queued restores, or the
  restore_park phase share): names the throttled lane.
- ``replication_lag`` — gossiped per-node oplog origin→apply lag over
  threshold: names the lagging ranks.
- ``slo_burn_rate`` — multi-window (5 m AND 1 h) error-budget burn per
  tenant over the token-bucket plane (the classic SRE pager rule:
  both windows hot ⇒ neither a blip nor stale news).
- ``spec_efficiency`` — per-shape speculative acceptance under the
  floor with enough proposals to matter: names the shape whose drafts
  miss (the item-1(a) adaptive-γ substrate).

A healthy mesh yields ZERO findings, as firmly as a seeded pathology
is named.

Import-light on purpose (stdlib only): both frontends, the router, and
the post-mortem reader (``python -m radixmesh_tpu_torch.doctor``) construct doctors without a backend; every input
is an optional duck-typed seam.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import deque
from dataclasses import dataclass, field

__all__ = [
    "DoctorConfig",
    "Finding",
    "BurnRateTracker",
    "MeshDoctor",
    "RULES",
    "RULE_EVIDENCE_FIELDS",
    "POSTMORTEM_RULES",
    "POSTMORTEM_EVIDENCE_FIELDS",
    "postmortem_report",
]

# Rule ids in severity-tiebreak order (ranking is by score first; this
# order breaks exact ties deterministically).
RULES = (
    "hot_shard",
    "prefill_convoy",
    "restore_park_stall",
    "replication_lag",
    "slo_burn_rate",
    "spec_efficiency",
    "rebalancer_asleep",
    "tier_thrash",
    # Fleet rules: judged over the FleetAggregator's cross-node
    # store — no single node's seams can run them.
    "straggler_node",
    "fleet_burn_slope",
    "telemetry_gap",
    # Token-plane rules: judged over the engine's per-token
    # timeline / speculation ledger and the history ring's goodput
    # series.
    "decode_stall",
    "spec_misconfigured",
    "goodput_regression",
)

# The pinned evidence vocabulary per rule: every finding MUST carry at
# least these keys (bench.validate_doctor checks artifacts against this
# map; tests/test_doctor.py checks live findings against it). Evidence
# without a contract rots into prose.
RULE_EVIDENCE_FIELDS = {
    "hot_shard": ("skew_score", "shard", "owners", "reporters"),
    "prefill_convoy": (
        "shape", "prefill_share", "mean_e2e_s", "fleet_mean_e2e_s",
        "requests",
    ),
    "restore_park_stall": (
        "lane", "parked", "restores_queued", "park_p99_s", "park_share",
    ),
    "replication_lag": ("ranks", "threshold_s", "worst_lag_s"),
    "slo_burn_rate": (
        "tenant", "burn_fast", "burn_slow", "fast_window_s",
        "slow_window_s", "budget", "tier",
    ),
    "spec_efficiency": ("shape", "proposed", "accepted", "acceptance"),
    "rebalancer_asleep": (
        "skew_peak", "sustained_s", "window_s", "moves_in_window",
        "hot_shard", "plane_armed",
    ),
    "tier_thrash": (
        "shard", "demotes", "promotes", "cycles", "window_s", "source",
    ),
    "straggler_node": (
        "rank", "signal", "value_s", "fleet_median_s", "ratio", "ranks",
    ),
    "fleet_burn_slope": (
        "tenant", "burn_fast", "burn_slow", "slope_per_s", "budget",
        "offered",
    ),
    "telemetry_gap": (
        "peer", "rank", "stalled_s", "peer_seq", "verdict",
    ),
    "decode_stall": (
        "cause", "stalls", "stall_seconds", "p99_itl_s", "threshold_s",
    ),
    "spec_misconfigured": (
        "tenant", "shape", "source", "gamma", "accept_ewma", "proposed",
    ),
    "goodput_regression": (
        "recent_tps", "baseline_tps", "drop_frac", "window_s",
    ),
}


@dataclass
class DoctorConfig:
    """Rule thresholds. Defaults are tuned so steady healthy serving —
    balanced heat, sub-threshold lag, drafts landing — yields zero
    findings (the acceptance workload's healthy-phase gate)."""

    # hot_shard: fleet skew (max/mean over reported shards) above this
    # with at least min_reporters heat reporters.
    hot_shard_skew: float = 4.0
    hot_shard_min_reporters: int = 1
    # prefill_convoy: a shape's exclusive prefill share of its e2e, with
    # at least min_requests audited waterfalls of that shape, while its
    # mean e2e exceeds the other shapes' mean by slowdown×.
    convoy_prefill_share: float = 0.55
    convoy_min_requests: int = 3
    convoy_slowdown: float = 1.5
    # restore_park_stall: live parked requests + a queued restore lane,
    # OR the audited restore_park share of e2e across requests.
    park_min_parked: int = 2
    park_share: float = 0.25
    # replication_lag: gossiped per-node lag EWMA above this.
    lag_threshold_s: float = 1.0
    # slo_burn_rate: shed-fraction burn multiple over budget, both
    # windows (SRE multi-window multi-burn: fast window catches the
    # fire, slow window proves it is not a blip).
    burn_budget: float = 0.01  # tolerable shed fraction (99% availability)
    burn_fast_window_s: float = 300.0
    burn_slow_window_s: float = 3600.0
    burn_fast_threshold: float = 14.4
    burn_slow_threshold: float = 6.0
    burn_min_requests: int = 20
    # spec_efficiency: acceptance floor with enough proposals to judge.
    spec_accept_floor: float = 0.3
    spec_min_proposed: int = 50
    # rebalancer_asleep: the fleet skew stayed above hot_shard_skew for
    # at least sustain seconds inside the trailing window while the
    # rebalance plane adopted ZERO moves in that window — the telemetry
    # sees a storm the mesh is not acting on (a missing/off plane fires
    # the same rule: that is the pre-rebalancer pathology by name).
    rebalance_window_s: float = 120.0
    rebalance_sustain_s: float = 10.0
    # Persistence bound for SELF-SAMPLED skew points (no history ring):
    # a diagnose-time sample only proves the skew at that instant, so
    # its value persists at most this long toward "sustained" — sparse
    # polling must not smear two momentary spikes into a storm (the
    # same discipline BurnRateTracker's staleness bound applies).
    # History-fed trajectories are change-compressed (a gap means NO
    # CHANGE), so their persistence is exact and uncapped.
    rebalance_max_sample_gap_s: float = 30.0
    # tier_thrash: the durable KV tier (cache/kv_tier.py) demoting AND
    # promoting the same subtree shard >= min_cycles times each inside
    # one hysteresis window — the working set straddles the host
    # watermark and every crossing pays a disk round trip. Cycles =
    # min(demotes, promotes) within the window.
    tier_thrash_window_s: float = 60.0
    tier_thrash_min_cycles: int = 3
    # straggler_node: one rank's decode-step (or replication-lag) EWMA
    # at least ratio× the fleet median across >= min_ranks ACTIVE ranks
    # (zeros are ranks not running that plane, not fast ranks), above
    # an absolute floor so uniform microsecond noise never fires.
    straggler_ratio: float = 3.0
    straggler_min_ranks: int = 2
    straggler_floor_s: float = 0.005
    # fleet_burn_slope: aggregated (fleet-summed) multi-window burn.
    # Deliberately LOWER thresholds than the per-node page rule: this
    # is the pre-scale signal (ROADMAP item 2) — it should fire, with
    # its slope, before anyone's pager does.
    fleet_burn_fast_threshold: float = 6.0
    fleet_burn_slow_threshold: float = 3.0
    fleet_burn_min_requests: int = 20
    # telemetry_gap: floor on how long a peer's ring may sit still
    # before it counts as stalled (the aggregator's per-peer
    # cadence-scaled threshold also applies — whichever is larger).
    telemetry_gap_s: float = 5.0
    # decode_stall: minimum attributed stall events before the token
    # timeline's dominant cause is worth a finding (a handful of gaps
    # is jitter, not a pathology).
    decode_stall_min_events: int = 10
    # spec_misconfigured: a (tenant, shape, draft-source) class whose
    # acceptance EWMA sits under spec_accept_floor while γ stays wide —
    # judged only with enough proposals, and only when γ was NOT zeroed
    # by the SLO degradation ladder (that is policy, not mistuning).
    spec_misconfig_min_proposed: int = 50
    # goodput_regression: recent-window mean of the history ring's
    # goodput:tokens_per_second at least regress_frac below the
    # preceding baseline window's mean (floored so an idle engine's
    # near-zero throughput never reads as a collapse).
    goodput_regress_frac: float = 0.3
    goodput_recent_window_s: float = 60.0
    goodput_baseline_window_s: float = 300.0
    goodput_min_tps: float = 1.0


@dataclass
class Finding:
    """One diagnosis: the rule that fired, a 0..1 severity score (1 =
    drop everything), a one-line summary, and the rule's pinned
    evidence dict."""

    rule: str
    score: float
    summary: str
    evidence: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "score": round(self.score, 4),
            "summary": self.summary,
            "evidence": self.evidence,
        }


class BurnRateTracker:
    """Windowed error-budget burn over cumulative (admitted, shed)
    request counters, backed by the telemetry-history feed.

    :meth:`sample` records one counter snapshot per tenant (the history
    sampler — ``obs/timeseries.py`` — feeds it every interval via
    ``bind_burn_tracker``, so the windows are dense regardless of how
    rarely anyone calls :meth:`burn`); :meth:`burn` answers the
    shed-fraction burn multiple over a trailing window by diffing the
    newest sample against the last sample AT OR BEFORE the window
    start — the exact window diff, accurate to one sample spacing.
    Retention is spacing-aware: samples closer together than
    ``min_spacing_s`` collapse (the bounded ring then spans the full
    1 h slow window even at a 1 s feed cadence). The clock is
    injectable (virtual-time unit tests). Burn = (shed / offered) /
    budget — 1.0 means exactly spending the budget, 14.4 over 5 m AND
    6 over 1 h is the classic page condition.

    With the history ring feeding every sample the base is always
    within one spacing of the window start, so the window diff is
    exact. A base more than ``max_base_lag_s`` older than the window
    start means the feed is sparse (a history-less doctor polled
    slower than the bound) — then the tracker degrades to the
    conservative base, the first sample INSIDE the window, which
    under-counts the window's head but never smears stale shed into
    it. Only a feed with no in-window sample at all (sampler dead)
    answers "can't judge".
    """

    MAX_SAMPLES = 720  # the 1 h slow window at min_spacing_s granularity

    def __init__(
        self,
        budget: float,
        now=time.monotonic,
        min_spacing_s: float = 5.0,
        max_base_lag_s: float = 30.0,
        max_samples: int | None = None,
    ):
        self.budget = max(1e-9, float(budget))
        self.min_spacing_s = float(min_spacing_s)
        self.max_base_lag_s = float(max_base_lag_s)
        # MAX_SAMPLES is sized for the live 5 s spacing; a replay over
        # a finer-grained recording must widen the ring or eviction
        # silently drops the pre-window base.
        self.max_samples = int(max_samples) if max_samples else self.MAX_SAMPLES
        self._now = now
        self._lock = threading.Lock()
        # tenant → deque[(t, admitted, shed)]
        self._samples: dict[str, deque] = {}

    def sample(self, counts: dict[str, dict[str, int]], t: float | None = None) -> None:
        t = self._now() if t is None else t
        with self._lock:
            for tenant, c in counts.items():
                dq = self._samples.setdefault(
                    tenant, deque(maxlen=self.max_samples)
                )
                if dq and t - dq[-1][0] < self.min_spacing_s:
                    # Spacing-aware retention: a 1 s history feed must
                    # not shrink the ring's span below the slow window —
                    # overwrite the newest slot instead of appending.
                    dq[-1] = (dq[-1][0], int(c.get("admitted", 0)),
                              int(c.get("shed", 0)))
                    continue
                dq.append((t, int(c.get("admitted", 0)), int(c.get("shed", 0))))

    def burn(
        self, tenant: str, window_s: float, t: float | None = None
    ) -> tuple[float, int]:
        """(burn multiple, offered requests) over the trailing window —
        offered lets callers gate on sample size."""
        t = self._now() if t is None else t
        start = t - window_s
        with self._lock:
            dq = self._samples.get(tenant)
            if not dq or len(dq) < 2:
                return 0.0, 0
            newest = dq[-1]
            # Last sample at or before the window start: the correct
            # window-diff base (bisect on the time column).
            times = [s[0] for s in dq]
            i = bisect.bisect_right(times, start) - 1
            if i < 0:
                # The ring is younger than the window: every retained
                # sample is in-window — judge over the actual span (a
                # freshly booted node's honest answer).
                base = dq[0]
            else:
                base = dq[i]
                if start - base[0] > self.max_base_lag_s:
                    # Feed gap: the nearest pre-window sample is too
                    # stale to localize the in-window shed. Fall back
                    # to the first IN-WINDOW sample (the conservative
                    # base) — the diff then under-counts the
                    # window's head instead of smearing stale shed
                    # into it, so a history-less doctor polled slower
                    # than the lag bound still judges. A dead feed
                    # (newest itself pre-window) still refuses below.
                    j = bisect.bisect_left(times, start)
                    if j >= len(dq) - 1:
                        return 0.0, 0
                    base = dq[j]
            if base is newest:
                return 0.0, 0
        admitted = newest[1] - base[1]
        shed = newest[2] - base[2]
        offered = admitted + shed
        if offered <= 0:
            return 0.0, 0
        return (shed / offered) / self.budget, offered

    def tenants(self) -> list[str]:
        with self._lock:
            return sorted(self._samples)


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


def _tier_move_events(series: dict) -> list[tuple[float, int, str]]:
    """(t, shard, dir) move events reconstructed from recorded
    ``radixmesh_kv_tier_moves_total`` counter series. Counters are
    change-compressed cumulative values, so each point's delta over the
    previous point is the number of moves landing at that sample."""
    events: list[tuple[float, int, str]] = []
    for name, body in series.items():
        if not name.startswith("radixmesh_kv_tier_moves_total{"):
            continue
        labels = _parse_labels(name)
        d = labels.get("dir")
        sh = labels.get("shard")
        if d not in ("demote", "promote") or sh is None:
            continue
        pts = body["points"] if isinstance(body, dict) else body
        prev = None
        for _, t, v in pts:
            if prev is None:
                # The first retained point of a change-compressed ring
                # carries the cumulative PRE-window count (late-started
                # history, pruned head): it is the baseline, not a
                # burst of moves at one instant. Deliberately
                # conservative — for a ring that recorded from counter
                # birth this swallows the first real move per series
                # (at most one cycle at the exact threshold), which is
                # the right trade against a pruned head replaying
                # hundreds of phantom moves as a guaranteed false
                # tier_thrash.
                prev = float(v)
                continue
            delta = int(round(float(v) - prev))
            prev = float(v)
            events.extend((float(t), int(sh), d) for _ in range(max(0, delta)))
    events.sort()
    return events


def _max_flap(
    events: list[tuple[float, int, str]], window_s: float
) -> tuple[int, int, int, int] | None:
    """Worst flapping shard over any sliding window of ``window_s``:
    (cycles, demotes, promotes, shard) where cycles = min(demotes,
    promotes) inside the window — one 'cycle' is a full host→disk→host
    round trip. None when no demote/promote events exist."""
    by_shard: dict[int, list[tuple[float, int, str]]] = {}
    for ev in events:
        by_shard.setdefault(ev[1], []).append(ev)
    best: tuple[int, int, int, int] | None = None
    for sh, evs in sorted(by_shard.items()):
        i = 0
        counts = {"demote": 0, "promote": 0}
        for j, (t, _, d) in enumerate(evs):
            counts[d] += 1
            while evs[i][0] < t - window_s:
                counts[evs[i][2]] -= 1
                i += 1
            cand = (
                min(counts["demote"], counts["promote"]),
                counts["demote"], counts["promote"], sh,
            )
            if best is None or cand > best:
                best = cand
    return best


class MeshDoctor:
    """The diagnosis engine. Every input is an optional seam:

    - ``mesh``: a MeshCache (FleetView health/heat + shard ownership).
    - ``engine``: an Engine (kv_transfer lane depths, parked requests,
      per-shape spec counters via ``telemetry()``).
    - ``slo``: an OverloadController (``burn_counts()`` + ``.tier``).
    - ``attributor``: a PhaseAttributor (per-shape phase aggregates).
    - ``history``: a TelemetryHistory (``obs/timeseries.py``) — when
      attached, its sampler feeds the burn tracker every interval, so
      the 5 m / 1 h windows are dense regardless of how rarely anyone
      GETs ``/cluster/doctor`` (no can't-judge gap between polls, by
      construction).

    Construct ONE per frontend and call :meth:`diagnose` per GET — the
    burn tracker needs continuity across calls (a fresh doctor has no
    windows). Absent seams silently skip their rules; ``rules_checked``
    in the report says which actually ran, so "no findings" can never
    be confused with "nothing was looked at".
    """

    def __init__(
        self,
        mesh=None,
        engine=None,
        slo=None,
        attributor=None,
        history=None,
        aggregator=None,
        cfg: DoctorConfig | None = None,
        now=time.monotonic,
    ):
        self.mesh = mesh
        self.engine = engine
        self.slo = slo
        self._attributor = attributor
        self.history = history
        # A FleetAggregator (obs/aggregator.py): the cross-node seam
        # behind the three fleet rules — straggler_node over per-rank
        # signal folds, fleet_burn_slope over fleet-summed burn
        # windows, telemetry_gap over per-peer pull bookkeeping.
        self.aggregator = aggregator
        self.cfg = cfg or DoctorConfig()
        self._now = now
        self.burn_tracker = BurnRateTracker(self.cfg.burn_budget, now=now)
        # The history ring becomes the burn windows' clock source: every
        # sampler tick forwards slo.burn_counts() into the tracker
        # (diagnose() then never needs to self-sample). Only a history
        # that itself holds an SLO seam ever feeds bound trackers — a
        # doctor bound to an slo-less history would starve forever, so
        # that shape keeps self-sampling instead.
        self._burn_fed_by_history = (
            history is not None
            and slo is not None
            and getattr(history, "slo", None) is not None
        )
        if self._burn_fed_by_history:
            history.bind_burn_tracker(self.burn_tracker)
        # Skew trajectory for the rebalancer_asleep rule when no
        # history ring is attached: diagnose-time samples, bounded to
        # the rule's window (the burn self-sampling pattern).
        self._skew_samples: deque = deque(maxlen=1024)

    # The attributor seam is callable-or-instance: frontends pass
    # obs.attribution.ensure_attributor so a test-swapped recorder
    # transparently resolves to its fresh attributor.
    @property
    def attributor(self):
        a = self._attributor
        return a() if callable(a) else a

    # -- rules ---------------------------------------------------------

    def _rule_hot_shard(self) -> Finding | None:
        if self.mesh is None or not getattr(self.mesh, "sharded", False):
            return None
        report = self.mesh.shard_heat_report()
        skew = float(report.get("skew_score") or 0.0)
        reporters = int(report.get("reporters") or 0)
        if (
            skew < self.cfg.hot_shard_skew
            or reporters < self.cfg.hot_shard_min_reporters
        ):
            return None
        shard = report.get("hot_shard")
        owners = sorted(report.get("hot_owners", []))
        return Finding(
            "hot_shard",
            min(1.0, 0.5 + skew / (8.0 * self.cfg.hot_shard_skew)),
            f"shard {shard} is soaking the fleet (skew {skew:.1f}, "
            f"owners {owners}) — rebalance or raise its RF",
            {
                "skew_score": round(skew, 4),
                "shard": shard,
                "owners": owners,
                "reporters": reporters,
            },
        )

    def _rule_prefill_convoy(self) -> Finding | None:
        attr = self.attributor
        if attr is None:
            return None
        shapes = {
            k: v
            for k, v in attr.by_shape().items()
            if v["count"] >= self.cfg.convoy_min_requests and v["e2e_s"] > 0
        }
        if not shapes:
            return None
        worst = None
        for shape, agg in shapes.items():
            share = agg["phases"].get("prefill", 0.0) / agg["e2e_s"]
            mean_e2e = agg["e2e_s"] / agg["count"]
            others = [
                (o["e2e_s"], o["count"])
                for k, o in shapes.items()
                if k != shape
            ]
            other_mean = (
                sum(e for e, _ in others) / max(1, sum(c for _, c in others))
                if others
                else 0.0
            )
            if share < self.cfg.convoy_prefill_share:
                continue
            if others and mean_e2e < other_mean * self.cfg.convoy_slowdown:
                # Prefill-heavy but not slower than the rest of the
                # traffic: batch-1-style workloads are prefill-dominant
                # by nature, not convoyed.
                continue
            cand = (share, shape, mean_e2e, other_mean, agg["count"])
            if worst is None or cand > worst:
                worst = cand
        if worst is None:
            return None
        share, shape, mean_e2e, other_mean, count = worst
        return Finding(
            "prefill_convoy",
            min(1.0, 0.4 + share / 2.0),
            f"shape {shape} spends {share:.0%} of its e2e in prefill "
            f"waves ({mean_e2e * 1e3:.0f} ms mean e2e vs "
            f"{other_mean * 1e3:.0f} ms fleet) — long prompts are "
            "convoying; interleave chunked prefill with decode",
            {
                "shape": shape,
                "prefill_share": round(share, 4),
                "mean_e2e_s": round(mean_e2e, 6),
                "fleet_mean_e2e_s": round(other_mean, 6),
                "requests": count,
            },
        )

    def _rule_restore_park_stall(self) -> Finding | None:
        eng = self.engine
        attr = self.attributor
        parked = restores_queued = 0
        if eng is not None:
            parked = len(getattr(eng, "_restoring", ()))
            plane = getattr(eng, "kv_transfer", None)
            if plane is not None:
                st = plane.stats()
                restores_queued = int(st.get("restores_queued", 0)) + int(
                    st.get("staged_chunks", 0)
                )
        park_p99 = park_share = 0.0
        if attr is not None:
            hist = attr.phase_hist("restore_park")
            total = sum(attr.phase_totals().values())
            if hist is not None and hist.count:
                park_p99 = hist.quantile(0.99)
                park_share = hist.sum / total if total > 0 else 0.0
        live_stall = (
            parked >= self.cfg.park_min_parked and restores_queued > 0
        )
        audited_stall = park_share > self.cfg.park_share
        if not (live_stall or audited_stall):
            return None
        return Finding(
            "restore_park_stall",
            min(1.0, 0.4 + 0.1 * parked + park_share),
            f"{parked} request(s) parked in RESTORING behind "
            f"{restores_queued} queued restore unit(s) "
            f"(park share {park_share:.0%}, p99 {park_p99 * 1e3:.0f} ms) "
            "— the restore lane is throttled; raise chunk size or lane "
            "concurrency",
            {
                "lane": "restore",
                "parked": parked,
                "restores_queued": restores_queued,
                "park_p99_s": round(park_p99, 6),
                "park_share": round(park_share, 4),
            },
        )

    def _rule_replication_lag(self) -> Finding | None:
        if self.mesh is None:
            return None
        fleet = getattr(self.mesh, "fleet", None)
        if fleet is None:
            return None
        lagging = {
            rank: round(d.replication_lag_s, 4)
            for rank, d in fleet.digests().items()
            if d.replication_lag_s > self.cfg.lag_threshold_s
        }
        if not lagging:
            return None
        worst = max(lagging.values())
        return Finding(
            "replication_lag",
            min(1.0, 0.4 + 0.1 * worst / self.cfg.lag_threshold_s),
            f"{len(lagging)} node(s) applying oplog frames "
            f"{worst:.1f}s after origin (threshold "
            f"{self.cfg.lag_threshold_s}s): {sorted(lagging)} — "
            "replicas are stale; failover there would lose prefix hits",
            {
                "ranks": {str(r): v for r, v in sorted(lagging.items())},
                "threshold_s": self.cfg.lag_threshold_s,
                "worst_lag_s": worst,
            },
        )

    def _rule_slo_burn_rate(self) -> Finding | None:
        slo = self.slo
        if slo is None:
            return None
        if not self._burn_fed_by_history:
            # Doctors whose tracker isn't fed by a sampler tick (no
            # history, or a history built without an SLO seam) still
            # self-sample at diagnose time; history-fed ones must not
            # double-sample.
            self.burn_tracker.sample(slo.burn_counts())
        cfg = self.cfg
        worst: Finding | None = None
        for tenant in self.burn_tracker.tenants():
            fast, offered = self.burn_tracker.burn(
                tenant, cfg.burn_fast_window_s
            )
            slow, _ = self.burn_tracker.burn(tenant, cfg.burn_slow_window_s)
            if offered < cfg.burn_min_requests:
                continue
            if (
                fast < cfg.burn_fast_threshold
                or slow < cfg.burn_slow_threshold
            ):
                continue
            f = Finding(
                "slo_burn_rate",
                min(1.0, 0.6 + fast / (10.0 * cfg.burn_fast_threshold)),
                f"tenant {tenant!r} burning error budget at "
                f"{fast:.1f}x over {cfg.burn_fast_window_s:.0f}s AND "
                f"{slow:.1f}x over {cfg.burn_slow_window_s:.0f}s "
                f"(budget {cfg.burn_budget:.2%} shed) — sustained "
                "overload, not a blip",
                {
                    "tenant": tenant,
                    "burn_fast": round(fast, 3),
                    "burn_slow": round(slow, 3),
                    "fast_window_s": cfg.burn_fast_window_s,
                    "slow_window_s": cfg.burn_slow_window_s,
                    "budget": cfg.burn_budget,
                    "tier": int(getattr(slo, "tier", 0)),
                },
            )
            if worst is None or f.score > worst.score:
                worst = f
        return worst

    def _rule_spec_efficiency(self) -> Finding | None:
        eng = self.engine
        if eng is None:
            return None
        spec = eng.spec_report()
        worst = None
        for shape, c in spec.items():
            if c["proposed"] < self.cfg.spec_min_proposed:
                continue
            if c["acceptance"] >= self.cfg.spec_accept_floor:
                continue
            cand = (
                self.cfg.spec_accept_floor - c["acceptance"], shape, c,
            )
            if worst is None or cand > worst:
                worst = cand
        if worst is None:
            return None
        _, shape, c = worst
        return Finding(
            "spec_efficiency",
            min(1.0, 0.3 + (self.cfg.spec_accept_floor - c["acceptance"])),
            f"shape {shape} accepts only {c['acceptance']:.0%} of "
            f"{c['proposed']} proposed draft tokens (floor "
            f"{self.cfg.spec_accept_floor:.0%}) — speculative verify "
            "waves are wasted compute there; shrink γ for that class",
            {
                "shape": shape,
                "proposed": c["proposed"],
                "accepted": c["accepted"],
                "acceptance": c["acceptance"],
            },
        )

    def _skew_trajectory(
        self, now: float
    ) -> tuple[list[tuple[float, float]], bool]:
        """((t, skew) points covering the trailing rule window, exact):
        the history ring's change-compressed ``shard:skew_ratio`` series
        when one is attached (dense regardless of diagnose cadence —
        a gap means the value did NOT change, so persistence is exact),
        else this doctor's own diagnose-time samples (a gap means
        nobody LOOKED — persistence must be capped)."""
        hist = self.history
        if hist is not None:
            try:
                q = hist.query(family="shard:skew_ratio", limit=100000)
                s = q["series"].get("shard:skew_ratio")
                if s is not None:
                    return [(p[1], float(p[2])) for p in s["points"]], True
            except Exception:  # noqa: BLE001 — a broken seam degrades to self-sampling
                pass
        mesh = self.mesh
        skew = 0.0
        if mesh is not None and getattr(mesh, "sharded", False):
            skew = float(mesh.fleet.shard_heat().get("skew_score") or 0.0)
        self._skew_samples.append((now, skew))
        return list(self._skew_samples), False

    @staticmethod
    def _sustained_above(
        pts,
        threshold: float,
        start: float,
        end: float,
        max_gap_s: float | None = None,
    ) -> tuple[float, float]:
        """(seconds above threshold, peak value) over [start, end].
        Each point's value persists until the next point — or at most
        ``max_gap_s`` when given (self-sampled trajectories: a sparse
        poll proves nothing about the time nobody looked, so two
        momentary spikes must not smear into a sustained storm)."""
        above_s = 0.0
        peak = 0.0
        for i, (t, v) in enumerate(pts):
            nxt = pts[i + 1][0] if i + 1 < len(pts) else end
            if max_gap_s is not None:
                nxt = min(nxt, t + max_gap_s)
            seg_start = max(t, start)
            seg_end = min(nxt, end)
            if seg_end <= seg_start:
                continue
            peak = max(peak, v)
            if v >= threshold:
                above_s += seg_end - seg_start
        return above_s, peak

    def _rule_rebalancer_asleep(self) -> Finding | None:
        mesh = self.mesh
        if mesh is None or not getattr(mesh, "sharded", False):
            return None
        cfg = self.cfg
        now = self._now()
        pts, exact = self._skew_trajectory(now)
        sustained, peak = self._sustained_above(
            pts, cfg.hot_shard_skew, now - cfg.rebalance_window_s, now,
            max_gap_s=None if exact else cfg.rebalance_max_sample_gap_s,
        )
        if sustained < cfg.rebalance_sustain_s:
            return None
        plane = getattr(mesh, "rebalance", None)
        moves = (
            plane.moves_in_window(cfg.rebalance_window_s)
            if plane is not None
            else 0
        )
        if moves > 0:
            return None
        hot = mesh.fleet.shard_heat().get("hot_shard")
        why = (
            "no rebalance plane is armed"
            if plane is None
            else "the rebalance plane adopted zero moves"
        )
        return Finding(
            "rebalancer_asleep",
            min(1.0, 0.5 + peak / (8.0 * cfg.hot_shard_skew)),
            f"skew held >= {cfg.hot_shard_skew:.1f} for {sustained:.0f}s "
            f"(peak {peak:.1f}, hot shard {hot}) while {why} in the "
            f"same {cfg.rebalance_window_s:.0f}s window — the heat map "
            "sees a storm nothing is acting on",
            {
                "skew_peak": round(peak, 4),
                "sustained_s": round(sustained, 3),
                "window_s": cfg.rebalance_window_s,
                "moves_in_window": int(moves),
                "hot_shard": hot,
                "plane_armed": plane is not None,
            },
        )

    def _rule_tier_thrash(self) -> Finding | None:
        cfg = self.cfg
        now = self._now()
        events: list[tuple[float, int, str]] = []
        source = None
        hist = self.history
        if hist is not None:
            try:
                q = hist.query(
                    family="radixmesh_kv_tier_moves_total", limit=100000
                )
                events = _tier_move_events(q["series"])
                if events:
                    source = "history"
            except Exception:  # noqa: BLE001 — a broken seam degrades to the live ring
                events = []
        if not events:
            tier = getattr(self.engine, "_kv_tier", None) \
                if self.engine is not None else None
            if tier is None:
                return None
            # list() is one C call over the deque (GIL-atomic snapshot,
            # the spec_report discipline).
            events = [
                (t, sh, d)
                for (t, sh, d) in list(tier.recent_moves)
                if d in ("demote", "promote")
            ]
            source = "live"
        events = [
            e for e in events if e[0] >= now - cfg.tier_thrash_window_s
        ]
        best = _max_flap(events, cfg.tier_thrash_window_s)
        if best is None or best[0] < cfg.tier_thrash_min_cycles:
            return None
        cycles, demotes, promotes, shard = best
        return Finding(
            "tier_thrash",
            min(1.0, 0.4 + 0.1 * cycles),
            f"subtree shard {shard} flapped host<->disk {cycles}x "
            f"({demotes} demotes / {promotes} promotes) inside the "
            f"{cfg.tier_thrash_window_s:.0f}s hysteresis window — the "
            "working set straddles the destage watermark; raise the "
            "watermark or the host arena",
            {
                "shard": int(shard),
                "demotes": int(demotes),
                "promotes": int(promotes),
                "cycles": int(cycles),
                "window_s": cfg.tier_thrash_window_s,
                "source": source,
            },
        )

    def _rule_straggler_node(self) -> Finding | None:
        agg = self.aggregator
        if agg is None:
            return None
        cfg = self.cfg
        worst = None
        for signal, family in (
            ("decode_ewma", "fleet:decode_ewma_seconds"),
            ("replication_lag", "fleet:replication_lag_seconds"),
        ):
            vals = {
                r: v for r, v in agg.rank_signal(family).items() if v > 0
            }
            if len(vals) < cfg.straggler_min_ranks:
                continue
            svals = sorted(vals.values())
            # Lower median: with two active ranks the baseline is the
            # FASTER one, so a 2-decode cell can still name its
            # straggler instead of comparing the slow rank to itself.
            median = svals[(len(svals) - 1) // 2]
            rank, v = max(vals.items(), key=lambda kv: kv[1])
            if v < cfg.straggler_floor_s:
                continue
            ratio = v / max(median, 1e-9)
            if ratio < cfg.straggler_ratio:
                continue
            cand = (ratio, signal, rank, v, median, len(vals))
            if worst is None or cand > worst:
                worst = cand
        if worst is None:
            return None
        ratio, signal, rank, v, median, n_ranks = worst
        return Finding(
            "straggler_node",
            min(1.0, 0.5 + ratio / (10.0 * cfg.straggler_ratio)),
            f"rank {rank} is a straggler: {signal} EWMA {v * 1e3:.1f} ms "
            f"vs fleet median {median * 1e3:.1f} ms ({ratio:.1f}x over "
            f"{n_ranks} active ranks) — drain or replace it before the "
            "mesh convoys behind it",
            {
                "rank": str(rank),
                "signal": signal,
                "value_s": round(v, 6),
                "fleet_median_s": round(median, 6),
                "ratio": round(ratio, 3),
                "ranks": n_ranks,
            },
        )

    def _rule_fleet_burn_slope(self) -> Finding | None:
        agg = self.aggregator
        if agg is None:
            return None
        cfg = self.cfg
        report = agg.fleet_burn_report(
            fast_window_s=cfg.burn_fast_window_s,
            slow_window_s=cfg.burn_slow_window_s,
        )
        worst: Finding | None = None
        for tenant, r in report.items():
            if r["offered"] < cfg.fleet_burn_min_requests:
                continue
            if (
                r["burn_fast"] < cfg.fleet_burn_fast_threshold
                or r["burn_slow"] < cfg.fleet_burn_slow_threshold
            ):
                continue
            slope = r["slope_per_s"]
            trend = (
                "and RISING" if slope > 0
                else ("and falling" if slope < 0 else "flat")
            )
            f = Finding(
                "fleet_burn_slope",
                min(
                    1.0,
                    0.5
                    + r["burn_fast"] / (10.0 * cfg.fleet_burn_fast_threshold)
                    + max(0.0, slope),
                ),
                f"tenant {tenant!r} burning error budget FLEET-WIDE at "
                f"{r['burn_fast']:.1f}x (fast) / {r['burn_slow']:.1f}x "
                f"(slow), slope {slope:+.4f}/s {trend} — the pre-scale "
                "signal: add capacity before the per-node pager trips",
                {
                    "tenant": tenant,
                    "burn_fast": r["burn_fast"],
                    "burn_slow": r["burn_slow"],
                    "slope_per_s": slope,
                    "budget": r["budget"],
                    "offered": r["offered"],
                },
            )
            if worst is None or f.score > worst.score:
                worst = f
        return worst

    def _rule_telemetry_gap(self) -> Finding | None:
        agg = self.aggregator
        if agg is None:
            return None
        cfg = self.cfg
        worst = None
        for name, st in agg.peer_status().items():
            stalled = st.get("stalled_s")
            if stalled is None:
                # Never pulled successfully: the aggregator cannot tell
                # a dead peer from one it has not reached yet.
                continue
            thresh = max(cfg.telemetry_gap_s, st.get("gap_threshold_s", 0.0))
            if stalled < thresh:
                continue
            # Disambiguate dead sampler vs dead node via the gossip
            # plane: a rank the FleetView still scores healthy has a
            # live process whose SAMPLER stopped; a rank gossip also
            # lost is simply dead.
            verdict = "unknown"
            rank = st.get("rank")
            if rank is not None and self.mesh is not None:
                try:
                    h = self.mesh.fleet.health().get(rank)
                    if h is not None and h["score"] >= 0.5:
                        verdict = "sampler_dead"
                    else:
                        verdict = "node_dead"
                except Exception:  # noqa: BLE001 — gossip seam optional for the verdict
                    pass
            cand = (stalled, name, rank, st, verdict)
            if worst is None or cand[0] > worst[0]:
                worst = cand
        if worst is None:
            return None
        stalled, name, rank, st, verdict = worst
        what = {
            "sampler_dead": "its process still gossips healthy — the "
            "SAMPLER died, not the node",
            "node_dead": "gossip lost it too — the node is dead",
            "unknown": "no gossip view to disambiguate",
        }[verdict]
        return Finding(
            "telemetry_gap",
            min(1.0, 0.5 + 0.05 * stalled),
            f"peer {name!r} ring stopped advancing {stalled:.1f}s ago "
            f"(last seq {st['seq']}); {what}",
            {
                "peer": name,
                "rank": None if rank is None else str(rank),
                "stalled_s": round(stalled, 3),
                "peer_seq": st["seq"],
                "verdict": verdict,
            },
        )

    def _rule_decode_stall(self) -> Finding | None:
        """Token-timeline stall histogram: enough attributed inter-token
        gaps over the stall threshold, with the DOMINANT cause named —
        this is the per-token refinement of restore_park_stall (which
        sees parks, not the gap each park put into someone's stream)."""
        eng = self.engine
        tl = getattr(eng, "timeline", None) if eng is not None else None
        if tl is None:
            return None
        snap = tl.snapshot(limit=0)
        stalls = snap.get("stalls") or {}
        total = sum(stalls.values())
        if total < self.cfg.decode_stall_min_events:
            return None
        cause = max(stalls, key=stalls.get)
        stall_s = float((snap.get("stall_seconds") or {}).get(cause, 0.0))
        p99 = max(
            (t.get("p99_s") or 0.0 for t in snap.get("itl", {}).values()),
            default=0.0,
        )
        return Finding(
            "decode_stall",
            min(1.0, 0.3 + 0.05 * stall_s + min(0.3, total / 200.0)),
            f"{total} decode stalls (>{snap['stall_threshold_s'] * 1e3:.0f}ms "
            f"inter-token gap), dominant cause {cause!r} "
            f"({stalls[cause]} events, {stall_s:.2f}s of stream time); "
            f"worst tenant p99 ITL {p99 * 1e3:.1f}ms",
            {
                "cause": cause,
                "stalls": total,
                "stall_seconds": round(stall_s, 3),
                "p99_itl_s": round(p99, 6),
                "threshold_s": snap["stall_threshold_s"],
            },
        )

    def _rule_spec_misconfigured(self) -> Finding | None:
        """γ and acceptance diverge: a (tenant, shape, draft-source)
        class keeps proposing wide waves whose EWMA acceptance sits
        under the floor. Distinct from spec_efficiency (raw per-shape
        counters): this judges the LEDGER's smoothed per-class view and
        stays silent when the SLO ladder zeroed γ on purpose."""
        eng = self.engine
        led = getattr(eng, "spec_ledger", None) if eng is not None else None
        if led is None:
            return None
        if getattr(eng, "spec_decode_tokens", 0) <= 0:
            return None  # speculation is off — nothing to mis-tune
        if getattr(led, "last_tier", 0) >= 1:
            return None  # γ zeroed by SLO policy, not by mistuning
        cfg = self.cfg
        worst = None
        for c in led.report().values():
            if c["proposed"] < cfg.spec_misconfig_min_proposed:
                continue
            ewma = c.get("accept_ewma")
            if ewma is None or ewma >= cfg.spec_accept_floor:
                continue
            if c.get("gamma_used", 0) <= 1:
                continue  # already at the narrowest useful γ
            cand = (cfg.spec_accept_floor - ewma, c)
            if worst is None or cand[0] > worst[0]:
                worst = cand
        if worst is None:
            return None
        gap, c = worst
        return Finding(
            "spec_misconfigured",
            min(1.0, 0.3 + gap),
            f"class {c['tenant']}/{c['shape']}/{c['source']} runs "
            f"γ={c['gamma_used']} while EWMA acceptance is "
            f"{c['accept_ewma']:.0%} (floor "
            f"{cfg.spec_accept_floor:.0%}, {c['proposed']} proposed) — "
            "shrink γ for that class or enable --spec-adaptive",
            {
                "tenant": c["tenant"],
                "shape": c["shape"],
                "source": c["source"],
                "gamma": c["gamma_used"],
                "accept_ewma": c["accept_ewma"],
                "proposed": c["proposed"],
            },
        )

    def _rule_goodput_regression(self) -> Finding | None:
        """The history ring's ``goodput:tokens_per_second`` series in
        the trailing recent window fell regress_frac below the preceding
        baseline window — useful throughput collapsed while the fleet is
        still up (the waste decomposition in /debug/tokens says where it
        went)."""
        hist = self.history
        if hist is None:
            return None
        try:
            q = hist.query(family="goodput:tokens_per_second", limit=100000)
            s = q["series"].get("goodput:tokens_per_second")
        except Exception:  # noqa: BLE001 — a broken seam is silence, not a crash
            return None
        if s is None:
            return None
        pts = [(p[1], float(p[2])) for p in s["points"]]
        if len(pts) < 2:
            return None
        cfg = self.cfg
        now = pts[-1][0]
        recent = [v for t, v in pts if t >= now - cfg.goodput_recent_window_s]
        base = [
            v
            for t, v in pts
            if now - cfg.goodput_baseline_window_s
            <= t
            < now - cfg.goodput_recent_window_s
        ]
        if not recent or not base:
            return None
        r = sum(recent) / len(recent)
        b = sum(base) / len(base)
        if b < cfg.goodput_min_tps:
            return None  # idle baseline: nothing to regress from
        drop = (b - r) / b
        if drop < cfg.goodput_regress_frac:
            return None
        return Finding(
            "goodput_regression",
            min(1.0, 0.3 + drop),
            f"useful throughput fell {drop:.0%}: {r:.1f} tok/s over the "
            f"last {cfg.goodput_recent_window_s:.0f}s vs {b:.1f} tok/s "
            "baseline — check the /debug/tokens waste decomposition "
            "(padding vs rejected drafts vs stalls)",
            {
                "recent_tps": round(r, 3),
                "baseline_tps": round(b, 3),
                "drop_frac": round(drop, 4),
                "window_s": cfg.goodput_recent_window_s,
            },
        )

    # -- the diagnosis -------------------------------------------------

    def diagnose(self) -> dict:
        """Run every rule whose inputs are attached; return the ranked
        findings report (the ``GET /cluster/doctor`` body)."""
        checks = {
            "hot_shard": self._rule_hot_shard,
            "prefill_convoy": self._rule_prefill_convoy,
            "restore_park_stall": self._rule_restore_park_stall,
            "replication_lag": self._rule_replication_lag,
            "slo_burn_rate": self._rule_slo_burn_rate,
            "spec_efficiency": self._rule_spec_efficiency,
            "rebalancer_asleep": self._rule_rebalancer_asleep,
            "tier_thrash": self._rule_tier_thrash,
            "straggler_node": self._rule_straggler_node,
            "fleet_burn_slope": self._rule_fleet_burn_slope,
            "telemetry_gap": self._rule_telemetry_gap,
            "decode_stall": self._rule_decode_stall,
            "spec_misconfigured": self._rule_spec_misconfigured,
            "goodput_regression": self._rule_goodput_regression,
        }
        # Seam presence per rule: a rule whose inputs are absent never
        # looked at anything, so it must NOT appear in rules_checked —
        # that list is the honesty field the module contract promises
        # ("no findings" vs "nothing was looked at"), and the healthy-
        # phase gate in bench.validate_doctor is vacuous without it.
        attr = self.attributor
        available = {
            "hot_shard": self.mesh is not None,
            "prefill_convoy": attr is not None,
            "restore_park_stall": self.engine is not None
            or attr is not None,
            "replication_lag": self.mesh is not None,
            "slo_burn_rate": self.slo is not None,
            "spec_efficiency": self.engine is not None,
            "rebalancer_asleep": self.mesh is not None,
            # The tier series ride the history ring even for an
            # engine-less doctor (a frontend sampling a remote
            # registry), so either seam arms the rule.
            "tier_thrash": self.engine is not None
            or self.history is not None,
            # The fleet rules judge the aggregator's cross-node store;
            # no single-node seam can substitute for it.
            "straggler_node": self.aggregator is not None,
            "fleet_burn_slope": self.aggregator is not None,
            "telemetry_gap": self.aggregator is not None,
            # Token-plane rules: the timeline/ledger hang off the
            # engine; the goodput series rides the history ring (so a
            # frontend sampling a remote registry can still run it).
            "decode_stall": self.engine is not None,
            "spec_misconfigured": self.engine is not None,
            "goodput_regression": self.history is not None,
        }
        findings: list[Finding] = []
        checked: list[str] = []
        for rule in RULES:
            if not available[rule]:
                continue
            try:
                f = checks[rule]()
            except Exception as e:  # noqa: BLE001 — a broken rule is a finding, not an outage
                f = Finding(
                    rule, 0.1,
                    f"rule crashed: {e!r} (diagnosis plane bug — file it)",
                    {"error": repr(e)},
                )
            checked.append(rule)
            if f is not None:
                missing = [
                    k
                    for k in RULE_EVIDENCE_FIELDS.get(rule, ())
                    if k not in f.evidence and "error" not in f.evidence
                ]
                if missing:  # pinned-evidence contract, enforced live
                    f.evidence["_missing_evidence"] = missing
                findings.append(f)
        findings.sort(key=lambda f: (-f.score, RULES.index(f.rule)))
        return {
            "findings": [f.as_dict() for f in findings],
            "healthy": not findings,
            "rules_checked": checked,
            "inputs": {
                "mesh": self.mesh is not None,
                "engine": self.engine is not None,
                "slo": self.slo is not None,
                "attribution": self.attributor is not None,
                "history": self.history is not None,
                "aggregator": self.aggregator is not None,
            },
        }


# ---------------------------------------------------------------------------
# post-mortem doctoring: the same judgment, over a black-box dump alone
# ---------------------------------------------------------------------------

# Post-mortem rule ids in severity-tiebreak order. These replay the
# live rules' judgment over RECORDED history series (a dump has no mesh
# or engine object to duck-type), plus the one rule only hindsight can
# run: node_crash.
POSTMORTEM_RULES = (
    "node_crash",
    "hot_shard",
    "replication_lag",
    "slo_burn_rate",
    "tier_thrash",
)

POSTMORTEM_EVIDENCE_FIELDS = {
    "node_crash": ("rank", "window", "detector"),
    "hot_shard": ("shard", "skew_peak", "t_peak"),
    "replication_lag": ("ranks", "threshold_s", "worst_lag_s"),
    "slo_burn_rate": ("tenant", "burn_fast", "burn_slow", "t_peak"),
    "tier_thrash": ("shard", "demotes", "promotes", "cycles", "window_s"),
}


def _labeled_series(series: dict, prefix: str) -> dict[str, list]:
    """label value → points, for series named ``prefix{label="X"}``."""
    out: dict[str, list] = {}
    head = prefix + "{"
    for name, pts in series.items():
        if name.startswith(head) and name.endswith('"}'):
            label = name[len(head):-2].split('="', 1)[-1]
            out[label] = pts
    return out


def _value_at(pts: list, t: float):
    """The change-compressed series' value at time ``t`` (last point at
    or before it); None before the first point."""
    times = [p[1] for p in pts]
    i = bisect.bisect_right(times, t) - 1
    return pts[i][2] if i >= 0 else None


def postmortem_report(dump: dict, cfg: DoctorConfig | None = None) -> dict:
    """Replay the doctor's judgment over a black-box dump
    (``obs/blackbox.py::load_blackbox``) — no live cluster required.
    ``scripts/doctor.py --blackbox`` is the CLI.

    Unlike the live rules, post-mortem rules judge the WHOLE recorded
    window (a pathology that peaked mid-flight and cooled before the
    dump still fired), and they can name the one thing no live rule
    can: the crash itself —

    - ``node_crash`` detector "health_drop": a fleet health score
      falling below 0.5; the window is anchored by the recorded digest
      age at the drop (the node was last heard from ``age`` seconds
      before the drop sample).
    - ``node_crash`` detector "history_truncated": the dump itself ends
      without any final flush (the kill -9 signature) — the crash
      window is the last recorded sample plus one segment of slack.
    """
    cfg = cfg or DoctorConfig()
    series: dict = dump.get("series", {})
    interval = float(dump.get("interval_s") or 1.0)
    findings: list[Finding] = []
    checked: list[str] = []

    # -- node_crash ----------------------------------------------------
    checked.append("node_crash")
    ages = _labeled_series(series, "fleet:health_age_seconds")
    for rank, pts in sorted(
        _labeled_series(series, "fleet:health_score").items()
    ):
        seen_good = False
        for seq, t, v in pts:
            if v >= 0.5:
                seen_good = True
                continue
            if not seen_good:
                # A drop only counts after the rank has been seen
                # healthy; leading sub-0.5 points (sampler started
                # while the digest was still converging) are skipped,
                # not terminal for the rank.
                continue
            age = _value_at(ages.get(rank, []), t) or 0.0
            findings.append(Finding(
                "node_crash",
                0.9,
                f"node rank {rank} went dark: health dropped to {v:.2f} "
                f"at t={t:.1f}, last heard {age:.1f}s earlier — crash "
                f"window [{t - age:.1f}, {t:.1f}]",
                {
                    "rank": rank,
                    "window": [round(t - age, 3), round(t, 3)],
                    "detector": "health_drop",
                    "score_at_drop": v,
                    "age_at_drop_s": round(age, 3),
                },
            ))
            break
    if dump.get("unclean") and dump.get("last_t") is None:
        # The box was armed (a manifest exists) but no history was ever
        # committed and no final flushed: the node died before its
        # first segment — unclean by construction, but with nothing
        # recorded there is no window to anchor.
        findings.append(Finding(
            "node_crash",
            1.0,
            f"node {dump.get('node', '?')}'s black box was armed but "
            "holds NO committed history and NO final flush — unclean "
            "death before the first segment; no crash window can be "
            "anchored",
            {
                "rank": dump.get("node", "?"),
                "window": [None, None],
                "detector": "history_truncated",
                "last_seq": None,
            },
        ))
    if dump.get("unclean") and dump.get("last_t") is not None:
        last_t = float(dump["last_t"])
        slack = interval * float(
            dump.get("manifest", {}).get("segment_every", 1) or 1
        )
        findings.append(Finding(
            "node_crash",
            1.0,
            f"node {dump.get('node', '?')}'s own history ends at "
            f"t={last_t:.1f} with NO final flush — unclean death; crash "
            f"window [{last_t:.1f}, {last_t + slack:.1f}] (one segment "
            "of slack past the last committed sample)",
            {
                "rank": dump.get("node", "?"),
                "window": [round(last_t, 3), round(last_t + slack, 3)],
                "detector": "history_truncated",
                "last_seq": dump.get("last_seq"),
            },
        ))

    # -- hot_shard (peak over the recorded window) ---------------------
    checked.append("hot_shard")
    skew_pts = series.get("shard:skew_ratio", [])
    if skew_pts:
        _, t_peak, skew_peak = max(skew_pts, key=lambda p: p[2])
        if skew_peak >= cfg.hot_shard_skew:
            heats = _labeled_series(series, "shard:heat")
            hot, hot_load = None, -1.0
            for sid, pts in heats.items():
                v = _value_at(pts, t_peak)
                if v is not None and v > hot_load:
                    hot, hot_load = int(sid), v
            if hot is None:
                # Skew peaked but no shard:heat series has a point at
                # or before the peak (heat rings pruned/capped, or the
                # first heat sample landed after the skew one) — a
                # "shard None peaked" finding would name nothing, so
                # record the anomaly as unresolvable instead.
                findings.append(Finding(
                    "hot_shard",
                    0.5,
                    f"skew peaked at {skew_peak:.1f} (t={t_peak:.1f}) "
                    "but the recorded heat series cannot resolve which "
                    "shard — heat rings pruned or absent at the peak",
                    {
                        "shard": None,
                        "skew_peak": round(skew_peak, 4),
                        "t_peak": round(t_peak, 3),
                        "hot_load": None,
                    },
                ))
            else:
                ev = {
                    "shard": hot,
                    "skew_peak": round(skew_peak, 4),
                    "t_peak": round(t_peak, 3),
                    "hot_load": round(hot_load, 4),
                }
                # The final dump's live findings can enrich the owner
                # set (owners are an ownership-map fact no recorded
                # series carries) — present only on dumps that reached
                # a flush.
                final = dump.get("final") or {}
                for f in (final.get("doctor") or {}).get(
                    "findings", ()
                ):
                    if f.get("rule") == "hot_shard" and f.get(
                        "evidence", {}
                    ).get("shard") == hot:
                        ev["owners"] = f["evidence"].get("owners")
                findings.append(Finding(
                    "hot_shard",
                    min(
                        1.0,
                        0.5 + skew_peak / (8.0 * cfg.hot_shard_skew),
                    ),
                    f"shard {hot} peaked at skew {skew_peak:.1f} "
                    f"(t={t_peak:.1f}) over the recorded window",
                    ev,
                ))

    # -- replication_lag (peak per rank) -------------------------------
    checked.append("replication_lag")
    lagging = {}
    for rank, pts in _labeled_series(
        series, "fleet:replication_lag_seconds"
    ).items():
        peak = max((p[2] for p in pts), default=0.0)
        if peak > cfg.lag_threshold_s:
            lagging[rank] = round(peak, 4)
    if lagging:
        findings.append(Finding(
            "replication_lag",
            min(1.0, 0.4 + 0.1 * max(lagging.values()) / cfg.lag_threshold_s),
            f"{len(lagging)} node(s) peaked past {cfg.lag_threshold_s}s "
            f"replication lag in the recorded window: {sorted(lagging)}",
            {
                "ranks": dict(sorted(lagging.items())),
                "threshold_s": cfg.lag_threshold_s,
                "worst_lag_s": max(lagging.values()),
            },
        ))

    # -- slo_burn_rate (worst multi-window point in the record) --------
    checked.append("slo_burn_rate")
    adm = _labeled_series(series, "slo:admitted")
    shed = _labeled_series(series, "slo:shed")
    for tenant in sorted(set(adm) & set(shed)):
        # Recorded series are change-compressed: a gap between points
        # means the counters did not move, so an arbitrarily stale
        # base is EXACT (the counter value at the window start), not a
        # smear risk — a storm that follows a long idle stretch must
        # still be named. No staleness refusal in replay.
        merged = sorted(
            {p[1] for p in adm[tenant]} | {p[1] for p in shed[tenant]}
        )
        tracker = BurnRateTracker(
            cfg.burn_budget, min_spacing_s=0.0,
            max_base_lag_s=float("inf"),
            max_samples=len(merged) + 1,
        )
        worst = None
        for t in merged:
            a = _value_at(adm[tenant], t) or 0.0
            s = _value_at(shed[tenant], t) or 0.0
            tracker.sample(
                {tenant: {"admitted": int(a), "shed": int(s)}}, t=t
            )
            fast, offered = tracker.burn(tenant, cfg.burn_fast_window_s, t=t)
            slow, _ = tracker.burn(tenant, cfg.burn_slow_window_s, t=t)
            if (
                offered >= cfg.burn_min_requests
                and fast >= cfg.burn_fast_threshold
                and slow >= cfg.burn_slow_threshold
                and (worst is None or fast > worst[0])
            ):
                worst = (fast, slow, t)
        if worst is not None:
            fast, slow, t = worst
            findings.append(Finding(
                "slo_burn_rate",
                min(1.0, 0.6 + fast / (10.0 * cfg.burn_fast_threshold)),
                f"tenant {tenant!r} burned error budget at {fast:.1f}x "
                f"(5m) AND {slow:.1f}x (1h) peaking at t={t:.1f} in the "
                "recorded window",
                {
                    "tenant": tenant,
                    "burn_fast": round(fast, 3),
                    "burn_slow": round(slow, 3),
                    "t_peak": round(t, 3),
                },
            ))

    # -- tier_thrash (worst flapping window in the record) -------------
    checked.append("tier_thrash")
    events = _tier_move_events(series)
    best = _max_flap(events, cfg.tier_thrash_window_s)
    if best is not None and best[0] >= cfg.tier_thrash_min_cycles:
        cycles, demotes, promotes, shard = best
        findings.append(Finding(
            "tier_thrash",
            min(1.0, 0.4 + 0.1 * cycles),
            f"subtree shard {shard} flapped host<->disk {cycles}x "
            f"({demotes} demotes / {promotes} promotes) inside one "
            f"{cfg.tier_thrash_window_s:.0f}s window of the recorded "
            "history — the tier was paying a disk round trip per "
            "watermark crossing before the dump",
            {
                "shard": int(shard),
                "demotes": int(demotes),
                "promotes": int(promotes),
                "cycles": int(cycles),
                "window_s": cfg.tier_thrash_window_s,
            },
        ))

    findings.sort(
        key=lambda f: (-f.score, POSTMORTEM_RULES.index(f.rule))
    )
    first_t = None
    for pts in series.values():
        for p in pts:
            if first_t is None or p[1] < first_t:
                first_t = p[1]
    return {
        "source": "blackbox",
        "node": dump.get("node"),
        "unclean": bool(dump.get("unclean")),
        "findings": [f.as_dict() for f in findings],
        "healthy": not findings,
        "rules_checked": checked,
        "window": [
            round(first_t, 3) if first_t is not None else None,
            round(float(dump["last_t"]), 3)
            if dump.get("last_t") is not None
            else None,
        ],
        "samples": int(dump.get("last_seq", -1)) + 1,
        "series": len(series),
    }
