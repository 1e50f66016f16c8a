"""Fleet telemetry plane: gossiped node digests, convergence audit, health.

``obs/metrics.py`` answers "how is THIS node doing"; ``obs/trace_plane.py``
answers "where did THIS request's time go". Neither can answer the two
questions a master-free eventually-consistent mesh raises in production:
*are all replicas' radix trees actually converged*, and *which node is
sick* — the paper's consistency story is exactly the part that is
invisible at runtime. This module supplies the fleet-level counterpart:

- Each prefill/decode node periodically assembles a compact, fixed-size
  :class:`NodeDigest` (cache fill + hit rate, host-tier fill, engine
  batch occupancy, decode step-time EWMA, replication lag, SLO tier,
  membership epoch, and the tree's incrementally-maintained
  order-independent **fingerprint** — ``cache/radix_tree.py``) and
  piggybacks it on the existing oplog ring as an idempotent ``DIGEST``
  op (one frame per interval per node; no new connections, no
  wire-format break for old op kinds — ``cache/oplog.py``).
- Every node (the router included, via the master's fan-out) folds
  received digests into a :class:`FleetView`: comparing fingerprints
  across replicas yields a ``convergence_age_seconds`` per pair (how
  long two trees have disagreed), and per-node health scoring — a stall
  watchdog (batch nonempty but decode not progressing), a
  replication-lag threshold, and an eviction-storm detector — produces
  a 0..1 score the :class:`CacheAwareRouter` consumes behind
  ``--health-aware-routing`` to demote sick nodes.
- Both HTTP frontends surface the view as ``GET /cluster/health`` and
  ``GET /cluster/telemetry`` (``server/http_frontend.py``).

The digest is bounded-size **by construction**: a fixed struct layout
(:data:`DIGEST_BYTE_BUDGET` pins the ceiling; ``tests/test_fleet_plane.py``
lints it), so ring piggybacking stays one small frame regardless of tree
size — the fingerprint compresses the whole tree into 8 bytes.

Health-score formula (documented in ARCHITECTURE.md "Fleet health"):
start at 1.0, then take the MINIMUM over the fired detectors' caps —
stall → 0.0, stale digest → 0.2, replication lag over threshold → 0.3,
eviction storm → 0.6. Deterministic, monotone in badness, and each cap
names its reason so operators see *why* a node was demoted.

Import-light on purpose (stdlib + numpy only — no jax): router nodes
and artifact tests use it without pulling in a backend.
"""

from __future__ import annotations

import itertools
import struct
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from radixmesh_tpu_torch.obs.metrics import get_registry
from radixmesh_tpu_torch.policy.lifecycle import lifecycle_code, lifecycle_from_code
from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = [
    "EVICTION_CAUSES",
    "DIGEST_BYTE_BUDGET",
    "NodeDigest",
    "FleetConfig",
    "FleetView",
    "FleetPlane",
    "eviction_counters",
]

# Eviction causes every dashboard and the storm detector distinguish:
# pressure (capacity / preempt — the pool is too small for the traffic)
# vs policy (ttl expiry / mesh replica trim — deliberate bounds).
EVICTION_CAUSES = ("capacity", "ttl", "preempt", "mesh_trim")
# Causes that count toward the eviction-storm detector (policy evictions
# are expected at steady state; pressure evictions at a sustained rate
# mean the node is thrashing its cache).
_STORM_CAUSES = ("capacity", "preempt")


def eviction_counters(node: str):
    """Per-cause eviction counter children for one node/engine label —
    the single registration point, so the family's label schema cannot
    drift between the engine (capacity/preempt) and the mesh replica
    (ttl/mesh_trim). All four children materialize eagerly so the series
    exist at 0 from process start (dashboards never see gaps)."""
    fam = get_registry().counter(
        "radixmesh_cache_evicted_tokens_total",
        "KV tokens evicted from the radix cache, by cause (capacity/"
        "preempt = pool pressure; ttl/mesh_trim = policy bounds)",
        ("node", "cause"),
    )
    return {c: fam.labels(node=node, cause=c) for c in EVICTION_CAUSES}


# ---------------------------------------------------------------------------
# NodeDigest: the fixed-layout gossip payload
# ---------------------------------------------------------------------------

# v2: the tier byte's high nibble carries the membership-lifecycle code
# (policy/lifecycle.py) — same layout, new INTERPRETATION of that byte.
# The version bump exists for the rolling-upgrade window: a v1 decoder
# reading a v2 digest would misparse BOOTSTRAPPING as slo_tier=16, so it
# must reject-and-log (its version check does) rather than misread;
# v2 decoders still accept v1 digests (full-byte tier, lifecycle
# "active" — factually what a pre-lifecycle node is in).
_DIGEST_VERSION = 2
# magic+version+role+tier, rank, epoch, waiting, seq, decode_steps,
# ts, fingerprint, tree_tokens, 5 floats, 4 eviction counters.
_DIGEST_FMT = "<BBBBiiiqqdQq5f4q"
# Hard ceiling on the serialized digest (lint-enforced): ring
# piggybacking must stay one small frame per interval per node.
DIGEST_BYTE_BUDGET = 160
_DIGEST_MAGIC = 0xFD

_ROLE_CODES = {"prefill": 0, "decode": 1, "router": 2}
_ROLE_NAMES = {v: k for k, v in _ROLE_CODES.items()}


@dataclass
class NodeDigest:
    """One node's periodic self-description, compact enough to ride the
    oplog ring every interval. All rates/fills are instantaneous reads;
    monotone counters (``decode_steps``, ``evictions``) let receivers
    derive progress/rates from consecutive digests."""

    rank: int
    role: str  # "prefill" | "decode" | "router"
    seq: int  # per-node monotonic digest number (newest-wins fold)
    ts: float  # origin wall clock (skew degrades ages, not correctness)
    epoch: int  # membership view epoch at assembly time
    fingerprint: int  # radix-tree fingerprint (cache/radix_tree.py)
    tree_tokens: int  # evictable + protected tokens in the mesh replica
    cache_hit_rate: float  # engine lifetime hit rate, 0..1
    pool_fill: float  # 1 - free/total device KV slots, 0..1
    host_fill: float  # host-tier fill, 0..1 (0 when no host tier)
    batch_occupancy: float  # active rows / max_batch, 0..1
    decode_ewma_s: float  # decode step-time EWMA (seconds/token)
    waiting: int  # queued requests
    decode_steps: int  # lifetime decode steps (stall-watchdog progress)
    replication_lag_s: float = 0.0  # recent oplog origin→apply lag EWMA
    slo_tier: int = 0  # graceful-degradation tier (0 = normal)
    evictions: tuple[int, int, int, int] = (0, 0, 0, 0)  # per EVICTION_CAUSES
    # The origin's publish cadence: receivers size their staleness window
    # from it (a router must not mark a 60s-interval fleet stale at 15s).
    interval_s: float = 0.0
    # Membership lifecycle state (policy/lifecycle.py): the router
    # withholds cache-hit routing from "bootstrapping" nodes and all new
    # work from "draining"/"left" ones. Travels in the HIGH NIBBLE of
    # the existing tier byte (tiers are 0-3, lifecycle codes are 0-3) —
    # same layout and size, but a v2 digest version so a pre-lifecycle
    # decoder rejects-and-logs instead of misreading the nibble as
    # slo_tier=16/32 during a rolling upgrade (v1 digests still decode
    # here: full-byte tier, lifecycle "active").
    lifecycle: str = "active"

    def encode(self) -> np.ndarray:
        """Pack into an int32 array — the shape the oplog wire already
        carries (``Oplog.value``), so digests ride existing frames."""
        raw = struct.pack(
            _DIGEST_FMT,
            _DIGEST_MAGIC,
            _DIGEST_VERSION,
            _ROLE_CODES.get(self.role, 2),
            (lifecycle_code(self.lifecycle) << 4) | (self.slo_tier & 0x0F),
            self.rank,
            self.epoch,
            self.waiting,
            self.seq,
            self.decode_steps,
            self.ts,
            self.fingerprint & ((1 << 64) - 1),
            self.tree_tokens,
            self.cache_hit_rate,
            self.pool_fill,
            self.host_fill,
            self.batch_occupancy,
            self.decode_ewma_s,
            *(int(e) for e in self.evictions),
        )
        # replication_lag_s + interval_s travel as a float32 tail (kept
        # out of the fixed prefix so the format string stays one struct).
        raw += struct.pack("<ff", self.replication_lag_s, self.interval_s)
        pad = (-len(raw)) % 4
        return np.frombuffer(raw + b"\x00" * pad, dtype=np.int32).copy()

    @classmethod
    def decode(cls, arr: np.ndarray) -> "NodeDigest":
        raw = np.ascontiguousarray(np.asarray(arr, dtype=np.int32)).tobytes()
        base = struct.calcsize(_DIGEST_FMT)
        if len(raw) < base + 8:
            raise ValueError(f"digest payload too short ({len(raw)} bytes)")
        (
            magic, version, role_code, tier, rank, epoch, waiting, seq,
            decode_steps, ts, fingerprint, tree_tokens, hit_rate, pool_fill,
            host_fill, batch_occ, decode_ewma, ev0, ev1, ev2, ev3,
        ) = struct.unpack_from(_DIGEST_FMT, raw, 0)
        if magic != _DIGEST_MAGIC:
            raise ValueError(f"bad digest magic {magic:#x}")
        if version not in (1, _DIGEST_VERSION):
            raise ValueError(f"unsupported digest version {version}")
        if version == 1:
            # Pre-lifecycle digest: the whole byte is the tier, and the
            # node factually has no lifecycle machinery → "active".
            slo_tier, lifecycle = tier, "active"
        else:
            slo_tier, lifecycle = tier & 0x0F, lifecycle_from_code(tier >> 4)
        lag, interval = struct.unpack_from("<ff", raw, base)
        return cls(
            rank=rank,
            role=_ROLE_NAMES.get(role_code, "router"),
            seq=seq,
            ts=ts,
            epoch=epoch,
            fingerprint=fingerprint,
            tree_tokens=tree_tokens,
            cache_hit_rate=hit_rate,
            pool_fill=pool_fill,
            host_fill=host_fill,
            batch_occupancy=batch_occ,
            decode_ewma_s=decode_ewma,
            waiting=waiting,
            decode_steps=decode_steps,
            replication_lag_s=lag,
            slo_tier=slo_tier,
            evictions=(ev0, ev1, ev2, ev3),
            interval_s=interval,
            lifecycle=lifecycle,
        )

    def encoded_size(self) -> int:
        return int(self.encode().nbytes)

    def as_dict(self) -> dict:
        return {
            "rank": self.rank,
            "role": self.role,
            "seq": self.seq,
            "ts": self.ts,
            "epoch": self.epoch,
            "fingerprint": f"{self.fingerprint & ((1 << 64) - 1):016x}",
            "tree_tokens": self.tree_tokens,
            "cache_hit_rate": round(self.cache_hit_rate, 4),
            "pool_fill": round(self.pool_fill, 4),
            "host_fill": round(self.host_fill, 4),
            "batch_occupancy": round(self.batch_occupancy, 4),
            "decode_ewma_s": round(self.decode_ewma_s, 6),
            "waiting": self.waiting,
            "decode_steps": self.decode_steps,
            "replication_lag_s": round(self.replication_lag_s, 6),
            "slo_tier": self.slo_tier,
            "evictions": dict(zip(EVICTION_CAUSES, self.evictions)),
            "interval_s": round(self.interval_s, 3),
            "lifecycle": self.lifecycle,
        }


# ---------------------------------------------------------------------------
# FleetView: digests folded into convergence + health state
# ---------------------------------------------------------------------------


@dataclass
class FleetConfig:
    """Detector thresholds. ``stale_after_s`` defaults to 3 digest
    intervals at :class:`FleetPlane` construction time."""

    interval_s: float = 5.0
    stale_after_s: float | None = None
    lag_threshold_s: float = 5.0
    eviction_storm_tokens_per_s: float = 50_000.0

    @property
    def effective_stale_after_s(self) -> float:
        if self.stale_after_s is not None:
            return self.stale_after_s
        return 3.0 * self.interval_s


class FleetView:
    """Per-node latest digests + derived convergence/health state.

    Folds happen on mesh transport-reader threads; reads come from HTTP
    handler threads and the router's hot path — all state is guarded by
    one short lock (folds are O(nodes), reads are O(nodes²) over a
    handful of nodes)."""

    def __init__(self, cfg: FleetConfig | None = None, now=time.time):
        self.cfg = cfg or FleetConfig()
        self._now = now
        self._lock = threading.Lock()
        self._digests: dict[int, NodeDigest] = {}
        self._prev: dict[int, NodeDigest] = {}  # previous distinct digest
        self._stalled: dict[int, bool] = {}
        self._storm_rate: dict[int, float] = {}  # pressure-evict tokens/s
        # (lo, hi) rank pair → wall time their fingerprints were first
        # seen unequal; absent = currently equal (or a side unknown).
        self._diverged_at: dict[tuple[int, int], float] = {}
        # Per-rank per-shard fingerprints (prefix-ownership sharding,
        # cache/sharding.py): folded whole-summary-at-a-time from
        # SHARD_SUMMARY gossip. Under sharding whole-tree fingerprints
        # diverge BY DESIGN, so convergence auditing compares these —
        # per shard, across the ranks that own (and therefore report)
        # it — instead of the scalar digest fingerprint.
        self._shard_fps: dict[int, dict[int, int]] = {}
        # (sid, lo rank, hi rank) → wall time the pair's fingerprints
        # for that shard were first seen unequal.
        self._shard_diverged_at: dict[tuple[int, int, int], float] = {}
        # Per-rank per-shard decayed load (tokens/s) from the heat
        # trailer on SHARD_SUMMARY gossip (cache/sharding.py::ShardHeat)
        # — the cluster heat map + skew score the future rebalancer
        # consumes.
        self._shard_heat: dict[int, dict[int, float]] = {}
        # Per-rank wall-clock skew estimate: min over recent folds of
        # (local wall at fold - digest origin ts). The minimum tracks
        # (skew + fastest observed transit), so it over-estimates skew
        # by at most the best one-way gossip latency — good enough to
        # align trace timelines (obs/trace_plane.py::stitch_traces);
        # never used for correctness.
        self._clock_skew: dict[int, float] = {}
        # Ranks that announced a PLANNED departure (LEAVE oplog): their
        # straggler digests are refused so a frozen fingerprint cannot
        # re-enter the convergence audit or pin min_score after the
        # membership dropped them. A rejoiner's fresh digests (state
        # bootstrapping/active) clear the mark.
        self._left: set[int] = set()
        self.folds = 0  # digests accepted (lifetime)

    # -- fold ----------------------------------------------------------

    def fold(self, d: NodeDigest) -> bool:
        """Fold one digest; newest-by-(ts, seq) wins per rank (idempotent
        — ring re-delivery of an already-seen digest is a no-op). The
        wall clock leads the ordering: a restarted node's seq counter
        resets to 1, and seq-first comparison would reject its fresh
        digests until seq caught up to the pre-crash value — reading a
        healthy rebooted node as stale/sick for hours. seq breaks ties
        within one origin's clock tick. Returns True when the digest
        advanced the view."""
        now = self._now()
        with self._lock:
            if d.rank in self._left:
                if d.lifecycle in ("draining", "left"):
                    # A straggler from a departed node (the LEAVE beat
                    # its final data-lane digests): refuse the fold.
                    return False
                # Fresh state from a rejoiner: the mark is stale.
                self._left.discard(d.rank)
            cur = self._digests.get(d.rank)
            if cur is not None and (d.ts, d.seq) <= (cur.ts, cur.seq):
                return False
            if cur is not None:
                self._prev[d.rank] = cur
            self._digests[d.rank] = d
            self.folds += 1
            self._update_detectors(d, self._prev.get(d.rank))
            self._update_divergence(d, now)
            if d.ts:
                skew = now - d.ts
                prev_skew = self._clock_skew.get(d.rank)
                self._clock_skew[d.rank] = (
                    skew if prev_skew is None else min(prev_skew, skew)
                )
            return True

    def _update_detectors(self, d: NodeDigest, prev: NodeDigest | None) -> None:
        if prev is None or d.ts <= prev.ts:
            return
        # Stall watchdog: two consecutive digests with a nonempty batch
        # and ZERO decode progress between them — the engine is wedged
        # (device hang, scheduler deadlock), not merely idle.
        self._stalled[d.rank] = (
            d.batch_occupancy > 0.0
            and prev.batch_occupancy > 0.0
            and d.decode_steps == prev.decode_steps
        )
        dt = d.ts - prev.ts
        pressure = sum(
            d.evictions[i] - prev.evictions[i]
            for i, c in enumerate(EVICTION_CAUSES)
            if c in _STORM_CAUSES
        )
        self._storm_rate[d.rank] = max(0.0, pressure) / dt

    def _update_divergence(self, d: NodeDigest, now: float) -> None:
        for other_rank, other in self._digests.items():
            if other_rank == d.rank:
                continue
            pair = (min(d.rank, other_rank), max(d.rank, other_rank))
            if d.fingerprint == other.fingerprint:
                self._diverged_at.pop(pair, None)
            else:
                self._diverged_at.setdefault(pair, now)

    def retain(self, ranks) -> None:
        """Forget every rank not in ``ranks`` — called on membership view
        changes so a decommissioned node's last digest cannot pin
        ``min_score`` at the stale cap and its frozen fingerprint cannot
        hold convergence pairs diverged forever. A rank that rejoins
        simply folds fresh digests again."""
        keep = set(ranks)
        with self._lock:
            known = (
                set(self._digests)
                | set(self._shard_fps)
                | set(self._shard_heat)
            )
            for r in [r for r in known if r not in keep]:
                self._forget_locked(r)

    def forget(self, rank: int) -> None:
        """Drop ONE rank's state — the single-rank mirror of
        :meth:`retain`, called when a peer announces a planned LEAVE
        (``policy/lifecycle.py``). Beyond what the view-change retain
        would eventually do, forgetting on the LEAVE itself guarantees a
        later REJOIN starts from a clean slate: the old replication-lag
        EWMA, stall flag, storm rate, and fingerprint all die with the
        departure instead of being inherited by the reincarnation."""
        with self._lock:
            self._forget_locked(rank)

    def _forget_locked(self, rank: int) -> None:
        for store in (self._digests, self._prev, self._stalled,
                      self._storm_rate, self._shard_fps,
                      self._shard_heat, self._clock_skew):
            store.pop(rank, None)
        for pair in [p for p in self._diverged_at if rank in p]:
            del self._diverged_at[pair]
        for key in [k for k in self._shard_diverged_at if rank in k[1:]]:
            del self._shard_diverged_at[key]

    def mark_left(self, rank: int) -> None:
        """Record a planned departure: ``lifecycle_of`` answers "left"
        (the router refuses the node new work even if a stale view still
        lists it) and straggler digests are refused (see ``fold``)."""
        with self._lock:
            self._left.add(rank)

    # -- reads ---------------------------------------------------------

    def digests(self) -> dict[int, NodeDigest]:
        with self._lock:
            return dict(self._digests)

    def fingerprints(self) -> dict[int, int]:
        """rank → last-gossiped tree fingerprint: the anti-entropy
        repair plane's scan input (one lock hold, no digest copies —
        the scan runs every repair interval on every node)."""
        with self._lock:
            return {r: d.fingerprint for r, d in self._digests.items()}

    def fold_shard_fps(self, rank: int, fps: dict[int, int]) -> None:
        """Fold one rank's per-owned-shard fingerprints (whole-summary
        swap — a summary always carries the rank's complete owned set,
        so stale shard entries cannot linger after an ownership change).
        Updates the per-shard divergence clocks against every other
        reporter of the same shard."""
        now = self._now()
        mask = (1 << 64) - 1
        fps = {int(s): int(f) & mask for s, f in fps.items()}
        with self._lock:
            self._shard_fps[rank] = fps
            for other_rank, other in self._shard_fps.items():
                if other_rank == rank:
                    continue
                lo, hi = min(rank, other_rank), max(rank, other_rank)
                for sid in set(fps) | set(other):
                    key = (sid, lo, hi)
                    a, b = fps.get(sid), other.get(sid)
                    if a is None or b is None or a == b:
                        # Not co-reported (owners report only owned
                        # shards, so co-reporting ⇔ co-ownership) or
                        # agreeing: the pair is not diverged on it.
                        self._shard_diverged_at.pop(key, None)
                    else:
                        self._shard_diverged_at.setdefault(key, now)

    def shard_fps(self, rank: int) -> dict[int, int]:
        """One rank's last-summarized shard fingerprints ({} = none
        seen) — the repair plane's owner-scoped scan input."""
        with self._lock:
            return dict(self._shard_fps.get(rank, {}))

    def shard_fingerprints(self) -> dict[int, dict[int, int]]:
        with self._lock:
            return {r: dict(f) for r, f in self._shard_fps.items()}

    def shard_convergence(self) -> dict:
        """Owner-scoped convergence audit (the sharded counterpart of
        :meth:`convergence`): a pair of ranks is compared ONLY on shards
        both report (= both own); ``converged`` means no co-reported
        shard currently disagrees anywhere in the fleet."""
        now = self._now()
        with self._lock:
            diverged = {}
            for (sid, a, b), since in self._shard_diverged_at.items():
                diverged[f"s{sid}:{a}-{b}"] = max(0.0, now - since)
            reporters = len(self._shard_fps)
        max_age = max(diverged.values(), default=0.0)
        return {
            "diverged": diverged,
            "max_convergence_age_s": round(max_age, 3),
            "converged": not diverged,
            "reporters": reporters,
        }

    def fold_shard_heat(self, rank: int, loads: dict[int, float]) -> None:
        """Fold one rank's per-owned-shard decayed loads (whole-summary
        swap, like :meth:`fold_shard_fps` — stale shard entries cannot
        linger past an ownership change). Empty folds CLEAR the rank
        (an owner reporting no traffic is cold, not unknown)."""
        with self._lock:
            if loads:
                self._shard_heat[rank] = {
                    int(s): max(0.0, float(v)) for s, v in loads.items()
                }
            else:
                self._shard_heat.pop(rank, None)

    def shard_heat(self) -> dict:
        """The cluster heat map + skew score.

        Per-shard fleet load = MAX over reporting owners (co-owners see
        the same inserts, so max — not sum — avoids counting one
        insert RF times; pull-through copies on non-owners never report,
        by construction). ``skew_score`` = max/mean over reported
        shards — the load-imbalance trigger the future shard rebalancer
        gates on (ROADMAP item 1's named follow-up); 1.0 = perfectly
        flat, >> 1 = one shard soaking the fleet."""
        with self._lock:
            by_rank = {r: dict(h) for r, h in self._shard_heat.items()}
        shards: dict[int, float] = {}
        for h in by_rank.values():
            for sid, load in h.items():
                shards[sid] = max(shards.get(sid, 0.0), load)
        skew = 0.0
        hot_shard = None
        if shards:
            mean = sum(shards.values()) / len(shards)
            hot_shard = max(shards, key=shards.get)
            skew = (shards[hot_shard] / mean) if mean > 0 else 0.0
        return {
            "shards": {str(s): round(v, 4) for s, v in sorted(shards.items())},
            "by_rank": {
                str(r): {str(s): round(v, 4) for s, v in sorted(h.items())}
                for r, h in sorted(by_rank.items())
            },
            "skew_score": round(skew, 4),
            "hot_shard": hot_shard,
            "reporters": len(by_rank),
        }

    def clock_offsets(self) -> dict[int, float]:
        """rank → estimated wall-clock skew seconds (min-tracked digest
        transit; see the ``_clock_skew`` comment). The stitcher's
        per-node correction input — telemetry-grade, never used for
        correctness."""
        with self._lock:
            return dict(self._clock_skew)

    def lifecycle_of(self, rank: int) -> str:
        """One rank's gossiped membership-lifecycle state ("active" for
        unknown ranks — normal routing is the safe default)."""
        with self._lock:
            if rank in self._left:
                return "left"
            d = self._digests.get(rank)
            return d.lifecycle if d is not None else "active"

    def lifecycles(self) -> dict[int, str]:
        """rank → lifecycle state, one lock hold (the router's per-route
        withhold/exclude computation)."""
        with self._lock:
            out = {r: d.lifecycle for r, d in self._digests.items()}
            for r in self._left:
                out[r] = "left"
            return out

    def diverged_with(self, rank: int) -> dict[int, float]:
        """Peers currently fingerprint-diverged from ``rank``, with
        seconds since each pair was first seen unequal — the per-node
        slice of :meth:`convergence` a repair operator (or /debug
        tooling) asks for when ONE node is under suspicion."""
        now = self._now()
        out: dict[int, float] = {}
        with self._lock:
            for (a, b), since in self._diverged_at.items():
                if rank == a:
                    out[b] = max(0.0, now - since)
                elif rank == b:
                    out[a] = max(0.0, now - since)
        return out

    def convergence(self) -> dict:
        """Pairwise ``convergence_age_seconds``: 0.0 for agreeing pairs,
        else seconds since their fingerprints were first seen unequal."""
        now = self._now()
        diverged = 0
        with self._lock:
            ranks = sorted(self._digests)
            pairs = {}
            for i, a in enumerate(ranks):
                for b in ranks[i + 1:]:
                    since = self._diverged_at.get((a, b))
                    if since is None:
                        pairs[f"{a}-{b}"] = 0.0
                    else:
                        diverged += 1
                        pairs[f"{a}-{b}"] = max(0.0, now - since)
        max_age = max(pairs.values(), default=0.0)
        return {
            "pairs": pairs,
            "max_convergence_age_s": round(max_age, 3),
            # "Converged" = no pair currently disagrees — NOT age == 0
            # (a pair that diverged this instant has age 0 but is not
            # converged).
            "converged": diverged == 0,
        }

    def health(self) -> dict[int, dict]:
        """Per-rank health: {"score": 0..1, "reasons": [...], "age_s": ...}.
        See the module docstring for the score formula."""
        now = self._now()
        out: dict[int, dict] = {}
        with self._lock:
            for rank, d in self._digests.items():
                score, reasons = 1.0, []
                age = max(0.0, now - d.ts)
                if self._stalled.get(rank):
                    score, reasons = 0.0, reasons + ["stall"]
                # Staleness window: the larger of this view's config and
                # 3× the ORIGIN's own advertised cadence — a router with
                # default config must not mark a slow-cadence fleet stale.
                stale_after = max(
                    self.cfg.effective_stale_after_s, 3.0 * d.interval_s
                )
                if age > stale_after:
                    score = min(score, 0.2)
                    reasons.append("stale_digest")
                if d.replication_lag_s > self.cfg.lag_threshold_s:
                    score = min(score, 0.3)
                    reasons.append("replication_lag")
                if (
                    self._storm_rate.get(rank, 0.0)
                    > self.cfg.eviction_storm_tokens_per_s
                ):
                    score = min(score, 0.6)
                    reasons.append("eviction_storm")
                out[rank] = {
                    "score": round(score, 3),
                    "reasons": reasons,
                    "age_s": round(age, 3),
                    "role": d.role,
                    "lifecycle": d.lifecycle,
                }
        return out

    def health_score(self, rank: int) -> float:
        """One rank's score; 1.0 for unknown ranks (no digest yet — a
        booting fleet must not read as universally sick)."""
        with self._lock:
            if rank not in self._digests:
                return 1.0
        return self.health().get(rank, {"score": 1.0})["score"]

    def sick_ranks(self, threshold: float) -> set[int]:
        """Ranks scoring below ``threshold`` — ONE health computation for
        the router's per-request demotion checks (per-address
        health_score calls would rebuild the full dict per candidate)."""
        return {
            r for r, h in self.health().items() if h["score"] < threshold
        }

    def snapshot(self) -> dict:
        """The ``/cluster/telemetry`` body."""
        digs = self.digests()
        out = {
            "nodes": {str(r): d.as_dict() for r, d in sorted(digs.items())},
            "convergence": self.convergence(),
            "folds": self.folds,
        }
        with self._lock:
            sharded = bool(self._shard_fps)
            heated = bool(self._shard_heat)
        if sharded:
            # Under sharding the scalar audit reads diverged by design;
            # the owner-scoped one is the meaningful signal.
            out["shard_convergence"] = self.shard_convergence()
        if heated:
            out["shard_heat"] = self.shard_heat()
        return out


# ---------------------------------------------------------------------------
# FleetPlane: the per-node digester thread
# ---------------------------------------------------------------------------


class FleetPlane:
    """Assembles this node's :class:`NodeDigest` every ``interval_s`` and
    hands it to ``MeshCache.broadcast_digest`` (which folds it locally and
    rings it — ONE oplog frame per interval). ``engine`` and ``slo`` are
    optional seams: cache-only nodes publish mesh-only digests; serving
    nodes add engine occupancy/latency and the SLO tier."""

    def __init__(
        self,
        mesh,
        engine=None,
        slo=None,
        interval_s: float = 5.0,
        cfg: FleetConfig | None = None,
    ):
        self.mesh = mesh
        self.engine = engine
        self.slo = slo  # OverloadController (or anything with ._tier)
        self.cfg = cfg or FleetConfig(interval_s=interval_s)
        self.cfg.interval_s = interval_s
        # The node's view adopts this plane's thresholds so /cluster/health
        # and the router see the detectors the operator configured.
        mesh.fleet.cfg = self.cfg
        self._seq = itertools.count(1)
        self.published = 0  # digests originated (== ring frames spent)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.log = get_logger(f"fleet.{mesh._node_label}")

    # -- digest assembly ----------------------------------------------

    def build_digest(self) -> NodeDigest:
        mesh = self.mesh
        tree = mesh.tree
        eng = self.engine
        tel = eng.telemetry() if eng is not None else {}
        ev = tel.get("evictions", {})
        mesh_ev = mesh.eviction_totals()
        evictions = tuple(
            int(ev.get(c, 0)) + int(mesh_ev.get(c, 0)) for c in EVICTION_CAUSES
        )
        tier = 0
        if self.slo is not None:
            tier = int(getattr(self.slo, "_tier", 0))
        # Membership lifecycle (policy/lifecycle.py): the plane, when one
        # is attached to the mesh, is the single source of truth — this
        # is a READ; only policy/lifecycle.py ever assigns the state.
        lc = getattr(mesh, "lifecycle", None)
        lifecycle = lc.state.value if lc is not None else "active"
        return NodeDigest(
            rank=mesh.rank,
            role=mesh.role.value,
            seq=next(self._seq),
            ts=time.time(),
            epoch=mesh.view.epoch,
            fingerprint=tree.fingerprint_,
            tree_tokens=tree.evictable_size_ + tree.protected_size_,
            cache_hit_rate=float(tel.get("cache_hit_rate", 0.0)),
            pool_fill=float(tel.get("pool_fill", 0.0)),
            host_fill=float(tel.get("host_fill", 0.0)),
            batch_occupancy=float(tel.get("batch_occupancy", 0.0)),
            decode_ewma_s=float(tel.get("decode_ewma_s", 0.0)),
            waiting=int(tel.get("waiting", 0)),
            decode_steps=int(tel.get("decode_steps", 0)),
            replication_lag_s=float(mesh.lag_ewma_s),
            slo_tier=tier,
            evictions=evictions,
            interval_s=self.cfg.interval_s,
            lifecycle=lifecycle,
        )

    def publish_once(self) -> NodeDigest:
        """One assemble+broadcast cycle (tests and the bench drive this
        directly; the thread just calls it on a timer)."""
        d = self.build_digest()
        self.mesh.broadcast_digest(d)
        self.published += 1
        return d

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "FleetPlane":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="fleet-digester"
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
                self.publish_once()
            except Exception:  # noqa: BLE001 — telemetry must not kill the node
                self.log.exception("digest publish failed")
            self._stop.wait(self.cfg.interval_s)
