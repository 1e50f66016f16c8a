"""Heat-driven shard rebalancing: the control plane that CONSUMES the
heat map.

The mesh ships the full measurement substrate — decayed per-shard heat on
SHARD_SUMMARY gossip, the cluster heat map + skew score, hot-owner
attribution — and nothing consumed it: a hot shard's owner set was a
fixed RF-successor walk, so a zipf storm concentrated load on the same
owners until they degraded. This module closes the loop:

- **Ownership overrides** (:class:`ShardOverrides`): an immutable,
  epoch-carried per-shard owner-set override map, gossiped like the
  membership view (new ``REBALANCE`` oplog kind). The effective
  ownership map stays a PURE function of (adopted view, rf, adopted
  overrides) — ``cache/sharding.py::build_ownership`` applies the
  overrides during derivation, so every node (router included) derives
  an identical map from the same inputs with zero coordination.
- **Elastic replication**: a hot shard temporarily RAISES its
  replication factor (extra owners appended to the base walk) so reads
  fan out across more warm replicas; a cooled shard shrinks back to the
  base walk. Boost and shrink thresholds form a hysteresis band
  (``boost_factor`` > ``shrink_factor``) so the map cannot flap on a
  load level that hovers at one threshold.
- **Bounded movement**: at most ``max_moves_per_round`` shards change
  owners per decision round — the same discipline ``get_nodes`` applies
  to RF walks: ownership changes are bounded, never wholesale.
- **Zero-loss moves**: when an adopted override GROWS a shard's owner
  set, the shard's primary (old) owner pushes its entries to the ranks
  that gained ownership through the drain-handoff machinery
  (``MeshCache._reemit_entry`` point-to-point) — in-flight requests on
  the old owners finish normally, new inserts deliver to the new set,
  and owner-scoped anti-entropy repair heals any straggler.

Decision authority: every sharded P/D node runs a :class:`RebalancePlane`
ticker, but only the CURRENT view master (the same failover rule as the
router fan-out) decides — one decider per view, no coordination needed.
A partitioned second decider's overrides lose the (epoch, version)
total order at every receiver, exactly like conflicting TOPO views.

Single-writer contract (lint-pinned like ownership and heat,
``analysis/single_writer.py`` invariant ``single-writer-overrides``):
ONLY this module constructs :class:`ShardOverrides` — everything else
(``MeshCache`` folds, routers, tests) swaps whole immutable instances.
A second decision-maker drifting in elsewhere would fork the owner sets
the delivery plane depends on.
"""

from __future__ import annotations

import struct
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np

from radixmesh_tpu_torch.obs.metrics import get_registry
from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = [
    "ShardOverrides",
    "RebalanceConfig",
    "RebalancePlane",
    "encode_overrides",
    "decode_overrides",
]


class ShardOverrides:
    """Immutable per-shard ownership overrides, totally ordered by
    (epoch, version).

    ``epoch`` is the view epoch the decision was derived against;
    ``version`` is the decider's monotonic round counter within that
    epoch. Receivers adopt only strictly newer pairs (:meth:`supersedes`)
    — an epoch rollback, or a replayed/duplicated frame, is refused.
    ``moves`` maps shard id → explicit owner-rank tuple; shards absent
    from the map keep their base RF-successor walk."""

    __slots__ = ("epoch", "version", "moves")

    def __init__(self, epoch: int, version: int, moves: dict):
        self.epoch = int(epoch)
        self.version = int(version)
        self.moves = {
            int(s): tuple(int(r) for r in ranks)
            for s, ranks in moves.items()
        }

    def supersedes(self, other: "ShardOverrides | None") -> bool:
        """Strict (epoch, version) order: equal pairs do NOT supersede
        (idempotent re-delivery), and a lower epoch never wins no matter
        the version (rollback refused)."""
        if other is None:
            return True
        return (self.epoch, self.version) > (other.epoch, other.version)

    def without_ranks(self, ranks) -> "ShardOverrides":
        """Overrides with every entry naming ANY of ``ranks`` dropped —
        the forget path: when an overridden rank leaves (or dies), its
        shards fall back to the base walk over the survivors instead of
        carrying a pointer at a ghost. (epoch, version) is preserved so
        the filtered map never reads as a new decision."""
        dead = {int(r) for r in ranks}
        if not dead:
            return self
        kept = {
            s: rs for s, rs in self.moves.items() if not (dead & set(rs))
        }
        if len(kept) == len(self.moves):
            return self
        return ShardOverrides(self.epoch, self.version, kept)

    def __len__(self) -> int:
        return len(self.moves)

    def __repr__(self) -> str:
        return (
            f"ShardOverrides(epoch={self.epoch}, version={self.version}, "
            f"moves={len(self.moves)})"
        )


# The canonical empty map (epoch 0, version 0): every MeshCache starts
# here, so the first real decision — any epoch >= 0, version >= 1 —
# supersedes it.
EMPTY_OVERRIDES = ShardOverrides(0, 0, {})


# ---------------------------------------------------------------------------
# REBALANCE wire payload: rides ``Oplog.value`` as an int32 array, the
# same pattern as SHARD_SUMMARY / NodeDigest.
# ---------------------------------------------------------------------------

_MAGIC = 0x60
_WIRE_VERSION = 1
_HDR = struct.Struct("<BBHqq")  # magic, wire ver, n_moves, epoch, version
_MOVE_HDR = struct.Struct("<iH")  # sid, n_owners
_OWNER = struct.Struct("<i")


def _to_i32(raw: bytes) -> np.ndarray:
    pad = (-len(raw)) % 4
    return np.frombuffer(raw + b"\x00" * pad, dtype=np.int32).copy()


def encode_overrides(ovr: ShardOverrides) -> np.ndarray:
    parts = [_HDR.pack(_MAGIC, _WIRE_VERSION, len(ovr.moves),
                       ovr.epoch, ovr.version)]
    for sid in sorted(ovr.moves):
        ranks = ovr.moves[sid]
        parts.append(_MOVE_HDR.pack(int(sid), len(ranks)))
        for r in ranks:
            parts.append(_OWNER.pack(int(r)))
    return _to_i32(b"".join(parts))


def decode_overrides(arr: np.ndarray) -> ShardOverrides:
    raw = np.ascontiguousarray(np.asarray(arr, dtype=np.int32)).tobytes()
    if len(raw) < _HDR.size:
        raise ValueError(f"rebalance payload too short ({len(raw)} bytes)")
    magic, ver, n_moves, epoch, version = _HDR.unpack_from(raw, 0)
    if magic != _MAGIC:
        raise ValueError(f"bad rebalance magic {magic:#x}")
    if ver != _WIRE_VERSION:
        raise ValueError(f"unsupported rebalance wire version {ver}")
    off = _HDR.size
    moves: dict[int, tuple[int, ...]] = {}
    for _ in range(n_moves):
        if len(raw) < off + _MOVE_HDR.size:
            raise ValueError("rebalance payload truncated (move header)")
        sid, n_owners = _MOVE_HDR.unpack_from(raw, off)
        off += _MOVE_HDR.size
        if len(raw) < off + n_owners * _OWNER.size:
            raise ValueError("rebalance payload truncated (owners)")
        ranks = []
        for _ in range(n_owners):
            (r,) = _OWNER.unpack_from(raw, off)
            off += _OWNER.size
            ranks.append(r)
        moves[int(sid)] = tuple(ranks)
    return ShardOverrides(epoch, version, moves)


@dataclass
class RebalanceConfig:
    """Decision thresholds. Defaults are tuned so balanced traffic
    (skew near 1) never moves anything, and the hysteresis band
    (``boost_factor`` > ``shrink_factor``) keeps a hovering load level
    from flapping the map."""

    # Decision cadence (seconds between ticks of the plane thread).
    interval_s: float = 5.0
    # Fleet skew score (max/mean over reported shards) below which the
    # decider does NOTHING — balanced meshes never churn ownership.
    skew_trigger: float = 4.0
    # A shard whose fleet load exceeds boost_factor x the mean gets
    # extra owners (reads fan out). Must exceed shrink_factor.
    boost_factor: float = 3.0
    # A BOOSTED shard shrinks back to its base walk only once its load
    # falls below shrink_factor x the mean — the hysteresis band.
    shrink_factor: float = 1.5
    # Extra owners appended to a hot shard's base walk (per role pool,
    # capped by the ranks actually alive).
    rf_boost: int = 2
    # Bounded movement: at most this many shards change owner sets per
    # decision round (the get_nodes discipline applied to rebalancing).
    max_moves_per_round: int = 4
    # Minimum heat reporters before any decision (one node's view of a
    # cold fleet must not trigger churn).
    min_reporters: int = 1


class RebalancePlane:
    """The decider thread + decision bookkeeping for one node.

    Every sharded P/D node runs one; only the current view master acts
    (``tick`` is a no-op elsewhere), so there is exactly one decider per
    adopted view with zero election machinery. Adopted decisions flow
    through ``mesh.adopt_overrides`` — the same fold path gossiped
    REBALANCE frames take — so the decider is not special on the apply
    side.

    Thread model: ``_lock`` guards the move log and decision counters;
    the mesh's own lock serializes everything ownership-related (the
    plane never touches mesh internals outside public mesh methods).
    """

    def __init__(
        self,
        mesh,
        cfg: RebalanceConfig | None = None,
        clock=time.monotonic,
        wait=None,
    ):
        self.mesh = mesh
        self.cfg = cfg or RebalanceConfig()
        self._clock = clock
        self._stop = threading.Event()
        # Injectable wait (virtual-time tests); default parks on the
        # stop event so close() interrupts the tick sleep immediately.
        self._wait = wait or self._stop.wait
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._version = 0
        self._rounds = 0
        self._decisions = 0
        # (monotonic t, cause, sid) per adopted move — the doctor's
        # "did anything move in this window" seam. Bounded.
        self._move_log: deque = deque(maxlen=512)
        self.log = get_logger(f"rebalance@{mesh.rank}")

        reg = get_registry()
        node = getattr(mesh, "_node_label", f"rank{mesh.rank}")
        self._node = node
        moves = reg.counter(
            "radixmesh_rebalance_moves_total",
            "adopted shard ownership changes by cause (rf_boost = hot "
            "shard gained owners; rf_shrink = cooled shard returned to "
            "its base walk; move = explicit owner-set replacement)",
            ("node", "cause"),
        )
        self._m_moves = {
            c: moves.labels(node=node, cause=c)
            for c in ("rf_boost", "rf_shrink", "move")
        }
        # Per-shard boost depth: extra owners currently granted beyond
        # the base walk. Zeroed on shrink (a scraped gauge has no
        # whole-map swap), same discipline as the heat gauges.
        self._g_boost = reg.gauge(
            "radixmesh_shard_rf_boost",
            "extra owners a shard currently holds beyond its base "
            "RF-successor walk (elastic replication; 0 = base walk)",
            ("node", "shard"),
        )
        self._boost_gauge_sids: set[int] = set()
        # Read-only seam for the doctor ("rebalancer asleep" rule) and
        # the frontends' status blocks. The mesh never calls back in.
        mesh.rebalance = self

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "RebalancePlane":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="rebalance-plane"
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        if getattr(self.mesh, "rebalance", None) is self:
            self.mesh.rebalance = None

    def _run(self) -> None:
        while not self._stop.is_set():
            if self._wait(self.cfg.interval_s):
                return
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — a decision bug must not kill the ticker
                self.log.exception("rebalance tick failed")

    # -- the decision round --------------------------------------------

    def is_decider(self) -> bool:
        """Only the current view master decides — the same
        lowest-alive-rank failover rule the router fan-out uses, so a
        dead decider's successor takes over on the next adopted view."""
        mesh = self.mesh
        return (
            getattr(mesh, "sharded", False)
            and mesh.view.contains(mesh.rank)
            and mesh.rank == mesh.view.master_rank()
        )

    def tick(self) -> dict:
        """One decision round. Reads the fleet heat map, applies the
        boost/shrink policy under the movement bound, and adopts +
        gossips the resulting overrides through the mesh. Returns a
        report (all zeros on non-deciders / balanced fleets)."""
        report = {
            "decider": False, "skew": 0.0, "boosted": [], "shrunk": [],
            "adopted": False, "version": self._version,
        }
        if not self.is_decider():
            return report
        report["decider"] = True
        cfg = self.cfg
        mesh = self.mesh
        heat = mesh.fleet.shard_heat()
        report["skew"] = float(heat.get("skew_score") or 0.0)
        shards: dict[int, float] = {
            int(s): float(v) for s, v in heat.get("shards", {}).items()
        }
        cur = mesh.overrides
        if int(heat.get("reporters") or 0) < cfg.min_reporters:
            return report
        mean = (sum(shards.values()) / len(shards)) if shards else 0.0
        moves = dict(cur.moves)
        boosted: list[int] = []
        shrunk: list[int] = []
        budget = cfg.max_moves_per_round
        # Shrink first (hysteresis): boosted shards whose load fell
        # below the band's floor return to the base walk. Shrinking
        # frees budget for this round's boosts. Only BOOST-shaped
        # entries (a strict superset of the base walk) are elastic —
        # an explicit propose() replacement is an operator decision the
        # load policy must not quietly revert.
        for sid in sorted(moves):
            if budget <= 0:
                break
            base = set(self.mesh.base_owners_of(sid))
            if not base < set(moves[sid]):
                continue  # explicit owner-set replacement: not elastic
            load = shards.get(sid, 0.0)
            if mean <= 0.0 or load < cfg.shrink_factor * mean:
                del moves[sid]
                shrunk.append(sid)
                budget -= 1
        # Boost: only on a skewed fleet, hottest first, bounded. ONE
        # rank-load snapshot for the whole round — per-shard recomputes
        # would rank each boost against a slightly different decayed
        # fleet view.
        if report["skew"] >= cfg.skew_trigger and mean > 0.0:
            hot = sorted(
                (
                    sid for sid, load in shards.items()
                    if load > cfg.boost_factor * mean and sid not in moves
                ),
                key=lambda s: -shards[s],
            )
            load_by_rank = self._rank_loads() if hot else {}
            for sid in hot:
                if budget <= 0:
                    break
                grown = self._boosted_owner_set(sid, load_by_rank)
                if grown is None:
                    continue
                moves[sid] = grown
                boosted.append(sid)
                budget -= 1
        if not boosted and not shrunk:
            return report
        self._version += 1
        new = ShardOverrides(mesh.view.epoch, self._version, moves)
        adopted = mesh.adopt_overrides(new)
        now = self._clock()
        with self._lock:
            self._rounds += 1
            if adopted:
                self._decisions += 1
                for sid in boosted:
                    self._move_log.append((now, "rf_boost", sid))
                    self._m_moves["rf_boost"].inc()
                for sid in shrunk:
                    self._move_log.append((now, "rf_shrink", sid))
                    self._m_moves["rf_shrink"].inc()
        if adopted:
            self._set_boost_gauges(new)
            self.log.info(
                "rebalance round %d adopted (epoch=%d version=%d): "
                "boosted %s, shrunk %s (skew %.2f)",
                self._rounds, new.epoch, new.version, boosted, shrunk,
                report["skew"],
            )
        report.update(
            boosted=boosted, shrunk=shrunk, adopted=bool(adopted),
            version=self._version,
        )
        return report

    def propose(self, sid: int, owners, cause: str = "move") -> bool:
        """Explicit owner-set replacement for one shard (operator /
        test seam — the drain-style handoff and fold semantics are
        identical to a policy decision). Decider-only."""
        if not self.is_decider():
            return False
        mesh = self.mesh
        moves = dict(mesh.overrides.moves)
        moves[int(sid)] = tuple(int(r) for r in owners)
        self._version += 1
        new = ShardOverrides(mesh.view.epoch, self._version, moves)
        adopted = mesh.adopt_overrides(new)
        if adopted:
            now = self._clock()
            with self._lock:
                self._decisions += 1
                self._move_log.append((now, cause, int(sid)))
            self._m_moves.get(cause, self._m_moves["move"]).inc()
            self._set_boost_gauges(new)
        return bool(adopted)

    def _boosted_owner_set(
        self, sid: int, load_by_rank: dict[int, float]
    ) -> tuple[int, ...] | None:
        """The hot shard's base walk plus up to ``rf_boost`` extra
        least-loaded alive ranks per role — base owners always keep
        their seats (boost never orphans in-flight traffic), and the
        per-role append preserves the failover invariant that each serving
        role holds survivor replicas. None = nothing to add."""
        mesh = self.mesh
        base = mesh.base_owners_of(sid)
        alive = [r for r in mesh.view.alive if r not in base]
        if not alive:
            return None
        extras: list[int] = []
        is_prefill = mesh.cfg.is_prefill_rank
        for role_pool in (
            [r for r in alive if is_prefill(r)],
            [r for r in alive if not is_prefill(r)],
        ):
            role_pool.sort(key=lambda r: (load_by_rank.get(r, 0.0), r))
            extras.extend(role_pool[: self.cfg.rf_boost])
        if not extras:
            return None
        return tuple(base) + tuple(extras)

    def _rank_loads(self) -> dict[int, float]:
        """rank → total reported shard load (the boost target picker's
        least-loaded ordering input)."""
        heat = self.mesh.fleet.shard_heat()
        out: dict[int, float] = {}
        for rank_s, per_shard in heat.get("by_rank", {}).items():
            out[int(rank_s)] = sum(per_shard.values())
        return out

    def _set_boost_gauges(self, ovr: ShardOverrides) -> None:
        mesh = self.mesh
        depths = {
            sid: max(0, len(ranks) - len(mesh.base_owners_of(sid)))
            for sid, ranks in ovr.moves.items()
        }
        for sid, depth in depths.items():
            self._g_boost.labels(node=self._node, shard=str(sid)).set(
                float(depth)
            )
        for sid in self._boost_gauge_sids - set(depths):
            self._g_boost.labels(node=self._node, shard=str(sid)).set(0.0)
        self._boost_gauge_sids = set(depths)

    # -- seams ----------------------------------------------------------

    def moves_in_window(self, window_s: float) -> int:
        """Adopted moves within the trailing window — the doctor's
        "rebalancer asleep" evidence input."""
        cutoff = self._clock() - window_s
        with self._lock:
            return sum(1 for t, _, _ in self._move_log if t >= cutoff)

    def stats(self) -> dict:
        with self._lock:
            return {
                "rounds": self._rounds,
                "decisions": self._decisions,
                "version": self._version,
                "moves_logged": len(self._move_log),
                "decider": self.is_decider(),
            }
