"""MeshCache: the distributed radix prefix cache.

Capability parity with the reference's ``RadixMesh``
(``radix/radix_mesh.py:72-495``), re-designed rather than translated:

- **Roles**: PREFILL / DECODE nodes hold real KV (slot indices into their
  local :class:`PagedKVPool`); the ROUTER holds a rank-only replica used for
  cache-aware routing (``radix_mesh.py:76-84``, ``core_enum.py:4-7``).
- **Replication**: every local insert is broadcast as an idempotent INSERT
  oplog around a TCP ring of prefill+decode nodes; the master (rank 0) fans
  every oplog out to the router, which never sends
  (``radix_mesh.py:325-347``, ``sync_algo.py:57-96``). TTLs bound each oplog
  to one ring lap. Receivers apply then forward with the decremented TTL —
  unlike the reference, which re-enters its local send path with a *fresh*
  TTL and relies on the origin-drop check to terminate
  (``radix_mesh.py:335,401``).
- **Conflict resolution**: multi-writer conflicts (different origin rank for
  the same prefix) resolve to the lowest origin rank on every node
  (``policy/conflict.py``); the losing value is recorded in ``dup_nodes``
  for distributed GC (``radix_mesh.py:273-323,466-495``).
- **Distributed GC**: each prefill/decode node periodically rings a
  GC_QUERY for its unlocked duplicates; peers vote; unanimity (= ring size)
  at the origin frees the duplicate's KV slots on its owner and a GC_EXEC
  lap retires the entry everywhere (``radix_mesh.py:148-166,362-389``).
  Reference quirks fixed: the GC thread no longer exits permanently the
  first time it finds nothing (``radix_mesh.py:157-158``), GC payloads
  survive serialization (``cache_oplog.py:58-66``), and ``dup_nodes`` is
  guarded by the same lock as the tree (it's a plain dict shared across
  three threads in the reference, ``radix_mesh.py:97,310,365,476``).
- **Startup barrier**: the tick originator rings a TICK with a two-lap TTL;
  every node (router included, via master fan-out) blocks in
  :meth:`wait_ready` until it has seen two laps — proof the ring is
  connected (``radix_mesh.py:118-135,435-445``, reference ``README.md:91-93``).
- **DELETE** is implemented (unlocked exact-key leaf removal, replicated)
  instead of the reference's no-op stub (``radix_mesh.py:417-418,428-429``).

Threading model: one re-entrant lock serializes all tree + dup_nodes
mutation; transport reader threads, the ticker, the GC thread, and user
threads all take it. Tree operations are microseconds, so contention is not
a factor at oplog rates; KV data movement never holds the lock (it rides
ICI collectives / the engine's jitted ops, not this control plane).

Outbound oplogs are **enqueued under the lock** (so wire order always
matches each origin's local application order — one node's racing
non-commutative ops can never replicate out of order) and transmitted by a
dedicated sender thread, so the network is never touched while holding the
lock: an unreachable ring successor cannot stall local match/insert
traffic. The queue is bounded; a peer outage long enough to fill it drops
oplogs with a counter + log line rather than growing the heap or blocking
— safe because the tree is a *cache*: a missed INSERT costs a replica a
cache hit, not correctness.

Consistency model (same as the reference's, ``README.md:60-67``): per-origin
FIFO + idempotent ops + rank-total-order conflict resolution give eventual
convergence for INSERTs. Cross-origin DELETE/INSERT races can leave a key
present on some replicas and absent on others — tolerated deliberately,
again by cache semantics (the replica that kept it serves extra hits; the
one that dropped it re-misses). Strict convergence would need tombstoned
logical clocks, which nothing downstream requires.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass

import numpy as np

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # kv_pool imports torch; a cache-only node never needs it
    from radixmesh_tpu_torch.cache.kv_pool import PagedKVPool
from radixmesh_tpu_torch.cache.mesh_values import (
    AdvertisedValue,
    PrefillValue,
    RouterValue,
)
from radixmesh_tpu_torch.cache.oplog import (
    GCEntry,
    NodeKey,
    Oplog,
    OplogType,
    deserialize,
    emit_version,
    patched_frame,
    serialize,
)
from radixmesh_tpu_torch.cache.radix_tree import (
    MatchResult,
    RadixTree,
    TreeNode,
    as_key,
    root_page_hash,
)
from radixmesh_tpu_torch.cache.rebalance import (
    EMPTY_OVERRIDES,
    decode_overrides,
    encode_overrides,
)
from radixmesh_tpu_torch.cache.sharding import (
    MAX_SUMMARY_ROOTS,
    ShardHeat,
    ShardSummaryTable,
    build_ownership,
    decode_shard_summary,
    encode_shard_summary,
    shard_of_tokens,
)
from radixmesh_tpu_torch.comm.communicator import Communicator, create_communicator
from radixmesh_tpu_torch.config import MeshConfig, NodeRole
from radixmesh_tpu_torch.obs.fleet_plane import FleetView, NodeDigest, eviction_counters
from radixmesh_tpu_torch.obs.metrics import get_registry
from radixmesh_tpu_torch.obs.trace_plane import get_recorder
from radixmesh_tpu_torch.obs.tracing import recorded
from radixmesh_tpu_torch.policy.conflict import NodeRankConflictResolver
from radixmesh_tpu_torch.policy.hierarchy import HierPlan, auto_group_size
from radixmesh_tpu_torch.policy.sync_algo import BaseSyncAlgo, get_sync_algo
from radixmesh_tpu_torch.policy.topology import (
    TopologyView,
    decode_view,
    encode_view,
    membership_gauges,
)
from radixmesh_tpu_torch.utils.logging import get_logger, throttled
from radixmesh_tpu_torch.utils.sync import AtomicCounter

__all__ = ["MeshCache", "RouterMatchResult"]


@dataclass
class RouterMatchResult:
    """Router-mode match: which nodes hold the longest cached prefix
    (reference ``RouterMatchResult``, ``radix_mesh.py:66-69``). ``-1`` means
    no node of that role holds any of the prefix."""

    prefill_rank: int
    decode_rank: int
    match_len: int = 0


class MeshCache:
    def __init__(
        self,
        cfg: MeshConfig,
        pool: PagedKVPool | None = None,
        sync_algo: BaseSyncAlgo | None = None,
        resolver: type[NodeRankConflictResolver] = NodeRankConflictResolver,
    ):
        cfg.validate()
        self.cfg = cfg
        self.role, self.rank, self.local_rank = cfg.local_identity()
        self.pool = pool
        self.sync = sync_algo or get_sync_algo()
        self.resolver = resolver
        self.log = get_logger(f"mesh.{self.role.value}@{self.rank}")

        # Replication granularity (cfg.page_size). The reference pins
        # token granularity (radix_mesh.py:87-89, page_size=1) and that
        # stays the compatibility default; with page_size = N > 1 the
        # mesh tree aligns node boundaries to N-token pages and INSERT
        # oplogs ship ONE page id per N tokens (the engine's paged
        # allocator guarantees within-page slot contiguity), cutting
        # wire value bytes and apply-side index work by N (VERDICT
        # round-3 next-step #4).
        self.page = cfg.page_size
        if self.page > 1:
            # Refuse page granularity ATOMICALLY at construction: if it
            # only surfaced inside insert()'s serialize() (after
            # _mesh_insert already applied), the origin's tree would
            # silently diverge from the ring on every publish.
            if emit_version() < 3:
                raise ValueError(
                    f"page_size={self.page} needs wire v3 oplogs; the "
                    f"emit version is pinned to {emit_version()} "
                    "(rolling upgrade?) — finish the roll or use "
                    "page_size=1"
                )
            if self.page > 255:
                raise ValueError(
                    f"page_size={self.page} exceeds the wire's u8 "
                    "page field (max 255)"
                )
        # Two-level hierarchical replication (policy/hierarchy.py; the
        # reference's >50-node roadmap question, README.md:57). None =
        # the flat ring. The scope flag lives in the v3 flags byte, so a
        # rolling upgrade pinned below v3 must finish before enabling.
        self.hier: HierPlan | None = None
        if cfg.topology == "hier":
            if emit_version() < 3:
                raise ValueError(
                    "topology=hier needs wire v3 oplogs (spine scope "
                    f"flag); the emit version is pinned to {emit_version()}"
                )
            self.hier = HierPlan(
                ring_size=cfg.num_ring,
                group_size=cfg.group_size or auto_group_size(cfg.num_ring),
            )
        # Prefix-ownership sharding (cache/sharding.py): rf > 0 bounds
        # each insert's delivery to the key's owner set instead of
        # circulating the whole ring — bytes-per-insert O(RF), not O(N).
        # rf == 0 is the full-replica compatibility mode: every wire
        # behavior below is bit-for-bit the unsharded ring.
        self.rf = cfg.replication_factor
        self.sharded = self.rf > 0
        _page = max(1, self.page)
        self.tree = RadixTree(
            page_size=self.page,
            shard_fn=(
                (lambda key, _p=_page: shard_of_tokens(key[:_p]))
                if self.sharded
                else None
            ),
        )
        self._lock = threading.RLock()
        # Flipped under the lock at the top of close(): the lazy p2p
        # dialers check it after winning their setdefault, so a dial
        # racing the close snapshot closes its own channel instead of
        # inserting one nothing will ever close.
        self._closing = False
        self._logic_op = AtomicCounter()
        self.dup_nodes: dict[NodeKey, PrefillValue | RouterValue] = {}
        # Slot-ownership ledger for locally-owned duplicate KV. Dup entries
        # are recorded per conflicted tree node, and node boundaries drift
        # as later inserts split nodes — so re-delivered oplogs can record
        # the SAME losing slot under entries of different granularity
        # (found by tests/test_convergence_sim.py). Every dup-driven free
        # must therefore go through this map: a slot id is claimed by at
        # most one entry, claims require the slot to be currently
        # allocated, and frees release only ids the freeing entry claims —
        # never a raw index array (which double-frees on overlap).
        self._dup_pending: dict[int, NodeKey] = {}
        self.tick_counts: dict[int, int] = {}
        # Elastic membership (policy/topology.py): every TTL and GC
        # unanimity count derives from the CURRENT view, not static config.
        self.view = TopologyView.initial(cfg)
        # Heat-driven rebalancing (cache/rebalance.py is the SINGLE
        # writer of override maps — this module only folds whole
        # immutable instances, epoch/version-guarded like views).
        # EMPTY_OVERRIDES until a decider's first round lands.
        self.overrides = EMPTY_OVERRIDES
        # RebalancePlane seam when one is attached (launch.py
        # --rebalance-interval). READ-ONLY here — the doctor and the
        # frontends' status blocks consult it; only cache/rebalance.py
        # makes decisions.
        self.rebalance = None
        # View-epoch-consistent ownership maps (cache/sharding.py is the
        # SINGLE writer — this module only swaps whole immutable maps,
        # re-derived from every adopted view). The BASE map is the pure
        # RF-successor walk (the rebalancer's boost baseline); the
        # effective map layers the adopted overrides on top. None when
        # unsharded.
        self._base_ownership = (
            build_ownership(
                self.view.alive, self.rf, self.view.epoch,
                is_prefill=cfg.is_prefill_rank,
            )
            if self.sharded
            else None
        )
        self.ownership = self._base_ownership
        # Router-side compact replica substitute: per-rank per-shard
        # (fingerprint, root summaries) folded from SHARD_SUMMARY gossip.
        # Maintained on every role (cheap; P/D nodes use the fps for
        # co-owner convergence too), read on the router's routing path.
        self._shard_table = ShardSummaryTable() if self.sharded else None
        self._last_shard_summary = 0.0
        # Per-shard heat telemetry (cache/sharding.py::ShardHeat):
        # decayed insert/hit/pull-through/byte counters for the shards
        # this replica touches. THIS MODULE is the single writer (lint-
        # pinned like ownership): the counting sites are insert origin
        # (_broadcast_data), replica apply (oplog_received), prefix-hit
        # (match_prefix), and pull-through serve (_handle_shard_pull).
        # P/D + sharded only — routers measure nothing; they read the
        # gossiped heat map.
        self.heat = (
            ShardHeat(
                **(
                    {"half_life_s": cfg.heat_half_life_s}
                    if cfg.heat_half_life_s > 0
                    else {}
                )
            )
            if self.sharded and self.role is not NodeRole.ROUTER
            else None
        )
        # Shard ids whose heat gauge children hold a nonzero value from
        # the LAST summary broadcast — zeroed when a shard cools off or
        # leaves the owned set (a scraped gauge can't be swapped whole).
        self._heat_gauge_sids: set[int] = set()
        # EWMA of wire bytes each local insert cost (frame size × owner
        # deliveries under sharding; frame × ring size unsharded).
        self._bpi_ewma = 0.0
        # Rate limit for tick-triggered view re-announcements (see the
        # TICK receive branch): at most one per tick interval per node.
        self._last_view_gossip = 0.0
        # Inbound-silence tracking for the membership housekeeper: a ring
        # node that hears NOTHING for a failure timeout may have been
        # excluded from a view it never received (reborn after its old
        # rank was declared dead — nobody routes to it, so no message can
        # tell it). It re-asserts itself with a JOIN.
        self._last_rx = time.monotonic()
        # Instrumentation seam: called (with the oplog, under the tree
        # lock) when this node's OWN oplog returns after a full ring lap —
        # the lap-latency probe for ``scripts/ringbench.py``. The
        # reference's benchmark has no timers at all (``benchmark.py:24-31``).
        self.on_lap_complete = None
        self._last_self_join = 0.0
        self._succ_rank: int | None = None
        # Channel retargets requested by view changes, applied by each
        # channel's OWN sender thread (serialized with its sends):
        # dest ("ring" | "spine") → new target address.
        self._pending_retargets: dict[str, str | None] = {}
        self._retarget_flags = {
            "ring": threading.Event(),
            "spine": threading.Event(),
        }
        # A successor is "established" once its channel has been seen
        # connected; until then sends block with unbounded patience (slow
        # startup must not read as death). Reset on retarget.
        self._succ_established = False
        # Hierarchical mode: the leader-spine channel (send-only, idle on
        # non-leaders — same pattern as the router fan-out channels) and
        # the current spine successor rank. The spine gets its OWN sender
        # thread + queues: a leader bridges every inter-group op, and
        # spine sends serializing behind its group forwards would halve
        # the hierarchy's throughput at exactly the nodes it hinges on.
        self._spine_comm: Communicator | None = None
        self._spine_rank: int | None = None
        self._spine_established = False
        # Hier GC: pending vote-aggregation rounds at this (query-origin)
        # node, keyed by the query's logic id (see run_gc_round).
        self._gc_pending: dict[int, dict] = {}
        self._router_state: dict[int, dict] = {}
        # Fired (under the mesh lock) as (old_view, new_view) after a view
        # change is adopted; the router uses this to retire/restore hash-
        # ring members. Keep callbacks cheap and non-blocking.
        self.on_view_change: list = []
        # Predictive-restore hints (cache/kv_transfer.py): a received
        # PREFETCH oplog addressed to this node is funneled here (set to
        # the serving engine's ``plane.note_hint`` by launch.py). Must be
        # cheap + non-blocking — it runs on the transport reader thread.
        self.on_prefetch = None
        # Router-originated hints go over dedicated fire-and-forget
        # channels (routers never send on the ring, sync_algo.py:80-96).
        self._prefetch_comms: dict[int, Communicator] = {}
        # Anti-entropy repair (cache/repair_plane.py): received
        # REPAIR_PROBE/REPAIR_SUMMARY frames addressed to this node are
        # funneled here (set to the plane's ``note_frame`` — must be
        # cheap, it runs on the transport reader thread under the lock);
        # sessions go over dedicated point-to-point channels, one per
        # peer rank, dialed lazily (the prefetch-channel pattern,
        # available to EVERY role — a router probes peers the same way).
        self.on_repair = None
        self._repair_comms: dict[int, Communicator] = {}
        # Owner-addressed data channels (prefix-ownership sharding): one
        # lazily-dialed point-to-point channel per owner rank, written
        # ONLY by the dedicated owner-sender thread. Same pattern as the
        # repair channels; separate map so bulk data never rides the
        # repair/bootstrap connections.
        self._owner_comms: dict[int, Communicator] = {}
        # Bootstrap-repair channels (policy/lifecycle.py warm join): a
        # BOOTSTRAPPING node's bulk sessions get their OWN point-to-point
        # channels so a full-replica transfer never queues behind (or
        # delays) steady-state anti-entropy frames on the regular repair
        # channel. Same lazy-dial pattern, separate map.
        self._bootstrap_comms: dict[int, Communicator] = {}
        # Membership lifecycle plane (policy/lifecycle.py), when one is
        # attached. READ-ONLY here: the receive path consults
        # ``is_departing`` (a draining node must not auto-rejoin on
        # seeing its own planned exclusion) and the fleet plane folds
        # ``state`` into the digest. Only policy/lifecycle.py assigns
        # lifecycle state (lint-pinned).
        self.lifecycle = None
        # Dropped-frame accounting hook: called (cause, kind_int) when a
        # frame is lost on the outbound path (queue overflow or transmit
        # failure). The repair plane arms an early probe from data-kind
        # losses instead of waiting out the staleness threshold.
        self.on_oplog_dropped = None
        # Fleet telemetry plane (obs/fleet_plane.py): every node — router
        # included — folds received DIGEST ops into this view; a
        # FleetPlane (launch.py --fleet-digest-interval) originates this
        # node's own digests through broadcast_digest().
        self.fleet = FleetView()
        # Recent origin→apply replication lag EWMA (the digest's
        # replication_lag_s field; the histogram keeps the distribution).
        self.lag_ewma_s = 0.0
        # Per-node label keeps series distinct when several nodes share a
        # process (the inproc test harness runs whole rings in-process).
        reg = get_registry()
        node = f"{self.role.value}@{self.rank}"
        self._node_label = node
        self._m_sent = reg.counter(
            "radixmesh_mesh_oplogs_sent_total", "oplogs enqueued for ring transmission", ("node",)
        ).labels(node=node)
        received = reg.counter(
            "radixmesh_mesh_oplogs_received_total",
            "oplogs received from the ring",
            ("node", "type"),
        )
        # Pre-resolved per-type children: the receive path runs per message
        # on the transport reader thread, so label resolution (set compare,
        # sort, family lock) must not happen there.
        self._m_received = {
            t: received.labels(node=node, type=t.name) for t in OplogType
        }
        self._m_dropped = reg.counter(
            "radixmesh_mesh_oplogs_dropped_total",
            "oplogs dropped on outbound-queue overflow",
            ("node",),
        ).labels(node=node)
        # Loss accounting with the failure mode attached: WHAT was lost
        # (op kind) and WHY (queue_full = backlogged successor; transmit
        # = the sender-loop exception path). Children resolve lazily —
        # drops are the cold path by definition.
        self._m_dropped_by = reg.counter(
            "radixmesh_oplog_dropped_total",
            "oplog frames lost on the outbound path, by cause and kind "
            "(data-kind losses arm an early anti-entropy repair probe)",
            ("node", "cause", "kind"),
        )
        # Prefix-ownership sharding telemetry. owned_shards tracks the
        # RF-invariant's local share; bytes_per_insert is the EWMA the
        # ringscale flatness gate watches live; pullthrough counts the
        # non-owner cache-fill traffic by outcome (sent/send_failed on
        # the requester, served/miss on the owner).
        self._g_owned_shards = reg.gauge(
            "radixmesh_mesh_owned_shards",
            "shards this node owns under the current ownership map "
            "(0 when unsharded or not an owner of anything)",
            ("node",),
        ).labels(node=node)
        self._g_bytes_per_insert = reg.gauge(
            "radixmesh_mesh_bytes_per_insert",
            "EWMA of ring/owner wire bytes per locally-originated insert "
            "(frame size x deliveries; O(RF) under sharding, O(N) full-replica)",
            ("node",),
        ).labels(node=node)
        self._m_pullthrough = reg.counter(
            "radixmesh_mesh_pullthrough_total",
            "shard pull-through requests by outcome (sent/send_failed = "
            "requester side; served/miss = owner side)",
            ("node", "outcome"),
        )
        self._m_prefetch_sent = reg.counter(
            "radixmesh_mesh_prefetch_sent_total",
            "PREFETCH restore hints originated by this node",
            ("node",),
        ).labels(node=node)
        # Per-shard heat & skew telemetry (the rebalancer's
        # measurement substrate). Families register on every node so a
        # fleet rolling sharding on sees series move from zero; values
        # only flow on sharded P/D nodes (the summary broadcast updates
        # them once per interval — never on the per-insert hot path).
        self._g_shard_heat = reg.gauge(
            "radixmesh_shard_heat_tokens_per_second",
            "decayed per-owned-shard load (insert+hit tokens/s, "
            "half-life-weighted — cache/sharding.py::ShardHeat)",
            ("node", "shard"),
        )
        self._g_skew = reg.gauge(
            "radixmesh_shard_skew_ratio",
            "fleet heat-map skew: max/mean decayed load over reported "
            "shards (1 = flat; the rebalancing trigger signal)",
            ("node",),
        ).labels(node=node)
        self._m_bridged = reg.counter(
            "radixmesh_mesh_spine_bridges_total",
            "oplogs bridged group→spine by this leader (hier topology)",
            ("node",),
        ).labels(node=node)
        self._m_conflicts = reg.counter(
            "radixmesh_mesh_conflicts_total", "multi-writer value conflicts resolved", ("node",)
        ).labels(node=node)
        self._m_gc_rounds = reg.counter(
            "radixmesh_mesh_gc_rounds_total", "distributed GC query laps originated", ("node",)
        ).labels(node=node)
        self._m_gc_freed = reg.counter(
            "radixmesh_mesh_gc_freed_slots_total", "KV slots reclaimed by distributed GC", ("node",)
        ).labels(node=node)
        # Replica evictions by cause (obs/fleet_plane.py registration
        # point): this node increments ttl (housekeeper sweep) and
        # mesh_trim (budget trim); engines own capacity/preempt.
        self._m_evicted = eviction_counters(node)
        self._m_lag = reg.histogram(
            "radixmesh_mesh_oplog_lag_seconds",
            "origin-to-apply replication lag (origin wall clock; skew degrades "
            "telemetry only)",
            ("node",),
        ).labels(node=node)
        # Membership/topology gauges (failover + hier re-election were
        # visible only in logs before): updated on every adopted view
        # change and successor recompute.
        self._g_membership = {
            "view_epoch": reg.gauge(
                "radixmesh_mesh_view_epoch",
                "epoch of the currently adopted topology view",
                ("node",),
            ).labels(node=node),
            "alive_nodes": reg.gauge(
                "radixmesh_mesh_alive_nodes",
                "ring members alive in the current view",
                ("node",),
            ).labels(node=node),
            "leader_flag": reg.gauge(
                "radixmesh_mesh_leader_flag",
                "1 when this node is its group's leader (hier) or the "
                "view master (flat ring)",
                ("node",),
            ).labels(node=node),
            "spine_nodes": reg.gauge(
                "radixmesh_mesh_spine_nodes",
                "leader-spine members in the current view (0 = flat ring)",
                ("node",),
            ).labels(node=node),
            "successor_rank": reg.gauge(
                "radixmesh_mesh_successor_rank",
                "this node's current ring successor rank (-1 = none)",
                ("node",),
            ).labels(node=node),
        }
        # Successor-rank TRANSITIONS by cause: ``dead`` = sender-side
        # failure detection fired (_declare_successor_dead), ``left`` = a
        # peer's planned LEAVE (policy/lifecycle.py), ``view_change`` =
        # any other adopted view (JOIN re-inclusion, merge, TOPO gossip).
        # Dashboards separate planned churn from real failure with this;
        # the drain chaos gate asserts zero ``dead`` transitions during a
        # graceful departure. All three children materialize eagerly so
        # the series exist at 0 from process start.
        succ_trans = reg.counter(
            "radixmesh_mesh_successor_rank_transitions_total",
            "ring-successor retargets, by cause (dead = failure "
            "detection; left = graceful LEAVE; view_change = other "
            "adopted views)",
            ("node", "cause"),
        )
        self._m_succ_trans = {
            c: succ_trans.labels(node=node, cause=c)
            for c in ("dead", "left", "view_change")
        }
        self._update_membership_gauges()

        self._comm: Communicator | None = None
        self._router_comms: list[Communicator] = []
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._started = False
        # Bounded so a long peer outage cannot grow the heap without limit.
        # Overflow drops the oplog (counted + logged): the tree is a cache,
        # so a peer missing an insert only costs it a cache hit, and
        # periodic ticks/GC rounds re-circulate — honest degradation beats
        # blocking the mesh lock on a dead network.
        self._out_q: queue.Queue[bytes] = queue.Queue(maxsize=65536)
        # Control-plane PRIORITY lane (reference roadmap README.md:54
        # "oplog msg priority"; VERDICT round-3 missing #3): TICK/TOPO/
        # JOIN must not queue behind a replication backlog — a full data
        # queue would delay heartbeats and view announcements exactly
        # when failure detection needs them. The sender drains this lane
        # FIRST. Data ops keep strict FIFO among themselves (wire order
        # == application order); control ops are order-independent
        # (ticks are counters, views are epoch-guarded, JOIN is
        # idempotent), so overtaking is safe.
        self._ctl_q: queue.Queue[bytes] = queue.Queue(maxsize=4096)
        self._send_evt = threading.Event()
        # The spine channel's lanes (hier leaders only; idle otherwise).
        self._spine_out_q: queue.Queue[bytes] = queue.Queue(maxsize=65536)
        self._spine_ctl_q: queue.Queue[bytes] = queue.Queue(maxsize=4096)
        self._spine_evt = threading.Event()
        # Owner-addressed data lane (sharding): (target rank, frame)
        # pairs drained by the dedicated owner-sender thread. FIFO per
        # origin — wire order equals application order per target, same
        # contract as the ring lane.
        self._owner_q: queue.Queue[tuple[int, bytes]] = queue.Queue(maxsize=65536)
        self._owner_evt = threading.Event()
        self._refresh_owned_shards()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> "MeshCache":
        """Open transports and start background threads. Unlike the
        reference (whose constructor blocks in the tick barrier,
        ``radix_mesh.py:101-142``), startup and readiness are separate:
        call :meth:`wait_ready` to block on ring verification."""
        topo = self.sync.topo(self.cfg)
        # The view master fans out to routers over dedicated send-only
        # channels (radix_mesh.py:103-109). Unlike the reference — where
        # only static rank 0 even *holds* router channels — every P/D node
        # opens them, because mastership moves to the lowest alive rank
        # when nodes die (policy/topology.py). Channels are idle unless
        # this node is the current master.
        if self.role is not NodeRole.ROUTER:
            for router_addr in self.cfg.router_nodes:
                self._router_comms.append(
                    create_communicator(
                        self.cfg.protocol, None, router_addr,
                        self.cfg.max_msg_bytes,
                        src_hint=self.cfg.local_addr,
                    )
                )
        next_addr = topo.next_node
        if self.hier is not None and self.role is not NodeRole.ROUTER:
            # Hier mode: the data channel targets the GROUP successor, not
            # the flat-ring successor the sync algo names.
            succ = self.hier.group_successor(self.rank, self._my_alive())
            next_addr = None if succ is None else self.cfg.addr_of_rank(succ)
        self._comm = create_communicator(
            self.cfg.protocol,
            topo.bind_addr,
            next_addr,
            self.cfg.max_msg_bytes,
        )
        self._comm.register_rcv_callback(self.oplog_received)
        if self.role is not NodeRole.ROUTER:
            if self.hier is not None:
                alive = self._my_alive()
                self._succ_rank = self.hier.group_successor(self.rank, alive)
                sp = (
                    self.hier.spine_successor(self.rank, alive)
                    if self.hier.is_leader(self.rank, alive)
                    else None
                )
                self._spine_rank = sp
                # Every ring node opens the spine channel (idle unless it
                # is currently a leader) so leadership can move to it on a
                # view change without opening transports mid-failover.
                self._spine_comm = create_communicator(
                    self.cfg.protocol,
                    None,
                    None if sp is None else self.cfg.addr_of_rank(sp),
                    self.cfg.max_msg_bytes,
                    src_hint=self.cfg.local_addr,
                )
            else:
                self._succ_rank = self.view.successor_of(self.rank)
        # Mark started before spawning threads: the ticker's first tick must
        # not be dropped by the _started gate in _send_bytes.
        self._update_membership_gauges()
        self._started = True
        # Silence is only meaningful once the node participates in the
        # ring; counting the construct-to-start gap would fire a spurious
        # housekeeper JOIN after a slow model load.
        self._last_rx = time.monotonic()
        if self.sync.can_send(self.cfg):
            # Announce (re)join: on a cold cluster boot everyone is already
            # in everyone's initial view and this is a no-op lap; after a
            # restart it prompts the view master to re-include this node.
            self._broadcast(
                Oplog(
                    op_type=OplogType.JOIN,
                    origin_rank=self.rank,
                    logic_id=self._logic_op.next(),
                    ttl=self._data_ttl(),
                )
            )
            t = threading.Thread(target=self._sender, daemon=True, name="mesh-sender")
            t.start()
            self._threads.append(t)
            if self.sharded:
                t = threading.Thread(
                    target=self._owner_sender, daemon=True,
                    name="mesh-owner-sender",
                )
                t.start()
                self._threads.append(t)
                # Seed the fleet's routing/convergence tables without
                # waiting out the first summary interval (an empty-tree
                # summary still tells the router which shards are ours).
                self.broadcast_shard_summary()
            if self.hier is not None:
                t = threading.Thread(
                    target=self._spine_sender, daemon=True, name="mesh-spine-sender"
                )
                t.start()
                self._threads.append(t)
            # Every ring node runs the ticker thread; only the CURRENT
            # view's tick origin broadcasts (see _view_tick_origin) —
            # heartbeats must survive the death of the static origin.
            t = threading.Thread(target=self._ticker, daemon=True, name="mesh-ticker")
            t.start()
            self._threads.append(t)
        if self.role is not NodeRole.ROUTER:
            t = threading.Thread(target=self._gc_loop, daemon=True, name="mesh-gc")
            t.start()
            self._threads.append(t)
            t = threading.Thread(
                target=self._housekeeper, daemon=True, name="mesh-housekeeper"
            )
            t.start()
            self._threads.append(t)
        return self

    def wait_ready(self, timeout: float | None = None) -> bool:
        """Block until SOME origin's tick has circulated the ring twice
        (two-round verification, reference ``radix_mesh.py:435-445``).
        Any origin proves connectivity — a node (re)starting while the
        static origin is dead must become ready on the failover origin's
        heartbeat (``_view_tick_origin``)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._stop.is_set():
            with self._lock:
                if any(c >= 2 for c in self.tick_counts.values()):
                    return True
            if deadline is not None and time.monotonic() > deadline:
                return False
            # Deadline-bounded wait on the stop event, not a bare sleep:
            # close() interrupts the poll instead of waiting it out.
            self._stop.wait(0.01)
        return False

    def close(self, graceful: bool = False) -> None:
        """Stop threads and close transports. ``graceful=True`` first
        announces a view without this node, so peers re-form the ring
        immediately instead of waiting out ``failure_timeout_s``. The
        default mimics a crash (what failure detection exists to handle)."""
        with self._lock:
            self._closing = True
        if (
            graceful
            and self._started
            and self.role is not NodeRole.ROUTER
            and self._comm is not None
            and not self._stop.is_set()
        ):
            with self._lock:
                leave = self.view.without(self.rank)
                op = Oplog(
                    op_type=OplogType.TOPO,
                    origin_rank=self.rank,
                    logic_id=self._logic_op.next(),
                    ttl=self._data_ttl(),
                    value=encode_view(leave),
                    ts=time.time(),
                )
                data = serialize(op)
                spine_data = None
                if (
                    self.hier is not None
                    and self._spine_comm is not None
                    and self._spine_rank is not None
                ):
                    # A leaving LEADER must tell the other groups directly —
                    # its own bridge is about to disappear with it.
                    op.spine = True
                    op.ttl = self.hier.spine_ttl(self._my_alive())
                    spine_data = serialize(op)
            try:  # best-effort: the ring may already be gone
                self._comm.try_send(data, 1.0)
                if spine_data is not None:
                    self._spine_comm.try_send(spine_data, 1.0)
                if self.rank == self.view.master_rank():
                    for rc in self._router_comms:
                        rc.try_send(data, 1.0)
            except Exception:  # noqa: BLE001
                pass
        self._stop.set()  # sender thread polls _stop; no sentinel needed
        for t in self._threads:
            t.join(timeout=2)
        if self._comm is not None:
            self._comm.close()
        if self._spine_comm is not None:
            self._spine_comm.close()
        for c in self._router_comms:
            c.close()
        # Snapshot the dedicated-channel maps under the lock before
        # closing: the lazy dialers (_p2p_channel / _prefetch_channel)
        # insert into these dicts from repair/router/transport-reader
        # threads that can still be live here — the mesh keeps receiving
        # for a beat after close(), and a peer's probe arriving
        # mid-shutdown dials a reply channel — so an unlocked .values()
        # iteration dies with "dictionary changed size during iteration"
        # and leaks every channel after the insertion point.
        with self._lock:
            p2p_comms = (
                list(self._prefetch_comms.values())
                + list(self._repair_comms.values())
                + list(self._bootstrap_comms.values())
                + list(self._owner_comms.values())
            )
        for c in p2p_comms:
            c.close()

    # ------------------------------------------------------------------
    # public cache API
    # ------------------------------------------------------------------

    def insert(
        self,
        key,
        slot_indices: np.ndarray,
        trace_id: int = 0,
        advertise: bool = False,
    ) -> int:
        """Insert a locally-computed prefix (KV already written to the local
        pool at ``slot_indices``) and replicate it around the ring
        (reference ``radix_mesh.py:193-201``). Prefill/decode only.

        ``trace_id`` (cross-node stitching, obs/trace_plane.py) rides
        the wire as the old-wire-tolerant trace trailer so every replica
        records its apply/lag spans under the originating request's
        timeline; 0 (tracing off) emits bit-for-bit the pre-trace
        frame.

        ``advertise=True`` (cold-cell resurrection): the indices
        are a placeholder advertisement — the local KV lives in DISK
        EXTENTS, not the pool, and is restored at admission time. The
        local tree stores an :class:`AdvertisedValue` so authoritative
        tree-path frees never release pool slots this prefix does not
        own; the wire frame is a normal rank-tagged INSERT."""
        if self.role is NodeRole.ROUTER:
            raise RuntimeError("router nodes hold no KV; insert is P/D-only")
        key = as_key(key)
        slot_indices = np.asarray(slot_indices, dtype=np.int32)
        if len(slot_indices) != len(key):
            raise ValueError("slot_indices length must equal key length")
        wire_value = slot_indices
        if self.page > 1:
            # Page-granular replication: publish only whole pages (the
            # engine already page-floors published prefixes) and ship one
            # page id per page. Requires within-page slot contiguity —
            # the paged allocator's invariant; checked here so a
            # misaligned caller fails at the source, not as silent
            # corruption on every replica.
            n = len(key) - len(key) % self.page
            if n == 0:
                return 0
            key = key[:n]
            slot_indices = slot_indices[:n]
            wire_value = self._page_wire_value(slot_indices)
        value = (
            AdvertisedValue(slot_indices, self.rank)
            if advertise
            else PrefillValue(slot_indices, self.rank)
        )
        t0 = time.monotonic()
        with self._lock:
            prefix_len = self._mesh_insert(key, value)
            # Enqueued under the lock: wire order == application order.
            self._broadcast_data(
                Oplog(
                    op_type=OplogType.INSERT,
                    origin_rank=self.rank,
                    logic_id=self._logic_op.next(),
                    ttl=self._data_ttl(),
                    key=key,
                    value=wire_value,
                    value_rank=self.rank,
                    page=self.page,
                    trace_id=int(trace_id),
                )
            )
        if trace_id:
            # Origin-side stitch anchor: the publish edge on THIS node's
            # ring lane under the request's trace id — paired with the
            # receivers' replication_lag spans, the replication fan-out
            # reads as visible edges in the stitched flame view. Only on
            # traced requests: tracing off (trace_id == 0) never reaches
            # this branch.
            rec = get_recorder()
            if rec.enabled:
                rec.event(
                    f"ring:{self._node_label}",
                    "mesh_publish",
                    t0,
                    time.monotonic() - t0,
                    cat="ring",
                    trace_id=trace_id,
                    node=self._node_label,
                    tokens=len(key),
                )
        return prefix_len

    def match_prefix(self, key) -> MatchResult | RouterMatchResult:
        """P/D: longest cached prefix with rank-tagged values. Router:
        which prefill/decode ranks hold the longest prefix
        (reference ``radix_mesh.py:203-238``)."""
        with self._lock:
            if self.role is NodeRole.ROUTER:
                res = self.tree.match_prefix(key, split_partial=False)
                return self._route_from_values(res.values)
            res = self.tree.match_prefix(key)
            if self.heat is not None and res.length > 0:
                key_arr = as_key(key)
                self.heat.note_hit(
                    shard_of_tokens(key_arr[: max(1, self.page)]), res.length
                )
            return res

    def local_prefix_indices(self, key) -> np.ndarray:
        """Longest *locally-usable* cached prefix: the leading run of
        matched values whose origin rank is this node — those are the only
        slot indices valid in the local KV pool. (The reference
        concatenates indices regardless of origin, ``radix_mesh.py:208-218``,
        which is only sound because it never attaches a model.)"""
        with self._lock:
            res = self.tree.match_prefix(key)
            runs = []
            for v in res.values:
                if not isinstance(v, PrefillValue) or v.rank != self.rank:
                    break
                runs.append(v.indices)
        if not runs:
            return np.empty(0, dtype=np.int32)
        return np.concatenate(runs)

    def delete(self, key) -> bool:
        """Remove an exact-key unlocked leaf and replicate the deletion
        (upgrade of the reference's DELETE stub, ``radix_mesh.py:417-418``)."""
        key = as_key(key)
        with self._lock:
            removed = self._apply_delete(key)
            if removed:
                # Only a successful local delete replicates — broadcasting a
                # refused delete (locked/mid-node key) would desynchronize
                # replicas that can apply it.
                self._broadcast_data(
                    Oplog(
                        op_type=OplogType.DELETE,
                        origin_rank=self.rank,
                        logic_id=self._logic_op.next(),
                        ttl=self._data_ttl(),
                        key=key,
                    )
                )
        return removed

    def reset_all(self) -> None:
        """Clear the local replica and replicate RESET (reference
        ``radix_mesh.py:419-420``)."""
        with self._lock:
            self._apply_reset()
            self._broadcast(
                Oplog(
                    op_type=OplogType.RESET,
                    origin_rank=self.rank,
                    logic_id=self._logic_op.next(),
                    ttl=self._data_ttl(),
                )
            )

    @property
    def metrics(self) -> dict[str, float]:
        """Programmatic snapshot of this node's replication counters."""
        return {
            "oplogs_sent": self._m_sent.value,
            "oplogs_dropped": self._m_dropped.value,
            "conflicts": self._m_conflicts.value,
            "gc_rounds": self._m_gc_rounds.value,
            "gc_freed_slots": self._m_gc_freed.value,
        }

    # lock-ref passthroughs (protect active requests from GC agreement)
    def inc_lock_ref(self, node: TreeNode) -> None:
        with self._lock:
            self.tree.inc_lock_ref(node)

    def dec_lock_ref(self, node: TreeNode) -> None:
        with self._lock:
            self.tree.dec_lock_ref(node)

    # ------------------------------------------------------------------
    # replication: receive path
    # ------------------------------------------------------------------

    def oplog_received(self, data: bytes) -> None:
        """Transport callback (reference ``radix_mesh.py:391-420``)."""
        op = deserialize(data)
        counter = self._m_received.get(op.op_type)
        if counter is not None:
            counter.inc()
        # Don't record lag for our own returning oplogs: that sample would
        # be a full ring lap (the systematically largest value) with no
        # apply behind it, inflating p99 for operators alerting on lag.
        if op.ts and op.origin_rank != self.rank:
            lag = max(0.0, time.time() - op.ts)
            self._m_lag.observe(lag)
            # Cheap EWMA for the fleet digest (no lock: a torn float read
            # costs one sample of staleness, and writes happen only here
            # on the transport reader thread).
            self.lag_ewma_s += 0.2 * (lag - self.lag_ewma_s)
            rec = get_recorder()
            if rec.enabled:
                # Flight-recorder lag span on this node's ring lane,
                # ending "now": the origin stamped wall-clock at enqueue,
                # so t0 is back-derived into the local monotonic base the
                # request spans use. When the frame carries the optional
                # trace trailer (cross-node stitching) the span
                # lands UNDER the originating request's 64-bit trace id —
                # the replication edge becomes part of that request's
                # stitched timeline; traceless frames are correlated by
                # time overlap only.
                rec.event(
                    f"ring:{self._node_label}",
                    "replication_lag",
                    time.monotonic() - lag,
                    lag,
                    cat="ring",
                    trace_id=op.trace_id,
                    node=self._node_label,
                    origin_rank=int(op.origin_rank),
                    op_type=(
                        op.op_type.name
                        if isinstance(op.op_type, OplogType)
                        else int(op.op_type)
                    ),
                )
        self._last_rx = time.monotonic()
        with self._lock:
            op.ttl -= 1
            if not isinstance(op.op_type, OplogType):
                # A newer peer's op kind (deserialize kept the raw int):
                # not ours to interpret — forward so the rest of the ring
                # (which may understand it) still sees it, and move on.
                # This tolerance ships WITH PREFETCH: nodes from this
                # build on coexist with senders of future kinds; builds
                # predating it raise on unknown kinds, so new-kind
                # emission follows the finish-the-roll discipline.
                if throttled(("unknown_op", self.rank, int(op.op_type)),
                             self.cfg.tick_interval_s):
                    self.log.warning(
                        "ignoring unknown oplog kind %d from rank %d",
                        int(op.op_type), op.origin_rank,
                    )
                if op.origin_rank != self.rank:
                    self._circulate(op, data)
                return
            if op.op_type is OplogType.PREFETCH:
                self._handle_prefetch(op, data)
                return
            if op.op_type in (
                OplogType.REPAIR_PROBE, OplogType.REPAIR_SUMMARY,
            ):
                self._handle_repair(op)
                return
            if op.op_type is OplogType.SHARD_SUMMARY:
                self._handle_shard_summary(op, data)
                return
            if op.op_type is OplogType.SHARD_PULL:
                self._handle_shard_pull(op)
                return
            if op.op_type is OplogType.REBALANCE:
                self._handle_rebalance(op, data)
                return
            if op.op_type is OplogType.TICK:
                # Counted before the origin-drop so the originator observes
                # its own tick completing each lap (radix_mesh.py:356-360).
                self.tick_counts[op.origin_rank] = (
                    self.tick_counts.get(op.origin_rank, 0) + 1
                )
                self._gossip_view_from_tick(op)
                # Scope-aware forward: the frame is immutable, so hops
                # patch the original bytes instead of re-serializing.
                self._circulate(op, data, control=True)
                return
            if op.op_type in (OplogType.GC_QUERY, OplogType.GC_EXEC, OplogType.GC_VOTE):
                self._gc_handle(op, data)
                return
            if op.op_type is OplogType.TOPO:
                self._handle_topo(op, data)
                return
            if op.op_type is OplogType.JOIN:
                self._handle_join(op, data)
                return
            if op.op_type is OplogType.LEAVE:
                self._handle_leave(op, data)
                return
            if op.op_type is OplogType.DIGEST:
                self._handle_digest(op, data)
                return
            if op.origin_rank == self.rank:
                # Lap complete (radix_mesh.py:401-402). Fire the
                # instrumentation seam before dropping. In hier mode the
                # seam fires on the GROUP lap's return; a leader-origin's
                # returning SPINE copy is just dropped.
                cb = self.on_lap_complete
                if cb is not None and not op.spine:
                    cb(op)
                return
            # Apply BEFORE any TTL-based drop: with elastic membership an
            # oplog can carry a TTL computed from a stale (smaller) view,
            # reaching the last ring member with ttl 0 — dropping it
            # unapplied would diverge that replica forever (receivers have
            # no gap detection). Ops are idempotent, so the worst case of
            # a stale-TTL lap overrun is a harmless re-apply; TTL only
            # gates FORWARDING (the infinite-circulation backstop when the
            # origin died mid-lap).
            if op.op_type is OplogType.INSERT:
                if self.role is NodeRole.ROUTER:
                    value = RouterValue(op.value_rank, len(op.key))
                else:
                    indices = op.value
                    if op.page > 1:
                        # Expand page ids back to per-token slots (the
                        # origin's allocator guarantees contiguity).
                        indices = (
                            indices[:, None].astype(np.int32) * op.page
                            + np.arange(op.page, dtype=np.int32)[None, :]
                        ).reshape(-1)
                    value = PrefillValue(indices, op.value_rank)
                self._mesh_insert(op.key, value)
                if self.heat is not None:
                    # Replica-side heat: the owner set's applies count the
                    # same traffic the origin counted, decayed identically
                    # — co-owners therefore gossip comparable loads and
                    # the fleet map takes the MAX, not the sum.
                    self.heat.note_insert(
                        shard_of_tokens(op.key[: max(1, self.page)]),
                        len(op.key),
                        len(data),
                    )
            elif op.op_type is OplogType.DELETE:
                self._apply_delete(op.key)
            elif op.op_type is OplogType.RESET:
                self._apply_reset()
            # Hot replication path: _circulate patches the TTL (and, in
            # hier mode, the scope) in the received frame and enqueues it
            # as-is. The key/value payload is immutable in flight, so
            # bytes are authoritative — and a 5-node ring re-serializing
            # every insert 4x was the dominant per-hop CPU cost.
            self._circulate(op, data)

    # ------------------------------------------------------------------
    # elastic membership (policy/topology.py; reference roadmap README.md:49-50)
    # ------------------------------------------------------------------

    def _my_alive(self) -> tuple[int, ...]:
        """The current view's alive set, always including this node: a
        node excluded from the view (reborn after being declared dead)
        must still be able to compute successors to deliver its JOIN."""
        a = self.view.alive
        if self.role is NodeRole.ROUTER or self.rank in a:
            return a
        return tuple(sorted((*a, self.rank)))

    def _data_ttl(self) -> int:
        """One lap of the CURRENT ring — the local group's ring in hier
        mode (generalizes sync_algo's static ``cfg.num_ring`` TTLs to
        elastic membership)."""
        if self.hier is not None and self.role is not NodeRole.ROUTER:
            return self.hier.group_ttl(self.rank, self._my_alive())
        return max(1, self.view.ring_size)

    def _tick_ttl(self) -> int:
        # Two laps at every level ("two-round verification",
        # sync_algo.py:103-104): in hier mode the doubling is applied
        # per-scope by _level_ttl, so a single origination still proves
        # ring connectivity twice to every member.
        return 2 * self._data_ttl()

    def _gc_ttl(self) -> int:
        return self._data_ttl()

    # ------------------------------------------------------------------
    # scope-aware circulation (flat ring + hier groups/spine)
    # ------------------------------------------------------------------

    def _frame(
        self,
        op: Oplog,
        data: bytes,
        *,
        ttl: int,
        spine: bool | None = None,
        value_rank: int | None = None,
        mutated: bool = False,
    ) -> bytes:
        """The outgoing frame for ``op``: patch the received bytes when
        the payload is unchanged (the hot path), re-serialize when a
        handler mutated the payload (GC vote counters) or the frame
        predates the fields being patched (possible only mid-roll)."""
        if not mutated:
            try:
                return patched_frame(data, ttl=ttl, spine=spine, value_rank=value_rank)
            except ValueError:
                pass
        op.ttl = ttl
        if spine is not None:
            op.spine = spine
        if value_rank is not None:
            op.value_rank = value_rank
        return serialize(op)

    def _circulate(
        self, op: Oplog, data: bytes, *, mutated: bool = False, control: bool = False
    ) -> None:
        """Post-apply propagation (caller holds the lock; ``op.ttl``
        already decremented). Flat ring: forward to the successor while
        TTL remains. Hier (policy/hierarchy.py): forward at the frame's
        scope; the origin group's leader bridges GROUP→SPINE; remote
        leaders inject SPINE→GROUP copies that die back at the injector
        by TTL (the injector is not the origin, so the origin-drop rule
        cannot terminate them)."""
        if self.role is NodeRole.ROUTER:
            return  # routers never send (sync_algo.py:80-96)
        if self.hier is None:
            if op.ttl > 0:
                self._send_bytes(self._frame(op, data, ttl=op.ttl, mutated=mutated),
                                 control=control)
            return
        plan = self.hier
        alive = self._my_alive()
        if op.spine:
            if plan.same_group(op.origin_rank, self.rank):
                return  # spine lap complete (back at the origin's group)
            if op.ttl > 0:
                self._send_bytes(
                    self._frame(op, data, ttl=op.ttl, mutated=mutated),
                    control=control,
                    dest="spine",
                )
            # Inject into my group ring. GC_QUERY injections are tagged
            # with the injector's rank (value_rank is unused for them) so
            # the returning copy is recognizably ours (_gc_handle emits
            # this group's aggregated GC_VOTE from it). A sole-member
            # group still enqueues the copy: the ring sender drops
            # targetless frames but the view master's router fan-out
            # rides that same path (sender break-then-fanout).
            inject_ttl = plan.group_ttl(self.rank, alive)
            tag = self.rank if op.op_type is OplogType.GC_QUERY else None
            self._send_bytes(
                self._frame(
                    op, data, ttl=inject_ttl, spine=False,
                    value_rank=tag, mutated=mutated,
                ),
                control=control,
            )
            if self._succ_rank is None and op.op_type is OplogType.GC_QUERY:
                # Sole alive member of this group: nobody to poll — emit
                # the group's (one-vote) tally immediately.
                self._emit_gc_vote(op)
            return
        # Group scope (or the flat frame of a mid-roll peer).
        if op.ttl > 0:
            self._send_bytes(
                self._frame(op, data, ttl=op.ttl, mutated=mutated), control=control
            )
        if (
            op.origin_rank != self.rank
            and 0 <= op.origin_rank < plan.ring_size
            and plan.same_group(op.origin_rank, self.rank)
            and plan.is_leader(self.rank, alive)
        ):
            self._bridge_to_spine(op, data, mutated=mutated, control=control)

    def _bridge_to_spine(
        self, op: Oplog, data: bytes, *, mutated: bool = False, control: bool = False
    ) -> None:
        """Re-emit a group-originated op onto the leader spine. GC_QUERY
        bridges carry ZEROED vote counters: the origin group's votes
        return to the origin on its own lap, and each remote group's
        votes return as that group's GC_VOTE — a bridge carrying partial
        tallies would double-count them."""
        if self._spine_rank is None:
            return  # degenerate: single nonempty group (flat semantics)
        # One spine lap per bridge (the same_group rule ends it at the
        # origin group's leader). TICKs originate with a TWO-lap group
        # TTL (_tick_ttl), so a non-leader origin's tick passes its
        # leader — and bridges — twice; with one-lap spine copies and
        # one-lap injections that delivers the startup barrier's two
        # ticks to every member of every group, with no doubling at the
        # lower levels.
        ttl = self.hier.spine_ttl(self._my_alive())
        self._m_bridged.inc()
        if op.op_type is OplogType.GC_QUERY:
            sp = Oplog(
                op_type=op.op_type,
                origin_rank=op.origin_rank,
                logic_id=op.logic_id,
                ttl=ttl,
                key=op.key,
                value=op.value,
                value_rank=-1,
                gc=[GCEntry(e.key, e.value_rank, 0) for e in op.gc],
                ts=op.ts,
                page=op.page,
                spine=True,
            )
            self._send_bytes(serialize(sp), control=control, dest="spine")
            return
        self._send_bytes(
            self._frame(op, data, ttl=ttl, spine=True, mutated=mutated),
            control=control,
            dest="spine",
        )

    def _handle_topo(self, op: Oplog, data: bytes) -> None:
        """Caller holds the lock; ttl already decremented."""
        try:
            view = decode_view(op.value)
        except ValueError:
            self.log.error("malformed TOPO payload from rank %d", op.origin_rank)
            return
        self._adopt_view(view)
        if op.origin_rank != self.rank:
            self._circulate(op, data, control=True)

    def _handle_join(self, op: Oplog, data: bytes) -> None:
        """A node announced it is (re)joining. The current view master
        answers with a view that re-includes it; everyone forwards so the
        JOIN reaches the master wherever it sits. Caller holds the lock."""
        if op.origin_rank == self.rank:
            return  # lap complete
        joiner = op.origin_rank
        if not self.view.contains(joiner) and self.rank == self.view.master_rank():
            new_view = self.view.including(joiner)
            self.log.info(
                "rank %d rejoining: announcing view epoch=%d alive=%s",
                joiner, new_view.epoch, new_view.alive,
            )
            self._adopt_view(new_view)
            self._announce_view(new_view)
            if self.sharded and len(self.overrides):
                # A (re)joiner starts from EMPTY overrides: without a
                # re-announcement its derived owner sets would fork from
                # the fleet's until the next rebalance round. Duplicate
                # receives refuse by (epoch, version) — idempotent.
                self._broadcast(
                    Oplog(
                        op_type=OplogType.REBALANCE,
                        origin_rank=self.rank,
                        logic_id=self._logic_op.next(),
                        ttl=self._data_ttl(),
                        value=encode_overrides(self.overrides),
                        value_rank=self.rank,
                    )
                )
        self._circulate(op, data, control=True)

    def _handle_leave(self, op: Oplog, data: bytes) -> None:
        """A peer announced a PLANNED departure (graceful drain,
        ``policy/lifecycle.py``). Unlike failure detection, nothing here
        is a failure: the leaver's FleetView telemetry is FORGOTTEN (its
        frozen fingerprint must not poison convergence or pin min_score;
        a later rejoin re-folds fresh — no inherited lag EWMA), it is
        marked "left" for routing, and the carried view (the leaver's
        view without itself) is adopted with cause="left" — so this
        node's channel retargets BEFORE its sender could ever time out
        into ``_declare_successor_dead``. Caller holds the lock."""
        if op.origin_rank == self.rank:
            return  # lap complete (our own LEAVE came back around)
        leaver = op.origin_rank
        try:
            view = decode_view(op.value)
        except ValueError:
            self.log.error("malformed LEAVE payload from rank %d", leaver)
            return
        self.fleet.forget(leaver)
        self.fleet.mark_left(leaver)
        adopted = self._adopt_view(view, cause="left")
        if not adopted and self.view.contains(leaver):
            # The leaver's view was stale (a concurrent change raced its
            # drain): still honor the departure — drop it from OUR view
            # one epoch up and gossip the result.
            old = self.view
            self.view = old.without(leaver)
            self._after_view_change(old, cause="left")
            self._announce_view(self.view)
        self._circulate(op, data, control=True)

    # ------------------------------------------------------------------
    # fleet telemetry (obs/fleet_plane.py)
    # ------------------------------------------------------------------

    def broadcast_digest(self, digest: NodeDigest) -> None:
        """Fold this node's own digest locally and ring it as ONE
        idempotent DIGEST oplog (the fleet plane's per-interval cost).
        P/D nodes only — routers never send (sync_algo.py:80-96)."""
        if self.role is NodeRole.ROUTER:
            raise RuntimeError("router nodes never originate ring traffic")
        arr = digest.encode()
        with self._lock:
            self.fleet.fold(digest)
            self._broadcast(
                Oplog(
                    op_type=OplogType.DIGEST,
                    origin_rank=self.rank,
                    logic_id=self._logic_op.next(),
                    ttl=self._data_ttl(),
                    value=arr,
                    value_rank=self.rank,
                )
            )

    def _handle_digest(self, op: Oplog, data: bytes) -> None:
        """Caller holds the lock; ttl already decremented. Folding before
        forwarding means every hop's fleet view is as fresh as its ring
        position allows; idempotent re-delivery is a no-op fold."""
        if op.origin_rank == self.rank:
            return  # lap complete
        try:
            self.fleet.fold(NodeDigest.decode(op.value))
        except ValueError:
            if throttled(("bad_digest", self.rank), self.cfg.tick_interval_s):
                self.log.warning(
                    "malformed DIGEST payload from rank %d", op.origin_rank
                )
        self._circulate(op, data)

    # ------------------------------------------------------------------
    # predictive restore hints (cache/kv_transfer.py)
    # ------------------------------------------------------------------

    def send_prefetch(self, key, target_rank: int) -> bool:
        """Fire a PREFETCH hint at ``target_rank``: "requests for this
        prefix are heading your way — if it's host-tier, start restoring
        now". Best-effort by contract: the hint may be dropped at any
        point (queue overflow, dead channel, unknown kind on an older
        peer) and the receiver treats duplicates as no-ops, so there is
        nothing to retry and no acknowledgement. P/D origins ride the
        ring like any oplog; ROUTER origins — which never send on the
        ring — use a dedicated fire-and-forget channel to the target's
        cache address. Returns whether the hint was handed to a
        transport."""
        key = as_key(key)
        if len(key) == 0:
            return False
        op = Oplog(
            op_type=OplogType.PREFETCH,
            origin_rank=self.rank,
            logic_id=self._logic_op.next(),
            # Direct router hints are addressed point-to-point: one hop.
            ttl=1 if self.role is NodeRole.ROUTER else self._data_ttl(),
            key=key,
            value_rank=target_rank,
            ts=time.time(),
        )
        if self.role is not NodeRole.ROUTER:
            with self._lock:
                self._broadcast(op)
            self._m_prefetch_sent.inc()
            return True
        comm = self._prefetch_channel(target_rank)
        if comm is None:
            return False
        try:
            ok = bool(comm.try_send(serialize(op), 0.05))
        except Exception:  # noqa: BLE001 — hints are droppable by contract
            ok = False
        if ok:
            self._m_prefetch_sent.inc()
        return ok

    def _prefetch_channel(self, target_rank: int) -> Communicator | None:
        """Lazily-opened send-only channel to a P/D node's cache address
        (router role only — the same pattern as the master's router
        fan-out channels, pointed the other way). The dial happens
        OUTSIDE the mesh lock: the transport reader thread needs that
        lock to apply oplogs, and a slow first connection must not stall
        ring processing (a racing duplicate dial just closes the loser)."""
        if not 0 <= target_rank < self.cfg.num_ring:
            return None
        with self._lock:
            comm = self._prefetch_comms.get(target_rank)
        if comm is not None:
            return comm
        try:
            comm = create_communicator(
                self.cfg.protocol,
                None,
                self.cfg.addr_of_rank(target_rank),
                self.cfg.max_msg_bytes,
                src_hint=self.cfg.local_addr,
            )
        except Exception:  # noqa: BLE001
            self.log.exception(
                "prefetch channel to rank %d failed", target_rank
            )
            return None
        with self._lock:
            if self._closing:
                # close() already snapshotted the map: inserting now
                # would leak the channel forever — refuse the dial.
                existing = None
            else:
                existing = self._prefetch_comms.setdefault(target_rank, comm)
        if existing is not comm:
            comm.close()
        return existing

    def _handle_prefetch(self, op: Oplog, data: bytes) -> None:
        """Caller holds the lock; ttl already decremented. The hint sink
        (``on_prefetch`` → the engine plane's bounded queue) must stay
        cheap: this runs on the transport reader thread. The tree here is
        the MESH replica — hints never touch it; only the serving
        engine's hierarchical tree acts on them, at its next pump."""
        if op.origin_rank == self.rank:
            return  # lap complete
        addressed_here = op.value_rank in (-1, self.rank)
        if (
            addressed_here
            and self.role is not NodeRole.ROUTER
            and self.on_prefetch is not None
        ):
            try:
                self.on_prefetch(op.key)
            except Exception:  # noqa: BLE001 — a sink bug must not kill the reader
                self.log.exception("prefetch sink failed")
        if op.value_rank != self.rank:
            # Not (exclusively) ours: keep it moving toward its target.
            self._circulate(op, data)

    def eviction_totals(self) -> dict[str, int]:
        """This replica's policy-eviction counters (digest input)."""
        return {
            "ttl": int(self._m_evicted["ttl"].value),
            "mesh_trim": int(self._m_evicted["mesh_trim"].value),
        }

    # ------------------------------------------------------------------
    # anti-entropy repair (cache/repair_plane.py)
    # ------------------------------------------------------------------

    def _handle_repair(self, op: Oplog) -> None:
        """Caller holds the lock; ttl already decremented. REPAIR frames
        are point-to-point (dedicated channels, one hop) — never
        circulated. The sink only enqueues; the repair plane's worker
        does the tree walks and replies off this thread."""
        if op.value_rank not in (-1, self.rank):
            if throttled(("repair_misaddressed", self.rank),
                         self.cfg.tick_interval_s):
                self.log.warning(
                    "repair frame for rank %d landed on rank %d — dropping",
                    op.value_rank, self.rank,
                )
            return
        if self.on_repair is not None:
            try:
                self.on_repair(op)
            except Exception:  # noqa: BLE001 — a sink bug must not kill the reader
                self.log.exception("repair sink failed")

    def send_repair(self, target_rank: int, op_type: OplogType,
                    value: np.ndarray, bootstrap: bool = False) -> bool:
        """Fire one repair frame at ``target_rank``'s cache address over
        a dedicated channel. Best-effort by contract: a lost frame just
        means another probe after backoff, so the send is short-deadline
        and unacknowledged. ``bootstrap`` selects the bulk-session
        channel (policy/lifecycle.py warm join) so a full-replica
        transfer never contends with steady-state anti-entropy frames.
        Returns whether a transport took it."""
        comm = self._repair_channel(target_rank, bootstrap=bootstrap)
        if comm is None:
            return False
        op = Oplog(
            op_type=op_type,
            origin_rank=self.rank,
            logic_id=self._logic_op.next(),
            ttl=1,  # point-to-point: one hop
            value=np.asarray(value, dtype=np.int32),
            value_rank=target_rank,
            ts=time.time(),
        )
        try:
            return bool(comm.try_send(serialize(op), 0.25))
        except Exception:  # noqa: BLE001 — repair frames are droppable by contract
            if throttled(("repair_tx", self.rank, target_rank),
                         self.cfg.failure_timeout_s):
                self.log.warning(
                    "repair channel to rank %d failed", target_rank
                )
            return False

    def _repair_channel(
        self, target_rank: int, bootstrap: bool = False
    ) -> Communicator | None:
        """Lazily-opened send-only channel to ``target_rank``'s cache
        address — the prefetch-channel pattern, but role-agnostic (a
        router probes peers; a P/D node answers a router's probe at the
        router's bind address). ``bootstrap`` keys a SEPARATE channel
        map so warm-join bulk sessions ride their own connection."""
        return self._p2p_channel(
            target_rank,
            self._bootstrap_comms if bootstrap else self._repair_comms,
        )

    def _p2p_channel(
        self, target_rank: int, comms: dict[int, "Communicator"]
    ) -> Communicator | None:
        """Shared lazy dialer for every dedicated point-to-point channel
        map (repair, bootstrap, owner-addressed data). Dialed OUTSIDE
        the mesh lock: the transport reader thread needs that lock to
        apply oplogs, and a slow first connection must not stall ring
        processing (a racing duplicate dial just closes the loser)."""
        if not 0 <= target_rank < self.cfg.num_total or target_rank == self.rank:
            return None
        with self._lock:
            comm = comms.get(target_rank)
        if comm is not None:
            return comm
        try:
            comm = create_communicator(
                self.cfg.protocol,
                None,
                self.cfg.addr_of_rank(target_rank),
                self.cfg.max_msg_bytes,
                src_hint=self.cfg.local_addr,
            )
        except Exception:  # noqa: BLE001
            self.log.exception(
                "repair channel to rank %d failed to dial", target_rank
            )
            return None
        with self._lock:
            if self._closing:
                # close() already snapshotted the map: inserting now
                # would leak the channel forever — refuse the dial.
                existing = None
            else:
                existing = comms.setdefault(target_rank, comm)
        if existing is not comm:
            comm.close()
        return existing

    def repair_push_keys(
        self, buckets, exclude_hashes: set[int], budget: int
    ) -> tuple[int, int]:
        """Re-replicate this replica's entries touching ``buckets``
        whose path hash is NOT in ``exclude_hashes`` (= the peer's side
        of the summary exchange) as ORDINARY idempotent INSERT oplogs on
        the ring — the existing conflict-resolution path applies them,
        and the master's fan-out carries them to the router, so one
        push heals every replica. Bounded by ``budget`` entries.
        Returns (entries pushed, oplogs enqueued). Routers hold no
        indices and never ring-send: always (0, 0) there."""
        if self.role is NodeRole.ROUTER or not buckets:
            return 0, 0
        keys = oplogs = 0
        with self._lock:
            for node in self.tree.nodes_touching_buckets(buckets):
                if keys >= budget:
                    break
                if self.tree.path_hash(node) in exclude_hashes:
                    continue
                n_ops = self._reemit_entry(node)
                if n_ops:
                    keys += 1
                    oplogs += n_ops
        return keys, oplogs

    def repair_push_shards(
        self, sids, exclude_hashes: set[int], budget: int
    ) -> tuple[int, int]:
        """Owner-scoped repair push (the sharded counterpart of
        :meth:`repair_push_keys`): re-replicate this replica's entries
        in shards ``sids`` whose path hash is NOT in the peer's summary,
        as sharded data re-emissions — delivered to the whole owner set,
        so one push heals every co-owner. Bounded by ``budget`` entries.
        Routers hold no indices: always (0, 0) there."""
        if self.role is NodeRole.ROUTER or not sids:
            return 0, 0
        keys = oplogs = 0
        with self._lock:
            by_shard = self.tree.nodes_in_shards(sids)  # ONE tree walk
            for sid in sids:
                if keys >= budget:
                    break
                for node in by_shard.get(sid, ()):
                    if keys >= budget:
                        break
                    if self.tree.path_hash(node) in exclude_hashes:
                        continue
                    n_ops = self._reemit_entry(node)
                    if n_ops:
                        keys += 1
                        oplogs += n_ops
        return keys, oplogs

    def _reemit_entry(
        self, node: TreeNode, target_rank: int | None = None
    ) -> int:
        """Re-broadcast the full root→``node`` path as INSERT oplogs,
        one per maximal same-rank run of path segments, emitted
        root-first (caller holds the lock, so the data lane preserves
        that order end-to-end). Root-first matters: value ranks along a
        path are non-decreasing with depth (a deeper position's owner is
        the min over a SUBSET of the prefix's writers), so by the time a
        run's frame applies anywhere, its prefix positions already hold
        values of strictly lower rank — the run's value can only land on
        its own span, with its own correct indices.

        ``target_rank`` (sharding: pull-through fill, drain handoff)
        redirects the frames point-to-point at ONE rank (ttl=1 on the
        owner lane) instead of the data broadcast. Returns oplogs
        enqueued (0 when the path isn't re-emittable)."""
        path: list[TreeNode] = []
        n = node
        while n is not None and n is not self.tree.root:
            path.append(n)
            n = n.parent
        path.reverse()
        if not path or any(
            not isinstance(p.value, PrefillValue) for p in path
        ):
            return 0  # router values / evicted spans carry no indices
        full_key = np.concatenate([p.key for p in path])
        full_idx = np.concatenate([p.value.indices for p in path])
        # Maximal same-rank runs over the path's segments.
        run_ends: list[tuple[int, int]] = []  # (end position, rank)
        end = 0
        for p in path:
            end += len(p.key)
            rank = p.value.rank
            if run_ends and run_ends[-1][1] == rank:
                run_ends[-1] = (end, rank)
            else:
                run_ends.append((end, rank))
        sent = 0
        for end, rank in run_ends:
            wire_value = full_idx[:end]
            if self.page > 1:
                try:
                    wire_value = self._page_wire_value(full_idx[:end])
                except ValueError:
                    # A pre-v3 token-granular stray: not representable on
                    # this wire — skip the entry rather than corrupt it.
                    return sent
            op = Oplog(
                op_type=OplogType.INSERT,
                origin_rank=self.rank,
                logic_id=self._logic_op.next(),
                ttl=self._data_ttl(),
                key=full_key[:end],
                value=wire_value,
                value_rank=rank,
                page=self.page,
            )
            if target_rank is None:
                self._broadcast_data(op)
            else:
                op.ts = time.time()
                op.ttl = 1
                self._enqueue_owner(target_rank, serialize(op))
            sent += 1
        return sent

    def _adopt_view(self, view: TopologyView, cause: str = "view_change") -> bool:
        """Adopt ``view`` if it supersedes the current one (higher epoch
        wins; equal-epoch conflicts merge by intersection one epoch up —
        both detectors' removals take effect). ``cause`` tags any
        successor retarget this adoption forces ("dead" / "left" /
        "view_change" — see the transitions counter). Caller holds the
        lock."""
        cur = self.view
        if view.epoch < cur.epoch:
            return False
        if view.epoch == cur.epoch:
            if view.alive == cur.alive:
                return False
            view = cur.merged_with(view)
            self.view = view
            self._after_view_change(cur, cause=cause)
            self._announce_view(view)  # peers must learn the merge result
            return True
        self.view = view
        self._after_view_change(cur, cause=cause)
        return True

    def broadcast_leave(self) -> None:
        """Announce this node's PLANNED departure (the graceful-drain
        endgame, ``policy/lifecycle.py``): one LEAVE oplog carrying our
        view WITHOUT us. Receivers adopt it with cause="left" — channel
        retargets happen proactively, failure detection never fires, and
        FleetView state is forgotten rather than left to rot. Droppable
        like any frame: the lifecycle plane re-announces until it
        observes its own exclusion (the view is epoch-guarded, so
        duplicates are harmless). P/D only — routers never ring-send."""
        if self.role is NodeRole.ROUTER:
            raise RuntimeError("router nodes never originate ring traffic")
        with self._lock:
            leave = self.view.without(self.rank)
            self._broadcast(
                Oplog(
                    op_type=OplogType.LEAVE,
                    origin_rank=self.rank,
                    logic_id=self._logic_op.next(),
                    ttl=self._data_ttl(),
                    value=encode_view(leave),
                )
            )

    def flush_outbound(self, timeout_s: float = 2.0) -> bool:
        """Wait (bounded) for the outbound lanes to drain — the leaver's
        LEAVE must actually reach the wire before the process exits.
        Empty queues mean the sender threads have picked everything up;
        the last in-flight send completes under close()'s thread join."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if (
                self._ctl_q.empty()
                and self._out_q.empty()
                and self._spine_ctl_q.empty()
                and self._spine_out_q.empty()
                # The owner-addressed data lane too: a draining node's
                # shard handoff (handoff_owned_shards) rides it, and
                # LEAVE must not beat those frames out of the process.
                and self._owner_q.empty()
            ):
                return True
            # Bounded wait on the stop event: once sender threads are
            # told to exit the queues will never drain, so give up
            # immediately instead of spinning out the deadline.
            if self._stop.wait(0.01):
                return False
        return False

    def _announce_view(self, view: TopologyView) -> None:
        self._broadcast(
            Oplog(
                op_type=OplogType.TOPO,
                origin_rank=self.rank,
                logic_id=self._logic_op.next(),
                ttl=self._data_ttl(),
                value=encode_view(view),
            )
        )

    def _after_view_change(self, old: TopologyView, cause: str = "view_change") -> None:
        """Recompute the ring successor and notify listeners. Caller holds
        the lock. The actual transport retarget happens on the sender
        thread (``_apply_pending_retarget``) so the receive path never
        blocks on an in-flight send."""
        view = self.view
        self.log.info(
            "topology view epoch=%d alive=%s (was epoch=%d alive=%s)",
            view.epoch, view.alive, old.epoch, old.alive,
        )
        if self.sharded:
            # Re-derive BOTH ownership maps from the ADOPTED view (same
            # pure derivation on every node — epoch-consistent, zero
            # coordination; cache/sharding.py is the single writer of
            # owner sets, these are whole-map swaps). Overrides naming
            # a departed rank are forgotten inside the helper.
            self._base_ownership = build_ownership(
                view.alive, self.rf, view.epoch,
                is_prefill=self.cfg.is_prefill_rank,
            )
            self._derive_effective_locked(self.overrides)
            if self._shard_table is not None:
                # Departed ranks' summaries leave the routing table with
                # the membership (their advertised warmth is unreachable;
                # the FleetView's shard fps go with its retain below).
                self._shard_table.retain(view.alive)
        if self.role is not NodeRole.ROUTER:
            if self.hier is not None:
                alive = self._my_alive()
                new_succ = self.hier.group_successor(self.rank, alive)
                new_spine = (
                    self.hier.spine_successor(self.rank, alive)
                    if self.hier.is_leader(self.rank, alive)
                    else None
                )
                if new_spine != self._spine_rank:
                    self._spine_rank = new_spine
                    self._pending_retargets["spine"] = (
                        None if new_spine is None else self.cfg.addr_of_rank(new_spine)
                    )
                    self._retarget_flags["spine"].set()
                    self._spine_evt.set()
            else:
                new_succ = view.successor_of(self.rank)
            if new_succ != self._succ_rank:
                self._succ_rank = new_succ
                self._m_succ_trans[cause].inc()
                self._pending_retargets["ring"] = (
                    None if new_succ is None else self.cfg.addr_of_rank(new_succ)
                )
                self._retarget_flags["ring"].set()
                self._send_evt.set()
            if not view.contains(self.rank):
                lc = self.lifecycle
                if lc is not None and lc.is_departing:
                    # PLANNED exclusion (our own LEAVE coming back, or a
                    # peer reacting to it): rejoining would undo the
                    # drain (policy/lifecycle.py).
                    self.log.info(
                        "removed from the view during drain — expected"
                    )
                else:
                    # Falsely declared dead (we're alive enough to
                    # receive this): ask to be re-included.
                    self.log.warning(
                        "this node was removed from the view; rejoining"
                    )
                    self._broadcast(
                        Oplog(
                            op_type=OplogType.JOIN,
                            origin_rank=self.rank,
                            logic_id=self._logic_op.next(),
                            ttl=self._data_ttl(),
                        )
                    )
        # Departed nodes leave the fleet view with the membership: their
        # last digest must not pin min_score at the stale cap or hold
        # convergence pairs diverged forever (rejoiners re-fold fresh).
        self.fleet.retain(self._my_alive() if self.role is not NodeRole.ROUTER
                          else view.alive)
        self._update_membership_gauges()
        for fn in self.on_view_change:
            try:
                fn(old, view)
            except Exception:  # noqa: BLE001 — listener bugs must not break adoption
                self.log.exception("view-change listener failed")

    def _update_membership_gauges(self) -> None:
        """Refresh the membership gauges from the current view (called
        under the lock on view change; from __init__/start before threads
        exist). Values come from ``policy/topology.py::membership_gauges``
        so the flat/hier semantics live next to the view logic."""
        vals = membership_gauges(
            self.view,
            self.rank,
            alive=(
                self._my_alive()
                if self.role is not NodeRole.ROUTER
                else self.view.alive
            ),
            hier=self.hier if self.role is not NodeRole.ROUTER else None,
            succ_rank=self._succ_rank,
        )
        for key, g in self._g_membership.items():
            g.set(vals[key])

    def _declare_successor_dead(self, dest: str = "ring") -> None:
        """Sender-side failure detection fired: the current successor on
        ``dest`` ("ring" = group/flat successor, "spine" = next leader)
        has been unreachable for ``failure_timeout_s``. Adopt a view
        without it and announce the new view around the re-formed ring."""
        with self._lock:
            dead = self._spine_rank if dest == "spine" else self._succ_rank
            if dead is None:
                return
            if throttled(
                ("succ_dead", self.rank, dest, dead), self.cfg.failure_timeout_s
            ):
                self.log.warning(
                    "%s successor rank %d unreachable for %.1fs — declaring it "
                    "dead and re-forming the ring",
                    dest, dead, self.cfg.failure_timeout_s,
                )
            old = self.view
            new_view = old.without(dead)
            self.view = new_view
            # cause="dead": this is the UNPLANNED path — a peer's
            # graceful LEAVE retargets with cause="left" instead, so
            # dashboards can tell churn from failure.
            self._after_view_change(old, cause="dead")
            self._announce_view(new_view)

    def _apply_pending_retarget(self, dest: str) -> None:
        """Runs on ``dest``'s sender thread only (serialized with its
        sends)."""
        flag = self._retarget_flags[dest]
        if not flag.is_set():
            return
        with self._lock:
            if dest not in self._pending_retargets:
                flag.clear()
                return
            target = self._pending_retargets.pop(dest)
            flag.clear()
        comm = self._spine_comm if dest == "spine" else self._comm
        if comm is None:
            return
        try:
            comm.retarget(target)
            # A retarget destination is a current view member (it was
            # alive enough to be in an adopted view / send JOIN), so it
            # gets the failure deadline, NOT first-contact unbounded
            # patience — a double failure must fire detection again, not
            # wedge the sender in a blocking send to a second dead peer.
            # A slow rejoiner spuriously re-declared dead simply rejoins
            # again.
            if dest == "spine":
                self._spine_established = target is not None
            else:
                self._succ_established = True
        except Exception:  # noqa: BLE001
            self.log.exception("failed to retarget %s successor to %s", dest, target)

    # ------------------------------------------------------------------
    # replication: send path
    # ------------------------------------------------------------------

    _CONTROL_TYPES = (
        OplogType.TICK, OplogType.TOPO, OplogType.JOIN, OplogType.LEAVE,
        # Ownership moves are membership-grade control: an override
        # queued behind a replication backlog would split the fleet's
        # owner sets for the backlog's whole drain time.
        OplogType.REBALANCE,
    )

    def _broadcast(self, op: Oplog) -> None:
        """First transmission of a locally-originated oplog
        (reference ``radix_mesh.py:325-347``). A leader-origin in hier
        mode emits both scopes directly: its group never delivers the op
        *to* it, so the group-lap bridge rule can't fire."""
        op.ts = time.time()
        control = op.op_type in self._CONTROL_TYPES
        data = serialize(op)
        self._send_bytes(data, control=control)
        if (
            self.hier is not None
            and self.role is not NodeRole.ROUTER
            and self.hier.is_leader(self.rank, self._my_alive())
        ):
            self._bridge_to_spine(op, data, control=control)
            if op.op_type is OplogType.TICK:
                # A NON-leader origin's two-lap tick passes its leader —
                # and bridges — twice; a leader-origin never receives its
                # own tick, so emit the second spine copy here to deliver
                # the same two ticks per origination to remote groups.
                self._bridge_to_spine(op, data, control=control)

    def _send_bytes(self, data: bytes, control: bool = False, dest: str = "ring") -> None:
        """Enqueue for transmission. Called under the lock by receive-path
        forwards and after local application by the public API — the data
        lane's FIFO makes wire order equal application order; control
        frames take the priority lane (drained first by the sender).
        The ring and spine channels have independent lanes + sender
        threads so a leader's bridge traffic never queues behind its
        group forwards (or vice versa)."""
        if not self._started or not self.sync.can_send(self.cfg):
            return
        if dest == "spine":
            q = self._spine_ctl_q if control else self._spine_out_q
            evt = self._spine_evt
        else:
            q = self._ctl_q if control else self._out_q
            evt = self._send_evt
        try:
            q.put_nowait(data)
            self._m_sent.inc()
            evt.set()
        except queue.Full:
            self._m_dropped.inc()
            self._note_drop(data, "queue_full")
            dropped = int(self._m_dropped.value)
            if dropped % 1000 == 1:
                self.log.error(
                    "outbound oplog queue full (%d dropped) — ring successor "
                    "unreachable for an extended period?",
                    dropped,
                )

    def _note_drop(self, data: bytes, cause: str) -> None:
        """Account a lost outbound frame by cause AND op kind (the kind
        byte sits at a fixed wire offset, so no deserialize on this
        path), then fire the recovery hook: a DATA-kind loss means some
        downstream replica is now known-diverged, so the repair plane
        arms an early probe instead of waiting out the fingerprint
        staleness threshold."""
        kind_int = data[2] if len(data) > 2 else -1
        try:
            kind = OplogType(kind_int).name
        except ValueError:
            kind = str(kind_int)
        self._m_dropped_by.labels(
            node=self._node_label, cause=cause, kind=kind
        ).inc()
        cb = self.on_oplog_dropped
        if cb is not None:
            try:
                cb(cause, kind_int)
            except Exception:  # noqa: BLE001 — a hook bug must not lose more frames
                self.log.exception("oplog-dropped hook failed")

    # ------------------------------------------------------------------
    # prefix-ownership sharding: owner-addressed delivery
    # (cache/sharding.py; replication_factor > 0)
    # ------------------------------------------------------------------

    def _broadcast_data(self, op: Oplog) -> None:
        """First transmission of a locally-originated DATA op. Full
        replica (rf == 0): the ordinary ring broadcast, bit-for-bit.
        Sharded: serialize once and enqueue point-to-point to the key's
        owner set — the O(RF) wire cost that replaces the O(N) lap.
        Caller holds the lock (wire order == application order per
        target, exactly the ring lane's contract)."""
        if not self.sharded or self.role is NodeRole.ROUTER:
            self._broadcast(op)
            if op.op_type is OplogType.INSERT and self._started:
                # Fleet-wide wire cost of this insert: one frame per ring
                # member (every hop forwards it once).
                self._note_insert_bytes(
                    len(serialize(op)) * max(1, self.view.ring_size)
                )
            return
        if op.op_type is OplogType.RESET:
            # Whole-tree op: shardless, rare — keep the ring lap.
            self._broadcast(op)
            return
        op.ts = time.time()
        op.ttl = 1  # point-to-point: one hop, never circulated
        data = serialize(op)
        sid = shard_of_tokens(op.key[: max(1, self.page)])
        owners = self.ownership.owners_of(sid) if self.ownership else ()
        targets = [r for r in owners if r != self.rank]
        for rank in targets:
            self._enqueue_owner(rank, data)
        if op.op_type is OplogType.INSERT:
            self._note_insert_bytes(len(data) * len(targets))
            if self.heat is not None:
                self.heat.note_insert(
                    sid, len(op.key), len(data) * max(1, len(targets))
                )

    def _note_insert_bytes(self, nbytes: int) -> None:
        self._bpi_ewma += 0.2 * (float(nbytes) - self._bpi_ewma)
        self._g_bytes_per_insert.set(self._bpi_ewma)

    def _enqueue_owner(self, rank: int, data: bytes) -> None:
        """Queue one frame for the owner-sender thread (bounded; drops
        count + arm the repair plane's early probe, same honest
        degradation as the ring lane)."""
        if not self._started or not self.sync.can_send(self.cfg):
            return
        try:
            self._owner_q.put_nowait((rank, data))
            self._m_sent.inc()
            self._owner_evt.set()
        except queue.Full:
            self._m_dropped.inc()
            self._note_drop(data, "queue_full")

    def _owner_channel(self, target_rank: int) -> Communicator | None:
        return self._p2p_channel(target_rank, self._owner_comms)

    def _owner_sender(self) -> None:
        """Dedicated transmit thread for owner-addressed data frames —
        the sharded counterpart of the ring sender: a slow or dead owner
        can never stall tree operations (bounded sends; a failed send
        drops the frame, counted, and anti-entropy heals the gap)."""
        while not self._stop.is_set():
            try:
                rank, data = self._owner_q.get_nowait()
            except queue.Empty:
                self._owner_evt.wait(timeout=0.2)
                self._owner_evt.clear()
                continue
            comm = self._owner_channel(rank)
            if comm is None:
                self._note_drop(data, "transmit")
                continue
            try:
                # SHORT bound, like the router fan-out — one dead/slow
                # owner must cost ~1s per frame, never head-of-line-block
                # every other owner behind the shared queue for a full
                # failure timeout. A dropped frame is healed by the
                # owner-scoped anti-entropy scan (the drop arms it).
                if not comm.try_send(
                    data, min(1.0, self.cfg.failure_timeout_s)
                ):
                    self._note_drop(data, "transmit")
            except Exception:  # noqa: BLE001 — transport errors must not kill the sender
                if not self._stop.is_set():
                    if throttled(
                        ("owner_tx", self.rank, rank), self.cfg.failure_timeout_s
                    ):
                        self.log.exception(
                            "owner-addressed send to rank %d failed", rank
                        )
                    self._note_drop(data, "transmit")

    def _refresh_owned_shards(self) -> None:
        if self.ownership is not None and self.role is not NodeRole.ROUTER:
            self._g_owned_shards.set(
                len(self.ownership.owned_shards(self.rank))
            )

    def owner_ranks(self, key) -> tuple[int, ...]:
        """The CURRENT owner set of ``key``'s shard, view-filtered — the
        router's failover/fallback candidate list (the failover invariant
        "a survivor holds the prefix" holds within this set). Empty when
        unsharded."""
        if self.ownership is None:
            return ()
        key = as_key(key)
        if len(key) == 0:
            return ()
        sid = shard_of_tokens(key[: max(1, self.page)])
        return tuple(
            r for r in self.ownership.owners_of(sid) if self.view.contains(r)
        )

    def diverged_shards_with(self, rank: int) -> list[int]:
        """Shards this node CO-OWNS with ``rank`` whose fingerprints
        disagree (mine from the tree, theirs from gossiped summaries) —
        the owner-scoped convergence unit: whole-tree fingerprints
        diverge BY DESIGN under sharding, so repair, bootstrap, and
        convergence auditing all compare per shard, per owner pair.
        A co-owned shard the peer has not yet summarized counts as
        diverged (an empty joiner must not read as converged). Empty
        list when unsharded or nothing is co-owned."""
        if not self.sharded or self.ownership is None:
            return []
        mine = self.tree.shard_fingerprints()
        theirs = self.fleet.shard_fps(rank)
        out = []
        for sid in self.ownership.owned_shards(self.rank):
            if not self.ownership.is_owner(rank, sid):
                continue
            if theirs.get(sid) != (mine.get(sid, 0) & ((1 << 64) - 1)):
                out.append(sid)
        return out

    def convergence_peers(self) -> list[int]:
        """Peer ranks with enough gossiped state to be convergence-
        compared (lifecycle cold-boot deadlock breaker): digest
        fingerprints unsharded, shard-summary reporters sharded."""
        if self.sharded:
            peers = self.fleet.shard_fingerprints()
        else:
            peers = self.fleet.fingerprints()
        return [r for r in peers if r != self.rank]

    def bootstrap_converged_with(self, rank: int) -> bool:
        """The lifecycle plane's warm-join convergence check against a
        donor: full replica → scalar fingerprint equality (the unsharded
        semantics); sharded → every co-owned shard agrees AND the peer
        has summarized at least once (gossip silence is not
        convergence)."""
        if not self.sharded:
            theirs = self.fleet.fingerprints().get(rank)
            mask = (1 << 64) - 1
            return (
                theirs is not None
                and (theirs & mask) == (self.tree.fingerprint_ & mask)
            )
        if not self.fleet.shard_fps(rank):
            return False
        return not self.diverged_shards_with(rank)

    def broadcast_shard_summary(self) -> int:
        """Ring one SHARD_SUMMARY frame: this node's per-owned-shard
        fingerprints + bounded root summaries (the router's routing
        table and the co-owner convergence currency). One frame per
        interval per node — the control-plane cost that replaces the
        per-insert lap. P/D only; returns the shard count published."""
        if not self.sharded or self.role is NodeRole.ROUTER:
            return 0
        with self._lock:
            owned = self.ownership.owned_shards(self.rank)
            if not owned:
                return 0
            per_shard = max(4, MAX_SUMMARY_ROOTS // len(owned))
            fps = self.tree.shard_fingerprints()
            shards = {
                sid: (
                    fps.get(sid, 0),
                    self.tree.shard_root_summaries(sid, per_shard),
                )
                for sid in owned
            }
            # Per-shard heat: decayed loads for the OWNED shards
            # ride the same frame as an old-wire-tolerant trailer — the
            # cluster heat map costs zero extra frames.
            loads = {}
            if self.heat is not None:
                all_loads = self.heat.loads()
                loads = {
                    sid: all_loads[sid] for sid in owned if sid in all_loads
                }
                for sid, load in loads.items():
                    self._g_shard_heat.labels(
                        node=self._node_label, shard=str(sid)
                    ).set(load)
                # Shards published last interval but silent now (cooled
                # to zero, or no longer owned) must read 0, not their
                # last hot value — a scraped gauge has no whole-summary
                # swap to correct it.
                for sid in self._heat_gauge_sids - set(loads):
                    self._g_shard_heat.labels(
                        node=self._node_label, shard=str(sid)
                    ).set(0.0)
                self._heat_gauge_sids = set(loads)
            # Fold locally first (same contract as broadcast_digest):
            # this node's own view is as fresh as anyone's.
            self.fleet.fold_shard_fps(
                self.rank, {sid: fp for sid, (fp, _) in shards.items()}
            )
            self.fleet.fold_shard_heat(self.rank, loads)
            self._g_skew.set(self.fleet.shard_heat()["skew_score"])
            if self._shard_table is not None:
                self._shard_table.fold(self.rank, shards)
            self._broadcast(
                Oplog(
                    op_type=OplogType.SHARD_SUMMARY,
                    origin_rank=self.rank,
                    logic_id=self._logic_op.next(),
                    ttl=self._data_ttl(),
                    value=encode_shard_summary(self.rank, shards, loads),
                    value_rank=self.rank,
                )
            )
        return len(shards)

    def _handle_shard_summary(self, op: Oplog, data: bytes) -> None:
        """Caller holds the lock; ttl already decremented. Fold-then-
        forward like DIGEST; idempotent (whole-summary swap per rank)."""
        if op.origin_rank == self.rank:
            return  # lap complete
        try:
            origin, shards, loads = decode_shard_summary(op.value)
        except ValueError:
            if throttled(("bad_shard_summary", self.rank),
                         self.cfg.tick_interval_s):
                self.log.warning(
                    "malformed SHARD_SUMMARY from rank %d", op.origin_rank
                )
            self._circulate(op, data)
            return
        self.fleet.fold_shard_fps(
            origin, {sid: fp for sid, (fp, _) in shards.items()}
        )
        self.fleet.fold_shard_heat(origin, loads)
        if self._shard_table is not None:
            self._shard_table.fold(origin, shards)
        self._circulate(op, data)

    def send_shard_pull(
        self, key, owner_rank: int, target_rank: int
    ) -> bool:
        """Pull-through request: ask ``owner_rank`` to re-emit its
        cached entries for ``key``'s prefix point-to-point to
        ``target_rank`` (a non-owner about to serve that subtree).
        Fire-and-forget and idempotent like PREFETCH — a lost pull
        costs the target a cache miss, never correctness. Routers use
        their dedicated fire-and-forget channels (they never ring-send);
        P/D requesters ride the owner lane."""
        key = as_key(key)
        if not self.sharded or len(key) == 0 or owner_rank == target_rank:
            return False
        op = Oplog(
            op_type=OplogType.SHARD_PULL,
            origin_rank=self.rank,
            logic_id=self._logic_op.next(),
            ttl=1,
            key=key,
            value=np.asarray(
                [shard_of_tokens(key[: max(1, self.page)])], dtype=np.int32
            ),
            value_rank=target_rank,
            ts=time.time(),
        )
        if self.role is not NodeRole.ROUTER:
            with self._lock:
                self._enqueue_owner(owner_rank, serialize(op))
            self._m_pullthrough.labels(
                node=self._node_label, outcome="sent"
            ).inc()
            return True
        comm = self._prefetch_channel(owner_rank)
        ok = False
        if comm is not None:
            try:
                ok = bool(comm.try_send(serialize(op), 0.05))
            except Exception:  # noqa: BLE001 — pulls are droppable by contract
                ok = False
        self._m_pullthrough.labels(
            node=self._node_label,
            outcome="sent" if ok else "send_failed",
        ).inc()
        return ok

    def _handle_shard_pull(self, op: Oplog) -> None:
        """Caller holds the lock; point-to-point (never circulated). Re-
        emit the matched entry's path to the beneficiary rank as ttl=1
        INSERT frames — the pull-through fill. Cheap: one read-only tree
        walk + bounded enqueues on the transport reader thread."""
        if self.role is NodeRole.ROUTER:
            return  # routers hold no indices to push
        target = op.value_rank
        if not 0 <= target < self.cfg.num_total or target == self.rank:
            return
        res = self.tree.match_prefix(op.key, split_partial=False)
        node = res.last_node
        if res.length == 0 or node is None or node is self.tree.root:
            self._m_pullthrough.labels(
                node=self._node_label, outcome="miss"
            ).inc()
            return
        if self._reemit_entry(node, target_rank=target):
            self._m_pullthrough.labels(
                node=self._node_label, outcome="served"
            ).inc()
            if self.heat is not None:
                self.heat.note_pull(
                    shard_of_tokens(op.key[: max(1, self.page)])
                )
        else:
            self._m_pullthrough.labels(
                node=self._node_label, outcome="miss"
            ).inc()

    def shard_route(self, key) -> RouterMatchResult:
        """Summary-based router match (the sharded replacement for the
        router's tree replica): which owner ranks advertise ``key``'s
        subtree as warm, and an estimated match length (min of the
        request's aligned length and the advertised deepest cached
        path — an upper bound; the serving node reports true hits)."""
        key = as_key(key)
        if len(key) == 0 or self._shard_table is None or self.ownership is None:
            return RouterMatchResult(-1, -1)
        page = max(1, self.page)
        sid = shard_of_tokens(key[:page])
        rh = root_page_hash(key, page)
        aligned = len(key) - len(key) % page if self.page > 1 else len(key)
        with self._lock:
            warm = self._shard_table.lookup(sid, rh)
            view = self.view
        prefill_rank = decode_rank = -1
        match_len = 0
        # Deepest-first: the rank advertising the longest cached path
        # wins its role slot (mirrors _route_from_values' deepest-writer
        # rule).
        for rank, depth in sorted(warm.items(), key=lambda kv: -kv[1]):
            if not view.contains(rank):
                continue
            est = min(aligned, int(depth))
            if prefill_rank == -1 and self.cfg.is_prefill_rank(rank):
                prefill_rank = rank
                match_len = max(match_len, est)
            if decode_rank == -1 and self.cfg.is_decode_rank(rank):
                decode_rank = rank
                match_len = max(match_len, est)
            if prefill_rank != -1 and decode_rank != -1:
                break
        return RouterMatchResult(
            prefill_rank=prefill_rank,
            decode_rank=decode_rank,
            match_len=match_len,
        )

    def shard_heat_report(self) -> dict:
        """The fleet heat map (``FleetView.shard_heat``) enriched with
        what only a node holding the ownership map can add: the HOT
        shard's current owner set — the exact ranks a rebalancer would
        move load off of. Served on ``/cluster/telemetry`` from every
        role (the router folds the same gossip)."""
        out = self.fleet.shard_heat()
        hot = out.get("hot_shard")
        if hot is not None and self.ownership is not None:
            out["hot_owners"] = list(self.ownership.owners_of(int(hot)))
        else:
            out["hot_owners"] = []
        return out

    def handoff_owned_shards(self) -> dict:
        """Drain-time ownership transfer (policy/lifecycle.py): push
        each owned shard's entries to the ranks that BECOME owners once
        this node leaves, so the RF invariant survives the departure
        without waiting out anti-entropy. One ``shard_transfer`` span
        per shard on the recorder. Returns transfer stats."""
        stats = {"shards": 0, "entries": 0, "targets": 0}
        if not self.sharded or self.role is NodeRole.ROUTER:
            return stats
        rec = get_recorder()
        with self._lock:
            cur = self.ownership
            survivors = [r for r in self.view.alive if r != self.rank]
            if not survivors or cur is None:
                return stats
            future = build_ownership(
                survivors, self.rf, self.view.epoch + 1,
                is_prefill=self.cfg.is_prefill_rank,
                # The survivors will keep the adopted overrides minus
                # entries naming the leaver — hand off to the exact
                # owner sets they will derive.
                overrides=self.overrides.without_ranks({self.rank}),
            )
            owned = cur.owned_shards(self.rank)
            by_shard = self.tree.nodes_in_shards(owned)  # ONE tree walk
            for sid in owned:
                gained = [
                    r for r in future.owners_of(sid)
                    if r not in cur.owners_of(sid)
                ]
                if not gained:
                    continue
                t0 = time.monotonic()
                entries = 0
                for n in by_shard.get(sid, ()):
                    if n.children:
                        continue  # a leaf's re-emit covers its ancestors
                    for tgt in gained:
                        if self._reemit_entry(n, target_rank=tgt):
                            entries += 1
                stats["shards"] += 1
                stats["entries"] += entries
                stats["targets"] += len(gained)
                if rec.enabled:
                    rec.event(
                        f"ring:{self._node_label}",
                        "shard_transfer",
                        t0,
                        time.monotonic() - t0,
                        cat="ring",
                        shard=int(sid),
                        targets=len(gained),
                        entries=int(entries),
                    )
        return stats

    # ------------------------------------------------------------------
    # heat-driven rebalancing (cache/rebalance.py; replication_factor > 0)
    # ------------------------------------------------------------------

    def heat_loads(self) -> dict[int, float]:
        """This node's decayed per-shard loads, snapshotted under the
        mesh lock (ShardHeat itself is not thread-safe — every counting
        site runs under this lock, so readers must too). Empty when
        unsharded / router."""
        if self.heat is None:
            return {}
        with self._lock:
            return self.heat.loads()

    def set_heat_clock(self, now=time.monotonic) -> None:
        """Run this node's heat cells on ``now`` (monotonic seconds, which
        at the swap must not read behind the clock it replaces: the
        cells' stamps came from that one); ``time.monotonic`` restores
        the wall clock."""
        if self.heat is None:
            return
        with self._lock:
            self.heat.set_clock(now)

    def base_owners_of(self, sid: int) -> tuple[int, ...]:
        """The shard's BASE RF-successor walk under the current view —
        the owner set with no overrides applied (the rebalancer's boost
        baseline and shrink target). Empty when unsharded."""
        with self._lock:
            base = self._base_ownership
        return base.owners_of(sid) if base is not None else ()

    def adopt_overrides(self, ovr) -> bool:
        """Adopt a LOCAL rebalance decision (``cache/rebalance.py`` is
        the only caller that originates one): apply the overrides,
        re-derive the effective ownership map, hand off entries to
        ranks that gained ownership, and gossip the decision as a
        REBALANCE oplog so every node converges on the same map.
        Returns False when ``ovr`` does not supersede the current
        overrides (stale epoch or replayed version — rollback refused)."""
        if not self.sharded:
            return False
        with self._lock:
            if not self._apply_overrides_locked(ovr):
                return False
            if self.role is not NodeRole.ROUTER:
                self._broadcast(
                    Oplog(
                        op_type=OplogType.REBALANCE,
                        origin_rank=self.rank,
                        logic_id=self._logic_op.next(),
                        ttl=self._data_ttl(),
                        value=encode_overrides(self.overrides),
                        value_rank=self.rank,
                    )
                )
        return True

    def _derive_effective_locked(self, ovr) -> None:
        """THE one derivation of the effective ownership map (caller
        holds the lock; both the view-change and override-fold paths
        come through here so the forget discipline and the
        empty-override fast path cannot fork): drop entries naming
        ranks outside the current view — a departed rank's overrides
        are forgotten (the FleetView.forget discipline; a decider
        racing a death must not resurrect a ghost owner; (epoch,
        version) preserved so the filter never reads as a rollback) —
        then swap the whole map."""
        dead = [
            r for r in range(self.cfg.num_ring)
            if not self.view.contains(r)
        ]
        ovr = ovr.without_ranks(dead)
        self.overrides = ovr
        self.ownership = (
            self._base_ownership
            if not len(ovr)
            else build_ownership(
                self.view.alive, self.rf, self.view.epoch,
                is_prefill=self.cfg.is_prefill_rank,
                overrides=ovr,
            )
        )
        self._refresh_owned_shards()

    def _apply_overrides_locked(self, ovr) -> bool:
        """Fold one override map (caller holds the lock): strict
        (epoch, version) supersession — an epoch rollback or a replayed
        frame is refused — then the whole-map ownership swap and the
        zero-loss handoff to gained owners."""
        if not ovr.supersedes(self.overrides):
            return False
        old_map = self.ownership
        self._derive_effective_locked(ovr)
        self._handoff_gained_owners(old_map, self.ownership)
        return True

    def _handoff_gained_owners(self, old, new) -> int:
        """Zero-loss ownership move (caller holds the lock): for every
        shard whose owner set GREW, the shard's old PRIMARY owner
        re-emits its cached entries point-to-point to each gained rank
        — the drain-handoff machinery (``handoff_owned_shards``) scoped
        to the moved shards. One pusher per shard (the deterministic
        primary), so co-owners never multiply the same bytes; a dead
        primary's gap is healed by owner-scoped anti-entropy repair.
        In-flight requests on the old owners finish normally — their
        replicas keep every entry; only responsibility moved."""
        if (
            old is None
            or new is None
            or self.role is NodeRole.ROUTER
        ):
            return 0
        moved: dict[int, list[int]] = {}
        for sid in old.owned_shards(self.rank):
            if old.primary(sid) != self.rank:
                continue
            gained = [
                r for r in new.owners_of(sid)
                if r not in old.owners_of(sid) and r != self.rank
            ]
            if gained:
                moved[sid] = gained
        if not moved:
            return 0
        rec = get_recorder()
        pushed = 0
        by_shard = self.tree.nodes_in_shards(list(moved))  # ONE tree walk
        for sid, gained in moved.items():
            t0 = time.monotonic()
            entries = 0
            for n in by_shard.get(sid, ()):
                if n.children:
                    continue  # a leaf's re-emit covers its ancestors
                for tgt in gained:
                    if self._reemit_entry(n, target_rank=tgt):
                        entries += 1
            pushed += entries
            if rec.enabled:
                rec.event(
                    f"ring:{self._node_label}",
                    "shard_transfer",
                    t0,
                    time.monotonic() - t0,
                    cat="ring",
                    shard=int(sid),
                    targets=len(gained),
                    entries=int(entries),
                    cause="rebalance",
                )
        return pushed

    def _handle_rebalance(self, op: Oplog, data: bytes) -> None:
        """Caller holds the lock; ttl already decremented. Fold-then-
        forward like TOPO: idempotent ((epoch, version)-guarded whole-map
        swap), and unsharded nodes still forward so a mixed roll cannot
        partition the gossip."""
        if op.origin_rank == self.rank:
            return  # lap complete
        if self.sharded:
            try:
                ovr = decode_overrides(op.value)
            except ValueError:
                if throttled(("bad_rebalance", self.rank),
                             self.cfg.tick_interval_s):
                    self.log.warning(
                        "malformed REBALANCE payload from rank %d",
                        op.origin_rank,
                    )
                self._circulate(op, data, control=True)
                return
            self._apply_overrides_locked(ovr)
        self._circulate(op, data, control=True)

    def _sender(self) -> None:
        """Dedicated transmit thread: the only place the control plane
        touches the network, so a slow/unreachable successor can never
        stall tree operations. Polls with a timeout instead of a queue
        sentinel: close() on a *full* queue must not need to enqueue
        anything to stop this thread.

        This is also where failure detection lives: in a unidirectional
        ring only a node's predecessor can observe its death, as the
        transmit channel stops delivering. The first delivery to each
        successor blocks indefinitely (cluster startup — peers may still be
        binding, like the reference's connect-retry loop,
        ``communicator.py:162-178``); established successors get
        ``failure_timeout_s`` before being declared dead and ringed around
        (``_declare_successor_dead``)."""
        self._sender_loop("ring", self._ctl_q, self._out_q, self._send_evt)

    def _spine_sender(self) -> None:
        """The spine channel's dedicated transmit thread (hier leaders):
        bridge traffic must not serialize behind group forwards — the
        leader is exactly the node whose send bandwidth the hierarchy
        hinges on."""
        self._sender_loop("spine", self._spine_ctl_q, self._spine_out_q, self._spine_evt)

    def _sender_loop(
        self,
        dest: str,
        ctl_q: "queue.Queue[bytes]",
        out_q: "queue.Queue[bytes]",
        evt: threading.Event,
    ) -> None:
        while not self._stop.is_set():
            self._apply_pending_retarget(dest)
            # Wait for ANY lane to fill; drain control first, then one
            # data frame per pass (so a control frame arriving mid-bulk
            # overtakes the rest of the backlog at the next pass).
            try:
                data = ctl_q.get_nowait()
            except queue.Empty:
                try:
                    data = out_q.get_nowait()
                except queue.Empty:
                    evt.wait(timeout=0.2)
                    evt.clear()
                    continue
            while not self._stop.is_set():
                if self._retarget_flags[dest].is_set():
                    self._apply_pending_retarget(dest)
                    continue
                if dest == "spine":
                    comm = self._spine_comm
                    with self._lock:
                        target = self._spine_rank
                    if comm is None or target is None:
                        # Demoted (or degenerate single group) since the
                        # frame was queued — nothing to bridge to.
                        break
                    established = self._spine_established
                else:
                    comm = self._comm
                    with self._lock:
                        target = self._succ_rank
                    if target is None:
                        break  # sole survivor: nothing to ring (fan-out below)
                    established = self._succ_established
                try:
                    if not established:
                        # Never-seen-alive successors get startup-grace
                        # patience (cluster boot: the peer may still be
                        # binding, like the reference's connect-retry
                        # loop) — but NOT unbounded patience: a node that
                        # restarts while its static successor is also dead
                        # must eventually ring around it or it can never
                        # deliver its JOIN.
                        if comm.try_send(data, self.cfg.effective_startup_grace_s):
                            if dest == "spine":
                                self._spine_established = comm.connected()
                            else:
                                self._succ_established = comm.connected()
                            break
                    elif comm.try_send(data, self.cfg.failure_timeout_s):
                        break
                except Exception:  # noqa: BLE001 — transport errors must not kill the sender
                    if not self._stop.is_set() and throttled(
                        ("tx_fail", self.rank, dest), self.cfg.failure_timeout_s
                    ):
                        self.log.exception("failed to transmit oplog")
                    # The frame is LOST (this break abandons it): account
                    # the loss with its op kind and let the repair plane
                    # arm an early probe for data-kind frames.
                    if not self._stop.is_set():
                        self._note_drop(data, "transmit")
                    break
                self._declare_successor_dead(dest)
            # The CURRENT view master fans out to routers (generalizes the
            # reference's static rank-0 fan-out, radix_mesh.py:344-347, so
            # routers keep learning the tree after rank 0 dies). Ring
            # frames only: every op the master transmits passes its ring
            # channel at least once, so fanning spine copies too would
            # just duplicate the router's stream.
            if dest != "ring":
                continue
            with self._lock:
                is_master = self.rank == self.view.master_rank()
            if is_master:
                self._fan_out_to_routers(data)

    def _fan_out_to_routers(self, data: bytes) -> None:
        """Bounded fan-out: routers are OUTSIDE the ring, so their
        unavailability must never cost ring liveness — attempts are
        deadline-bounded and an unreachable router is backed off (its
        fan-outs dropped) instead of stalling the sender thread per
        message. A dropped fan-out costs the router cache hits until the
        next circulating oplog, not correctness."""
        now = time.monotonic()
        for rc in self._router_comms:
            st = self._router_state.setdefault(
                id(rc), {"established": False, "retry_at": 0.0}
            )
            if now < st["retry_at"]:
                continue  # backing off an unreachable router
            # Always a SHORT probe: this runs on the ring sender thread, so
            # a down router must cost at most ~1s per backoff window, never
            # a full failure_timeout stall of ring replication. Correctness
            # tolerates dropped fan-outs (the router just misses hits).
            timeout = min(1.0, self.cfg.failure_timeout_s)
            try:
                if rc.try_send(data, timeout):
                    st["established"] = True
                    st["retry_at"] = 0.0
                else:
                    # Short retry cadence pre-first-contact (a booting
                    # router should start receiving within ~a second of
                    # coming up); long backoff for a router that was live
                    # and went away.
                    st["retry_at"] = time.monotonic() + (
                        self.cfg.failure_timeout_s
                        if st["established"]
                        else min(1.0, self.cfg.failure_timeout_s)
                    )
                    if st["established"] and throttled(
                        ("router_down", self.rank, rc.target_address()),
                        self.cfg.failure_timeout_s,
                    ):
                        self.log.error(
                            "router %s unreachable; backing off fan-out",
                            rc.target_address(),
                        )
                    st["established"] = False
            except Exception:  # noqa: BLE001
                if not self._stop.is_set():
                    self.log.exception("router fan-out failed")

    # ------------------------------------------------------------------
    # tree mutation with conflict resolution
    # ------------------------------------------------------------------

    def _page_wire_value(self, slot_indices: np.ndarray) -> np.ndarray:
        """Compress per-token slot indices to one page id per
        ``self.page`` tokens for the v3 wire (requires within-page slot
        contiguity — the paged allocator's invariant; raises on a
        violation so a misaligned caller fails at the source)."""
        by_page = np.asarray(slot_indices, dtype=np.int32).reshape(-1, self.page)
        page_ids = by_page[:, 0] // self.page
        expected = (
            page_ids[:, None] * self.page
            + np.arange(self.page, dtype=np.int32)[None, :]
        )
        if not np.array_equal(by_page, expected):
            raise ValueError(
                "slot_indices are not page-contiguous at mesh "
                f"page_size={self.page}"
            )
        return page_ids.astype(np.int32)

    def _mesh_insert(self, key: np.ndarray, value) -> int:
        """Insert with rank-conflict resolution via the tree's conflict
        hook (reference overrides the whole walk instead,
        ``radix_mesh.py:273-323``). Caller holds the lock. Returns the
        length of the already-present prefix."""
        # Positions of this op that WIN (or merge cleanly) become
        # tree-owned; positions that LOSE are re-claimed by _record_dup
        # during the walk. Releasing the op's ids up front makes that
        # partition exact even when earlier deliveries claimed the same
        # ids under since-split node keys (granularity drift).
        self._unclaim(value)
        n = self.tree.insert(key, value, on_conflict=self._resolve_conflict)
        self._trim_to_budget()
        return n

    def _trim_to_budget(self) -> None:
        """Bound the replica: LRU-trim unlocked entries beyond
        ``cfg.mesh_max_tokens``. Local-only (not replicated) — a trimmed
        replica re-misses, which cache semantics tolerate; freeing is via
        ``_free_local`` so foreign-rank indices never touch the pool
        allocator and advertisement-only replicas free nothing."""
        budget = self.cfg.mesh_max_tokens
        if budget <= 0:
            return
        excess = self.tree.evictable_size_ + self.tree.protected_size_ - budget
        if excess > 0:
            freed = self.tree.evict(
                excess, on_evict=lambda n: self._free_local(n.value)
            )
            if freed:
                self._m_evicted["mesh_trim"].inc(freed)

    def _resolve_conflict(self, child: TreeNode, new_seg):
        """Called by the tree for each matched node whose value differs
        from the incoming segment (mesh values compare by origin rank);
        returns the winning value and records the loser for GC."""
        if (
            isinstance(child.value, AdvertisedValue)
            and not isinstance(new_seg, AdvertisedValue)
            and new_seg.rank == child.value.rank
        ):
            # Resurrection placeholder upgraded by the origin's own REAL
            # publish (the prefix was served through a disk restore and
            # re-published with true pool slots): replace outright — no
            # conflict counted, no dup recorded (the placeholder owns
            # nothing to GC).
            return new_seg
        self._m_conflicts.inc()
        full_key = self._full_key(child)
        if self.resolver.keep(child.value.rank, new_seg.rank):
            # Existing wins; the incoming copy is a duplicate
            # (radix_mesh.py:309-310).
            self._record_dup(full_key, new_seg)
            return child.value
        # New wins; swap in place and remember the loser
        # (radix_mesh.py:303-307,466-495).
        self._record_dup(full_key, child.value)
        return new_seg

    def _full_key(self, node: TreeNode) -> np.ndarray:
        """Token path root→node (reference ``_full_key``,
        ``radix_mesh.py:459-464``)."""
        parts = []
        while node is not None and node is not self.tree.root:
            parts.append(node.key)
            node = node.parent
        if not parts:
            return np.empty(0, dtype=np.int32)
        return np.concatenate(parts[::-1])

    def _record_dup(self, full_key: np.ndarray, loser) -> None:
        nk = NodeKey(full_key, loser.rank)
        prev = self.dup_nodes.get(nk)
        if prev is not None and prev is not loser:
            # A fresh losing copy for the same (key, rank) — e.g. the origin
            # recomputed KV after its first copy lost — replaces the entry.
            # Slots the previous loser claimed and the new one doesn't carry
            # are referenced by neither the tree nor any dup entry, so free
            # them now instead of leaking them; shared ids (idempotent
            # re-delivery) just stay claimed.
            keep = (
                set(int(i) for i in loser.indices)
                if isinstance(loser, PrefillValue)
                else set()
            )
            self._pending_free(nk, exclude=keep)
        self.dup_nodes[nk] = loser
        self._claim(nk, loser)

    # ---- dup-slot ledger (see __init__._dup_pending) ----

    def _claim(self, nk: NodeKey, value) -> None:
        """Claim ``value``'s locally-owned, currently-allocated, unclaimed
        slot ids for entry ``nk``. Ids already claimed elsewhere stay with
        their owner; ids no longer allocated were freed by an earlier
        replacement of a coarser entry and must not re-enter the ledger
        (freeing them again would hit a reallocated tenant)."""
        if (
            self.pool is None
            or not isinstance(value, PrefillValue)
            # Advertised placeholders own no pool slots: claiming their
            # arange ids would ledger LIVE slots belonging to unrelated
            # requests, and a later _pending_free would free them out
            # from under that data.
            or isinstance(value, AdvertisedValue)
            or value.rank != self.rank
            or not len(value.indices)
        ):
            return
        allocated = self.pool.allocator.is_allocated(value.indices)
        for i, ok in zip(value.indices, allocated):
            i = int(i)
            if ok and i not in self._dup_pending:
                self._dup_pending[i] = nk

    def _unclaim(self, value) -> None:
        """Release claims on ``value``'s ids without freeing (the ids are
        becoming tree-owned, or are being freed by an authoritative tree
        path); pending entries skip unclaimed ids at collect time."""
        if (
            not self._dup_pending
            or not isinstance(value, PrefillValue)
            or value.rank != self.rank
        ):
            return
        for i in value.indices:
            self._dup_pending.pop(int(i), None)

    def _pending_free(self, nk: NodeKey, exclude: set[int] | None = None) -> int:
        """Free every slot id claimed by ``nk`` (minus ``exclude``) and
        release the claims. Returns the number of slots freed."""
        if self.pool is None or not self._dup_pending:
            return 0
        ids = [
            i
            for i, owner in self._dup_pending.items()
            if owner == nk and (exclude is None or i not in exclude)
        ]
        if not ids:
            return 0
        for i in ids:
            del self._dup_pending[i]
        self.pool.free(np.asarray(ids, dtype=np.int32))
        return len(ids)

    def _apply_delete(self, key: np.ndarray) -> bool:
        res = self.tree.match_prefix(key, split_partial=False)
        node = res.last_node
        if (
            res.length != len(key)
            or node is self.tree.root
            or len(self._full_key(node)) != len(key)
            or node.children
            or node.lock_ref > 0
        ):
            return False
        del node.parent.children[self.tree._child_key(node.key)]
        self.tree._fp_detach(node)  # direct removal bypasses _remove_node
        self.tree.evictable_size_ -= len(node.key)
        self._free_local(node.value)
        return True

    def _apply_reset(self) -> None:
        for n in list(self.tree._all_nodes()):
            if n is not self.tree.root:
                self._free_local(n.value)
        # Swapped-out losers awaiting GC also hold locally-owned slots;
        # dropping them without freeing would leak pool capacity forever.
        # The ledger (not the entries, which can overlap after granularity
        # drift) is the exact set of dup-owned ids.
        if self.pool is not None and self._dup_pending:
            self.pool.free(np.asarray(sorted(self._dup_pending), dtype=np.int32))
            self._dup_pending.clear()
        self.tree.reset()
        self.dup_nodes.clear()

    def _free_local(self, value) -> None:
        """Return KV slots to the local pool iff this node owns them
        (authoritative tree-path frees: evict, delete, reset)."""
        if (
            self.pool is not None
            and isinstance(value, PrefillValue)
            # Advertised values (cold-cell resurrection) carry
            # placeholder indices — the KV lives in disk extents, and
            # freeing would release pool slots owned by live data.
            and not isinstance(value, AdvertisedValue)
            and value.rank == self.rank
            and len(value.indices)
        ):
            # The tree owned these ids, so no dup entry should claim them —
            # but release any stale claims so a later GC collect can never
            # free a since-reallocated slot out from under new data.
            self._unclaim(value)
            self.pool.free(value.indices)

    # ------------------------------------------------------------------
    # routing scan
    # ------------------------------------------------------------------

    def _route_from_values(self, values) -> RouterMatchResult:
        """Scan matched ranks from the tail: the deepest prefill writer and
        the deepest decode writer win (reference ``radix_mesh.py:219-238``)."""
        prefill_rank = decode_rank = -1
        for v in reversed(values):
            # Dead nodes (outside the current view) must not win routing:
            # their cached prefixes are unreachable until they rejoin.
            if not self.view.contains(v.rank):
                continue
            if prefill_rank == -1 and self.cfg.is_prefill_rank(v.rank):
                prefill_rank = v.rank
            if decode_rank == -1 and self.cfg.is_decode_rank(v.rank):
                decode_rank = v.rank
            if prefill_rank != -1 and decode_rank != -1:
                break
        return RouterMatchResult(
            prefill_rank=prefill_rank,
            decode_rank=decode_rank,
            match_len=sum(len(v) for v in values),
        )

    # ------------------------------------------------------------------
    # heartbeat / startup barrier
    # ------------------------------------------------------------------

    def _gossip_view_from_tick(self, op: Oplog) -> None:
        """Anti-entropy on the heartbeat (caller holds the lock): adopt a
        newer piggybacked view; when the ticker's view is STALE, re-announce
        ours so the epoch difference reaches it within a lap (rate-limited —
        every node on the ring sees the same stale tick)."""
        if op.value is None or len(op.value) == 0:
            return
        try:
            view = decode_view(op.value)
        except ValueError:
            return
        if view.epoch >= self.view.epoch:
            self._adopt_view(view)
        else:
            now = time.monotonic()
            if now - self._last_view_gossip >= self.cfg.tick_interval_s:
                self._last_view_gossip = now
                self._announce_view(self.view)

    def _housekeeper(self) -> None:
        """Membership self-assertion (ring nodes only): if no inbound
        message has arrived for ``failure_timeout_s``, broadcast a JOIN.
        Covers the reincarnation race the one-shot startup JOIN misses: a
        node reborn while the ring still held the FULL view sends its
        startup JOIN as a no-op, and when the older exclusion view later
        spreads by gossip, the re-formed ring routes nothing to this node
        — silence is the only observable signal it gets. A healthy quiet
        ring still carries ticks, so JOINs fire only when genuinely cut
        off (or when the tick origin itself is down, where the extra JOIN
        lap doubles as a poor man's heartbeat)."""
        timeout = self.cfg.failure_timeout_s
        while not self._stop.is_set():
            self._stop.wait(self.cfg.tick_interval_s)
            if self._stop.is_set():
                return
            self._ttl_sweep()
            now = time.monotonic()
            if self.sharded:
                # Per-interval shard-summary gossip: the router's routing
                # table + the co-owner convergence feed (one bounded frame
                # per interval — the control cost that replaced per-insert
                # circulation).
                interval = (
                    self.cfg.shard_summary_interval_s
                    or self.cfg.tick_interval_s
                )
                if now - self._last_shard_summary >= interval:
                    self._last_shard_summary = now
                    try:
                        self.broadcast_shard_summary()
                    except Exception:  # noqa: BLE001 — gossip must not kill housekeeping
                        self.log.exception("shard summary publish failed")
            if now - self._last_rx < timeout or now - self._last_self_join < timeout:
                continue
            lc = self.lifecycle
            if lc is not None and lc.is_departing:
                # Silence is EXPECTED while draining/left: peers stopped
                # routing to us on purpose; a self-assertion JOIN would
                # claw the node back into the view mid-drain.
                continue
            self._last_self_join = now
            if throttled(("rejoin", self.rank), timeout):
                self.log.warning(
                    "no inbound traffic for %.1fs — re-asserting ring membership",
                    now - self._last_rx,
                )
            self._broadcast(
                Oplog(
                    op_type=OplogType.JOIN,
                    origin_rank=self.rank,
                    logic_id=self._logic_op.next(),
                    ttl=self._data_ttl(),
                )
            )

    def _ttl_sweep(self) -> None:
        """Expire replica entries untouched for ``mesh_ttl_s`` (0 = off),
        REPLICATING each expiry as a DELETE (best-effort: peers apply
        only exact unlocked leaves, like the engine's eviction
        retraction). Replication keeps the fleet plane's fingerprint
        audit honest — a local-only sweep would read as permanent
        divergence on /cluster/health; with it, an entry a peer still
        serves hot simply re-misses there and re-replicates on its next
        publish (cache semantics). Freed tokens count under the "ttl"
        eviction cause so dashboards can tell policy from pressure.
        (The mesh_max_tokens budget trim stays deliberately local —
        see _trim_to_budget — so replicas near their size bound CAN
        report fingerprint divergence until re-publication heals it.)"""
        ttl = self.cfg.mesh_ttl_s
        if ttl <= 0:
            return
        cutoff = time.monotonic() - ttl
        expired_keys: list[np.ndarray] = []

        def _expire(node) -> None:
            expired_keys.append(self._full_key(node))
            self._free_local(node.value)

        with self._lock:
            freed = self.tree.evict(
                self.tree.evictable_size_ or 1,
                on_evict=_expire,
                older_than=cutoff,
            )
            for key in expired_keys:
                self._broadcast_data(
                    Oplog(
                        op_type=OplogType.DELETE,
                        origin_rank=self.rank,
                        logic_id=self._logic_op.next(),
                        ttl=self._data_ttl(),
                        key=key,
                    )
                )
        if freed:
            self._m_evicted["ttl"].inc(freed)

    def _view_tick_origin(self) -> int:
        """Tick origination follows the VIEW, not static config — a dead
        static origin must not silence the heartbeat. Policy lives in the
        sync algo (``view_tick_origin``) so alternative algos control
        origination the same way they control the static origin."""
        return self.sync.view_tick_origin(self.cfg, self.view.alive)

    def _ticker(self) -> None:
        """Periodic ring tick (reference ``radix_mesh.py:118-133``). The
        first tick fires immediately so startup isn't gated on the
        interval. Ticks carry the originator's topology view: views are
        otherwise only announced ON CHANGE, and a storm that crashes and
        reincarnates most of the ring can leave fresh epoch-0 nodes and a
        higher-epoch survivor with no changes left to announce — a
        permanent membership split (found by tests/test_failover_storm.py
        seed 0). The piggybacked view is the anti-entropy channel that
        reconciles it."""
        while not self._stop.is_set():
            with self._lock:
                is_origin = self._view_tick_origin() == self.rank
                view_bytes = encode_view(self.view) if is_origin else None
            if is_origin:
                self._broadcast(
                    Oplog(
                        op_type=OplogType.TICK,
                        origin_rank=self.rank,
                        logic_id=self._logic_op.next(),
                        ttl=self._tick_ttl(),
                        value=view_bytes,
                    )
                )
            self._stop.wait(self.cfg.tick_interval_s)

    # ------------------------------------------------------------------
    # distributed GC (reference radix_mesh.py:148-166,362-389)
    # ------------------------------------------------------------------

    def _gc_loop(self) -> None:
        # Unlike the reference — whose GC thread `return`s forever the first
        # time it finds nothing (radix_mesh.py:157-158) — this loop runs for
        # the node's lifetime.
        while not self._stop.is_set():
            self._stop.wait(self.cfg.gc_interval_s)
            if self._stop.is_set():
                return
            self.run_gc_round()

    def run_gc_round(self) -> None:
        """Originate one GC_QUERY lap for locally-unlocked duplicates.
        Public so tests (and operators) can trigger a round on demand.

        Flat ring: unanimity is counted on the single frame as it laps.
        Hier: the origin's group votes on the origin's own lap; every
        remote group's leader returns its group's tally as a GC_VOTE
        (see ``_gc_handle``); the origin folds tallies until every
        nonempty group reported, then checks unanimity. Rounds that a
        view change strands (a group died mid-poll) expire and re-run
        on the next GC interval.

        ``recorded``: one span per origination on this node's ring lane
        (profiler annotation + flight recorder) — GC stalls show up next
        to the request timelines they starve."""
        with recorded(f"ring:{self._node_label}", "gc_round"), self._lock:
            entries = [
                GCEntry(
                    key=np.asarray(nk.tokens, dtype=np.int32),
                    value_rank=nk.value_rank,
                    agree=1,
                )
                for nk in self.dup_nodes
                if self._gc_agrees(np.asarray(nk.tokens, dtype=np.int32))
            ]
            if not entries:
                return
            self._m_gc_rounds.inc()
            logic_id = self._logic_op.next()
            if self.hier is not None:
                now = time.monotonic()
                horizon = max(2.0 * self.cfg.gc_interval_s, 1.0)
                self._gc_pending = {
                    lid: r
                    for lid, r in self._gc_pending.items()
                    if now - r["created"] < horizon
                }
                round_ = {
                    "entries": {
                        NodeKey(e.key, e.value_rank): 0 for e in entries
                    },
                    "groups": set(),
                    "expect": set(self.hier.nonempty_groups(self._my_alive())),
                    "created": now,
                    # A round is only valid for the membership it polled: a
                    # voter that dies mid-round could numerically substitute
                    # for a live node that refused (its votes persist while
                    # the alive count shrinks), so a view-epoch change
                    # discards the round instead of finishing it — the next
                    # GC interval re-polls the surviving membership.
                    "epoch": self.view.epoch,
                }
                self._gc_pending[logic_id] = round_
            self._broadcast(
                Oplog(
                    op_type=OplogType.GC_QUERY,
                    origin_rank=self.rank,
                    logic_id=logic_id,
                    ttl=self._gc_ttl(),
                    gc=entries,
                )
            )
            if self.hier is not None and self._succ_rank is None:
                # Sole member of my group: the group "lap" can't return —
                # fold my own (already-counted) vote immediately.
                g = self.hier.group_of(self.rank)
                round_["groups"].add(g)
                for e in entries:
                    round_["entries"][NodeKey(e.key, e.value_rank)] += e.agree
                self._maybe_finish_gc_round(logic_id)

    def _gc_agrees(self, key: np.ndarray) -> bool:
        """A node agrees to collect a duplicate iff the key's path is not
        lock-protected here (reference ``radix_mesh.py:385-389``)."""
        res = self.tree.match_prefix(key, split_partial=False)
        node = res.last_node
        while node is not None and node is not self.tree.root:
            if node.lock_ref > 0:
                return False
            node = node.parent
        return True

    def _gc_handle(self, op: Oplog, data: bytes) -> None:
        """Caller holds the lock; op.ttl already decremented."""
        if op.op_type is OplogType.GC_VOTE:
            # A remote group's aggregated tally (hier only). Addressed by
            # value_rank; everyone else just circulates it.
            if op.value_rank == self.rank:
                self._fold_gc_vote(op)
                return
            if op.origin_rank == self.rank:
                return  # lap complete (our own vote came back around)
            self._circulate(op, data)
            return
        if op.op_type is OplogType.GC_QUERY:
            if op.origin_rank == self.rank:
                if op.spine:
                    # A leader-origin's ZEROED spine template completed its
                    # spine lap — drop it. Folding it would burn the own-
                    # group slot with zero votes before the real group lap
                    # returns.
                    return
                if self.hier is not None:
                    # Origin-group lap complete: fold this group's tally.
                    round_ = self._gc_pending.get(op.logic_id)
                    if round_ is not None:
                        g = self.hier.group_of(self.rank)
                        if g not in round_["groups"]:
                            round_["groups"].add(g)
                            for e in op.gc:
                                nk = NodeKey(e.key, e.value_rank)
                                if nk in round_["entries"]:
                                    round_["entries"][nk] += e.agree
                            self._maybe_finish_gc_round(op.logic_id)
                    return
                # Flat ring: the single lap IS the whole poll — unanimity
                # = every ring member agreed (radix_mesh.py:368-384).
                unanimous = [e for e in op.gc if e.agree >= self.view.ring_size]
                if not unanimous:
                    return
                self._gc_finish(unanimous)
                return
            if (
                self.hier is not None
                and not op.spine
                and op.value_rank == self.rank
            ):
                # My INJECTED copy returned with my group's votes: report
                # them (plus my own vote) to the query origin.
                self._emit_gc_vote(op)
                return
            if not op.spine:
                # Vote only on group-scope (or flat) frames: a spine frame
                # is the zeroed TEMPLATE every remote group's injection is
                # patched from — votes on it would be inherited by every
                # group downstream and double-counted in their GC_VOTEs.
                for e in op.gc:
                    if self._gc_agrees(e.key):
                        e.agree += 1
                self._circulate(op, data, mutated=True)
            else:
                self._circulate(op, data)
            return
        # GC_EXEC: everyone retires the duplicate; the slot owner frees
        # (radix_mesh.py:363-366).
        if op.origin_rank != self.rank:
            for e in op.gc:
                self._gc_collect(e)
            self._circulate(op, data)

    def _gc_finish(self, unanimous: list[GCEntry]) -> None:
        """Unanimity reached: collect locally and ring GC_EXEC. Caller
        holds the lock."""
        for e in unanimous:
            self._gc_collect(e)
        self._broadcast(
            Oplog(
                op_type=OplogType.GC_EXEC,
                origin_rank=self.rank,
                logic_id=self._logic_op.next(),
                ttl=self._gc_ttl(),
                gc=[GCEntry(e.key, e.value_rank, e.agree) for e in unanimous],
            )
        )

    def _emit_gc_vote(self, op: Oplog) -> None:
        """This group's aggregated GC_QUERY tally (injected-copy votes
        plus this leader's own), addressed to the query origin. Caller
        holds the lock; hier only."""
        g = self.hier.group_of(self.rank)
        self._broadcast(
            Oplog(
                op_type=OplogType.GC_VOTE,
                origin_rank=self.rank,
                logic_id=op.logic_id,  # the QUERY's id names the round
                ttl=self._data_ttl(),
                value=np.asarray([g], dtype=np.int32),
                value_rank=op.origin_rank,  # addressee
                gc=[
                    GCEntry(
                        e.key,
                        e.value_rank,
                        e.agree + (1 if self._gc_agrees(e.key) else 0),
                    )
                    for e in op.gc
                ],
            )
        )

    def _fold_gc_vote(self, op: Oplog) -> None:
        """Fold a remote group's tally into the pending round (idempotent
        per group — duplicate deliveries are expected). Caller holds the
        lock; hier only."""
        round_ = self._gc_pending.get(op.logic_id)
        if round_ is None:
            return  # expired / unknown round
        g = int(op.value[0]) if len(op.value) else -1
        if g in round_["groups"]:
            return
        round_["groups"].add(g)
        for e in op.gc:
            nk = NodeKey(e.key, e.value_rank)
            if nk in round_["entries"]:
                round_["entries"][nk] += e.agree
        self._maybe_finish_gc_round(op.logic_id)

    def _maybe_finish_gc_round(self, logic_id: int) -> None:
        """Check a pending hier GC round for completion: every nonempty
        group reported → unanimity check against the CURRENT alive count.
        Caller holds the lock."""
        round_ = self._gc_pending.get(logic_id)
        if round_ is None:
            return
        if round_["epoch"] != self.view.epoch:
            # Membership changed since the poll went out: the tally mixes
            # votes from a dead membership — discard, re-poll next interval.
            del self._gc_pending[logic_id]
            return
        if not round_["groups"] >= round_["expect"]:
            return
        del self._gc_pending[logic_id]
        n_alive = max(1, len(self.view.alive))
        unanimous = [
            GCEntry(
                key=np.asarray(nk.tokens, dtype=np.int32),
                value_rank=nk.value_rank,
                agree=votes,
            )
            for nk, votes in round_["entries"].items()
            if votes >= n_alive
        ]
        if unanimous:
            self._gc_finish(unanimous)

    def _gc_collect(self, e: GCEntry) -> None:
        nk = NodeKey(e.key, e.value_rank)
        loser = self.dup_nodes.pop(nk, None)
        if loser is None:
            return
        # Only ids this entry still CLAIMS are freed — ids that migrated to
        # a finer-granularity entry, were re-adopted by the tree, or were
        # already freed by a replacement are skipped (ledger contract).
        freed = self._pending_free(nk)
        if freed:
            self._m_gc_freed.inc(freed)
