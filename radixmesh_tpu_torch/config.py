"""Cluster + cache configuration of the cache mesh (the port's copy of the
JAX package's ``config.py``).

``MeshConfig`` holds the prefill/decode/router address lists plus this
node's address, derives the node's role and global/local rank from its
position in those lists, and every node in a cluster shares one config
except ``local_addr``. ``model`` and ``mesh_axes`` are carried as the JAX
package reads them; the port's launcher reads ``model`` and serves on one
device. :func:`load_config` reads YAML through PyYAML where it is
installed and JSON otherwise (a JSON file means the same to both).
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Any

DEFAULT_MAX_MSG_BYTES = 16 * 1024 * 1024  # mirror of reference cache_config.py:12


class NodeRole(enum.Enum):
    """Node roles (reference ``radix/core_enum.py:4-7`` RadixMode)."""

    PREFILL = "prefill"
    DECODE = "decode"
    ROUTER = "router"


@dataclass
class MeshConfig:
    """Topology + cache sizing for one node of the cache mesh.

    Global rank space mirrors the reference (``cache_config.py:20-28``):
    prefill nodes occupy ranks ``[0, P)``, decode ``[P, P+D)``, routers
    ``[P+D, ...)``.
    """

    prefill_nodes: list[str] = field(default_factory=list)
    decode_nodes: list[str] = field(default_factory=list)
    router_nodes: list[str] = field(default_factory=list)
    local_addr: str = ""
    # Max serialized oplog size; also the transport buffer size
    # (reference cache_config.py:12-14 couples these the same way).
    max_msg_bytes: int = DEFAULT_MAX_MSG_BYTES
    protocol: str = "tcp"  # "tcp" (C++ native) | "tcp-py" | "inproc"
    page_size: int = 1
    # Replication topology: "ring" (the reference's flat ring) or "hier"
    # (two-level groups + leader spine, policy/hierarchy.py — the
    # reference's open roadmap item for >50-node meshes, README.md:57).
    topology: str = "ring"
    # Group size for topology="hier"; 0 = auto (~sqrt(ring size)).
    group_size: int = 0
    # Prefix-ownership sharding (cache/sharding.py): bounded replication
    # factor. 0 = full replication (every insert circulates the whole
    # ring — the documented compatibility mode, bit-for-bit the old
    # wire); N >= 1 = each subtree shard is owned by min(N, ring size)
    # consistent-hash successors and inserts are delivered point-to-
    # point to the owner set only (bytes-per-insert O(RF), not O(N)).
    replication_factor: int = 0
    # Shard-summary gossip cadence under sharding (the router's routing
    # table + co-owner convergence feed). 0 = the tick interval.
    shard_summary_interval_s: float = 0.0
    # Cache sizing: number of KV slots (tokens) the paged pool holds.
    num_kv_slots: int = 65536
    # Replica-size bound (tokens) for the mesh tree. Serving inserts every
    # sequence ever published into every replica (router included); without
    # a bound a long-running deployment leaks linearly in tokens served.
    # Exceeding it triggers a LOCAL LRU trim (not replicated — a trimmed
    # replica just re-misses; the reference's mesh evict is a no-op TODO,
    # radix_mesh.py:349-351). 0 disables.
    mesh_max_tokens: int = 1 << 20
    # Mesh GC / heartbeat cadence (seconds). Reference hardcodes 10s
    # (radix_mesh.py:133,166); configurable here so tests run fast.
    gc_interval_s: float = 10.0
    tick_interval_s: float = 10.0
    # How long a ring successor may be unreachable before its predecessor
    # declares it dead and re-forms the ring (policy/topology.py). The
    # reference has no failure detection at all (roadmap, README.md:49-50).
    failure_timeout_s: float = 10.0
    # Patience for a successor that has NEVER been seen connected (cluster
    # boot: peers may still be binding; a restart may also target an
    # already-dead successor, which must eventually be ringed around).
    # None → max(30s, 3 × failure_timeout_s).
    startup_grace_s: float | None = None
    # Fleet telemetry plane (obs/fleet_plane.py): how often each ring
    # node gossips its NodeDigest (tree fingerprint, fill, health
    # signals) as one oplog frame. 0 disables digest origination;
    # receive-side folding is always on. launch.py
    # --fleet-digest-interval overrides.
    digest_interval_s: float = 0.0
    # Replica-entry TTL (seconds): mesh-tree entries untouched this long
    # are swept by the housekeeper (cause "ttl" on the eviction
    # counters). 0 disables — cache semantics tolerate either choice;
    # TTL bounds staleness rather than size (mesh_max_tokens does that).
    mesh_ttl_s: float = 0.0
    # Anti-entropy repair plane (cache/repair_plane.py): scan cadence
    # for comparing this node's tree fingerprint against the fleet's
    # gossiped digests and opening bounded repair sessions with stale-
    # diverged peers. 0 disables the plane (divergence is then only
    # DETECTED by the digests). Requires digest gossip
    # (digest_interval_s / --fleet-digest-interval) to see peers.
    repair_interval_s: float = 0.0
    # How long a pairwise divergence must persist before a probe fires
    # (transients heal via live replication; probing them is waste).
    repair_age_threshold_s: float = 10.0
    # Per-session storm-control bounds: entries re-replicated per
    # summary, and the exponential-backoff base between rounds against
    # one peer (doubles per round, capped at 30x the base).
    repair_key_budget: int = 256
    repair_backoff_s: float = 2.0
    # Chaos/fault-injection plane (comm/faults.py): a FaultPlan spec
    # (``FaultPlan.from_dict`` schema) installed at the transport seam
    # before this node opens any channel. Empty = no faults — the only
    # sane production value; populated ONLY by tests, soaks, and
    # chaos drills. launch.py --chaos-plan FILE overrides.
    chaos: dict[str, Any] = field(default_factory=dict)
    # Async KV-movement plane (cache/kv_transfer.py): serving nodes
    # stage host-tier restores / eviction write-backs / disagg handoff
    # placement off the scheduling thread. Off = the synchronous seed
    # behavior. launch.py --kv-transfer-async overrides.
    kv_transfer_async: bool = False
    # Restore staging granularity (tokens per chunk): smaller chunks
    # interleave with decode more finely at more dispatch overhead.
    kv_transfer_chunk_tokens: int = 512
    # Restores shorter than this take the synchronous in-admission path
    # (parking a tiny restore costs more than it hides). 0 = always
    # staged when the plane is on.
    kv_transfer_min_restore_tokens: int = 0
    # Durable KV spill tier (cache/kv_tier.py): directory for
    # checksummed fsynced extent files — the third tier below HBM and
    # host RAM. Setting it arms the async KV plane (disk I/O is
    # staged-only) and enables cold-cell resurrection at boot. None =
    # the tier stack ends at host RAM.
    # launch.py --kv-tier-dir overrides.
    kv_tier_dir: str | None = None
    # Disk budget for the extent store; oldest extents are dropped past
    # it (cache semantics: a dangling ref degrades to a recompute).
    kv_tier_capacity_bytes: int = 1 << 30
    # Mid-decode publish cadence (crash recovery, server/recovery.py):
    # every N generated tokens a request's grown prefix publishes to the
    # tree AND the ring, so a node death costs a resurrected request at
    # most N tokens of cache hit. 0 = publish only at finish/preempt.
    stream_publish_tokens: int = 0
    # Heat-driven shard rebalancing (cache/rebalance.py): decision
    # cadence for the view master's RebalancePlane — per-shard ownership
    # overrides (elastic RF boost/shrink under a hysteresis band,
    # bounded moves per round) gossiped like the view. 0 disables the
    # decider; folding received REBALANCE frames is always on. Requires
    # replication_factor > 0. launch.py --rebalance-interval overrides.
    rebalance_interval_s: float = 0.0
    # Per-shard heat decay half-life (cache/sharding.py::ShardHeat).
    # 0 = the library default (30 s). Short half-lives make the skew
    # signal track traffic shifts faster — drills and rebalance benches
    # use seconds; production keeps the default.
    heat_half_life_s: float = 0.0
    # Fleet telemetry aggregation (obs/aggregator.py): router nodes
    # cursor-pull every ring node's /debug/timeseries at this cadence
    # into one node-labeled fleet store — GET /cluster/timeseries, true
    # cross-node percentiles on GET /cluster/slo, and the fleet doctor
    # rules (straggler_node / fleet_burn_slope / telemetry_gap) ride on
    # it. 0 disables the collector; serving nodes ignore the key.
    # launch.py --agg-interval overrides.
    agg_interval_s: float = 0.0

    @property
    def effective_startup_grace_s(self) -> float:
        if self.startup_grace_s is not None:
            return self.startup_grace_s
        return max(30.0, 3.0 * self.failure_timeout_s)
    # Optional model/mesh sections for serving nodes.
    model: dict[str, Any] = field(default_factory=dict)
    mesh_axes: dict[str, int] = field(default_factory=dict)  # e.g. {"dp":2,"tp":4}
    # Serving HTTP port of a P/D node = its cache port + this offset.
    # Derived (not listed per-node) so the reference's identical-config
    # invariant (README.md:122-124) holds for the serving tier too.
    serve_port_offset: int = 1000

    def serve_addr(self, cache_addr: str | None) -> str | None:
        """Map a node's cache-mesh address to its serving-HTTP address.
        ``None`` for portless addresses (inproc test hubs have no HTTP)."""
        if cache_addr is None:
            return None
        try:
            host, port = parse_addr(cache_addr)
        except ValueError:
            return None
        return f"{host}:{port + self.serve_port_offset}"

    # ---- derived rank space (reference cache_config.py:20-35) ----

    @property
    def num_prefill(self) -> int:
        return len(self.prefill_nodes)

    @property
    def num_decode(self) -> int:
        return len(self.decode_nodes)

    @property
    def num_ring(self) -> int:
        """Ring members = prefill + decode nodes (routers stay outside,
        reference ``sync_algo.py:57-75``)."""
        return self.num_prefill + self.num_decode

    @property
    def num_total(self) -> int:
        """The whole global rank space: ring members plus EVERY router.
        The one definition every rank-bound check derives from, so the
        multi-router front door cannot drift out of the ring accounting
        (two call sites computing ``num_ring + len(router_nodes)`` by
        hand is how an off-by-one ships)."""
        return self.num_ring + len(self.router_nodes)

    def is_prefill_rank(self, rank: int) -> bool:
        return 0 <= rank < self.num_prefill

    def is_decode_rank(self, rank: int) -> bool:
        return self.num_prefill <= rank < self.num_ring

    def is_router_rank(self, rank: int) -> bool:
        return rank >= self.num_ring

    def role_of_rank(self, rank: int) -> NodeRole:
        if self.is_prefill_rank(rank):
            return NodeRole.PREFILL
        if self.is_decode_rank(rank):
            return NodeRole.DECODE
        return NodeRole.ROUTER

    def addr_of_rank(self, rank: int) -> str:
        all_nodes = self.prefill_nodes + self.decode_nodes + self.router_nodes
        return all_nodes[rank]

    def prefill_addr(self, prefill_rank: int) -> str:
        """Address of prefill node by global rank (reference
        ``radix_mesh.py:447-451``)."""
        return self.prefill_nodes[prefill_rank]

    def decode_addr(self, decode_rank: int) -> str:
        """Address of decode node by global rank (reference
        ``radix_mesh.py:453-457``)."""
        return self.decode_nodes[decode_rank - self.num_prefill]

    # ---- this node's identity ----

    def local_identity(self) -> tuple[NodeRole, int, int]:
        """Return (role, global_rank, local_rank) for ``local_addr``.

        Enforces exactly-one-membership like the reference
        (``cache_config.py:50-75``).
        """
        memberships = []
        for role, nodes, base in (
            (NodeRole.PREFILL, self.prefill_nodes, 0),
            (NodeRole.DECODE, self.decode_nodes, self.num_prefill),
            (NodeRole.ROUTER, self.router_nodes, self.num_ring),
        ):
            for i, addr in enumerate(nodes):
                if addr == self.local_addr:
                    memberships.append((role, base + i, i))
        if len(memberships) != 1:
            raise ValueError(
                f"local_addr {self.local_addr!r} must appear in exactly one "
                f"node list, found {len(memberships)} memberships"
            )
        return memberships[0]

    @property
    def local_role(self) -> NodeRole:
        return self.local_identity()[0]

    @property
    def global_rank(self) -> int:
        """This node's rank in the global rank space (distinct from the
        within-role local rank, ``local_identity()[2]``)."""
        return self.local_identity()[1]

    def validate(self) -> None:
        # Multi-router front door: N routers are first-class (the
        # reference's single-router restriction, cache_config.py:47-48,
        # is gone — every router rides the master fan-out and the
        # global rank space already accounts for the whole list). What
        # remains is REAL validation: distinct addresses (the global
        # rank space is positional — a duplicate would alias two ranks)
        # and non-empty entries.
        if len(set(self.router_nodes)) != len(self.router_nodes):
            raise ValueError("router_nodes must be distinct addresses")
        if any(not a for a in self.router_nodes):
            raise ValueError("router_nodes entries must be non-empty")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.topology not in ("ring", "hier"):
            raise ValueError(
                f"unknown topology {self.topology!r}; known: ring, hier"
            )
        if self.group_size < 0:
            raise ValueError("group_size must be >= 0 (0 = auto)")
        if self.topology == "ring" and self.group_size:
            raise ValueError("group_size is only meaningful with topology: hier")
        if self.topology == "hier" and self.group_size == 1:
            # HierPlan requires >= 2; reject at config load like the other
            # topology constraints, not later at MeshCache construction.
            raise ValueError("group_size must be >= 2 (or 0 = auto) for hier")
        all_nodes = self.prefill_nodes + self.decode_nodes + self.router_nodes
        if len(set(all_nodes)) != len(all_nodes):
            raise ValueError("node addresses must be unique across roles")
        if self.replication_factor < 0:
            raise ValueError("replication_factor must be >= 0 (0 = full replica)")
        if self.shard_summary_interval_s < 0:
            raise ValueError("shard_summary_interval_s must be >= 0")
        if self.replication_factor > 0 and self.topology == "hier":
            # The hierarchy exists to shorten the full-replica lap; the
            # owner-addressed plane replaces the lap entirely. Composing
            # them would mean two delivery topologies for one insert.
            raise ValueError(
                "replication_factor > 0 requires topology: ring "
                "(sharded delivery replaces the hier lap)"
            )
        if self.repair_interval_s < 0 or self.repair_age_threshold_s < 0:
            raise ValueError("repair timers must be >= 0")
        if self.repair_key_budget < 1:
            raise ValueError("repair_key_budget must be >= 1")
        if self.repair_backoff_s <= 0:
            # A non-positive backoff disables the exponential round
            # pacing entirely — the probe storm the plane's storm-control
            # invariants exist to prevent.
            raise ValueError("repair_backoff_s must be > 0")
        if self.rebalance_interval_s < 0 or self.heat_half_life_s < 0:
            raise ValueError("rebalance/heat timers must be >= 0")
        if self.agg_interval_s < 0:
            raise ValueError("agg_interval_s must be >= 0")
        if self.rebalance_interval_s > 0 and self.replication_factor == 0:
            # The rebalancer moves OWNERSHIP; a full replica has none.
            raise ValueError(
                "rebalance_interval_s > 0 requires replication_factor > 0 "
                "(ownership overrides are meaningless on a full replica)"
            )
        if self.model:
            # Serving deployments derive each P/D node's HTTP port as
            # cache port + offset: both must be bindable and disjoint
            # from every cache port (same-host topologies collide).
            cache_ports = {}
            for addr in self.prefill_nodes + self.decode_nodes:
                try:
                    host, port = parse_addr(addr)
                except ValueError:
                    continue  # portless inproc address: no HTTP tier
                cache_ports.setdefault(host, set()).add(port)
            for host, ports in cache_ports.items():
                for port in ports:
                    serve = port + self.serve_port_offset
                    if not (0 < serve <= 65535):
                        raise ValueError(
                            f"serve port {serve} for {host}:{port} out of range; "
                            "adjust serve_port_offset"
                        )
                    if serve in ports:
                        raise ValueError(
                            f"serve port {serve} for {host}:{port} collides "
                            "with another node's cache port on the same host"
                        )
        self.local_identity()  # raises on bad membership


def _parse_config(path: str, text: str):
    """The file's mapping, read by PyYAML where it is installed. Without
    it the file is read as JSON, which is YAML too, so a JSON config means
    the same to both; any other file is refused by name."""
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text)
        except json.JSONDecodeError as e:
            raise ValueError(
                f"{path}: PyYAML is not installed, so the config file must be "
                f"JSON (a JSON file is also YAML): {e}"
            ) from None
    return yaml.safe_load(text)


def load_config(
    path: str,
    router_nodes: list[str] | None = None,
    replication_factor: int | None = None,
    rebalance_interval_s: float | None = None,
) -> MeshConfig:
    """Load a YAML (or JSON) config file into a validated :class:`MeshConfig`
    (reference ``load_server_args``, ``cache_config.py:38-76``).

    The keyword arguments are the CLI overrides (``--router-nodes`` /
    ``--replication-factor`` / ``--rebalance-interval``), replacing the
    file's values BEFORE validation — a router added by flag must be
    able to find its own membership, and the rebalance/replication
    cross-field check must judge the values the node will actually run
    with; post-validation patching can give neither."""
    with open(path) as f:
        raw = _parse_config(path, f.read()) or {}
    if router_nodes is not None:
        raw["router_nodes"] = list(router_nodes)
    if replication_factor is not None:
        raw["replication_factor"] = int(replication_factor)
    if rebalance_interval_s is not None:
        raw["rebalance_interval_s"] = float(rebalance_interval_s)
    known = {
        "prefill_nodes",
        "decode_nodes",
        "router_nodes",
        "local_addr",
        "max_msg_bytes",
        "protocol",
        "page_size",
        "topology",
        "group_size",
        "replication_factor",
        "shard_summary_interval_s",
        "num_kv_slots",
        "mesh_max_tokens",
        "gc_interval_s",
        "tick_interval_s",
        "failure_timeout_s",
        "startup_grace_s",
        "repair_interval_s",
        "repair_age_threshold_s",
        "repair_key_budget",
        "repair_backoff_s",
        "chaos",
        "kv_transfer_async",
        "kv_transfer_chunk_tokens",
        "kv_transfer_min_restore_tokens",
        "kv_tier_dir",
        "kv_tier_capacity_bytes",
        "stream_publish_tokens",
        "rebalance_interval_s",
        "heat_half_life_s",
        "agg_interval_s",
        "model",
        "mesh_axes",
        "serve_port_offset",
    }
    unknown = set(raw) - known
    if unknown:
        # Every node must share an identical config (reference
        # README.md:122-124); a typo'd key must fail fast, not silently
        # default one node into a different rank space.
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    cfg = MeshConfig(
        prefill_nodes=list(raw.get("prefill_nodes", [])),
        decode_nodes=list(raw.get("decode_nodes", [])),
        router_nodes=list(raw.get("router_nodes", [])),
        local_addr=raw.get("local_addr", ""),
        max_msg_bytes=int(raw.get("max_msg_bytes", DEFAULT_MAX_MSG_BYTES)),
        protocol=raw.get("protocol", "tcp"),
        page_size=int(raw.get("page_size", 1)),
        topology=raw.get("topology", "ring"),
        group_size=int(raw.get("group_size", 0)),
        replication_factor=int(raw.get("replication_factor", 0)),
        shard_summary_interval_s=float(
            raw.get("shard_summary_interval_s", 0.0)
        ),
        num_kv_slots=int(raw.get("num_kv_slots", 65536)),
        mesh_max_tokens=int(raw.get("mesh_max_tokens", 1 << 20)),
        gc_interval_s=float(raw.get("gc_interval_s", 10.0)),
        tick_interval_s=float(raw.get("tick_interval_s", 10.0)),
        failure_timeout_s=float(raw.get("failure_timeout_s", 10.0)),
        startup_grace_s=(
            None
            if raw.get("startup_grace_s") is None
            else float(raw["startup_grace_s"])
        ),
        repair_interval_s=float(raw.get("repair_interval_s", 0.0)),
        repair_age_threshold_s=float(raw.get("repair_age_threshold_s", 10.0)),
        repair_key_budget=int(raw.get("repair_key_budget", 256)),
        repair_backoff_s=float(raw.get("repair_backoff_s", 2.0)),
        chaos=dict(raw.get("chaos", {}) or {}),
        kv_transfer_async=bool(raw.get("kv_transfer_async", False)),
        kv_transfer_chunk_tokens=int(raw.get("kv_transfer_chunk_tokens", 512)),
        kv_transfer_min_restore_tokens=int(
            raw.get("kv_transfer_min_restore_tokens", 0)
        ),
        kv_tier_dir=raw.get("kv_tier_dir"),
        kv_tier_capacity_bytes=int(
            raw.get("kv_tier_capacity_bytes", 1 << 30)
        ),
        stream_publish_tokens=int(raw.get("stream_publish_tokens", 0)),
        rebalance_interval_s=float(raw.get("rebalance_interval_s", 0.0)),
        heat_half_life_s=float(raw.get("heat_half_life_s", 0.0)),
        agg_interval_s=float(raw.get("agg_interval_s", 0.0)),
        model=dict(raw.get("model", {})),
        mesh_axes=dict(raw.get("mesh_axes", {})),
        serve_port_offset=int(raw.get("serve_port_offset", 1000)),
    )
    cfg.validate()
    return cfg


def parse_addr(addr: str) -> tuple[str, int]:
    """``"host:port"`` → ``(host, port)`` (reference ``communicator.py:133-135``)."""
    host, _, port = addr.rpartition(":")
    return host, int(port)
