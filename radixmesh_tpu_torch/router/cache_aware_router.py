"""Cache-aware request routing (reference
``router/cache_aware_router.py:15-39``).

The router node's :class:`MeshCache` replica stores *which rank* wrote
each prefix (rank-only values, no KV) — so routing a request is one
read-only tree walk. Semantics matched to the reference:

- **Warm-up** (``:20-25``): until ``finish_warm_up()`` the router reports
  no match so traffic spreads over the hash ring.
- **Hit** (``:28-34``): matched prefill/decode rank → that node's address.
- **Miss per role** (``:30-37``): consistent hash over that role's nodes.

Net-new beyond the reference: the hash rings are built once and updated
on topology change (not rebuilt per request), and the result carries the
matched prefix length so the serving frontend can report hit-rate —
the north-star metric (``BASELINE.json``).
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from radixmesh_tpu_torch.cache.mesh_cache import MeshCache, RouterMatchResult
from radixmesh_tpu_torch.config import MeshConfig
from radixmesh_tpu_torch.obs.metrics import TOKEN_LEN_BUCKETS, get_registry
from radixmesh_tpu_torch.obs.trace_plane import get_recorder
from radixmesh_tpu_torch.router.consistent_hash import ConsistentHash

__all__ = ["CacheAwareRouter", "RouteResult"]


@dataclass
class RouteResult:
    """Where to send a request (reference ``RouteResult``,
    ``cache_aware_router.py:8-11``), plus hit telemetry.

    An address is ``None`` when NO node of that role is currently alive
    (every member left the topology view): the caller should surface
    "no capacity" — queueing or erroring per its policy — rather than
    dialing."""

    prefill_addr: str | None
    decode_addr: str | None
    prefill_cache_hit: bool = False
    decode_cache_hit: bool = False
    match_len: int = 0
    # Crash failover (server/recovery.py): the longest-prefix match
    # pointed at a node the caller excluded (declared dead) — the
    # request was re-placed on a surviving node. ``match_len`` is KEPT
    # on failover: every ring member replicates the prefix, so the
    # survivor serves the same cached tokens the dead writer would have.
    prefill_failover: bool = False
    decode_failover: bool = False


class _LoadTracker:
    """Leaky-bucket in-flight estimate per address: each routed request
    adds one unit; units decay exponentially with ``tau`` seconds (the
    router never sees completions, so decay stands in for them)."""

    def __init__(self, tau_s: float):
        self.tau = tau_s
        # One lock: /route runs on concurrent ThreadingHTTPServer handler
        # threads, and an unlocked read-modify-write would undercount the
        # hot node exactly when shedding matters.
        self._lock = threading.Lock()
        self._load: dict[str, float] = {}
        self._t: dict[str, float] = {}

    def _decayed(self, addr: str, now: float) -> float:
        last = self._t.get(addr)
        if last is None:
            return 0.0
        return self._load[addr] * math.exp(-(now - last) / self.tau)

    def note(self, addr: str) -> None:
        now = time.monotonic()
        with self._lock:
            self._load[addr] = self._decayed(addr, now) + 1.0
            self._t[addr] = now

    def load(self, addr: str) -> float:
        with self._lock:
            return self._decayed(addr, time.monotonic())


class CacheAwareRouter:
    def __init__(
        self,
        mesh_cache: MeshCache,
        config: MeshConfig,
        overload_factor: float | None = 3.0,
        overload_floor: float = 8.0,
        load_tau_s: float = 10.0,
        health_aware: bool = False,
        health_threshold: float = 0.5,
        prefetch_hints: bool = False,
        prefetch_window_s: float = 2.0,
    ):
        if not config.prefill_nodes or not config.decode_nodes:
            raise ValueError("router needs at least one prefill and one decode node")
        self.mesh_cache = mesh_cache
        self.config = config
        self._warm_up = True
        self._prefill_ring = ConsistentHash(config.prefill_nodes)
        self._decode_ring = ConsistentHash(config.decode_nodes)
        # Health-aware demotion (obs/fleet_plane.py; --health-aware-routing):
        # a node whose gossiped health score drops below the threshold —
        # stall watchdog fired, replication badly lagged, eviction storm —
        # is treated as overloaded (cache hits shed past it) AND excluded
        # from the hash-ring fallback, so the router stops selecting it
        # until its digests recover. Scores come from the router replica's
        # FleetView, fed by the ring's DIGEST gossip; unknown ranks score
        # 1.0, so a booting fleet routes normally.
        self.health_aware = health_aware
        self.health_threshold = health_threshold
        self.fleet = mesh_cache.fleet
        self._rank_of_addr = {
            **{a: r for r, a in enumerate(config.prefill_nodes)},
            **{
                a: config.num_prefill + r
                for r, a in enumerate(config.decode_nodes)
            },
        }
        # Static inverse, precomputed once: _lifecycle_sets runs on the
        # routing hot path and must not rebuild this per request.
        self._addr_of_rank = {r: a for a, r in self._rank_of_addr.items()}
        # Hot-prefix overload protection (net-new; the reference always
        # follows the cache): when a cache hit points at a node whose
        # estimated in-flight load exceeds ``overload_factor`` x the
        # role's mean (and at least ``overload_floor`` absolute — light
        # traffic never sheds), the request takes the hash-ring fallback
        # instead: one recomputed prefix beats a convoy on the hot node.
        # ``overload_factor=None`` disables shedding.
        self.overload_factor = overload_factor
        self.overload_floor = overload_floor
        self._loads = _LoadTracker(load_tau_s)
        # Predictive restore hints (cache/kv_transfer.py; launch.py
        # --kv-prefetch-hints): when a cache hit routes to a node, fire a
        # PREFETCH oplog at it so a host-tier prefix starts restoring
        # BEFORE the request arrives. The router cannot see tiers (its
        # replica is rank-only), so it over-approximates — hinting every
        # hit — and the receiver no-ops when the prefix is already in
        # HBM; idempotence makes the over-approximation free. A per-
        # (rank, prefix) dedupe window keeps a hot prefix from spraying
        # one hint per request.
        self.prefetch_hints = prefetch_hints
        self.prefetch_window_s = prefetch_window_s
        self._prefetch_sent: dict[tuple[int, int], float] = {}
        self._prefetch_lock = threading.Lock()
        # Prefix-ownership sharding (cache/sharding.py): the mesh
        # replica is summary-only, routing prefers OWNER replicas for
        # hits, failover, and fallback (the failover invariant "a survivor
        # holds the prefix" holds within the owner set), and a warm hit
        # landing on a non-owner fires a pull-through so the target's
        # replica fills before the traffic pattern repeats.
        self.sharded = bool(getattr(mesh_cache, "sharded", False))
        # Hints leave the ROUTE HOT PATH through this bounded queue and
        # a single daemon sender: the wire send (channel dial, bounded
        # try_send) must never add to a /route response, and drop-on-
        # overflow is exactly the fire-and-forget contract. Pull-through
        # requests ride the same queue (tagged tuples).
        self._prefetch_q: deque = deque(maxlen=256)
        self._prefetch_evt = threading.Event()
        self._prefetch_thread: threading.Thread | None = None
        if prefetch_hints or self.sharded:
            self._prefetch_thread = threading.Thread(
                target=self._prefetch_sender, daemon=True,
                name="router-prefetch",
            )
            self._prefetch_thread.start()
        # Mutated by _on_view_change on the mesh transport-reader thread
        # while /route handler threads read it: guard with a lock (the
        # hash rings guard their own state the same way).
        self._alive_lock = threading.Lock()
        self._alive = {
            "prefill": set(config.prefill_nodes),
            "decode": set(config.decode_nodes),
        }
        reg = get_registry()
        routed = reg.counter(
            "radixmesh_router_requests_total",
            "routing decisions by role and outcome",
            ("role", "outcome"),
        )
        # Pre-resolved children: label resolution must not run (or be
        # measured) inside the per-request timed region.
        self._m_routed = {
            (role, outcome): routed.labels(role=role, outcome=outcome)
            for role in ("prefill", "decode")
            for outcome in ("hit", "fallback", "shed", "withheld", "failover")
        }
        # Membership-lifecycle withholding (policy/lifecycle.py): a
        # BOOTSTRAPPING node's replica is still cold — a cache hit
        # pointing at it would miss on arrival, so hits are withheld
        # (hash-ring fallback serves instead) until its fingerprint
        # converges with its donor and it gossips ACTIVE. DRAINING/LEFT
        # nodes get no new work at all. Always on: lifecycle states only
        # exist when a LifecyclePlane gossips them.
        self.withheld_hits = 0  # lifetime count (chaos-gate telemetry)
        self._m_route_latency = reg.histogram(
            "radixmesh_router_route_seconds", "cache-aware routing decision latency"
        )
        self._m_match_len = reg.histogram(
            "radixmesh_router_match_len_tokens",
            "matched prefix length per routed request (tokens)",
            buckets=TOKEN_LEN_BUCKETS,
        )

    def finish_warm_up(self) -> None:
        """Enable cache-aware decisions (reference ``:20-21``)."""
        self._warm_up = False

    # -- topology changes (net-new: reference lists node add/remove as
    # roadmap, README.md:49-50) --

    def add_node(self, role: str, addr: str) -> None:
        (self._prefill_ring if role == "prefill" else self._decode_ring).add_node(addr)
        with self._alive_lock:
            self._alive[role].add(addr)

    def remove_node(self, role: str, addr: str) -> None:
        ring = self._prefill_ring if role == "prefill" else self._decode_ring
        ring.remove_node(addr)
        with self._alive_lock:
            self._alive[role].discard(addr)

    def watch_topology(self) -> None:
        """Subscribe to the mesh replica's epoch-numbered view changes
        (``policy/topology.py``): dead nodes leave the consistent-hash
        fallback rings, rejoined nodes return — so even cache-miss traffic
        stops landing on nodes the mesh has declared dead."""
        self.mesh_cache.on_view_change.append(self._on_view_change)

    def _on_view_change(self, old, new) -> None:
        for rank in set(old.alive) - set(new.alive):
            self.remove_node(
                "prefill" if self.config.is_prefill_rank(rank) else "decode",
                self.config.addr_of_rank(rank),
            )
        for rank in set(new.alive) - set(old.alive):
            self.add_node(
                "prefill" if self.config.is_prefill_rank(rank) else "decode",
                self.config.addr_of_rank(rank),
            )

    def _sick_addrs(self) -> set[str]:
        """Addresses currently below the health threshold — the demotion
        + hash-ring exclusion set. ONE FleetView.health computation per
        route call (per-address health_score lookups would rebuild the
        whole O(nodes) dict per candidate on the request hot path)."""
        if not self.health_aware:
            return set()
        sick = self.fleet.sick_ranks(self.health_threshold)
        if not sick:
            return set()
        return {a for a, r in self._rank_of_addr.items() if r in sick}

    def _lifecycle_sets(self) -> tuple[set[int], set[str]]:
        """(withheld hit ranks, excluded addrs) from gossiped lifecycle
        states — one FleetView lock hold per route call. BOOTSTRAPPING
        ranks lose only their cache-hit preference (they still take
        hash-ring fallback traffic: the warm-up they are running exists
        to serve exactly that); DRAINING/LEFT nodes are excluded from
        hits AND the fallback rings (no new work on a departing node)."""
        lifecycles = self.fleet.lifecycles()
        withhold: set[int] = set()
        excluded: set[str] = set()
        for rank, state in lifecycles.items():
            if state == "active":
                continue  # the steady-state hot path: no sets built
            if state == "bootstrapping":
                withhold.add(rank)
            elif state in ("draining", "left"):
                withhold.add(rank)
                addr = self._addr_of_rank.get(rank)
                if addr is not None:
                    excluded.add(addr)
        return withhold, excluded

    def _overloaded(self, role: str, addr: str, sick: set[str]) -> bool:
        # Health demotion first: a stalled node must shed even when its
        # load estimate looks light (a wedged engine stops completing,
        # so decayed load is exactly the number that lies here).
        if addr in sick:
            return True
        if self.overload_factor is None:
            return False
        with self._alive_lock:
            alive = set(self._alive[role])  # snapshot vs concurrent view changes
        alive.add(addr)  # the routed target counts even if it just left the view
        if len(alive) <= 1:
            return False  # nowhere to shed to
        target = self._loads.load(addr)
        if target < self.overload_floor:
            return False
        # Compare against the OTHER nodes' mean: including the target in
        # the mean makes the threshold unreachable for factor >= n (with
        # 2 nodes and factor 3 a convoy would never shed). Idle peers
        # (others_mean ~ 0) shed as soon as the floor is crossed.
        others = [self._loads.load(a) for a in alive if a != addr]
        others_mean = sum(others) / len(others)
        return target > self.overload_factor * others_mean

    def _maybe_prefetch(self, key: Sequence[int], match_len: int, rank: int) -> None:
        """Queue one deduped PREFETCH hint for ``key``'s matched prefix.
        Fire-and-forget: the wire send happens on the background sender,
        and failures / dedupe skips / queue overflow cost an overlap
        opportunity, never a routing decision (or a route's latency)."""
        prefix = np.asarray(key[:match_len], dtype=np.int32)
        dedupe = (rank, hash(prefix.tobytes()))
        now = time.monotonic()
        with self._prefetch_lock:
            last = self._prefetch_sent.get(dedupe, 0.0)
            if now - last < self.prefetch_window_s:
                return
            self._prefetch_sent[dedupe] = now
            if len(self._prefetch_sent) > 4096:  # bounded memory
                cutoff = now - self.prefetch_window_s
                self._prefetch_sent = {
                    k: t for k, t in self._prefetch_sent.items() if t >= cutoff
                }
            self._prefetch_q.append(("hint", prefix, rank))
        self._prefetch_evt.set()

    def _prefetch_sender(self) -> None:
        """Daemon drain of the hint queue — the only place router
        prefetches (and sharded pull-throughs) touch a transport."""
        while True:
            with self._prefetch_lock:
                item = self._prefetch_q.popleft() if self._prefetch_q else None
            if item is None:
                self._prefetch_evt.wait(timeout=0.2)
                self._prefetch_evt.clear()
                continue
            try:
                if item[0] == "pull":
                    self.mesh_cache.send_shard_pull(item[1], item[2], item[3])
                else:
                    self.mesh_cache.send_prefetch(item[1], item[2])
            except Exception:  # noqa: BLE001 — hints are droppable by contract
                pass

    def _owner_addrs(self, key: Sequence[int], role: str) -> list[str]:
        """Ordered owner-replica addresses of ``key``'s shard for one
        role (empty when unsharded) — the preferred hit/failover/
        fallback targets under sharding."""
        if not self.sharded:
            return []
        out = []
        for rank in self.mesh_cache.owner_ranks(key):
            if (role == "prefill") != self.config.is_prefill_rank(rank):
                continue
            addr = self._addr_of_rank.get(rank)
            if addr is not None:
                out.append(addr)
        return out

    def _pick(self, role: str, key: Sequence[int], exclude) -> str | None:
        """One fallback choice: owner replicas first (sharded — traffic
        for a subtree concentrates where its inserts land, and failover
        must land on a replica that HOLDS the prefix), then the role's
        consistent-hash ring. Among eligible owner replicas the
        LEAST-LOADED wins: under elastic replication
        (cache/rebalance.py) a hot shard's boosted owner set is exactly
        the fan-out surface — a first-owner-wins pick would re-convoy
        the traffic the boost exists to spread."""
        exclude = exclude or set()
        owners = [
            a for a in self._owner_addrs(key, role) if a not in exclude
        ]
        if owners:
            if len(owners) == 1:
                return owners[0]
            # Ties (an idle fleet) keep the walk order — cold routing
            # stays deterministic at the primary owner.
            return min(
                enumerate(owners),
                key=lambda ia: (self._loads.load(ia[1]), ia[0]),
            )[1]
        ring = self._prefill_ring if role == "prefill" else self._decode_ring
        return ring.get_node(key, exclude=exclude or None)

    def _maybe_pull_through(
        self, key: Sequence[int], match_len: int, addr: str | None
    ) -> None:
        """A warm subtree is being served by a NON-owner (shed/withheld/
        ring fallback): queue a pull-through so an owner re-emits the
        prefix to that node before the pattern repeats. Deduped through
        the same window as prefetch hints."""
        if not self.sharded or addr is None or match_len <= 0:
            return
        target = self._rank_of_addr.get(addr)
        if target is None:
            return
        owners = [
            r for r in self.mesh_cache.owner_ranks(key) if r != target
        ]
        if not owners or target in self.mesh_cache.owner_ranks(key):
            return
        prefix = np.asarray(key[:match_len], dtype=np.int32)
        dedupe = (target, hash(prefix.tobytes()))
        now = time.monotonic()
        with self._prefetch_lock:
            last = self._prefetch_sent.get(dedupe, 0.0)
            if now - last < self.prefetch_window_s:
                return
            self._prefetch_sent[dedupe] = now
            self._prefetch_q.append(("pull", prefix, owners[0], target))
        self._prefetch_evt.set()

    def cache_aware_route(
        self, key: Sequence[int], exclude: Sequence[str] | None = None
    ) -> RouteResult:
        """Route one request's token ids (reference ``:23-39``).

        ``exclude`` (crash failover, ``server/recovery.py``): addresses
        the caller has declared dead — never routed to, as hit or
        fallback. A longest-prefix match pointing at one re-places on a
        surviving node with ``match_len`` preserved (replication means
        the survivor holds the prefix), flagged ``*_failover``."""
        t0 = time.monotonic()
        try:
            res = self._route(key, frozenset(exclude or ()))
        finally:
            dur = time.monotonic() - t0
            self._m_route_latency.observe(dur)
        rec = get_recorder()
        if rec.enabled:
            # Routing leg of the request-flight timeline: the router is
            # its own node, so these land on a "router" lane correlated
            # with engine lanes by wall-clock overlap.
            rec.event(
                "router", "route", t0, dur, cat="router",
                match_len=int(res.match_len),
                prefill_hit=bool(res.prefill_cache_hit),
                decode_hit=bool(res.decode_cache_hit),
            )
        return res

    def _route(
        self, key: Sequence[int], exclude: frozenset = frozenset()
    ) -> RouteResult:
        if self._warm_up:
            match = RouterMatchResult(-1, -1)
        elif self.sharded:
            # Summary-based match: the router holds no tree replica
            # under sharding — per-shard summaries (fingerprints + root
            # depths) gossiped by the owners stand in for it.
            match = self.mesh_cache.shard_route(key)
        else:
            match = self.mesh_cache.match_prefix(key)
            assert isinstance(match, RouterMatchResult), (
                "cache_aware_route requires a ROUTER-mode MeshCache"
            )

        p_out = d_out = None
        p_fo = d_fo = False
        sick = self._sick_addrs()
        withhold, lc_excluded = self._lifecycle_sets()
        # Dead-declared addresses (crash failover) are excluded HARD —
        # unlike sickness, which is advisory, a dead node must never be
        # returned even when it is the only ring member left.
        lc_excluded = lc_excluded | exclude
        avoid = sick | lc_excluded  # never a fallback target either
        if match.prefill_rank >= 0:
            prefill_addr = self.config.prefill_addr(match.prefill_rank)
            p_hit = True
            if prefill_addr in exclude:
                # The longest-prefix writer is DEAD: re-place on a
                # surviving node. match_len is kept — replication means
                # the survivor holds the prefix, which is exactly what
                # makes a resurrected request's re-prefill nearly free.
                # No survivor at all is NOT a failover (nothing was
                # re-placed): plain fallback-to-None, no preserved match.
                # Sharded: owner replicas are tried first — they are the
                # only nodes guaranteed to hold the prefix (RF invariant).
                alt = self._pick(
                    "prefill", key, {prefill_addr} | avoid
                ) or self._pick("prefill", key, exclude)
                p_hit = False
                if alt is not None:
                    prefill_addr, p_out, p_fo = alt, "failover", True
                else:
                    prefill_addr = None
            elif match.prefill_rank in withhold:
                # Cold (bootstrapping) or departing replica: the hit is
                # not servable there — hash-ring fallback instead.
                self.withheld_hits += 1
                alt = self._pick(
                    "prefill", key, {prefill_addr} | avoid
                ) or self._pick("prefill", key, lc_excluded)
                if alt is not None:
                    prefill_addr = alt
                p_hit, p_out = False, "withheld"
            elif self._overloaded("prefill", prefill_addr, sick):
                shed = self._pick("prefill", key, {prefill_addr} | avoid)
                if shed is not None:
                    prefill_addr, p_hit, p_out = shed, False, "shed"
        else:
            # Cache miss: hash-ring fallback, skipping health-demoted
            # and departing nodes. If EVERY node of the role is sick,
            # route anyway (degraded service beats no service) —
            # sickness is advisory; departure/death exclusion yields
            # only when literally nothing else exists (dead addresses
            # stay excluded even then: None means "no capacity").
            prefill_addr = (
                self._pick("prefill", key, avoid)
                or self._pick("prefill", key, lc_excluded)
                or self._pick("prefill", key, exclude)
            )
            p_hit = False
        if match.decode_rank >= 0:
            decode_addr = self.config.decode_addr(match.decode_rank)
            d_hit = True
            if decode_addr in exclude:
                alt = self._pick(
                    "decode", key, {decode_addr} | avoid
                ) or self._pick("decode", key, exclude)
                d_hit = False
                if alt is not None:
                    decode_addr, d_out, d_fo = alt, "failover", True
                else:
                    decode_addr = None
            elif match.decode_rank in withhold:
                self.withheld_hits += 1
                alt = self._pick(
                    "decode", key, {decode_addr} | avoid
                ) or self._pick("decode", key, lc_excluded)
                if alt is not None:
                    decode_addr = alt
                d_hit, d_out = False, "withheld"
            elif self._overloaded("decode", decode_addr, sick):
                shed = self._pick("decode", key, {decode_addr} | avoid)
                if shed is not None:
                    decode_addr, d_hit, d_out = shed, False, "shed"
        else:
            decode_addr = (
                self._pick("decode", key, avoid)
                or self._pick("decode", key, lc_excluded)
                or self._pick("decode", key, exclude)
            )
            d_hit = False
        if self.prefetch_hints and match.match_len > 0:
            # Hint only ranks the request will actually LAND on (a shed
            # hit routes elsewhere — warming the hot node would restore
            # KV nobody is coming for).
            if p_hit and match.prefill_rank >= 0:
                self._maybe_prefetch(key, match.match_len, match.prefill_rank)
            if d_hit and match.decode_rank >= 0:
                self._maybe_prefetch(key, match.match_len, match.decode_rank)
        if self.sharded and match.match_len > 0:
            # A warm subtree landing on a NON-owner (shed, withheld,
            # failover residue, or a role with no owner replica): fill
            # that node's replica from an owner so the next request of
            # this pattern hits locally.
            self._maybe_pull_through(key, match.match_len, prefill_addr)
            self._maybe_pull_through(key, match.match_len, decode_addr)
        if prefill_addr is not None:
            self._loads.note(prefill_addr)
        if decode_addr is not None:
            self._loads.note(decode_addr)
        self._m_routed[("prefill", p_out or ("hit" if p_hit else "fallback"))].inc()
        self._m_routed[("decode", d_out or ("hit" if d_hit else "fallback"))].inc()
        self._m_match_len.observe(
            match.match_len if (p_hit or d_hit or p_fo or d_fo) else 0
        )
        # match_len only counts when a ROUTED address actually holds the
        # match (post-shedding): a shed request lands on a node without
        # the prefix, and reporting cached tokens there would inflate the
        # hit-rate the north-star metric watches. Failover is the
        # exception — replication puts the prefix on the survivor too.
        return RouteResult(
            prefill_addr=prefill_addr,
            decode_addr=decode_addr,
            prefill_cache_hit=p_hit,
            decode_cache_hit=d_hit,
            match_len=match.match_len if (p_hit or d_hit or p_fo or d_fo) else 0,
            prefill_failover=p_fo,
            decode_failover=d_fo,
        )
