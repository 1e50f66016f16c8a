"""Prefix-ownership sharding: bounded-replication-factor placement.

Full replication circulates every INSERT around the whole ring — 12
frames / ~3 KB per insert at just 12 nodes, growing linearly with N
(RINGSCALE_r05.json), which cannot reach hundreds of nodes. This module
breaks that wall: the token space is partitioned into :data:`NUM_SHARDS`
**subtree shards** (a key's shard is a pure hash of its first page — the
subtree ROOT segment, so every prefix of a request lands in one shard),
and each shard is owned by a bounded set of ``replication_factor``
nodes, derived by a deterministic RF-successor walk on the consistent
hash ring (``router/consistent_hash.py::get_nodes``). An insert is then
delivered point-to-point to its owner set only: **bytes-per-insert is
O(RF), independent of N**.

Invariants (ARCHITECTURE.md "Sharded replication"):

- **Deterministic derivation.** The :class:`OwnershipMap` is a pure
  function of (alive P/D ranks, replication factor) — every node,
  router included, derives an identical map from the same membership
  view with zero coordination; the map carries the view epoch it was
  derived from so readers can detect cross-epoch races.
- **Single writer.** Only this module constructs ownership maps
  (``tests/test_mesh_lint.py`` pins it): ``MeshCache`` re-derives via
  :func:`build_ownership` on every adopted view change and only ever
  swaps whole immutable maps, so a half-updated owner set can never be
  observed.
- **RF invariant.** Every shard has ``min(RF, N)`` distinct owners;
  with N <= RF every node owns every shard (the full-replica
  degeneracy). The failover invariant "a survivor holds the
  prefix" holds WITHIN the owner set: routers must fail over onto
  owner replicas.
- **Pull-through.** Non-owners may hold cached copies (the insert
  origin keeps its locally-computed KV; a ``SHARD_PULL`` re-emits an
  owner's entries to a non-owner serving fallback traffic) — copies
  serve hits but are nobody's responsibility: convergence auditing and
  anti-entropy compare only co-owners, per shard.

``replication_factor = 0`` (the config default) disables all of this:
the wire behavior is bit-for-bit the unsharded full-replica ring.
"""

from __future__ import annotations

import hashlib
import math
import struct
import time
from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "NUM_SHARDS",
    "shard_of_tokens",
    "OwnershipMap",
    "build_ownership",
    "encode_shard_summary",
    "decode_shard_summary",
    "ShardSummaryTable",
    "ShardHeat",
    "HEAT_HALF_LIFE_S",
]

# Fixed shard space: small enough that the full per-shard fingerprint
# set of one node fits a single gossip frame, large enough that RF·S/N
# shards per node stays balanced into the hundreds of nodes.
NUM_SHARDS = 64

# Virtual nodes per rank on the ownership ring: more points = better
# shard balance per rank at slightly more map-rebuild cost (rebuilds
# happen only on membership change).
_OWNER_VNODES = 8


def shard_of_tokens(tokens: Sequence[int] | np.ndarray) -> int:
    """Shard id of a subtree-root segment (the first page of a key).
    Pure, stable across processes and versions within a deploy: blake2b
    over the little-endian int32 token bytes, mod :data:`NUM_SHARDS`."""
    arr = np.ascontiguousarray(np.asarray(tokens, dtype="<i4"))
    if arr.size == 0:
        return 0
    h = hashlib.blake2b(arr.tobytes(), digest_size=8).digest()
    return int.from_bytes(h, "little") % NUM_SHARDS


class OwnershipMap:
    """Immutable shard → owner-set table, derived from one membership
    view. Constructed ONLY by :func:`build_ownership` (single-writer
    lint); everything else treats instances as read-only values."""

    __slots__ = ("epoch", "rf", "ranks", "owners", "_owned_by")

    def __init__(
        self,
        epoch: int,
        rf: int,
        ranks: tuple[int, ...],
        owners: tuple[tuple[int, ...], ...],
    ):
        self.epoch = epoch
        self.rf = rf
        self.ranks = ranks
        self.owners = owners  # len NUM_SHARDS, each a tuple of ranks
        owned: dict[int, list[int]] = {r: [] for r in ranks}
        for sid, os_ in enumerate(owners):
            for r in os_:
                owned.setdefault(r, []).append(sid)
        self._owned_by = {r: tuple(s) for r, s in owned.items()}

    def owners_of(self, shard: int) -> tuple[int, ...]:
        return self.owners[shard % NUM_SHARDS]

    def primary(self, shard: int) -> int | None:
        os_ = self.owners[shard % NUM_SHARDS]
        return os_[0] if os_ else None

    def is_owner(self, rank: int, shard: int) -> bool:
        return rank in self.owners[shard % NUM_SHARDS]

    def owned_shards(self, rank: int) -> tuple[int, ...]:
        return self._owned_by.get(rank, ())

    def __repr__(self) -> str:
        return (
            f"OwnershipMap(epoch={self.epoch}, rf={self.rf}, "
            f"ranks={len(self.ranks)})"
        )


def build_ownership(
    alive_ranks: Iterable[int],
    rf: int,
    epoch: int,
    is_prefill=None,
    overrides=None,
) -> OwnershipMap:
    """Derive the ownership map for one membership view: consistent-hash
    the alive P/D ranks, then take the deterministic RF-successor walk
    per shard. The sole constructor of :class:`OwnershipMap`.

    ``is_prefill`` (rank → bool), when given, makes ownership
    **role-aware**: each shard gets ``min(rf, role size)`` owners from
    EACH serving role's ring (prefill owners listed first). Both roles
    serve prefix KV for their half of a request, and the failover
    invariant — "a survivor holds the prefix" — must hold per role: a
    joint walk could hand a shard three prefill owners and leave a
    crashed decode node's streams with no owner replica to resurrect
    on. ``None`` (role-blind) walks one joint ring — the cache-only /
    single-role topologies.

    ``overrides`` (heat-driven rebalancing,
    ``cache/rebalance.py::ShardOverrides``) replaces individual shards'
    owner tuples AFTER the base walk: an override's ranks are filtered
    to the alive set (a dead overridden rank must never be delivered
    to) and deduplicated in order; an override left empty by that
    filter falls back to the base walk. The result stays a pure
    function of (alive set, rf, overrides) — every node derives the
    identical effective map from the same adopted inputs."""
    # Deferred import: the router PACKAGE pulls in cache_aware_router →
    # mesh_cache → this module at import time; by the first map build
    # (MeshCache construction) the cycle has resolved.
    from radixmesh_tpu_torch.router.consistent_hash import ConsistentHash

    ranks = tuple(sorted(int(r) for r in alive_ranks))
    groups: list[tuple[int, ...]]
    if is_prefill is None:
        groups = [ranks]
    else:
        pf = tuple(r for r in ranks if is_prefill(r))
        dc = tuple(r for r in ranks if not is_prefill(r))
        groups = [g for g in (pf, dc) if g]
    rings = [
        ConsistentHash(
            (f"rank:{r}" for r in g), virtual_nodes=_OWNER_VNODES
        )
        for g in groups
    ]
    moves = getattr(overrides, "moves", None) or {}
    alive = set(ranks)

    def _owners_of(sid: int) -> tuple[int, ...]:
        base = tuple(
            int(name.split(":", 1)[1])
            for ring in rings
            for name in ring.get_nodes(f"shard:{sid}", max(1, rf))
        )
        ovr = moves.get(sid)
        if not ovr:
            return base
        seen: set[int] = set()
        kept = tuple(
            r for r in ovr
            if r in alive and not (r in seen or seen.add(r))
        )
        return kept or base

    owners = tuple(_owners_of(sid) for sid in range(NUM_SHARDS))
    return OwnershipMap(epoch=epoch, rf=rf, ranks=ranks, owners=owners)


# ---------------------------------------------------------------------------
# SHARD_SUMMARY wire payload: the router's routing currency.
#
# One frame per node per summary interval, carrying for each shard the
# node OWNS: the shard's incremental fingerprint (per-shard convergence
# audit — whole-tree fingerprints diverge BY DESIGN under sharding) and
# a bounded set of (root-page path hash, deepest cached token length)
# entries — enough for a router holding NO replica to answer "is this
# subtree warm, and roughly how deep". Rides ``Oplog.value`` as an int32
# array, the same pattern as NodeDigest / the repair payloads.
# ---------------------------------------------------------------------------

_MAGIC = 0x5D
_VERSION = 1
_HDR = struct.Struct("<BBHi")  # magic, version, n_shards, origin_rank
_SHARD_HDR = struct.Struct("<iQI")  # sid, fingerprint, n_roots
_ROOT = struct.Struct("<QI")  # root-page path hash, deepest length (tokens)
# Per-shard heat trailer: appended AFTER the v1
# payload so a pre-trailer decoder — which parses exactly ``n_shards``
# sections and never inspects trailing bytes — keeps decoding v1
# semantics from a heat-bearing frame, and a trailer-aware decoder reads
# empty loads from a trailerless frame. Same old-wire-tolerant
# trailer discipline as the oplog trace trailer.
_HEAT_MAGIC = 0x5E
_HEAT_HDR = struct.Struct("<BxH")  # magic, pad, n_entries
_HEAT_ENTRY = struct.Struct("<if")  # sid, decayed load (tokens/s)

# Per-frame ceiling on root entries: a pathological shard summarizes its
# deepest roots first and truncates — the router then under-reports
# warmth (a miss-routed request re-misses; cache semantics), never
# overflows the frame.
MAX_SUMMARY_ROOTS = 256


def _to_i32(raw: bytes) -> np.ndarray:
    """Pad-to-4 + int32 view: the one definition of how byte payloads
    ride ``Oplog.value`` (repair_plane imports this — two copies of the
    padding rule could drift into frames one decoder rejects)."""
    pad = (-len(raw)) % 4
    return np.frombuffer(raw + b"\x00" * pad, dtype=np.int32).copy()


def encode_shard_summary(
    origin_rank: int,
    shards: dict[int, tuple[int, list[tuple[int, int]]]],
    loads: dict[int, float] | None = None,
) -> np.ndarray:
    """``shards``: sid → (fingerprint, [(root_hash, deepest_len), ...]).
    ``loads``: sid → decayed load (tokens/s, :class:`ShardHeat`), packed
    as the old-wire-tolerant heat trailer — None/empty emits the exact
    pre-trailer bytes."""
    parts = [_HDR.pack(_MAGIC, _VERSION, len(shards), origin_rank)]
    budget = MAX_SUMMARY_ROOTS
    for sid in sorted(shards):
        fp, roots = shards[sid]
        take = roots[: max(0, budget)]
        budget -= len(take)
        parts.append(_SHARD_HDR.pack(int(sid), fp & ((1 << 64) - 1), len(take)))
        for h, depth in take:
            parts.append(_ROOT.pack(int(h) & ((1 << 64) - 1), int(depth)))
    if loads:
        entries = sorted(loads.items())
        parts.append(_HEAT_HDR.pack(_HEAT_MAGIC, len(entries)))
        for sid, load in entries:
            parts.append(_HEAT_ENTRY.pack(int(sid), float(load)))
    return _to_i32(b"".join(parts))


def decode_shard_summary(
    arr: np.ndarray,
) -> tuple[
    int, dict[int, tuple[int, list[tuple[int, int]]]], dict[int, float]
]:
    """→ (origin rank, sid → (fingerprint, [(root_hash, deepest_len)]),
    sid → decayed load). The load dict is empty for frames without
    the heat trailer."""
    raw = np.ascontiguousarray(np.asarray(arr, dtype=np.int32)).tobytes()
    if len(raw) < _HDR.size:
        raise ValueError(f"shard summary too short ({len(raw)} bytes)")
    magic, version, n_shards, origin = _HDR.unpack_from(raw, 0)
    if magic != _MAGIC:
        raise ValueError(f"bad shard-summary magic {magic:#x}")
    if version != _VERSION:
        raise ValueError(f"unsupported shard-summary version {version}")
    off = _HDR.size
    out: dict[int, tuple[int, list[tuple[int, int]]]] = {}
    for _ in range(n_shards):
        if len(raw) < off + _SHARD_HDR.size:
            raise ValueError("shard summary truncated (shard header)")
        sid, fp, n_roots = _SHARD_HDR.unpack_from(raw, off)
        off += _SHARD_HDR.size
        if len(raw) < off + n_roots * _ROOT.size:
            raise ValueError("shard summary truncated (roots)")
        roots = []
        for _ in range(n_roots):
            h, depth = _ROOT.unpack_from(raw, off)
            off += _ROOT.size
            roots.append((h, depth))
        out[sid] = (fp, roots)
    loads: dict[int, float] = {}
    if len(raw) >= off + _HEAT_HDR.size:
        hmagic, n_entries = _HEAT_HDR.unpack_from(raw, off)
        if (
            hmagic == _HEAT_MAGIC
            and len(raw) >= off + _HEAT_HDR.size + n_entries * _HEAT_ENTRY.size
        ):
            off += _HEAT_HDR.size
            for _ in range(n_entries):
                sid, load = _HEAT_ENTRY.unpack_from(raw, off)
                off += _HEAT_ENTRY.size
                loads[int(sid)] = float(load)
        # A non-matching magic is the _to_i32 pad (or an unknown future
        # trailer): this decoder reads no loads — never raises.
    return origin, out, loads


class ShardSummaryTable:
    """Router-side fold of per-rank shard summaries: the compact replica
    substitute. Reads run on the routing hot path; folds arrive on the
    mesh transport reader thread — callers serialize with the mesh lock
    (the table itself is swap-on-fold per rank, so torn reads cannot
    observe a half-written summary)."""

    def __init__(self):
        # rank → sid → (fingerprint, {root_hash: deepest_len})
        self._by_rank: dict[int, dict[int, tuple[int, dict[int, int]]]] = {}

    def fold(
        self,
        rank: int,
        shards: dict[int, tuple[int, list[tuple[int, int]]]],
    ) -> None:
        self._by_rank[rank] = {
            sid: (fp, {h: d for h, d in roots})
            for sid, (fp, roots) in shards.items()
        }

    def forget(self, rank: int) -> None:
        self._by_rank.pop(rank, None)

    def retain(self, ranks) -> None:
        keep = set(ranks)
        for r in [r for r in self._by_rank if r not in keep]:
            del self._by_rank[r]

    def lookup(self, sid: int, root_hash: int) -> dict[int, int]:
        """rank → deepest cached length, over every rank whose summary
        for ``sid`` contains ``root_hash`` (the warm set)."""
        out: dict[int, int] = {}
        for rank, shards in self._by_rank.items():
            entry = shards.get(sid)
            if entry is None:
                continue
            depth = entry[1].get(root_hash)
            if depth is not None:
                out[rank] = depth
        return out

    def shard_fp(self, rank: int, sid: int) -> int | None:
        shards = self._by_rank.get(rank)
        if shards is None:
            return None
        entry = shards.get(sid)
        return entry[0] if entry is not None else None

    def ranks(self) -> list[int]:
        return sorted(self._by_rank)


# ---------------------------------------------------------------------------
# Per-shard heat: the rebalancer's measurement substrate.
#
# Owner sets are load-blind today (ROADMAP item 1's named follow-up) —
# nobody measures which shards are hot. ShardHeat counts per-shard
# insert/hit/pull-through/byte traffic with exponential decay, so "load"
# means RECENT tokens/s, not lifetime totals: a shard that was hot an
# hour ago reads cold now, which is what a rebalancer must see. The
# decayed scalar load rides the SHARD_SUMMARY gossip (heat trailer
# above), folds into FleetView as the cluster heat map, and the skew
# score (max/mean owned-shard load) is the trigger signal a future
# shard REBALANCER consumes.
#
# Single-writer contract (lint-pinned like ownership maps): ShardHeat is
# constructed and mutated ONLY by cache/mesh_cache.py — one module owns
# the counting sites, so insert/hit/pull heat cannot be double-counted
# by a second instrumentation layer drifting in elsewhere.
# ---------------------------------------------------------------------------

# Heat decay half-life: recent-enough that a traffic shift shows within
# a minute, long enough that gossip intervals (seconds) sample a stable
# value.
HEAT_HALF_LIFE_S = 30.0


class ShardHeat:
    """Exponentially-decayed per-shard traffic counters.

    Each (shard, kind) series is a decayed accumulator: ``note`` first
    decays the stored value by ``0.5 ** (dt / half_life)`` then adds the
    sample. Reads decay-to-now, so an idle shard's load asymptotes to
    zero without any sweeper thread. The scalar ``loads()`` rate —
    insert + hit tokens normalized by the half-life — is the gossip
    currency; ``snapshot()`` keeps the per-kind breakdown for
    /cluster/telemetry.

    NOT thread-safe on its own: every call site runs under the mesh
    lock (the same serialization the fp_shards_ bookkeeping rides)."""

    KINDS = ("insert_tokens", "hit_tokens", "pull_throughs", "bytes")

    def __init__(self, half_life_s: float = HEAT_HALF_LIFE_S, now=time.monotonic):
        self.half_life_s = float(half_life_s)
        self._now = now
        # sid → kind → [decayed value, last-update monotonic stamp]
        self._cells: dict[int, dict[str, list[float]]] = {}

    def set_clock(self, now=time.monotonic) -> None:
        """Decay on ``now`` (monotonic seconds) from here on; at the swap
        it must not read behind the clock it replaces."""
        self._now = now

    def _bump(self, sid: int, kind: str, amount: float) -> None:
        now = self._now()
        cell = self._cells.setdefault(int(sid), {})
        v = cell.get(kind)
        if v is None:
            cell[kind] = [float(amount), now]
            return
        v[0] = v[0] * math.pow(0.5, (now - v[1]) / self.half_life_s) + amount
        v[1] = now

    def note_insert(self, sid: int, tokens: int, nbytes: int = 0) -> None:
        self._bump(sid, "insert_tokens", tokens)
        if nbytes:
            self._bump(sid, "bytes", nbytes)

    def note_hit(self, sid: int, tokens: int) -> None:
        self._bump(sid, "hit_tokens", tokens)

    def note_pull(self, sid: int) -> None:
        self._bump(sid, "pull_throughs", 1.0)

    def _decayed(self, sid: int, kind: str, now: float) -> float:
        v = self._cells.get(int(sid), {}).get(kind)
        if v is None:
            return 0.0
        return v[0] * math.pow(0.5, (now - v[1]) / self.half_life_s)

    # Below this rate (tokens/s) a shard is COLD: it leaves the gossip
    # trailer and its gauge zeroes, instead of exponential decay keeping
    # a denormal-sized residue on the wire forever.
    MIN_LOAD = 1e-6

    def loads(self) -> dict[int, float]:
        """sid → decayed load (tokens/s): insert + hit tokens over the
        half-life window — THE scalar the heat trailer gossips and the
        skew score ranks. Shards below :data:`MIN_LOAD` are omitted
        (cold, not merely quiet)."""
        now = self._now()
        out: dict[int, float] = {}
        for sid in self._cells:
            tok = self._decayed(sid, "insert_tokens", now) + self._decayed(
                sid, "hit_tokens", now
            )
            rate = tok / self.half_life_s
            if rate >= self.MIN_LOAD:
                out[sid] = rate
        return out

    def snapshot(self) -> dict[int, dict[str, float]]:
        """Per-kind decayed values for /cluster/telemetry."""
        now = self._now()
        return {
            sid: {
                k: round(self._decayed(sid, k, now), 3)
                for k in self.KINDS
                if self._decayed(sid, k, now) > 0.0
            }
            for sid in sorted(self._cells)
        }
