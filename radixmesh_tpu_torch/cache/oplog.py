"""Idempotent cache-oplog protocol + compact binary wire format.

Capability parity with the reference's ``radix/cache_oplog.py`` +
``communication/serializer.py``: oplogs are idempotent radix-tree operations
(INSERT/DELETE/RESET), ring-control messages (TICK), and distributed-GC
messages (GC_QUERY/GC_EXEC), each carrying the origin node's rank, a
per-node monotonic logic id, and a TTL decremented per ring hop
(``cache_oplog.py:13-56``).

Deliberate departures from the reference:

- **Binary, not JSON.** The reference serializes via ``to_dict()`` + JSON
  (``serializer.py:21-27``), which is slow and — worse — ``to_dict`` omits
  the ``gc_query``/``gc_exec`` payloads (``cache_oplog.py:58-66``), so GC
  never works across the wire. Here the wire format is a fixed-layout
  struct + raw int32 arrays, and every field round-trips (tested).
- Router values carry their true token length (the reference's
  ``RouterRadixMeshTreeValue.__len__`` returns 1, ``radix_mesh.py:47-63``,
  which under-reports match lengths on the router).
"""

from __future__ import annotations

import enum
import os
import struct
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

__all__ = [
    "OplogType",
    "EXTENSION_KINDS",
    "DATA_KINDS",
    "GCEntry",
    "Oplog",
    "NodeKey",
    "serialize",
    "deserialize",
    "patched_ttl",
    "patched_frame",
    "set_emit_version",
]

_MAGIC = 0x52  # 'R'
_VERSION = 3  # v3 added page (page-granular INSERT values) + u24 arrays
# v3 header: the v2 header plus trailing page and flags bytes (+pad).
# Earlier headers are strict prefixes, so the TTL patch offset is shared.
_HEADER_V3 = struct.Struct(
    "<BBBxiqiidBBxx"
)  # magic, ver, type, pad, origin, logic, ttl, value_rank, ts, page, flags
# v3 flags: the key/value arrays are packed 3 bytes per element (token
# ids fit 24 bits for every real vocabulary; slot/page ids for every
# real pool size — serialize() checks and falls back to int32 per array).
_FLAG_KEY_U24 = 1
_FLAG_VALUE_U24 = 2
# Hierarchical-topology scope (policy/hierarchy.py): set = the frame is
# circulating on the leader SPINE; clear = on a group ring (or the flat
# ring — flat mode never sets it). Pre-v3 peers cannot carry the bit, so
# hier mode requires the v3 emit version (enforced by MeshCache).
_FLAG_SPINE = 4
# Cross-node trace stitching (obs/trace_plane.py): set = an 8-byte
# little-endian 64-bit trace id TRAILS the frame (after the GC entries),
# tying this frame's receive-side spans to the originating request's
# timeline. Old-wire tolerant BY CONSTRUCTION, the same contract the
# EXTENSION_KINDS pass-through gave new op kinds: a pre-trailer decoder
# ignores unknown flag bits, parses exactly the bytes its offsets name,
# and never inspects trailing bytes — and since every hop forwards the
# RAW frame (patched_ttl edits in place), the trailer survives transit
# through old peers untouched. The edge timestamp of the hop is the
# existing ``ts`` header field (v2+) — no second clock on the wire.
_FLAG_TRACE = 8
_TRACE_TRAILER = struct.Struct("<Q")
_HEADER_V2 = struct.Struct(
    "<BBBxiqiid"
)  # magic, ver, type, pad, origin, logic, ttl, value_rank, ts
# v1 header (no ts). Rolling-restart compatibility is two-sided:
# - RECEIVE: older frames are always accepted (ts = 0.0 / page = 1 where
#   the frame predates the field).
# - EMIT: older peers reject newer frames, so while any old node remains
#   in the ring, upgraded nodes must emit the old version — set
#   RADIXMESH_WIRE_VERSION (or set_emit_version) for the duration of the
#   roll, then flip to the current version. Page-granular replication
#   (page > 1) requires v3 and raises under an older emit version.
_HEADER_V1 = struct.Struct("<BBBxiqii")

_emit_version = int(os.environ.get("RADIXMESH_WIRE_VERSION", _VERSION))


def set_emit_version(version: int) -> None:
    """Select the wire version ``serialize`` emits (an older version
    during a rolling upgrade, the current one — the default —
    otherwise)."""
    global _emit_version
    if version not in (1, 2, _VERSION):
        raise ValueError(f"unsupported wire version {version}")
    _emit_version = version


def emit_version() -> int:
    """The wire version ``serialize`` currently emits (page-granular
    callers check compatibility up front — see ``MeshCache``)."""
    return _emit_version


class OplogType(enum.IntEnum):
    """Reference ``cache_oplog.py:13-22``."""

    INSERT = 1
    DELETE = 2
    RESET = 3
    GC_QUERY = 4
    GC_EXEC = 5
    # Elastic-membership extensions (the reference lists failure detection
    # and dynamic add/remove as roadmap, README.md:49-50):
    TOPO = 6  # value = [epoch, *alive_ranks] — a membership view
    JOIN = 7  # origin_rank is (re)joining; view master answers with TOPO
    # Hierarchical-GC extension (policy/hierarchy.py): a group leader's
    # aggregated vote tally for a GC_QUERY round, addressed to the query
    # origin (value_rank = query origin, logic_id = query logic id,
    # value = [voting group index]). Circulates like data; consumed by
    # the addressee, a no-op everywhere else.
    GC_VOTE = 8
    # Fleet-telemetry extension (obs/fleet_plane.py): a node's periodic
    # NodeDigest (cache fill, health signals, tree fingerprint) packed
    # into ``value`` as an int32 array (value_rank = origin). Idempotent
    # (receivers fold newest-by-seq) and rides the existing ring frames —
    # no wire-format change for older op kinds.
    DIGEST = 9
    TICK = 10
    # KV-movement extension (cache/kv_transfer.py): a fire-and-forget
    # restore hint — "node ``value_rank``: requests for ``key`` are
    # heading your way; if that prefix is host-tier, start restoring it
    # now". Semantics are strictly advisory: idempotent (in-flight
    # restores are joined, completed ones no-op), droppable at any hop,
    # and NEVER mutates tree structure on the receiver (read-only match,
    # no splits, no evictions). Receivers carrying ``deserialize``'s
    # unknown-kind tolerance (added alongside this kind) ignore FUTURE
    # kinds without error; builds that predate the tolerance raise on
    # any unknown kind, so enable hint emission only after the whole
    # fleet carries it (the same finish-the-roll discipline as the v3
    # wire features above).
    PREFETCH = 11
    # Anti-entropy repair extension (cache/repair_plane.py): a node that
    # observes a stale fingerprint divergence with a peer opens a
    # bounded repair session over a dedicated point-to-point channel
    # (the PREFETCH router-channel pattern). PROBE carries the
    # initiator's 64-bucket fingerprint vector; SUMMARY answers with the
    # responder's vector plus key-hash summaries for the diverged
    # buckets, letting each side re-replicate ONLY its one-sided entries
    # as ordinary idempotent INSERT oplogs on the ring (existing
    # conflict-resolution path — repair introduces no new apply
    # semantics). Both are droppable by contract: a lost frame just
    # means another probe after backoff. value_rank addresses the
    # target; old wires see unknown ints and forward/ignore
    # (EXTENSION_KINDS below).
    REPAIR_PROBE = 12
    REPAIR_SUMMARY = 13
    # Membership-lifecycle extension (policy/lifecycle.py): the origin
    # announces a PLANNED departure at the end of a graceful drain.
    # value = [epoch, *alive] — the origin's view WITHOUT itself (the
    # same payload as TOPO), so receivers adopt it through the ordinary
    # epoch-guarded view machinery; beyond TOPO semantics they also tag
    # the successor retarget cause="left" (dashboards separate churn
    # from failure), forget the leaver's FleetView telemetry (a frozen
    # fingerprint must not poison convergence/min-score), and mark it
    # "left" so routers refuse it new work even under a stale view.
    # Droppable by contract: the leaver re-announces until it observes
    # its own exclusion, and failure detection remains the backstop.
    LEAVE = 14
    # Prefix-ownership sharding extensions (cache/sharding.py,
    # replication_factor > 0):
    #
    # SHARD_SUMMARY — one frame per node per summary interval carrying,
    # for every shard the origin OWNS, the shard's incremental
    # fingerprint plus bounded (root-page hash, deepest length) entries
    # (value = packed sharding.encode_shard_summary, value_rank =
    # origin). Rides the ring like DIGEST (idempotent newest-wins fold;
    # the master fan-out carries it to the router, whose routing table
    # it IS — the router holds no tree replica under sharding). This is
    # the control-plane cost that replaces per-insert O(N) circulation:
    # bytes amortize to ~zero per insert under load.
    SHARD_SUMMARY = 15
    # SHARD_PULL — pull-through request: "owner, re-emit your entries
    # for prefix ``key`` (shard ``value[0]``) point-to-point to rank
    # ``value_rank``" (the beneficiary — usually a non-owner that is
    # about to serve fallback traffic for a warm subtree). Fire-and-
    # forget and idempotent like PREFETCH: the re-emitted INSERTs apply
    # through the ordinary conflict-resolution path; a lost pull just
    # costs the target a cache miss.
    SHARD_PULL = 16
    # Heat-driven shard rebalancing (cache/rebalance.py): the decider's
    # per-shard ownership OVERRIDES, gossiped like a membership view
    # (value = packed rebalance.encode_overrides). Idempotent and
    # rollback-refusing: receivers adopt only a strictly newer
    # (epoch, version) pair, re-derive the effective ownership map
    # through the same pure derivation as a view change, and forward —
    # so every node's owner sets move in lockstep with zero
    # coordination. Droppable like TOPO: the decider re-gossips each
    # round until the fleet converges.
    REBALANCE = 17


# Kinds added AFTER the unknown-kind pass-through tolerance shipped:
# a peer running any post-PREFETCH build deserializes these to raw ints
# when it predates them, forwards them untouched, and never breaks —
# the forward-compat contract every new kind must register under
# (lint-pinned by tests/test_mesh_lint.py). Kinds NOT listed here
# predate the tolerance and are safe on every wire.
EXTENSION_KINDS = frozenset(
    {
        OplogType.PREFETCH,
        OplogType.REPAIR_PROBE,
        OplogType.REPAIR_SUMMARY,
        OplogType.LEAVE,
        OplogType.SHARD_SUMMARY,
        OplogType.SHARD_PULL,
        OplogType.REBALANCE,
    }
)
# Kinds that carry replicated cache DATA: losing one of these frames
# diverges a replica until repair (or a lucky re-insert) heals it.
# The dropped-frame accounting (``mesh_cache._send_bytes`` /
# ``_sender_loop``) arms an early repair probe exactly for these.
DATA_KINDS = frozenset(
    {OplogType.INSERT, OplogType.DELETE, OplogType.RESET}
)


@dataclass
class GCEntry:
    """One duplicate-KV candidate in a GC round (reference ``GCQuery``,
    ``cache_oplog.py:43-45``, extended with the origin rank that identifies
    which copy of the key is the duplicate)."""

    key: np.ndarray  # token ids
    value_rank: int  # origin rank of the duplicated value
    agree: int = 1  # unanimity counter, incremented per agreeing node

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, GCEntry)
            and self.value_rank == other.value_rank
            and self.agree == other.agree
            and np.array_equal(self.key, other.key)
        )


@dataclass
class Oplog:
    """One replicated tree operation (reference ``CacheOplog``,
    ``cache_oplog.py:48-56``).

    ``op_type`` stays a raw ``int`` when the frame carries a kind this
    build doesn't know (a newer peer's extension op): receivers forward
    such frames untouched and otherwise ignore them — the forward-compat
    contract that let PREFETCH (and DIGEST before it) ride the existing
    ring without a wire break."""

    op_type: OplogType | int
    origin_rank: int  # node that created the oplog
    logic_id: int  # per-origin monotonic id (radix_mesh.py:431-433)
    ttl: int  # remaining ring hops
    key: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.int32))
    value: np.ndarray = field(default_factory=lambda: np.empty(0, dtype=np.int32))
    value_rank: int = -1  # origin rank of the *value* (INSERT); -1 if n/a
    gc: list[GCEntry] = field(default_factory=list)
    # Origin wall-clock (time.time()) at creation; used only for the
    # replication-lag histogram, so clock skew degrades telemetry, never
    # correctness. 0.0 = unset.
    ts: float = 0.0
    # INSERT value granularity: 1 = one slot index per token (the
    # reference's convention, radix_mesh.py:87-89); N > 1 = one PAGE id
    # per N tokens (receivers expand to slots ``page_id*N + 0..N-1`` —
    # the paged allocator guarantees within-page contiguity).
    page: int = 1
    # Hierarchical scope: True while the frame rides the leader spine
    # (policy/hierarchy.py). Always False in flat-ring mode.
    spine: bool = False
    # Cross-node trace stitching (obs/trace_plane.py): the originating
    # request's 64-bit trace id, carried as an optional old-wire-tolerant
    # trailer (see _FLAG_TRACE). 0 = untraced — the frame's bytes are
    # then bit-for-bit the pre-trace wire.
    trace_id: int = 0

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Oplog)
            and self.op_type == other.op_type
            and self.origin_rank == other.origin_rank
            and self.logic_id == other.logic_id
            and self.ttl == other.ttl
            and self.value_rank == other.value_rank
            and self.page == other.page
            and self.spine == other.spine
            and self.trace_id == other.trace_id
            and np.array_equal(self.key, other.key)
            and np.array_equal(self.value, other.value)
            and self.gc == other.gc
        )


class NodeKey:
    """Hashable (tokens, value_rank) identity for duplicate-KV bookkeeping
    (reference ``ImmutableNodeKey``, ``cache_oplog.py:25-40``)."""

    __slots__ = ("tokens", "value_rank", "_hash")

    def __init__(self, tokens: Sequence[int] | np.ndarray, value_rank: int):
        self.tokens = tuple(int(t) for t in tokens)
        self.value_rank = value_rank
        self._hash = hash((self.tokens, value_rank))

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, NodeKey)
            and self._hash == other._hash
            and self.value_rank == other.value_rank
            and self.tokens == other.tokens
        )

    def __repr__(self) -> str:
        return f"NodeKey(rank={self.value_rank}, tokens={self.tokens[:8]}...)"


def _arr(a: np.ndarray | None) -> np.ndarray:
    return np.ascontiguousarray(
        np.empty(0, dtype=np.int32) if a is None else np.asarray(a, dtype=np.int32)
    )


def _fits_u24(a: np.ndarray) -> bool:
    return a.size > 0 and 0 <= int(a.min()) and int(a.max()) < (1 << 24)


def _pack_u24(a: np.ndarray) -> bytes:
    """int32 array → 3 little-endian bytes per element (drop the high
    byte — caller guarantees ``_fits_u24``)."""
    return a.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()


def _unpack_u24(buf: memoryview, count: int, offset: int) -> np.ndarray:
    raw = np.frombuffer(buf, dtype=np.uint8, count=3 * count, offset=offset)
    out = np.zeros((count, 4), dtype=np.uint8)
    out[:, :3] = raw.reshape(count, 3)
    return out.view(np.int32).reshape(count)


def serialize(op: Oplog) -> bytes:
    """Oplog → bytes. Every field — including GC payloads — round-trips
    (fixing the reference's ``to_dict`` omission, ``cache_oplog.py:58-66``)."""
    key, value = _arr(op.key), _arr(op.value)
    if op.page > 1 and _emit_version < 3:
        raise ValueError(
            f"page-granular oplogs (page={op.page}) need wire v3; "
            f"emit version is {_emit_version}"
        )
    if not 1 <= op.page <= 255:
        raise ValueError(f"oplog page {op.page} out of the wire's u8 range")
    if op.spine and _emit_version < 3:
        raise ValueError(
            f"spine-scoped oplogs need wire v3; emit version is {_emit_version}"
        )
    key_bytes, value_bytes = key.tobytes(), value.tobytes()
    if _emit_version == 1:
        header = _HEADER_V1.pack(
            _MAGIC, 1, int(op.op_type),
            op.origin_rank, op.logic_id, op.ttl, op.value_rank,
        )
    elif _emit_version == 2:
        header = _HEADER_V2.pack(
            _MAGIC, 2, int(op.op_type),
            op.origin_rank, op.logic_id, op.ttl, op.value_rank, op.ts,
        )
    else:
        flags = _FLAG_SPINE if op.spine else 0
        if op.trace_id:
            flags |= _FLAG_TRACE
        if _fits_u24(key):
            flags |= _FLAG_KEY_U24
            key_bytes = _pack_u24(key)
        if _fits_u24(value):
            flags |= _FLAG_VALUE_U24
            value_bytes = _pack_u24(value)
        header = _HEADER_V3.pack(
            _MAGIC, _VERSION, int(op.op_type),
            op.origin_rank, op.logic_id, op.ttl, op.value_rank, op.ts,
            op.page, flags,
        )
    parts = [
        header,
        struct.pack("<III", len(key), len(value), len(op.gc)),
        key_bytes,
        value_bytes,
    ]
    for e in op.gc:
        ek = _arr(e.key)
        parts.append(struct.pack("<iiI", e.agree, e.value_rank, len(ek)))
        parts.append(ek.tobytes())
    if op.trace_id and _emit_version >= 3:
        # Optional trace trailer (see _FLAG_TRACE): appended LAST so a
        # pre-trace decoder — which parses to its computed end offset and
        # never inspects trailing bytes — stays byte-compatible. A
        # pinned pre-v3 emit version silently drops the id (tracing
        # degrades during a rolling upgrade; the wire never breaks).
        parts.append(_TRACE_TRAILER.pack(op.trace_id & ((1 << 64) - 1)))
    return b"".join(parts)


# The int32 TTL lives at a fixed offset shared by BOTH wire versions
# (the v1 header is a strict prefix of v2 up to and including ttl). Ring
# forwarding rewrites ONLY this field, so hops patch the original frame
# instead of paying a full re-serialization of the key/value payload.
_TTL_OFFSET = struct.calcsize("<BBBxiq")  # magic, ver, type, origin, logic


def patched_ttl(data: bytes, ttl: int) -> bytes:
    """The same wire frame with only its TTL replaced.

    Guards the header version: a future version that rearranges fields
    must fail loudly here rather than silently corrupt forwarded
    frames. (v1 ⊂ v2 ⊂ v3 headers share the TTL offset.)"""
    if data[1] not in (1, 2, 3):
        raise ValueError(
            f"patched_ttl knows wire versions 1-3, got v{data[1]}"
        )
    buf = bytearray(data)
    struct.pack_into("<i", buf, _TTL_OFFSET, ttl)
    return bytes(buf)


# v3-only fixed offsets for the hierarchical-circulation patcher.
_VALUE_RANK_OFFSET = struct.calcsize("<BBBxiqi")  # ..., ttl
_FLAGS_OFFSET = struct.calcsize("<BBBxiqiidB")  # ..., ts, page


def patched_frame(
    data: bytes,
    ttl: int | None = None,
    spine: bool | None = None,
    value_rank: int | None = None,
) -> bytes:
    """A wire frame with TTL and/or spine scope and/or value_rank
    replaced in place — the hierarchical bridge/inject primitive
    (re-scoping must not pay a full re-serialization of the payload).
    Scope and value_rank patches require a v3 frame; callers fall back
    to ``serialize`` for older frames (possible only mid-roll, since
    hier mode itself requires the v3 emit version)."""
    if (spine is not None or value_rank is not None) and data[1] != 3:
        raise ValueError(f"scope/value_rank patch needs a v3 frame, got v{data[1]}")
    if data[1] not in (1, 2, 3):
        raise ValueError(f"patched_frame knows wire versions 1-3, got v{data[1]}")
    buf = bytearray(data)
    if ttl is not None:
        struct.pack_into("<i", buf, _TTL_OFFSET, ttl)
    if value_rank is not None:
        struct.pack_into("<i", buf, _VALUE_RANK_OFFSET, value_rank)
    if spine is not None:
        flags = buf[_FLAGS_OFFSET]
        buf[_FLAGS_OFFSET] = (flags | _FLAG_SPINE) if spine else (flags & ~_FLAG_SPINE)
    return bytes(buf)


def deserialize(buf: bytes | memoryview) -> Oplog:
    buf = memoryview(buf)
    magic, ver = buf[0], buf[1]
    if magic != _MAGIC:
        raise ValueError(f"bad oplog magic {magic:#x}")
    page, flags = 1, 0
    if ver == _VERSION:
        (_, _, op_type, origin, logic, ttl, value_rank, ts,
         page, flags) = _HEADER_V3.unpack_from(buf, 0)
        off = _HEADER_V3.size
    elif ver == 2:
        _, _, op_type, origin, logic, ttl, value_rank, ts = (
            _HEADER_V2.unpack_from(buf, 0)
        )
        off = _HEADER_V2.size
    elif ver == 1:
        _, _, op_type, origin, logic, ttl, value_rank = _HEADER_V1.unpack_from(buf, 0)
        ts = 0.0
        off = _HEADER_V1.size
    else:
        raise ValueError(f"unsupported oplog version {ver}")
    key_len, val_len, n_gc = struct.unpack_from("<III", buf, off)
    off += 12
    if flags & _FLAG_KEY_U24:
        key = _unpack_u24(buf, key_len, off)
        off += 3 * key_len
    else:
        key = np.frombuffer(buf, dtype=np.int32, count=key_len, offset=off).copy()
        off += 4 * key_len
    if flags & _FLAG_VALUE_U24:
        value = _unpack_u24(buf, val_len, off)
        off += 3 * val_len
    else:
        value = np.frombuffer(buf, dtype=np.int32, count=val_len, offset=off).copy()
        off += 4 * val_len
    gc: list[GCEntry] = []
    for _ in range(n_gc):
        agree, vrank, eklen = struct.unpack_from("<iiI", buf, off)
        off += 12
        ek = np.frombuffer(buf, dtype=np.int32, count=eklen, offset=off).copy()
        off += 4 * eklen
        gc.append(GCEntry(key=ek, value_rank=vrank, agree=agree))
    trace_id = 0
    if flags & _FLAG_TRACE and len(buf) >= off + _TRACE_TRAILER.size:
        # Optional trace trailer (see _FLAG_TRACE). The length guard
        # makes a flag-without-trailer frame decode as untraced instead
        # of raising — a truncated trailer costs stitching, never a
        # frame.
        (trace_id,) = _TRACE_TRAILER.unpack_from(buf, off)
    try:
        op_type = OplogType(op_type)
    except ValueError:
        pass  # a newer peer's op kind: keep the raw int (see Oplog docs)
    return Oplog(
        op_type=op_type,
        origin_rank=origin,
        logic_id=logic,
        ttl=ttl,
        key=key,
        value=value,
        value_rank=value_rank,
        gc=gc,
        ts=ts,
        page=page,
        spine=bool(flags & _FLAG_SPINE),
        trace_id=trace_id,
    )
