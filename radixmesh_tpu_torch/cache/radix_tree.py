"""Host-side radix prefix tree over token ids (numpy only; this package's own
copy of the JAX package's ``cache/radix_tree.py``, kept identical so both
schedulers evict and match the same way).

Capability parity with the reference's single-node cache
(``radix/sglang/srt/mem_cache/radix_cache.py:87-436``): prefix match with
node splitting, insert, LRU eviction of unlocked leaves, lock-refcounting
with evictable/protected size accounting, paged keys (``page_size >= 1``),
and a KV-cache event journal. Re-designed, not translated:

- Tree values are **numpy int32 arrays of KV slot indices** into a
  :class:`~radixmesh_tpu_torch.cache.kv_pool.PagedKVPool` whose pages are
  device tensors — the tree itself is pointer-chasing host code that never
  touches the device.
- Key comparison is vectorized with numpy instead of the reference's
  per-token Python loop (``radix_cache.py:14-32``).
- The event journal's ``BlockStored``/``BlockRemoved``/``AllBlocksCleared``
  types are actually defined here (they are undefined names in the
  reference, ``radix_cache.py:379-424``, making events unusable there).
- Values are any object supporting ``len()`` and slicing; the distributed
  layer (``cache/mesh_cache.py``) wraps values with origin-rank metadata the
  same way the reference's ``RadixMesh`` does (``radix_mesh.py:21-63``).
"""

from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Sequence

import numpy as np

__all__ = [
    "TreeNode",
    "MatchResult",
    "RadixTree",
    "BlockStored",
    "BlockRemoved",
    "AllBlocksCleared",
    "FP_BUCKETS",
    "root_page_hash",
]

_node_ids = itertools.count()

# ---------------------------------------------------------------------------
# Tree fingerprint (fleet convergence audit, ``obs/fleet_plane.py``).
#
# Every token position present in the tree contributes one well-mixed
# 64-bit word to an XOR accumulator. The word is a *chained* hash of the
# whole root→token path (``c_i = c_{i-1}·M + (t_i+1) mod 2^64``, then a
# splitmix64 finalizer), so two trees have equal fingerprints iff they
# hold the same SET of token paths — regardless of insert order (XOR is
# commutative) and regardless of node boundaries (a split just partitions
# a node's chain array between the two halves; the contribution set is
# unchanged). Values (slot indices / origin ranks) are deliberately NOT
# hashed: replicas store different value types per role (PrefillValue vs
# RouterValue), and the convergence question is "do we cache the same
# keys", which is exactly what eventual consistency promises.
#
# The chain is computed vectorized: with ``Minv = M^-1 mod 2^64``,
# ``c_i = M^i·(c_0 + Σ_{j<=i}(t_j+1)·M^-j)`` — two cumprods, one cumsum,
# all wrapping naturally in uint64.
# ---------------------------------------------------------------------------

_FP_MULT = np.uint64(0x9E3779B97F4A7C15)  # odd → invertible mod 2^64
_FP_MULT_INV = np.uint64(pow(0x9E3779B97F4A7C15, -1, 1 << 64))
_FP_SEED = np.uint64(0x243F6A8885A308D3)  # root chain value

# Anti-entropy bucket count (cache/repair_plane.py): every mixed
# contribution word ALSO XOR-folds into bucket ``word mod FP_BUCKETS``
# of a fixed-width vector, so two diverged replicas can localize their
# difference to a handful of buckets instead of re-walking whole trees
# (Merkle-style level-1 partition, DeCandia et al. 2007 §4.7). 64
# buckets × 8 bytes = 512 B — the wire ceiling the repair PROBE frame
# budgets for. The assignment uses the splitmix64-mixed word (not the
# raw chain value), so buckets inherit the chain hash's diffusion, stay
# insert-order-independent (XOR), and stay split-invariant (a split
# partitions a node's chain array; the contribution multiset — and thus
# every bucket — is unchanged). The scalar ``fingerprint_`` is always
# the XOR-reduce of the bucket vector (both maintained incrementally).
FP_BUCKETS = 64


def _chain_hashes(start: np.uint64, tokens: np.ndarray) -> np.ndarray:
    """Per-token chain values for ``tokens`` continuing a path whose last
    chain value is ``start`` (uint64 array, same length as ``tokens``)."""
    n = len(tokens)
    if n == 0:
        return np.empty(0, dtype=np.uint64)
    t = tokens.astype(np.int64).astype(np.uint64) + np.uint64(1)
    pw = np.cumprod(np.full(n, _FP_MULT, dtype=np.uint64))
    pw_inv = np.cumprod(np.full(n, _FP_MULT_INV, dtype=np.uint64))
    s = np.cumsum(t * pw_inv)
    return pw * (np.uint64(start) + s)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized — decorrelates the polynomial
    chain values before they meet the XOR accumulator."""
    x = x.astype(np.uint64, copy=True)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def _node_contribution(chain: np.ndarray) -> int:
    if len(chain) == 0:
        return 0
    return int(np.bitwise_xor.reduce(_mix64(chain)))


def root_page_hash(tokens: Sequence[int] | np.ndarray, page_size: int) -> int:
    """Path hash of a key's first page — the subtree-root identity the
    shard summaries (cache/sharding.py) publish and the router recomputes
    from raw request tokens. A pure function of the tokens (same chain +
    splitmix64 pipeline as :meth:`RadixTree.path_hash`), so both sides
    agree regardless of how either replica's node boundaries fell."""
    arr = np.asarray(tokens, dtype=np.int32)[: max(1, page_size)]
    if len(arr) == 0:
        return 0
    chain = _chain_hashes(_FP_SEED, arr)
    return int(_mix64(chain[-1:])[0])


def match_len(a: np.ndarray, b: np.ndarray) -> int:
    """Length of the common prefix of two int arrays (vectorized analog of
    the reference's ``_key_match_page_size1``, ``radix_cache.py:14-20``)."""
    n = min(len(a), len(b))
    if n == 0:
        return 0
    eq = a[:n] == b[:n]
    return n if eq.all() else int(np.argmin(eq))


def as_key(key: Sequence[int] | np.ndarray) -> np.ndarray:
    arr = np.asarray(key, dtype=np.int32)
    if arr.ndim != 1:
        raise ValueError("keys must be 1-D token-id sequences")
    return arr


# ---------------------------------------------------------------------------
# KV-cache event journal (reference radix_cache.py:379-436, with the event
# types actually defined).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BlockStored:
    block_hashes: tuple[int, ...]
    parent_block_hash: int | None
    token_ids: tuple[int, ...]
    block_size: int


@dataclass(frozen=True)
class BlockRemoved:
    block_hashes: tuple[int, ...]


@dataclass(frozen=True)
class AllBlocksCleared:
    pass


def _block_hash(parent_hash: int | None, tokens: tuple[int, ...]) -> int:
    return hash((parent_hash, tokens))


class TreeNode:
    """Radix-tree node (reference ``radix_cache.py:35-64``): ``children``
    keyed by first token (or first-page tuple), ``key`` = token-id array,
    ``value`` = KV slot indices (or a mesh value wrapper), ``lock_ref``
    protects against eviction, ``last_access_time`` orders LRU."""

    __slots__ = (
        "children",
        "parent",
        "key",
        "value",
        "host_value",
        "disk_value",
        "lock_ref",
        "last_access_time",
        "hit_count",
        "block_hashes",
        "chain",
        "shard",
        "id",
    )

    def __init__(self, parent: "TreeNode | None" = None):
        self.children: dict[Any, TreeNode] = {}
        self.parent = parent
        self.key: np.ndarray = np.empty(0, dtype=np.int32)
        self.value: Any = None
        # Host-tier slot indices when this node's KV has been written back
        # to host RAM (the reference's HiCache stubs ``host_value``/
        # ``backuped``, ``radix_cache.py:47-61``, realized by
        # ``cache/host_cache.py``). A node may hold both tiers (restored to
        # device with the host copy retained → re-eviction is free).
        self.host_value: np.ndarray | None = None
        # Durable-tier extent handle (cache/kv_tier.py::ExtentRef) when
        # this node's KV has been spilled to a disk extent. A node may
        # hold any combination of tiers — a disk copy makes host/device
        # re-eviction free, exactly like host_value does for the device
        # tier. ``len(disk_value)`` is the segment token count.
        self.disk_value: Any = None
        self.lock_ref = 0
        self.last_access_time = time.monotonic()
        self.hit_count = 0
        # Chained per-page hashes of the path down to (and including) this
        # node's key, used by the event journal for parent-hash chaining.
        self.block_hashes: tuple[int, ...] | None = None
        # Per-token chain-hash values of this node's key segment (uint64,
        # len == len(key)) — the tree-fingerprint contribution source
        # (see module comment above ``_chain_hashes``). Attached by
        # ``RadixTree._fp_attach``; empty on the root.
        self.chain: np.ndarray = np.empty(0, dtype=np.uint64)
        # Subtree shard id (prefix-ownership sharding, cache/sharding.py):
        # constant down a subtree — a node inherits its parent's, top-level
        # nodes hash their first page. -1 = shard tracking off.
        self.shard = -1
        self.id = next(_node_ids)

    @property
    def evicted(self) -> bool:
        return self.value is None

    @property
    def backuped(self) -> bool:
        """Reference ``radix_cache.py:60-61``: KV present in the host tier."""
        return self.host_value is not None

    def __lt__(self, other: "TreeNode") -> bool:
        return self.last_access_time < other.last_access_time

    def __repr__(self) -> str:
        return (
            f"TreeNode(id={self.id}, len={len(self.key)}, "
            f"lock={self.lock_ref}, children={len(self.children)})"
        )


@dataclass
class MatchResult:
    """Prefix-match result (reference ``radix_cache.py:67-84``).

    ``values`` holds one value object per matched node along the path (the
    last possibly a slice); ``last_node`` anchors lock-ref operations. Use
    :meth:`indices` to concatenate numpy slot-index values for the KV pool.

    ``host_values``/``host_nodes`` describe the host-tier *extension*: the
    chain of written-back nodes continuing past the device-resident prefix
    (the reference's ``host_hit_length``/``last_host_node``,
    ``radix_cache.py:67-84``). ``HierarchicalCache.load`` restores them
    into device slots.

    ``disk_values``/``disk_nodes`` extend the chain one tier further:
    nodes whose KV lives only in durable disk extents
    (``cache/kv_tier.py``). They are restorable exclusively through the
    staged KV-transfer plane (reading an extent is blocking file I/O,
    lint-banned from the admission path), so the synchronous
    ``match_and_load`` path ignores them and the hit is simply shorter.
    """

    values: list[Any] = field(default_factory=list)
    last_node: "TreeNode | None" = None
    host_values: list[np.ndarray] = field(default_factory=list)
    host_nodes: list["TreeNode"] = field(default_factory=list)
    disk_values: list[Any] = field(default_factory=list)
    disk_nodes: list["TreeNode"] = field(default_factory=list)

    @property
    def length(self) -> int:
        return sum(len(v) for v in self.values)

    @property
    def host_length(self) -> int:
        """Tokens matched beyond ``length`` that live only in host RAM."""
        return sum(len(v) for v in self.host_values)

    @property
    def disk_length(self) -> int:
        """Tokens matched beyond the host extension that live only in
        disk extents."""
        return sum(len(v) for v in self.disk_values)

    def restorable_nodes(self) -> list["TreeNode"]:
        """The ordered host+disk extension — the staged restore's unit
        source (shallowest first; the restore must stay prefix-closed)."""
        return list(self.host_nodes) + list(self.disk_nodes)

    @property
    def last_host_node(self) -> "TreeNode | None":
        return self.host_nodes[-1] if self.host_nodes else None

    def indices(self) -> np.ndarray:
        if not self.values:
            return np.empty(0, dtype=np.int32)
        return np.concatenate([np.asarray(v, dtype=np.int32) for v in self.values])

    def host_indices(self) -> np.ndarray:
        if not self.host_values:
            return np.empty(0, dtype=np.int32)
        return np.concatenate(
            [np.asarray(v, dtype=np.int32) for v in self.host_values]
        )


class RadixTree:
    """Single-node radix prefix cache (reference ``RadixCache``,
    ``radix_cache.py:87-436``).

    Parameters
    ----------
    page_size:
        Match/insert granularity in tokens. ``1`` matches per-token (the
        reference's default and the mesh layer's fixed mode,
        ``radix_mesh.py:87-89``); larger values match whole pages, which is
        what the TPU paged-attention kernel wants (dense page tiles).
    on_free:
        Called with a concatenated numpy array of slot indices when eviction
        frees them (the reference calls
        ``token_to_kv_pool_allocator.free()``, ``radix_cache.py:188-199``).
    enable_events:
        Record :class:`BlockStored`/:class:`BlockRemoved` journal entries
        for external observers (reference ``radix_cache.py:379-436``).
    """

    def __init__(
        self,
        page_size: int = 1,
        on_free: Callable[[np.ndarray], None] | None = None,
        enable_events: bool = False,
        time_fn: Callable[[], float] = time.monotonic,
        on_free_host: Callable[[np.ndarray], None] | None = None,
        shard_fn: Callable[[np.ndarray], int] | None = None,
    ):
        self.page_size = page_size
        self.on_free = on_free
        self.on_free_host = on_free_host
        self.enable_events = enable_events
        self._time = time_fn
        self._events: list[Any] = []
        # Prefix-ownership sharding (cache/sharding.py): when set, maps a
        # TOP-LEVEL node's key segment to its shard id, and the tree
        # maintains per-shard fingerprints next to the scalar/buckets —
        # the owner-scoped convergence currency (whole-tree fingerprints
        # diverge BY DESIGN under sharding). None = tracking off.
        self.shard_fn = shard_fn
        # Durable-tier detach hook (cache/kv_tier.py): called with an
        # ExtentRef whenever a node carrying one leaves the tree or is
        # split — the owner (HierarchicalCache) queues the extent for
        # worker-side deletion. In-memory append only; never file I/O
        # on the caller's thread.
        self.on_disk_detach: Callable[[Any], None] | None = None
        # Draft-ahead epoch (ROADMAP 1a′): bumped by note_draft_ready()
        # whenever a PREFETCH fill or disk promotion ATTACHES continuation
        # KV this tree did not serve natively (cache/kv_transfer.py's
        # apply path). ``Engine._draft_for`` compares it against each
        # request's last-peeked epoch to re-arm the one-shot tree-draft
        # latch — promoted/remote-resident hits then draft exactly like
        # native ones. Deliberately NOT reset() state: residency changes,
        # the monotonic clock of arrivals does not.
        self.draft_ready_epoch = 0
        # All remaining state (root, size counters) is established by reset().
        self.reset()

    def note_draft_ready(self) -> None:
        """Mark that restored/promoted continuation KV just landed (any
        engine-thread apply site). Cheap int bump — safe on the hot
        path; readers only ever compare for inequality."""
        self.draft_ready_epoch += 1

    # ---- key plumbing ----

    def _child_key(self, key: np.ndarray) -> Any:
        if self.page_size == 1:
            return int(key[0])
        # tolist() is one C call; a per-token genexpr was the dominant
        # cost of paged-tree inserts (2.5x slower than page_size=1).
        return tuple(key[: self.page_size].tolist())

    def _aligned_len(self, n: int) -> int:
        return n - (n % self.page_size)

    def _match(self, a: np.ndarray, b: np.ndarray) -> int:
        m = match_len(a, b)
        if self.page_size > 1:
            m = self._aligned_len(m)
        return m

    # ---- public API ----

    def reset(self, root_value: Any = None) -> None:
        """Clear the tree (reference ``radix_cache.py:118-125``), returning
        every stored KV slot to the pool via ``on_free``."""
        if self.on_free is not None and getattr(self, "root", None) is not None:
            freed = self.all_values_flatten()
            if freed.size:
                self.on_free(freed)
        if self.on_free_host is not None and getattr(self, "root", None) is not None:
            host = [
                n.host_value
                for n in self._all_nodes()
                if n is not self.root and n.host_value is not None
            ]
            if host:
                self.on_free_host(np.concatenate(host))
        if self.on_disk_detach is not None and getattr(self, "root", None) is not None:
            for n in self._all_nodes():
                if n is not self.root and n.disk_value is not None:
                    self.on_disk_detach(n.disk_value)
                    n.disk_value = None
        self.root = TreeNode()
        self.root.key = np.empty(0, dtype=np.int32)
        self.root.value = root_value
        self.root.lock_ref = 1
        self.root.last_access_time = self._time()
        self.evictable_size_ = 0
        self.protected_size_ = 0
        # Order-independent fingerprint of the SET of token paths in the
        # tree (see module comment): XOR of every node's per-token mixed
        # chain hashes, maintained incrementally on insert/delete/evict.
        self.fingerprint_ = 0
        # Per-bucket partition of the same contributions (FP_BUCKETS
        # module comment): fingerprint_ == XOR-reduce(fp_buckets_).
        self.fp_buckets_ = np.zeros(FP_BUCKETS, dtype=np.uint64)
        # Per-SHARD partition (only when shard_fn is set): shard id →
        # XOR of that subtree shard's contributions. Sparse dict — most
        # nodes own a fraction of the shard space. The scalar equals the
        # XOR of these values too (same contribution multiset).
        self.fp_shards_: dict[int, int] = {}
        if self.enable_events:
            self._events.append(AllBlocksCleared())

    def match_prefix(self, key: Sequence[int], split_partial: bool = True) -> MatchResult:
        """Longest cached prefix of ``key``.

        Walks child links, splitting a node in place when the match ends
        mid-node (reference ``radix_cache.py:127-162,252-294``). With
        ``split_partial=False`` the walk is read-only and the final value is
        returned as a slice view — the router-replica mode (reference
        ``radix_mesh.py:247-271`` deliberately avoids splits on the router).
        """
        key = as_key(key)
        if self.page_size > 1:
            key = key[: self._aligned_len(len(key))]
        node = self.root  # walk pointer: advances through ALL tiers
        last_dev = self.root  # lock anchor: deepest device-resident node
        values: list[Any] = []
        host_values: list[np.ndarray] = []
        host_nodes: list[TreeNode] = []
        disk_values: list[Any] = []
        disk_nodes: list[TreeNode] = []
        in_host = False  # device residency is prefix-closed; host extends it
        in_disk = False  # ... and durable disk extents extend the host chain
        now = self._time()
        node.last_access_time = now
        while len(key) > 0:
            child = node.children.get(self._child_key(key))
            if child is None:
                break
            m = self._match(child.key, key)
            if m == 0:
                break
            child.last_access_time = now
            child.hit_count += 1
            if not in_host and child.value is None:
                # Written back to host RAM (value lives in host_value): the
                # device prefix ends here; keep walking the host extension.
                in_host = True
            if in_host and not in_disk and child.host_value is None:
                if child.disk_value is not None:
                    # Demoted one tier further (cache/kv_tier.py): the
                    # host extension ends here; keep walking the durable
                    # disk extension.
                    in_disk = True
                else:
                    break  # structural node with KV in no tier
            if in_disk and child.disk_value is None:
                break  # disk residency must stay prefix-closed too
            if m < len(child.key):
                if in_disk:
                    # An extent covers its whole segment — it cannot be
                    # partially restored, so a mid-node divergence ends
                    # the disk extension (never split here: splitting
                    # would orphan the extent).
                    break
                if split_partial:
                    child = self._split_node(child, m)
                    if in_host:
                        host_values.append(child.host_value)
                        host_nodes.append(child)
                    else:
                        values.append(child.value)
                        last_dev = child
                else:
                    # Read-only walk (router replica mode): return the
                    # partial value as a slice but anchor last_node at the
                    # deepest FULLY matched node, so lock-ref operations
                    # never protect tokens beyond the matched prefix.
                    if in_host:
                        host_values.append(child.host_value[:m])
                        host_nodes.append(child)
                    else:
                        values.append(child.value[:m])
                break
            if in_disk:
                disk_values.append(child.disk_value)
                disk_nodes.append(child)
            elif in_host:
                host_values.append(child.host_value)
                host_nodes.append(child)
            else:
                values.append(child.value)
                last_dev = child
            node = child
            key = key[m:]
        return MatchResult(
            values=values,
            last_node=last_dev,
            host_values=host_values,
            host_nodes=host_nodes,
            disk_values=disk_values,
            disk_nodes=disk_nodes,
        )

    def insert(
        self,
        key: Sequence[int],
        value: Any,
        on_conflict: Callable[[TreeNode, Any], Any] | None = None,
    ) -> int:
        """Insert ``key``→``value``; returns the length of the prefix that
        was already present (reference ``radix_cache.py:164-170,296-327``).

        ``value`` must satisfy ``len(value) == len(key)`` and support
        slicing. Over the already-present prefix the existing value is kept
        by default; with ``on_conflict`` set, each matched node whose value
        differs (``!=``) from the incoming segment is resolved by the
        callback, whose return value replaces the node's value — the hook
        the distributed layer uses for rank-conflict resolution (reference
        ``radix_mesh.py:273-323`` overrides the whole walk instead).

        A matched node that is HOST-resident (``value is None`` after a
        write-back) ADOPTS the incoming device segment: the caller just
        recomputed that span's KV, and taking it restores the invariant
        that device residency is prefix-closed (no device KV below a
        device-empty node — ``match_prefix`` and eviction both assume it).
        Adopted spans are NOT counted in the returned already-present
        length, so callers treat their slots as tree-owned, exactly like a
        fresh leaf's.
        """
        key = as_key(key)
        if len(value) != len(key):
            raise ValueError(f"value length {len(value)} != key length {len(key)}")
        if self.page_size > 1:
            n = self._aligned_len(len(key))
            key, value = key[:n], value[:n]
        if len(key) == 0:
            return 0
        return self._insert_helper(self.root, key, value, on_conflict)

    def peek_continuation(self, key: Sequence[int], max_tokens: int) -> np.ndarray:
        """Tokens the cache holds BEYOND ``key`` — the speculative drafter's
        best guess: if this exact sequence was served before, the published
        continuation is what the model said last time. Token-wise read-only
        walk (no splits, no paging truncation — nothing is mutated); at
        branch points it follows the most recently touched child. Empty
        when ``key`` diverges from or exhausts the tree."""
        key = as_key(key)
        node = self.root
        i = 0
        out: list[int] = []
        while i < len(key):
            child = node.children.get(self._child_key(key[i:]))
            if child is None:
                # Paged child keys bucket by the first FULL page, so only a
                # ragged tail shorter than one page can still match some
                # child's edge; with page_size == 1 (or a full-page tail) a
                # dict miss is definitive — skip the O(children) scan.
                if self.page_size > 1 and len(key) - i < self.page_size:
                    child = next(
                        (
                            c
                            for c in node.children.values()
                            if match_len(c.key, key[i:]) == len(key) - i
                        ),
                        None,
                    )
                if child is None:
                    return np.empty(0, dtype=np.int32)
            m = match_len(child.key, key[i:])
            if m < len(child.key):
                if i + m < len(key):
                    return np.empty(0, dtype=np.int32)  # diverged mid-edge
                out.extend(int(t) for t in child.key[m : m + max_tokens])
            i += m
            node = child
        cur = node
        while len(out) < max_tokens and cur.children:
            cur = max(cur.children.values(), key=lambda c: c.last_access_time)
            out.extend(int(t) for t in cur.key[: max_tokens - len(out)])
        return np.asarray(out[:max_tokens], dtype=np.int32)

    def evict(
        self,
        num_tokens: int,
        on_evict: Callable[["TreeNode"], None] | None = None,
        older_than: float | None = None,
    ) -> int:
        """Evict LRU unlocked leaves until ``num_tokens`` device slots are
        freed (reference ``radix_cache.py:179-202,366-377``). Returns slots
        freed. With a ``writeback`` hook (see :class:`HierarchicalCache`),
        evicted KV is copied to host RAM and the node *stays in the tree*
        host-resident instead of vanishing. ``on_evict`` (mesh replicas,
        whose values are rank-tagged objects rather than slot arrays)
        receives each evicted node instead of the ``on_free`` slot batch.
        ``older_than`` restricts eviction to nodes last touched BEFORE
        that monotonic instant — the TTL-sweep mode (``mesh_ttl_s``):
        the LRU heap pops oldest-first, so the sweep stops at the first
        fresh-enough candidate."""
        return self._evict_impl(
            num_tokens, writeback=None, on_evict=on_evict, older_than=older_than
        )

    def _evict_impl(
        self,
        num_tokens: int,
        writeback: Callable[["TreeNode"], bool] | None,
        on_evict: Callable[["TreeNode"], None] | None = None,
        older_than: float | None = None,
    ) -> int:
        # Candidates are "device leaves": unlocked nodes holding device KV
        # with no device KV anywhere below them (host-resident descendants
        # don't pin their ancestors on device). One post-order pass computes
        # per-node device-descendant counts; evictions then decrement
        # ancestors incrementally (O(n + evicted·depth), not O(n²)).
        dev_below: dict[int, int] = {}
        leaves: list[TreeNode] = []
        stack: list[tuple[TreeNode, bool]] = [(self.root, False)]
        while stack:
            n, processed = stack.pop()
            if not processed:
                stack.append((n, True))
                stack.extend((c, False) for c in n.children.values())
                continue
            below = sum(
                dev_below[id(c)] + (1 if c.value is not None else 0)
                for c in n.children.values()
            )
            dev_below[id(n)] = below
            if (
                n is not self.root
                and n.value is not None
                and below == 0
                and n.lock_ref == 0
            ):
                leaves.append(n)
        heapq.heapify(leaves)
        freed = 0
        freed_arrays: list[np.ndarray] = []
        freed_host: list[np.ndarray] = []
        while leaves and freed < num_tokens:
            node = heapq.heappop(leaves)
            if older_than is not None and node.last_access_time >= older_than:
                break  # heap pops LRU-first: everything left is fresher
            if node is self.root or node.lock_ref > 0 or node.value is None:
                continue
            freed += len(node.key)
            wrote_back = writeback is not None and writeback(node)
            if wrote_back:
                # KV now lives in node.host_value; release the device slots
                # but keep the node (its key remains matchable — no
                # ``on_evict``: the prefix is still servable via restore).
                freed_arrays.append(np.asarray(node.value, dtype=np.int32))
                node.value = None
                self.evictable_size_ -= len(node.key)
            else:
                # The KV is destroyed. ``on_evict`` (when given) takes over
                # slot release so it can also retract/account externally.
                if on_evict is not None:
                    on_evict(node)
                else:
                    freed_arrays.append(np.asarray(node.value, dtype=np.int32))
                self._remove_node(node, freed_host)
            # This node no longer holds device KV: decrement every
            # ancestor's count; the nearest DEVICE-holding ancestor (there
            # may be host-resident/structural nodes in between) becomes a
            # candidate when its count reaches zero.
            anc = node.parent
            while anc is not None and anc is not self.root:
                dev_below[id(anc)] -= 1
                anc = anc.parent
            dev_below[id(self.root)] -= 1
            anc = node.parent
            while anc is not self.root and anc.value is None:
                anc = anc.parent
            if (
                anc is not self.root
                and anc.value is not None
                and anc.lock_ref == 0
                and dev_below[id(anc)] == 0
            ):
                heapq.heappush(leaves, anc)
        if freed_arrays and self.on_free is not None:
            self.on_free(np.concatenate(freed_arrays))
        if freed_host and self.on_free_host is not None:
            self.on_free_host(np.concatenate(freed_host))
        return freed

    def _remove_node(self, node: TreeNode, freed_host: list[np.ndarray]) -> None:
        """Detach ``node`` (and, transitively, its host-resident subtree —
        a removed interior node strands its descendants) from the tree."""
        self._record_remove_event(node)
        del node.parent.children[self._child_key(node.key)]
        stack = [node]
        while stack:
            n = stack.pop()
            self._fp_detach(n)
            if n.value is not None:
                self.evictable_size_ -= len(n.key)
            if n.host_value is not None:
                freed_host.append(n.host_value)
            stack.extend(n.children.values())
            if n.disk_value is not None:
                # The extent is unreachable once the node leaves the
                # tree: queue it for worker-side deletion. (If the
                # process dies before the unlink, the extent re-grafts
                # at the next boot — stale-but-valid union semantics.)
                if self.on_disk_detach is not None:
                    self.on_disk_detach(n.disk_value)
                n.disk_value = None
            # Clear every tier on the detached nodes: any stale reference
            # (e.g. a restore loop that matched before the removal) must
            # see "no KV here" rather than freed slot ids.
            n.value = None
            n.host_value = None
            n.children = {}


    def inc_lock_ref(self, node: TreeNode) -> None:
        """Protect the path root→``node`` from eviction (reference
        ``radix_cache.py:204-216``)."""
        while node is not None and node is not self.root:
            if node.lock_ref == 0:
                self.evictable_size_ -= len(node.key)
                self.protected_size_ += len(node.key)
            node.lock_ref += 1
            node = node.parent

    def dec_lock_ref(self, node: TreeNode) -> None:
        """Release one protection ref along root→``node`` (reference
        ``radix_cache.py:218-230``)."""
        while node is not None and node is not self.root:
            if node.lock_ref == 1:
                self.evictable_size_ += len(node.key)
                self.protected_size_ -= len(node.key)
            if node.lock_ref > 0:
                node.lock_ref -= 1
            node = node.parent

    # ---- fingerprint maintenance (obs/fleet_plane.py convergence audit) ----

    @property
    def fingerprint(self) -> int:
        """64-bit order-independent digest of the token paths this tree
        holds. Two replicas that converged on the same key set report the
        same value; any divergent leaf flips it (w.h.p.)."""
        return self.fingerprint_

    def _fp_fold(self, chain: np.ndarray, shard: int = -1) -> None:
        """XOR ``chain``'s mixed contributions into the scalar
        fingerprint, the bucket vector, and (when shard tracking is on)
        the shard's slot (self-inverse: attach and detach are the same
        fold)."""
        if len(chain) == 0:
            return
        mixed = _mix64(chain)
        word = int(np.bitwise_xor.reduce(mixed))
        self.fingerprint_ ^= word
        np.bitwise_xor.at(
            self.fp_buckets_,
            (mixed % np.uint64(FP_BUCKETS)).astype(np.int64),
            mixed,
        )
        if shard >= 0:
            cur = self.fp_shards_.get(shard, 0) ^ word
            if cur:
                self.fp_shards_[shard] = cur
            else:
                self.fp_shards_.pop(shard, None)

    def _fp_attach(self, node: TreeNode) -> None:
        """Compute ``node.chain`` from its parent's path and fold the
        node's contribution into the fingerprint. Called exactly once per
        node entering the tree (new leaves, checkpoint restore)."""
        parent = node.parent
        start = (
            parent.chain[-1]
            if parent is not None and len(parent.chain)
            else _FP_SEED
        )
        node.chain = _chain_hashes(start, node.key)
        if self.shard_fn is not None:
            # Shard is constant down a subtree: top-level nodes hash
            # their own segment; everything deeper inherits (O(1)).
            node.shard = (
                self.shard_fn(node.key)
                if parent is None or parent is self.root
                else parent.shard
            )
        self._fp_fold(node.chain, node.shard)

    def _fp_detach(self, node: TreeNode) -> None:
        """Remove ``node``'s contribution (it is leaving the tree)."""
        self._fp_fold(node.chain, node.shard)
        node.chain = np.empty(0, dtype=np.uint64)

    def fingerprint_buckets(self) -> np.ndarray:
        """Copy of the 64-entry bucket vector (uint64) — the repair
        plane's PROBE payload. Pairwise-equal vectors ⇔ (w.h.p.) equal
        key sets; a diverged pair localizes the difference to the
        unequal buckets."""
        return self.fp_buckets_.copy()

    @staticmethod
    def path_hash(node: TreeNode) -> int:
        """Order-stable 64-bit identity of the full root→``node`` token
        path — equal across replicas REGARDLESS of how each replica's
        node boundaries fell (the chain value is a pure function of the
        path). The repair-plane key-summary currency."""
        if len(node.chain) == 0:
            return 0
        return int(_mix64(node.chain[-1:])[0])

    def nodes_touching_buckets(self, buckets) -> list[TreeNode]:
        """Tree nodes (root excluded) whose fingerprint contributions
        land in any of ``buckets`` — the candidates a repair session
        summarizes/re-replicates for those diverged buckets. A node
        whose KEY differs between replicas necessarily contributes to a
        diverged bucket, so this enumeration cannot miss the defect; it
        may include converged bystanders sharing a bucket (harmless:
        their summaries match and nothing is pushed)."""
        want = np.zeros(FP_BUCKETS, dtype=bool)
        for b in buckets:
            if 0 <= int(b) < FP_BUCKETS:
                want[int(b)] = True
        if not want.any():
            # The converged-probe steady state: an empty diff must cost
            # O(1), not a full-tree rehash under the caller's mesh lock.
            return []
        out = []
        for n in self._all_nodes():
            if n is self.root or len(n.chain) == 0:
                continue
            idx = (_mix64(n.chain) % np.uint64(FP_BUCKETS)).astype(np.int64)
            if want[idx].any():
                out.append(n)
        return out

    # ---- prefix-ownership sharding (cache/sharding.py) ----

    def shard_fingerprints(self) -> dict[int, int]:
        """shard id → 64-bit fingerprint of that shard's contribution
        set (only populated shards present; requires ``shard_fn``). The
        owner-scoped convergence currency: two co-owners of a shard have
        converged on it iff these values agree."""
        return dict(self.fp_shards_)

    def nodes_in_shard(self, sid: int) -> list[TreeNode]:
        """Tree nodes (root excluded) belonging to subtree shard
        ``sid`` — the enumeration a shard-scoped repair session (or a
        drain-time ownership transfer) summarizes/re-emits."""
        return self.nodes_in_shards([sid]).get(sid, [])

    def nodes_in_shards(self, sids) -> dict[int, list[TreeNode]]:
        """shard id → that shard's nodes, for every requested shard, in
        ONE tree walk. Repair handlers and drain handoffs enumerate
        many shards per exchange under the mesh lock — a walk per shard
        would stall oplog application O(shards × tree)."""
        want = {int(s) for s in sids}
        out: dict[int, list[TreeNode]] = {s: [] for s in want}
        if not want:
            return out
        for n in self._all_nodes():
            if n is self.root or len(n.chain) == 0:
                continue
            if n.shard in want:
                out[n.shard].append(n)
        return out

    def shard_root_summaries(
        self, sid: int, max_roots: int = 256
    ) -> list[tuple[int, int]]:
        """Per-subtree routing entries for shard ``sid``: one
        ``(root-page path hash, deepest cached token length)`` pair per
        top-level subtree in the shard, deepest-first (truncation under
        ``max_roots`` drops the shallowest — the least valuable hits).
        The hash matches :func:`root_page_hash` of the subtree's first
        page, so a router can recompute it from raw request tokens."""
        out: list[tuple[int, int]] = []
        for child in self.root.children.values():
            if child.shard != sid or len(child.chain) == 0:
                continue
            idx = min(max(1, self.page_size), len(child.chain)) - 1
            rh = int(_mix64(child.chain[idx : idx + 1])[0])
            deepest = 0
            stack: list[tuple[TreeNode, int]] = [(child, 0)]
            while stack:
                n, base = stack.pop()
                d = base + len(n.key)
                if d > deepest:
                    deepest = d
                stack.extend((c, d) for c in n.children.values())
            out.append((rh, deepest))
        out.sort(key=lambda t: -t[1])
        return out[:max_roots]

    # ---- introspection (reference radix_cache.py:172-177,232-248,354-364) ----

    def evictable_size(self) -> int:
        return self.evictable_size_

    def protected_size(self) -> int:
        return self.protected_size_

    def total_size(self) -> int:
        return sum(len(n.key) for n in self._all_nodes() if n is not self.root)

    def all_values_flatten(self) -> np.ndarray:
        vals = [
            np.asarray(n.value, dtype=np.int32)
            for n in self._all_nodes()
            if n is not self.root and n.value is not None
        ]
        if not vals:
            return np.empty(0, dtype=np.int32)
        return np.concatenate(vals)

    def pretty_print(self) -> str:
        lines: list[str] = []

        def walk(node: TreeNode, depth: int) -> None:
            if node is not self.root:
                lines.append(
                    "  " * depth
                    + f"{list(node.key[:8])}{'...' if len(node.key) > 8 else ''} "
                    + f"lock={node.lock_ref} value={node.value!r:.60}"
                )
            for child in node.children.values():
                walk(child, depth + 1)

        walk(self.root, -1)
        return "\n".join(lines)

    def take_events(self) -> list[Any]:
        ev, self._events = self._events, []
        return ev

    # ---- internals ----

    def _split_node(self, node: TreeNode, split_len: int) -> TreeNode:
        """Split ``node`` so its first ``split_len`` tokens become a new
        parent; returns the new parent (reference ``radix_cache.py:277-294``)."""
        new_node = TreeNode(parent=node.parent)
        new_node.key = node.key[:split_len]
        new_node.value = None if node.value is None else node.value[:split_len]
        new_node.host_value = (
            None if node.host_value is None else node.host_value[:split_len]
        )
        new_node.lock_ref = node.lock_ref
        new_node.last_access_time = node.last_access_time
        new_node.hit_count = node.hit_count
        new_node.children = {self._child_key(node.key[split_len:]): node}
        node.parent.children[self._child_key(new_node.key)] = new_node
        node.key = node.key[split_len:]
        node.value = None if node.value is None else node.value[split_len:]
        node.host_value = (
            None if node.host_value is None else node.host_value[split_len:]
        )
        if node.disk_value is not None:
            # An extent covers its node's exact segment and cannot be
            # sliced: a split retires the ref (neither half keeps it).
            # The caller just recomputed (or will recompute) this span,
            # and pressure will re-spill it with the new boundaries —
            # losing the extent costs a future disk write, never data.
            if self.on_disk_detach is not None:
                self.on_disk_detach(node.disk_value)
            node.disk_value = None
        # Chain hashes are a pure function of the root path, so a split
        # partitions them between the halves — zero fingerprint delta.
        # Shard is a function of the path's FIRST page only, so both
        # halves stay in the node's shard (zero shard-vector delta too).
        new_node.chain = node.chain[:split_len]
        node.chain = node.chain[split_len:]
        new_node.shard = node.shard
        node.parent = new_node
        if node.block_hashes is not None:
            # Page-chained hashes are a pure function of the root path, so a
            # split just partitions them between the two nodes.
            n_pages = split_len // max(self.page_size, 1)
            new_node.block_hashes = node.block_hashes[:n_pages]
            node.block_hashes = node.block_hashes[n_pages:]
        return new_node

    def _insert_helper(
        self,
        node: TreeNode,
        key: np.ndarray,
        value: Any,
        on_conflict: Callable[[TreeNode, Any], Any] | None = None,
    ) -> int:
        node.last_access_time = self._time()
        total_prefix = 0
        while True:
            child = node.children.get(self._child_key(key))
            if child is None:
                leaf = TreeNode(parent=node)
                leaf.key = key
                leaf.value = value
                leaf.last_access_time = self._time()
                node.children[self._child_key(key)] = leaf
                self.evictable_size_ += len(key)
                self._fp_attach(leaf)
                self._record_store_event(leaf)
                return total_prefix
            m = self._match(child.key, key)
            child.last_access_time = self._time()
            if m < len(child.key):
                child = self._split_node(child, m)
            if child.value is None:
                # Host-resident (or structural) node: adopt the caller's
                # freshly computed device KV for this span. Not counted as
                # already-present — the caller must hand these slots over
                # (they are tree-owned now). The host copy, if any, stays:
                # re-eviction of this node is then free.
                child.value = value[:m]
                self.evictable_size_ += len(child.key)
                self._record_store_event(child)
            else:
                if on_conflict is not None:
                    new_seg = value[:m]
                    if child.value != new_seg:
                        child.value = on_conflict(child, new_seg)
                total_prefix += m
            if m == len(key):
                return total_prefix
            key = key[m:]
            value = value[m:]
            node = child

    def _all_nodes(self) -> Iterable[TreeNode]:
        stack = [self.root]
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    # ---- event journal ----

    def _record_store_event(self, node: TreeNode) -> None:
        if not self.enable_events:
            return
        parent = node.parent
        parent_hash = (
            parent.block_hashes[-1]
            if parent is not None and parent.block_hashes
            else None
        )
        hashes = []
        toks = tuple(int(t) for t in node.key)
        page = max(self.page_size, 1)
        h = parent_hash
        for i in range(0, len(toks), page):
            h = _block_hash(h, toks[i : i + page])
            hashes.append(h)
        node.block_hashes = tuple(hashes)
        self._events.append(
            BlockStored(
                block_hashes=tuple(hashes),
                parent_block_hash=parent_hash,
                token_ids=toks,
                block_size=page,
            )
        )

    def _record_remove_event(self, node: TreeNode) -> None:
        if not self.enable_events:
            return
        if node.block_hashes:
            self._events.append(BlockRemoved(block_hashes=node.block_hashes))
