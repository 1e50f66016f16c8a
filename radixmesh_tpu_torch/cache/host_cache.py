"""Hierarchical KV cache: the pool's device tier, a host-RAM tier behind it,
and the durable disk tier behind that (this package's port of the JAX
package's ``cache/host_cache.py``).

- :class:`HostKVStore`: a host-RAM arena, a CPU tensor ``[slots, 2, L,
  Hkv, D]`` in the pool's stored dtype (int8 pools add ``[slots, 2, L,
  Hkv]`` float32 scales), with the pool's page-granular
  :class:`SlotAllocator`. Behind a CUDA pool the arena is **pinned**
  (page-locked), so host↔device copies are DMA transfers that run beside
  compute; pinning that fails raises instead of falling back to pageable
  memory. The arena is slot-major (the JAX arena is ``[2, L, slots, Hkv,
  D]``): a run of consecutive slots is one contiguous range, which the
  plane copies to and from the card directly, with no host-side gather.
  Host copies are torch ops, which run without the GIL.
- :class:`HierarchicalCache`: a :class:`RadixTree` whose eviction WRITES
  BACK device KV to the host arena instead of dropping it (the node stays in
  the tree, host-resident), whose :meth:`~HierarchicalCache.match_and_load`
  restores a matched host extension into fresh pool slots, and which spills
  cold host copies to disk extents and resurrects them at boot.

Write-back is sweep-batched: one eviction sweep pays ONE fused gather of
every evicted node's slots (``_flush_writeback_batch``). The sweep's device
slots go back to the free list at once and the next prefill may overwrite
them, so the gather must read the old K/V first. It is enqueued on the
current (compute) stream at the end of the sweep, before any later pool
write, and stream order gives that guarantee (where the JAX package relies
on buffer donation). With the async plane (``cache/kv_transfer.py``) only
the device→host copy and the arena write leave the engine thread.

When the arena fills, disk-backed host copies are demoted first (arena
slots freed, prefix kept on disk); only then do host-only nodes die in LRU
order and their prefixes recompute, never an error. The JAX package's
Prometheus series are plain counters here (``stats()``).
"""

from __future__ import annotations

import heapq
import os
import time

import numpy as np
import torch

from radixmesh_tpu_torch.cache.kv_pool import PagedKVPool, SlotAllocator
from radixmesh_tpu_torch.cache.kv_tier import node_heat
from radixmesh_tpu_torch.cache.radix_tree import MatchResult, RadixTree, TreeNode, match_len
from radixmesh_tpu_torch.obs.metrics import get_registry
from radixmesh_tpu_torch.ops.quant import KV_QUANT_DTYPES
from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = ["HostKVStore", "HierarchicalCache", "gather_padded"]


def gather_padded(pool: PagedKVPool, slots) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One fused gather of ``slots``, brought to the host: ``(kv [2, L, n,
    H, D], scales [2, L, n, H] | None)`` as CPU tensors in the pool's
    STORED dtype (int8 and scales for quantized pools: the tier keeps the
    exact representation). The JAX version pads the gather to a
    power-of-two bucket for its jit cache; eager PyTorch compiles nothing
    per shape, so this one gathers exactly ``len(slots)`` tokens."""
    kv, scales = pool.gather_raw(np.asarray(slots, dtype=np.int32))
    return kv.cpu(), None if scales is None else scales.cpu()


class HostKVStore:
    """Host-RAM KV arena with page-granular allocation. The arena is
    SLOT-major, ``[slots, 2, L, H, D]`` (scales ``[slots, 2, L, H]``): each
    token slot's K/V is one contiguous block, so a run of consecutive slots
    is one contiguous range that a single DMA moves to or from the card
    (:meth:`rows`). :meth:`read` and :meth:`write` speak the token-major
    ``[2, L, n, H, D]`` interchange format, as the JAX arena does.
    ``pin_memory`` page-locks the arena (the engine asks for it behind a
    CUDA pool)."""

    def __init__(
        self,
        num_slots: int,
        num_layers: int,
        num_kv_heads: int,
        head_dim: int,
        page_size: int = 1,
        dtype: torch.dtype = torch.bfloat16,
        quant: str | None = None,
        pin_memory: bool = False,
    ):
        self.num_slots = num_slots
        self.page_size = page_size
        self.quant = quant
        if quant is not None:
            dtype = KV_QUANT_DTYPES[quant]
        self.dtype = dtype
        self.allocator = SlotAllocator(num_slots, page_size)
        self._arena = torch.zeros(
            (num_slots, 2, num_layers, num_kv_heads, head_dim), dtype=dtype, pin_memory=pin_memory
        )
        # Per-(token, head) scales for quantized arenas (ops/quant.py).
        self._scale_arena = (
            torch.zeros((num_slots, 2, num_layers, num_kv_heads), dtype=torch.float32,
                        pin_memory=pin_memory)
            if quant is not None
            else None
        )
        if pin_memory and not all(
            t.is_pinned() for t in (self._arena, self._scale_arena) if t is not None
        ):
            raise RuntimeError("the host KV arena could not be pinned")

    @property
    def pinned(self) -> bool:
        return self._arena.is_pinned()

    @property
    def free_slots(self) -> int:
        return self.allocator.free_slots

    def alloc(self, n_tokens: int) -> np.ndarray | None:
        return self.allocator.alloc(n_tokens)

    def free(self, slots: np.ndarray) -> None:
        self.allocator.free(slots)

    def rows(self, start: int, n: int) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Views of the arena's slots ``[start, start + n)``: ``[n, 2, L, H,
        D]`` (and ``[n, 2, L, H]`` scales), contiguous."""
        sc = self._scale_arena
        return self._arena[start : start + n], None if sc is None else sc[start : start + n]

    def write(self, slots, kv, scales=None) -> None:
        """Store token-major ``kv`` ``[2, L, n, H, D]`` (plus quant scales
        ``[2, L, n, H]``), CPU tensors or numpy arrays in the arena's dtype,
        at host ``slots``. Duplicate slot ids resolve last-write-wins, in
        order (see ``HierarchicalCache._flush_writeback_batch``)."""
        slots = np.asarray(slots, dtype=np.int64)
        kv = torch.as_tensor(kv).permute(2, 0, 1, 3, 4)
        scales = None if scales is None else torch.as_tensor(scales).permute(2, 0, 1, 3)
        if len(np.unique(slots)) != len(slots):
            # index_copy_ leaves the winner of a duplicate id unspecified:
            # keep each id's last occurrence only.
            _, first_rev = np.unique(slots[::-1], return_index=True)
            keep = np.sort(len(slots) - 1 - first_rev)
            slots = slots[keep]
            kv = kv[torch.as_tensor(keep)]
            scales = None if scales is None else scales[torch.as_tensor(keep)]
        idx = torch.as_tensor(slots)
        self._arena.index_copy_(0, idx, kv)
        if self._scale_arena is not None:
            self._scale_arena.index_copy_(0, idx, scales)

    def read(self, slots) -> tuple[torch.Tensor, torch.Tensor | None]:
        """``(kv [2, L, n, H, D], scales [2, L, n, H] | None)`` at host
        ``slots``: token-major views of new slot-major CPU tensors."""
        idx = torch.as_tensor(np.asarray(slots, dtype=np.int64))
        kv = self._arena.index_select(0, idx).permute(1, 2, 0, 3, 4)
        if self._scale_arena is None:
            return kv, None
        return kv, self._scale_arena.index_select(0, idx).permute(1, 2, 0, 3)


class HierarchicalCache(RadixTree):
    """Radix tree with a write-back host tier behind the device pool, and
    optionally a durable disk tier behind the host tier."""

    def __init__(
        self,
        pool: PagedKVPool,
        host_store: HostKVStore,
        page_size: int | None = None,
        disk_tier=None,
        **tree_kw,
    ):
        if pool.quant != host_store.quant:
            raise ValueError(
                f"pool quant={pool.quant!r} and host tier quant={host_store.quant!r} must "
                "match: the tier stores the pool's exact representation"
            )
        if host_store.dtype != pool.dtype:
            raise ValueError(f"host tier dtype {host_store.dtype} != pool dtype {pool.dtype}")
        if pool.device.type == "cuda" and not host_store.pinned:
            # Pageable host memory would turn every DMA into a blocking copy.
            raise ValueError("the host tier behind a CUDA pool must be pinned (pin_memory=True)")
        self.pool = pool
        self.host = host_store
        # Durable third tier (cache/kv_tier.py::DiskKVTier). Disk restores
        # and spills go only through the staged plane (no file I/O on the
        # admission path), so the engine arms the plane with the tier.
        self.disk = disk_tier
        self.log = get_logger("hicache")
        # Async KV-movement plane (cache/kv_transfer.py). None = every copy
        # is synchronous; the owning engine installs a plane to move arena
        # reads and writes off its scheduling thread.
        self.plane = None
        # Current sweep's write-back batch [(node, dev_slots, host_slots)],
        # lifetime sweep/gather counts (gathers per sweep <= 1), and the
        # JAX package's radixmesh_hicache_* series, on the registry and as
        # plain counters for stats() (/stats).
        self._wb_batch: list[tuple[TreeNode, np.ndarray, np.ndarray]] = []
        self.wb_sweeps = 0
        self.wb_gathers = 0
        self.backup_tokens = 0
        self.restore_tokens = 0
        self.host_evicted_tokens = 0
        self.restore_stall_count = 0
        self.restore_stall_s = 0.0
        reg = get_registry()
        self._m_backup = reg.counter(
            "radixmesh_hicache_backup_tokens_total", "tokens written back HBM → host RAM"
        )
        self._m_restore = reg.counter(
            "radixmesh_hicache_restore_tokens_total", "tokens restored host RAM → HBM"
        )
        self._m_host_evicted = reg.counter(
            "radixmesh_hicache_host_evicted_tokens_total",
            "host-resident tokens dropped when the host arena filled",
        )
        self._m_restore_stall = reg.histogram(
            "radixmesh_hicache_restore_stall_seconds",
            "host-side time spent reading the arena + dispatching "
            "restore writes per match_and_load (device execution "
            "overlaps later admission work; this is the blocking part)",
        )
        super().__init__(
            page_size=pool.page_size if page_size is None else page_size,
            on_free=pool.free,
            on_free_host=host_store.free,
            **tree_kw,
        )
        if self.disk is not None:
            # Extent refs leaving the tree (split/remove/reset) queue for
            # worker-side unlink: an in-memory append, never file I/O here.
            self.on_disk_detach = self.disk.retire

    def stats(self) -> dict:
        """The host tier's occupancy and counters (``/stats`` ``host_tier``,
        the JAX ``/debug/state`` keys plus its counters)."""
        return {
            "num_slots": self.host.num_slots,
            "free_slots": self.host.free_slots,
            "pinned": self.host.pinned,
            "writeback_sweeps": self.wb_sweeps,
            "writeback_gathers": self.wb_gathers,
            "backup_tokens": self.backup_tokens,
            "restore_tokens": self.restore_tokens,
            "host_evicted_tokens": self.host_evicted_tokens,
            "restore_stall_count": self.restore_stall_count,
            "restore_stall_s": self.restore_stall_s,
        }

    # ---- device eviction with write-back ----

    def evict(self, num_tokens: int, on_evict=None) -> int:
        """Evict with host write-back. ``on_evict`` fires only for nodes
        the host tier could NOT absorb (arena full: KV destroyed);
        written-back nodes stay matchable. The whole sweep pays one fused
        gather at its end (``_flush_writeback_batch``): its freed device
        slots cannot be reallocated before this engine-thread call
        returns, and the gather is enqueued before any later pool write."""
        self._wb_batch = []
        try:
            freed = self._evict_impl(num_tokens, writeback=self._writeback, on_evict=on_evict)
        finally:
            self._flush_writeback_batch()
        return freed

    def evict_no_writeback(self, num_tokens: int) -> int:
        """Plain-drop eviction: the staged-restore allocator's room-maker
        (writing back here could free the very host slots an in-flight
        restore is reading)."""
        return self._evict_impl(num_tokens, writeback=None)

    def _writeback(self, node: TreeNode) -> bool:
        """Reserve arena room for ``node`` and record it in the sweep batch
        (the data moves in ``_flush_writeback_batch``). False (a plain
        eviction) only if the arena can't make room."""
        if node.host_value is not None:
            return True  # already backed up: re-eviction is free
        if node.disk_value is not None:
            return True  # durable on disk: demotion past the host is free
        slots = np.asarray(node.value, dtype=np.int32)
        host_slots = self.host.alloc(len(slots))
        if host_slots is None:
            self._evict_host(max(1, len(slots) - self.host.free_slots))
            host_slots = self.host.alloc(len(slots))
            if host_slots is None:
                return False
        host_slots = host_slots[: len(slots)]
        node.host_value = host_slots
        self._wb_batch.append((node, slots, host_slots))
        self.backup_tokens += len(slots)
        self._m_backup.inc(len(slots))
        return True

    def _flush_writeback_batch(self) -> None:
        """One fused device→host copy for the whole eviction sweep.
        Duplicate host-slot ids are possible when ``_evict_host`` dropped
        a just-written-back node mid-sweep and its slots were re-reserved:
        the arena write resolves them last-write-wins in batch order, and
        the dropped node is out of the tree, so nobody reads its stale
        mapping."""
        batch, self._wb_batch = self._wb_batch, []
        if not batch:
            return
        self.wb_sweeps += 1
        self.wb_gathers += 1
        all_slots = np.concatenate([s for _, s, _ in batch])
        all_host = np.concatenate([h for _, _, h in batch])
        if self.plane is not None:
            # Gather enqueued here (engine thread, compute stream); the
            # device→host copy and the arena write on the plane worker.
            self.plane.submit_writeback(self.pool, self.host, all_slots, all_host)
        else:
            self.host.write(all_host, *gather_padded(self.pool, all_slots))

    def _evict_host(self, num_tokens: int) -> int:
        """Make arena room, preferring DEMOTE over DROP: a host copy
        already destaged to a disk extent frees its arena slots without
        losing the prefix (the node stays, disk-resident). Only then are
        host-ONLY leaves LRU-dropped for real. Never touches nodes that
        still hold device KV, or nodes a staged restore or spill reads."""
        plane = self.plane

        def busy(n) -> bool:
            return plane is not None and (plane.is_pending(n) or plane.spill_pending(n))

        freed = 0
        # Pass 1, demote: disk-backed host copies are free to shed.
        demote_host: list[np.ndarray] = []
        for n in self._all_nodes():
            if freed >= num_tokens:
                break
            if (
                n is not self.root
                and n.value is None
                and n.host_value is not None
                and n.disk_value is not None
                and n.lock_ref == 0
                and not busy(n)
            ):
                freed += len(n.host_value)
                demote_host.append(n.host_value)
                n.host_value = None
        if demote_host:
            self.host.free(np.concatenate(demote_host))
        if freed >= num_tokens:
            return freed
        # Pass 2, drop: LRU host-only leaves die (leaves only: paths stay
        # connected; a node mid-restore or mid-spill keeps its slots).
        candidates = [
            n
            for n in self._all_nodes()
            if n is not self.root
            and n.value is None
            and n.host_value is not None
            and n.lock_ref == 0
            and not n.children
            and not busy(n)
        ]
        heapq.heapify(candidates)
        freed_host: list[np.ndarray] = []
        while candidates and freed < num_tokens:
            node = heapq.heappop(candidates)
            freed += len(node.host_value)
            self.host_evicted_tokens += len(node.host_value)
            self._m_host_evicted.inc(len(node.host_value))
            self._remove_node(node, freed_host)
            parent = node.parent
            if (
                parent is not self.root
                and parent.value is None
                and parent.host_value is not None
                and parent.lock_ref == 0
                and not parent.children
                and not busy(parent)
            ):
                heapq.heappush(candidates, parent)
        if freed_host:
            self.host.free(np.concatenate(freed_host))
        return freed

    # ---- durable disk tier (cache/kv_tier.py) ----

    @staticmethod
    def path_tokens(node: TreeNode) -> np.ndarray:
        """Root→parent token path above ``node`` (the extent's prefix
        field: what makes a spilled segment restorable by path alone)."""
        parts = []
        p = node.parent
        while p is not None and p.parent is not None:  # stop at the root
            parts.append(p.key)
            p = p.parent
        if not parts:
            return np.empty(0, dtype=np.int32)
        return np.concatenate([np.asarray(k, dtype=np.int32) for k in reversed(parts)])

    def destage_cold(
        self,
        *,
        watermark: float = 0.7,
        min_heat: float = 0.0,
        budget: int = 16,
        force: bool = False,
        now: float | None = None,
    ) -> int:
        """Write-behind destage: once the arena fills past ``watermark``,
        schedule disk spills for host-resident nodes not yet extent-backed,
        coldest first, so that later arena pressure DEMOTES them instead of
        dropping them. Nodes colder than ``min_heat`` (``node_heat``) are
        left to die. ``force`` (the drain path) spills everything. Returns
        spills submitted; the plane worker does the file I/O and the
        engine's next pump commits the refs."""
        if self.disk is None or self.plane is None or self.host.num_slots <= 0:
            return 0
        fill = 1.0 - self.host.free_slots / self.host.num_slots
        if not force and fill < watermark:
            return 0
        t = self._time() if now is None else now
        plane = self.plane
        cands: list[TreeNode] = []
        for n in self._all_nodes():
            if (
                n is self.root
                or n.host_value is None
                or n.disk_value is not None
                or plane.is_pending(n)
                or plane.spill_pending(n)
            ):
                continue
            if not force and node_heat(n, t) < min_heat:
                continue  # too cold to be worth a disk write: it may die
            cands.append(n)
        cands.sort(key=lambda n: n.last_access_time)  # coldest first
        submitted = 0
        for n in cands:
            if submitted >= budget:
                break
            if plane.submit_spill(self, n, self.path_tokens(n)):
                submitted += 1
        return submitted

    def resurrect_from_disk(self, common=None) -> dict:
        """Cold-cell resurrection (COLD PATH: boot-time blocking file I/O):
        scan the extent directory, drop torn or corrupt extents, and graft
        the verified paths back as disk-resident nodes. Extents whose
        ancestor chain is not fully covered are orphans and are retired:
        restore degrades to the longest verified prefix, never serves
        holes. ``common(names) -> set`` (an engine over several ranks, each
        with its shard's extents): only the extents it returns, those that
        verified on every rank, are grafted; the rest are retired."""
        out = {"extents": 0, "grafted_nodes": 0, "grafted_tokens": 0, "orphaned": 0, "keys": []}
        if self.disk is None:
            return out
        metas = self.disk.scan()
        if common is not None:
            keep = common([os.path.basename(m.ref.path) for m in metas])
            for m in metas:
                if os.path.basename(m.ref.path) not in keep:
                    self.disk.retire(m.ref)
            metas = [m for m in metas if os.path.basename(m.ref.path) in keep]
        out["extents"] = len(metas)
        for meta in metas:
            node = self._graft_extent(meta)
            if node is None:
                out["orphaned"] += 1
                self.disk.retire(meta.ref)
            else:
                out["grafted_nodes"] += 1
                out["grafted_tokens"] += len(meta.seg_tokens)
                out["keys"].append(np.concatenate([
                    np.asarray(meta.prefix_tokens, dtype=np.int32),
                    np.asarray(meta.seg_tokens, dtype=np.int32),
                ]))
        self.disk.drain_retired()  # cold path: an inline unlink is fine
        if out["grafted_nodes"]:
            self.log.info(
                "resurrected %d disk-resident node(s) / %d tokens from %s (%d orphaned)",
                out["grafted_nodes"], out["grafted_tokens"], self.disk.dir, out["orphaned"],
            )
        return out

    def _graft_extent(self, meta) -> TreeNode | None:
        """Attach one verified extent under its recorded path; None =
        orphan (prefix not fully covered, a boundary mismatch, or the slot
        already holds live KV)."""
        cur = self.root
        toks = np.asarray(meta.prefix_tokens, dtype=np.int32)
        i = 0
        while i < len(toks):
            child = cur.children.get(self._child_key(toks[i:]))
            if child is None:
                return None
            m = match_len(child.key, toks[i:])
            if m < len(child.key):
                return None  # boundary mismatch: degrade to orphan
            i += m
            cur = child
        seg = np.asarray(meta.seg_tokens, dtype=np.int32)
        if len(seg) == 0:
            return None
        ck = self._child_key(seg)
        existing = cur.children.get(ck)
        if existing is not None:
            if (
                len(existing.key) == len(seg)
                and match_len(existing.key, seg) == len(seg)
                and existing.value is None
                and existing.host_value is None
                and existing.disk_value is None
            ):
                existing.disk_value = meta.ref
                return existing
            return None
        leaf = TreeNode(parent=cur)
        leaf.key = seg
        leaf.disk_value = meta.ref
        cur.children[ck] = leaf
        self._fp_attach(leaf)
        return leaf

    def _drop_poisoned_host(self, node: TreeNode) -> None:
        """Retire a host copy whose write-back never landed (plane worker
        failure): free the arena slots and leave the node host-empty,
        which is strictly safer than serving unwritten bytes."""
        self.log.warning("dropping %d-token host copy whose write-back failed", len(node.host_value))
        self.host.free(np.asarray(node.host_value, dtype=np.int32))
        node.host_value = None

    # ---- host → device restore (the synchronous path) ----

    def match_and_load(self, key, match: MatchResult | None = None) -> MatchResult:
        """``match_prefix`` + restore: if the match extends into the host
        tier, allocate pool slots, copy the host KV back into the pool and
        reinstate each node's device value, so the returned result covers
        the full two-tier hit. Nodes that can't be restored (pool exhausted
        even after eviction) stay host-resident: the hit is shorter.
        ``match`` may carry a just-computed splitting ``match_prefix``
        result (valid only if the tree has not changed since)."""
        res = self.match_prefix(key) if match is None else match
        if not res.host_nodes:
            return res
        if self.plane is not None and not self.plane.wait_host_ready():
            # Read barrier: this sweep's arena writes may still be on the
            # plane worker; a failed barrier means the bytes are untrusted,
            # so serve the shorter device-only hit.
            self.log.warning(
                "host-tier read barrier failed; skipping restore of a %d-token host extension",
                res.host_length,
            )
            return res
        stall_t0 = time.monotonic()
        # Lock the device prefix while restoring: the room-making evictions
        # below are plain drops and must not take the chain's own ancestors.
        # The anchor moves down as nodes are restored.
        anchor = res.last_node
        locked = anchor is not None and anchor is not self.root
        if locked:
            self.inc_lock_ref(anchor)
        try:
            for node in res.host_nodes:
                if node.host_value is None or node.value is not None:
                    break
                if self.plane is not None and not self.plane.host_slots_ok(node.host_value):
                    # This node's write-back failed: drop the host copy (a
                    # recompute) instead of restoring garbage.
                    self._drop_poisoned_host(node)
                    break
                n = len(node.host_value)
                partial = False
                dev = self.pool.alloc(n)
                if dev is None:
                    self._evict_impl(n - self.pool.free_slots, writeback=None)
                    dev = self.pool.alloc(n)
                if dev is None:
                    # Partial restore: split the node at the largest
                    # page-aligned length the pool can hold.
                    avail = self._aligned_len(min(n - self.page_size, self.pool.free_slots))
                    if avail <= 0:
                        break
                    node = self._split_node(node, avail)
                    n = avail
                    partial = True
                    dev = self.pool.alloc(n)
                    if dev is None:
                        break
                dev = dev[:n]
                kv, scales = self.host.read(node.host_value)  # [2, L, n, H, D]
                self.pool.write_raw(dev, kv, scales)
                node.value = dev
                self.evictable_size_ += len(node.key)
                self.restore_tokens += n
                self._m_restore.inc(n)
                res.values.append(node.value)
                res.last_node = node
                self.inc_lock_ref(node)
                if locked:
                    self.dec_lock_ref(anchor)
                anchor, locked = node, True
                if partial:
                    break  # deeper host nodes no longer touch the device prefix
        finally:
            if locked:
                self.dec_lock_ref(anchor)
            stall = time.monotonic() - stall_t0
            self.restore_stall_count += 1
            self.restore_stall_s += stall
            self._m_restore_stall.observe(stall)
        res.host_values = []
        res.host_nodes = []
        return res
