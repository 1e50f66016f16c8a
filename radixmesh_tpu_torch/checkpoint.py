"""Checkpoint and resume (the JAX package's ``checkpoint.py``).

- **Model weights**: the param tree in one safetensors file inside a
  directory, read and written by the port's own reader and writer
  (``models/hf_io.py``: no package). The JAX package writes orbax, which the
  card's machine lacks; ``torch.save`` would be a second format. The leaves
  keep the param tree's layout (``layers.wq`` is ``[L, H, Hq*D]``) and their
  dtype (int8 and float32 scales for W8A16). ``load_params(path, mesh=)``
  gives each rank its shard, equal to ``shard_params`` of the whole tree,
  the counterpart of JAX's restore onto a mesh: the file is mapped, so a
  rank reads only the pages of its slice where the layout allows it (its
  pipeline stage's layers, its vocabulary rows).
- **Cache state**: a radix-tree snapshot in the JAX package's format, so a
  snapshot written by either package loads in the other: JSON metadata
  (version 2), KV content in ``path + '.kv.npz'`` as float32 ``[2, L, n, H,
  D]`` per preorder node id (stored, where the JAX package deflates it:
  ``np.load`` reads either, and deflating the tens of megabytes of float32 KV
  of one long prompt takes seconds of host time), a shared ``snapshot_id``
  that refuses a torn pair, the access clock rebased on restore and ``on_free`` detached while
  the tree is rebuilt. On a mesh (a pool holding this rank's layers and
  heads, ``mesh=``) every rank gathers its shard, the engine's leader
  all-gathers the heads over tp and the layers over pp (as
  ``engine/disagg.PrefillWorker`` gathers a packet) and writes the one
  file; on load every rank reads it and writes its own slice.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid

import numpy as np
import torch
import torch.distributed as dist

from radixmesh_tpu_torch.cache.radix_tree import RadixTree, TreeNode
from radixmesh_tpu_torch.models.hf_io import read_safetensors, write_safetensors
from radixmesh_tpu_torch.models.llama import ModelConfig, param_logical_axes
from radixmesh_tpu_torch.parallel.collectives import all_gather
from radixmesh_tpu_torch.parallel.sharding import shard_params
from radixmesh_tpu_torch.utils.device import resolve_device

__all__ = [
    "save_params",
    "load_params",
    "tree_snapshot",
    "tree_restore",
    "save_tree",
    "load_tree",
]

PARAMS_FILE = "params.safetensors"


# ---------------------------------------------------------------------------
# model weights (safetensors)
# ---------------------------------------------------------------------------


def _flatten(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    out = {}
    for name, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{name}."))
        else:
            out[prefix + name] = v
    return out


def _unflatten(flat: dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def save_params(path: str, params: dict) -> None:
    """Write the param tree (tensors on any device: an ``init_params`` dict
    or a ``Llama``'s ``param_tree()``) into the directory ``path`` as
    ``params.safetensors``, leaf names joined by dots. The directory is
    written beside ``path`` and renamed into place, replacing a checkpoint
    already there."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    write_safetensors({k: v.detach() for k, v in _flatten(params).items()}, os.path.join(tmp, PARAMS_FILE))
    old = None
    if os.path.exists(path):
        old = f"{path}.old-{os.getpid()}"
        os.replace(path, old)
    os.replace(tmp, path)
    if old is not None:
        shutil.rmtree(old)


def load_params(path: str, mesh=None, device=None) -> dict:
    """The param tree written by :func:`save_params`, on ``device`` (CUDA
    unless ``"cpu"`` is asked for). With ``mesh`` (a ``ProcessMesh`` with tp
    or pp) each leaf is this rank's shard, equal to ``shard_params`` of the
    whole tree: sliced from the mapped file before it is moved, so only the
    slice is read where it is contiguous."""
    device = resolve_device(device)
    tree = _unflatten(read_safetensors(os.path.join(os.path.abspath(path), PARAMS_FILE)))
    if mesh is not None and (mesh.size("tp") > 1 or mesh.size("pp") > 1):
        cfg = ModelConfig(qkv_bias="bq" in tree["layers"], tie_embeddings="lm_head" not in tree)
        tree = shard_params(tree, param_logical_axes(cfg, tree), mesh)

    def move(t):
        return {k: move(v) for k, v in t.items()} if isinstance(t, dict) else t.to(device, copy=True)

    return move(tree)


# ---------------------------------------------------------------------------
# radix-tree snapshot
# ---------------------------------------------------------------------------


def _whole_kv(pool, slots: np.ndarray, mesh) -> np.ndarray:
    """``pool.gather`` of ``slots`` as float32 ``[2, L, n, H, D]``; on a mesh
    the ranks' shards all-gathered, heads over tp and layers over pp (every
    rank of the engine takes part)."""
    kv = pool.gather(slots).contiguous()
    if mesh is not None:
        kv = all_gather(all_gather(kv, mesh, "tp", dim=3), mesh, "pp", dim=1)
    return kv.float().cpu().numpy()


def tree_snapshot(tree: RadixTree, pool=None, mesh=None) -> tuple[dict, dict]:
    """Serializable snapshot: every node's (key tokens, slot values, access
    time, hit count), parent-linked by preorder id, plus the monotonic
    clock it was taken at (restore rebases access times onto the restoring
    process's clock). Lock refs are not saved: they are per-request runtime
    state, and all requests are gone after a restart.

    Returns ``(meta, kv_arrays)``. With ``pool`` (a ``PagedKVPool``),
    ``kv_arrays`` maps preorder node id → that node's KV content ``[2, L,
    n, H, D]`` (float32, a lossless container for bf16 pools and the
    dequantized int8 ones) so a restart can serve cache hits from the
    restored tree; without it, ``kv_arrays`` is empty and the snapshot is
    metadata-only (router and mesh replicas, whose values carry no local
    KV). ``mesh``: the pool holds this rank's shard (``_whole_kv``); every
    rank of the engine must call it, and each gets the whole snapshot."""
    nodes = []
    kv_arrays: dict[str, np.ndarray] = {}
    kv_jobs: list[tuple[str, np.ndarray]] = []  # (nid, slots)

    def walk(node: TreeNode, parent_id: int) -> None:
        for child in node.children.values():
            nid = len(nodes)
            value = child.value
            nodes.append(
                {
                    "parent": parent_id,
                    "key": np.asarray(child.key, dtype=np.int32).tolist(),
                    "value": (
                        None
                        if value is None
                        else np.asarray(value, dtype=np.int32).tolist()
                    ),
                    "last_access_time": child.last_access_time,
                    "hit_count": child.hit_count,
                }
            )
            if pool is not None and value is not None:
                kv_jobs.append((str(nid), np.asarray(value, dtype=np.int32)))
            walk(child, nid)

    walk(tree.root, -1)
    if kv_jobs:
        # One gather for every node, split on the host.
        g = _whole_kv(pool, np.concatenate([s for _, s in kv_jobs]), mesh)
        off = 0
        for nid, slots in kv_jobs:
            kv_arrays[nid] = g[:, :, off : off + len(slots)]
            off += len(slots)
    meta = {
        "version": 2,
        "page_size": tree.page_size,
        "clock": time.monotonic(),
        "has_kv": pool is not None,
        "nodes": nodes,
    }
    return meta, kv_arrays


def _rank_slice(kv: np.ndarray, pool, mesh) -> np.ndarray:
    """This rank's ``[2, L/pp, n, Hkv/tp, D]`` block of a whole node's KV."""
    if mesh is None:
        return kv
    nl, h = pool.num_layers, pool.num_kv_heads
    if kv.shape[1] != nl * mesh.size("pp") or kv.shape[3] != h * mesh.size("tp"):
        raise ValueError(f"snapshot KV of {kv.shape[1]} layers x {kv.shape[3]} heads does not fit a pool "
                         f"of {nl} layers x {h} heads on pp={mesh.size('pp')}, tp={mesh.size('tp')}")
    lo, i = mesh.index("pp") * nl, mesh.index("tp") * h
    return kv[:, lo:lo + nl, :, i:i + h]


def tree_restore(
    snapshot: dict,
    tree: RadixTree,
    pool=None,
    kv_arrays: dict[str, np.ndarray] | None = None,
    mesh=None,
) -> int:
    """Rebuild ``tree`` (cleared first) from a snapshot; returns the number
    of nodes restored.

    With ``pool``, each node's slots are re-claimed in the (fresh) pool's
    allocator and its saved KV content is written back (``mesh``: this
    rank's layers and heads of it), so the restored tree serves real hits.
    Restoring slot-valued nodes into a pool *without* their KV content is
    refused: the tree would reference pages whose contents no longer exist
    and hits would decode garbage. Metadata-only restore (``pool=None``)
    leaves the allocator alone and is for replicas whose values carry no
    local KV."""
    if snapshot.get("version") not in (1, 2):
        raise ValueError(f"unknown snapshot version {snapshot.get('version')}")
    if snapshot["page_size"] != tree.page_size:
        raise ValueError("snapshot page_size mismatch")
    if pool is not None and not snapshot.get("has_kv"):
        raise ValueError(
            "snapshot has no KV content; restoring it into a KV pool would "
            "serve hits from pages that were never rewritten — snapshot "
            "with pool= to include KV, or restore with pool=None"
        )
    kv_arrays = kv_arrays or {}
    # Rebase LRU clocks: a snapshot's monotonic timestamps are meaningless
    # in a new process (whose clock restarts near 0) — shift so the
    # snapshot's "now" maps to this process's now, preserving order.
    now = time.monotonic()
    snap_clock = snapshot.get("clock", now)
    # Detach on_free during the rebuild: reset() must not free pool slots
    # that the snapshot is about to re-claim.
    on_free, tree.on_free = tree.on_free, None
    try:
        tree.reset()
    finally:
        tree.on_free = on_free
    restored: list[TreeNode] = []
    for rec in snapshot["nodes"]:
        nid = len(restored)
        parent = tree.root if rec["parent"] < 0 else restored[rec["parent"]]
        node = TreeNode(parent=parent)
        node.key = np.asarray(rec["key"], dtype=np.int32)
        node.value = (
            None if rec["value"] is None else np.asarray(rec["value"], dtype=np.int32)
        )
        node.last_access_time = now - max(
            0.0, snap_clock - rec["last_access_time"]
        )
        node.hit_count = rec["hit_count"]
        parent.children[tree._child_key(node.key)] = node
        tree.evictable_size_ += len(node.key)
        # Rebuild the convergence fingerprint (parents precede children in
        # preorder, so each node's chain base is already attached).
        tree._fp_attach(node)
        if pool is not None and node.value is not None:
            pool.reserve(node.value)
            kv = kv_arrays.get(str(nid))
            if kv is None:
                raise ValueError(f"snapshot missing KV content for node {nid}")
            # [2, L, n, H, D] float32 container → pool dtype on write.
            kv = torch.as_tensor(np.ascontiguousarray(_rank_slice(kv, pool, mesh)), device=pool.device)
            pool.write(node.value, kv[0], kv[1])
        # Re-chain the event journal: observers must see the restored
        # contents, not an AllBlocksCleared followed by silence (parents
        # precede children in preorder, so hash chaining is well-defined).
        tree._record_store_event(node)
        restored.append(node)
    return len(restored)


def _leader(mesh) -> bool:
    return mesh is None or mesh.engine_index == 0


def save_tree(path: str, tree: RadixTree, pool=None, mesh=None) -> None:
    """Atomic snapshot to ``path`` (JSON metadata); with ``pool``, KV
    content lands beside it at ``path + '.kv.npz'``.

    The two files are replaced in separate (individually atomic) steps, so
    a crash between them can leave metadata from one snapshot next to KV
    from another. Both carry a shared random snapshot id that
    :func:`load_tree` verifies — a torn pair fails loudly instead of
    silently serving hits whose KV belongs to different token keys.

    ``mesh``: every rank of the engine calls it; the engine's leader writes
    the files and the call returns on every rank once they are in place
    (under dp each engine is a replica with a tree of its own: give each its
    own ``path``)."""
    meta, kv_arrays = tree_snapshot(tree, pool=pool, mesh=mesh)
    if _leader(mesh):
        sid = uuid.uuid4().hex
        meta["snapshot_id"] = sid
        if pool is not None:
            tmp_kv = path + ".kv.npz.tmp"
            with open(tmp_kv, "wb") as f:
                np.savez(
                    f,
                    __snapshot_id__=np.frombuffer(sid.encode(), dtype=np.uint8),
                    **kv_arrays,
                )
            os.replace(tmp_kv, path + ".kv.npz")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, path)  # atomic on POSIX
    if mesh is not None and mesh.engine_group() is not None:
        dist.barrier(group=mesh.engine_group())


def load_tree(path: str, tree: RadixTree, pool=None, mesh=None) -> int:
    """Restore the snapshot at ``path`` into ``tree`` (and ``pool``:
    ``tree_restore``); refuses a torn metadata/KV pair. ``mesh``: each rank
    writes its own slice of the KV."""
    with open(path) as f:
        meta = json.load(f)
    kv_arrays = None
    if pool is not None:
        with np.load(path + ".kv.npz") as z:
            kv_arrays = dict(z)
        kv_sid = kv_arrays.pop("__snapshot_id__", None)
        meta_sid = meta.get("snapshot_id")
        if meta_sid is not None or kv_sid is not None:
            kv_sid_str = (
                None if kv_sid is None else kv_sid.tobytes().decode(errors="replace")
            )
            if kv_sid_str != meta_sid:
                raise ValueError(
                    f"torn snapshot: metadata id {meta_sid!r} != KV id "
                    f"{kv_sid_str!r} (crash between the two file replaces?) — "
                    "take a fresh snapshot"
                )
    return tree_restore(meta, tree, pool=pool, kv_arrays=kv_arrays, mesh=mesh)
