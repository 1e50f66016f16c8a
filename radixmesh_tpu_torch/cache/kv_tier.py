"""Durable KV spill tier: checksummed, fsynced, schema-versioned extent files
(this package's own copy of the JAX package's ``cache/kv_tier.py``).

Every tier above this one is volatile: the pool dies with the process, the
host arena (``cache/host_cache.py``) with the machine. This is the third
tier: local-disk **extent files**, one per spilled radix node segment,
written to a temp file, flushed, ``os.fsync``-ed and ``os.replace``-d, so the
rename is the commit point and a ``kill -9`` at any instant leaves every
committed extent intact and at most one temp file (removed at the next
scan). A committed extent that is later truncated or bit-flipped fails its
CRC and is **dropped, never served**: a restore degrades to a shorter
verified prefix. An extent records its full root→node token path beside
its segment's KV, so it is restorable by path alone, and **cold-cell
resurrection** is a directory scan (``HierarchicalCache.resurrect_from_disk``).

The file format is byte-identical to the JAX package's: the same preamble
(magic, schema version, header length and CRC), a ``sort_keys`` JSON
header, the CRC32 of the payload, and ``kv_dtype`` names ``"bfloat16"``,
``"float32"``, ``"int8"``. A node of either package can resurrect the
other's extents. The KV travels as torch tensors; bf16 is encoded from and
decoded into its 16-bit patterns (``view(torch.int16)``), never through a
numpy float (numpy has no bfloat16 of its own).

Threading contract: all blocking file I/O here runs on the KV-transfer
plane's worker thread (spills, reads, unlinks) or on cold paths (the boot
``scan``, drain). The engine thread only handles in-memory
:class:`ExtentRef` objects; deletions it triggers are queued by
:meth:`DiskKVTier.retire` and unlinked by the worker
(:meth:`DiskKVTier.drain_retired`). The JAX package's Prometheus series
are plain counters here, read through :meth:`DiskKVTier.stats`.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from radixmesh_tpu_torch.obs.metrics import TRANSFER_SECONDS_BUCKETS, get_registry
from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = [
    "EXTENT_SCHEMA_VERSION",
    "rank_tier_dir",
    "ExtentRef",
    "ExtentMeta",
    "DiskKVTier",
    "node_heat",
]

EXTENT_SCHEMA_VERSION = 1

# Fixed preamble: magic, schema version, reserved, header-JSON length,
# header CRC. The header's own CRC makes a torn or flipped header
# detectable before any field is trusted.
_MAGIC = b"RMKV"
_PRE = struct.Struct("<4sHHII")

# Per-node decayed heat: a node's hit count halves every half-life of
# idleness; the demote-vs-die signal of the write-behind destager.
NODE_HEAT_HALF_LIFE_S = 120.0

# Shards of the tier's move telemetry: the sharding plane's first-page
# blake2b bucketing (the JAX package's ``cache/sharding.py``).
_NUM_SHARDS = 64

# kv_dtype name in the header → (torch dtype, numpy dtype of its bit
# patterns), for every pool dtype. bf16 rides numpy as int16 and is viewed
# back as bf16.
_KV_DTYPES = {
    "bfloat16": (torch.bfloat16, np.int16),
    "float32": (torch.float32, np.float32),
    "int8": (torch.int8, np.int8),
}
_KV_NAMES = {t: name for name, (t, _) in _KV_DTYPES.items()}

_CORRUPT_CAUSES = ("truncated", "checksum", "schema", "io")


# The per-rank layout of an engine over several ranks (``rank_tier_dir``).
TIER_MANIFEST = "manifest.json"
# What every rank's manifest of one directory must share.
_MESH_KEYS = ("tp", "pp", "sp", "n_layers", "n_kv_heads", "head_dim", "page_size", "dtype", "quant")


def rank_tier_dir(root: str, manifest: dict | None) -> str:
    """The directory one engine rank's tier reads and writes under the tier
    root ``root``. A single-device engine (``manifest`` None) uses ``root``
    itself, laid out as the JAX tier lays it out. A rank of an engine over
    several ranks (``manifest``: its mesh shape, its ``rank`` among the
    engine's ranks and the geometry of its shard) uses ``root/rank<i>/``,
    which holds extents of its own heads and layers beside
    ``manifest.json``. A root written at another mesh shape or geometry
    (another rank's manifest differs in ``_MESH_KEYS``), by a single-device
    engine for a multi-rank one, or the other way round, is refused by
    name: its extents hold other shards."""
    root = os.path.abspath(root)
    names = sorted(os.listdir(root)) if os.path.isdir(root) else []
    ranks = {}
    for name in names:
        path = os.path.join(root, name, TIER_MANIFEST)
        if name.startswith("rank") and os.path.isfile(path):
            with open(path) as fh:
                ranks[name] = json.load(fh)
    if manifest is None:
        if ranks:
            m = next(iter(ranks.values()))
            raise ValueError(
                f"kv_tier_dir {root} holds the per-rank extents of an engine over tp={m['tp']}, "
                f"pp={m['pp']}, sp={m['sp']}; a single-device engine cannot serve them"
            )
        return root
    if any(n.startswith("ext-") and n.endswith(".kv") for n in names):
        raise ValueError(
            f"kv_tier_dir {root} holds a single-device engine's extents (every head and layer); "
            f"an engine over tp={manifest['tp']}, pp={manifest['pp']}, sp={manifest['sp']} cannot "
            "serve them"
        )
    for name, m in ranks.items():
        theirs = {k: m.get(k) for k in _MESH_KEYS}
        ours = {k: manifest.get(k) for k in _MESH_KEYS}
        if theirs != ours:
            raise ValueError(
                f"kv_tier_dir {root} was written at another mesh shape or geometry ({name}: {theirs}); "
                f"this engine is {ours}"
            )
    sub = os.path.join(root, f"rank{manifest['rank']}")
    os.makedirs(sub, exist_ok=True)
    mine = ranks.get(f"rank{manifest['rank']}")
    if mine is not None and mine != manifest:
        raise ValueError(f"kv_tier_dir {sub} holds another shard ({mine}); this rank is {manifest}")
    if mine is None:
        tmp = os.path.join(sub, f"{TIER_MANIFEST}.tmp.{os.getpid()}")
        with open(tmp, "w") as fh:
            json.dump(manifest, fh, sort_keys=True)
        os.replace(tmp, os.path.join(sub, TIER_MANIFEST))
    return sub


def node_heat(node, now: float, half_life_s: float = NODE_HEAT_HALF_LIFE_S) -> float:
    """Exponentially decayed per-node heat: ``hit_count`` halved per
    ``half_life_s`` since the node's last touch."""
    age = max(0.0, now - node.last_access_time)
    return float(node.hit_count) * 0.5 ** (age / max(1e-9, half_life_s))


@dataclass(frozen=True)
class ExtentRef:
    """In-memory handle to one committed extent (what ``TreeNode.disk_value``
    holds). ``len()`` is the segment token count."""

    path: str  # absolute extent file path
    n_seg: int  # segment token count
    nbytes: int  # committed file size
    shard: int  # bounded subtree id for the move telemetry

    def __len__(self) -> int:
        return self.n_seg


@dataclass(frozen=True)
class ExtentMeta:
    """One verified extent from a boot-time :meth:`DiskKVTier.scan`."""

    ref: ExtentRef
    prefix_tokens: np.ndarray  # root→parent token path (may be empty)
    seg_tokens: np.ndarray  # this node's own key segment


def _shard_of(tokens: np.ndarray, page_size: int) -> int:
    head = np.ascontiguousarray(np.asarray(tokens[: max(1, page_size)], dtype="<i4"))
    if head.size == 0:
        return 0
    h = hashlib.blake2b(head.tobytes(), digest_size=8).digest()
    return int.from_bytes(h, "little") % _NUM_SHARDS


def _kv_bytes(kv: torch.Tensor) -> bytes:
    """The tensor's bytes in C order (its bit patterns: no float round trip)."""
    return kv.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()


class DiskKVTier:
    """The extent store: one instance per engine, one directory per node.
    The in-memory books (resident bytes, extent map, retire queue,
    counters) are lock-guarded; the file I/O methods
    (:meth:`write_extent`, :meth:`read_extent`, :meth:`scan`,
    :meth:`drain_retired`) run on the plane worker or a cold path."""

    def __init__(self, dir: str, *, capacity_bytes: int = 1 << 30, page_size: int = 1,
                 name: str = "tier"):
        self.dir = os.path.abspath(dir)
        os.makedirs(self.dir, exist_ok=True)
        self.capacity_bytes = int(capacity_bytes)
        self.page_size = max(1, int(page_size))
        self.log = get_logger("kvtier")
        self._lock = threading.Lock()
        # extent file path → ExtentRef (the live, committed set)
        self._extents: dict[str, ExtentRef] = {}
        self._resident_bytes = 0
        self._retired: deque[ExtentRef] = deque()
        # (monotonic t, shard, "demote"|"promote"|"drop") ring: the mesh
        # doctor's tier_thrash input when no history ring is attached.
        self.recent_moves: deque = deque(maxlen=4096)
        # The JAX package's radixmesh_kv_tier_* series, on the registry and
        # as plain counters for stats() (/stats).
        self.spilled_tokens = 0
        self.restored_tokens = 0
        self.bytes_written = 0
        self.bytes_read = 0
        self.io_seconds = {"write": 0.0, "read": 0.0}
        self.corrupt_by = {c: 0 for c in _CORRUPT_CAUSES}
        self.tier_moves = {"demote": 0, "promote": 0, "drop": 0}
        reg = get_registry()
        lbl = {"tier": name}
        self._m_spilled = reg.counter(
            "radixmesh_kv_tier_spilled_tokens_total",
            "tokens demoted host RAM -> disk extents (committed writes)",
            ("tier",),
        ).labels(**lbl)
        self._m_restored = reg.counter(
            "radixmesh_kv_tier_restored_tokens_total",
            "tokens read back from verified disk extents",
            ("tier",),
        ).labels(**lbl)
        nbytes = reg.counter(
            "radixmesh_kv_tier_bytes_total", "extent bytes moved, by direction", ("tier", "op")
        )
        self._m_bytes_rw = {op: nbytes.labels(op=op, **lbl) for op in ("write", "read")}
        corrupt = reg.counter(
            "radixmesh_kv_tier_corrupt_extents_total",
            "extents dropped instead of served: torn tails, checksum "
            "mismatches, future schemas, unreadable files",
            ("tier", "cause"),
        )
        self._m_corrupt_by = {c: corrupt.labels(cause=c, **lbl) for c in _CORRUPT_CAUSES}
        self._m_moves = reg.counter(
            "radixmesh_kv_tier_moves_total",
            "tier transitions by direction and subtree shard: demote = "
            "host->disk spill committed, promote = disk->HBM restore "
            "applied, drop = extent evicted for disk capacity",
            ("tier", "dir", "shard"),
        )
        self._m_moves_lbl = lbl
        self._m_resident = reg.gauge(
            "radixmesh_kv_tier_resident_bytes", "bytes held in committed extents", ("tier",)
        ).labels(**lbl)
        self._m_extents = reg.gauge(
            "radixmesh_kv_tier_extents", "committed extent files currently live", ("tier",)
        ).labels(**lbl)
        io = reg.histogram(
            "radixmesh_kv_tier_io_seconds",
            "one extent write (incl. fsync) or verified read",
            ("tier", "op"),
            buckets=TRANSFER_SECONDS_BUCKETS,
        )
        self._m_io_rw = {op: io.labels(op=op, **lbl) for op in ("write", "read")}

    # ------------------------------------------------------------------
    # bookkeeping
    # ------------------------------------------------------------------

    def _note_move(self, direction: str, shard: int) -> None:
        with self._lock:
            self.tier_moves[direction] += 1
            self.recent_moves.append((time.monotonic(), int(shard), direction))
        self._m_moves.labels(dir=direction, shard=str(int(shard)), **self._m_moves_lbl).inc()

    def _count_corrupt(self, cause: str) -> None:
        with self._lock:
            self.corrupt_by[cause] += 1
        self._m_corrupt_by[cause].inc()

    def _set_gauges(self) -> None:
        """Resident bytes and live extents onto the registry (hold
        ``_lock``)."""
        self._m_resident.set(self._resident_bytes)
        self._m_extents.set(len(self._extents))

    def note_promote(self, ref: ExtentRef) -> None:
        """Count one applied disk→pool restore (engine thread, at unit
        apply: in-memory accounting only)."""
        with self._lock:
            self.restored_tokens += ref.n_seg
        self._m_restored.inc(ref.n_seg)
        self._note_move("promote", ref.shard)

    def stats(self) -> dict:
        """The JAX tier's ``stats()`` keys, plus its counters."""
        with self._lock:
            return {
                "dir": self.dir,
                "extents": len(self._extents),
                "resident_bytes": self._resident_bytes,
                "capacity_bytes": self.capacity_bytes,
                "retire_queue": len(self._retired),
                "spilled_tokens": self.spilled_tokens,
                "restored_tokens": self.restored_tokens,
                "bytes_written": self.bytes_written,
                "bytes_read": self.bytes_read,
                "io_seconds": dict(self.io_seconds),
                "corrupt_extents": dict(self.corrupt_by),
                "moves": dict(self.tier_moves),
            }

    @property
    def extents(self) -> int:
        with self._lock:
            return len(self._extents)

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident_bytes

    # ------------------------------------------------------------------
    # extent encoding
    # ------------------------------------------------------------------

    @staticmethod
    def _encode(prefix_tokens, seg_tokens, kv: torch.Tensor, scales: torch.Tensor | None,
                page_size: int) -> bytes:
        if kv.dtype not in _KV_NAMES:
            raise ValueError(f"extent kv dtype {kv.dtype} is not supported")
        prefix = np.ascontiguousarray(prefix_tokens, dtype=np.int32)
        seg = np.ascontiguousarray(seg_tokens, dtype=np.int32)
        payload = prefix.tobytes() + seg.tobytes() + _kv_bytes(kv)
        if scales is not None:
            payload += _kv_bytes(scales.to(torch.float32))
        hdr = json.dumps(
            {
                "page_size": int(page_size),
                "n_prefix": int(len(prefix)),
                "n_seg": int(len(seg)),
                "kv_shape": list(kv.shape),
                "kv_dtype": _KV_NAMES[kv.dtype],
                "scales_shape": None if scales is None else list(scales.shape),
                "payload_crc": zlib.crc32(payload) & 0xFFFFFFFF,
                "payload_len": len(payload),
            },
            sort_keys=True,
        ).encode()
        pre = _PRE.pack(
            _MAGIC, EXTENT_SCHEMA_VERSION, 0, len(hdr), zlib.crc32(hdr) & 0xFFFFFFFF
        )
        return pre + hdr + payload

    @staticmethod
    def _decode(raw: bytes) -> tuple[dict, np.ndarray, np.ndarray, torch.Tensor, torch.Tensor | None]:
        """(header, prefix, seg, kv, scales), kv and scales as CPU torch
        tensors; raises ValueError naming a corruption cause ("truncated" /
        "checksum" / "schema")."""
        if len(raw) < _PRE.size:
            raise ValueError("truncated")
        magic, schema, _, hdr_len, hdr_crc = _PRE.unpack_from(raw, 0)
        if magic != _MAGIC or schema > EXTENT_SCHEMA_VERSION:
            raise ValueError("schema")  # refuse the future, never misread
        if len(raw) < _PRE.size + hdr_len:
            raise ValueError("truncated")
        hdr_b = raw[_PRE.size : _PRE.size + hdr_len]
        if (zlib.crc32(hdr_b) & 0xFFFFFFFF) != hdr_crc:
            raise ValueError("checksum")
        try:
            hdr = json.loads(hdr_b)
        except ValueError:
            raise ValueError("checksum") from None
        payload = raw[_PRE.size + hdr_len :]
        if len(payload) != int(hdr["payload_len"]):
            raise ValueError("truncated")
        if (zlib.crc32(payload) & 0xFFFFFFFF) != int(hdr["payload_crc"]):
            raise ValueError("checksum")
        if hdr["kv_dtype"] not in _KV_DTYPES:
            raise ValueError("schema")
        torch_dtype, np_dtype = _KV_DTYPES[hdr["kv_dtype"]]
        n_prefix, n_seg = int(hdr["n_prefix"]), int(hdr["n_seg"])
        off = 0
        prefix = np.frombuffer(payload, np.int32, n_prefix, off).copy()
        off += 4 * n_prefix
        seg = np.frombuffer(payload, np.int32, n_seg, off).copy()
        off += 4 * n_seg
        kv_shape = tuple(hdr["kv_shape"])
        kv_count = int(np.prod(kv_shape)) if kv_shape else 0
        bits = np.frombuffer(payload, np_dtype, kv_count, off).reshape(kv_shape).copy()
        kv = torch.from_numpy(bits).view(torch_dtype)
        off += kv_count * np.dtype(np_dtype).itemsize
        scales = None
        if hdr.get("scales_shape") is not None:
            s_shape = tuple(hdr["scales_shape"])
            scales = torch.from_numpy(
                np.frombuffer(payload, np.float32, int(np.prod(s_shape)), off)
                .reshape(s_shape)
                .copy()
            )
        return hdr, prefix, seg, kv, scales

    # ------------------------------------------------------------------
    # write path (plane worker)
    # ------------------------------------------------------------------

    @staticmethod
    def _path_name(prefix_tokens, seg_tokens) -> str:
        """Extent file name, keyed on the FULL root→node token path: a
        re-spill of the same path replaces the stale extent atomically."""
        full = np.concatenate([
            np.asarray(prefix_tokens, dtype=np.int32),
            np.asarray(seg_tokens, dtype=np.int32),
        ])
        return f"ext-{hashlib.blake2b(full.tobytes(), digest_size=12).hexdigest()}.kv"

    def write_extent(self, prefix_tokens, seg_tokens, kv: torch.Tensor,
                     scales: torch.Tensor | None) -> ExtentRef | None:
        """Commit one extent (PLANE WORKER: blocking write + fsync). ``kv``
        is ``[2, L, n, H, D]`` in the pool's stored dtype, ``scales`` ``[2,
        L, n, H]`` or None. Returns None on an I/O failure: the caller
        degrades (the node stays volatile)."""
        t0 = time.monotonic()
        data = self._encode(prefix_tokens, seg_tokens, kv, scales, self.page_size)
        path = os.path.join(self.dir, self._path_name(prefix_tokens, seg_tokens))
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as fh:
                fh.write(data)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)  # the commit point
        except OSError:
            self.log.exception("extent write failed (%s)", path)
            self._count_corrupt("io")
            try:
                os.remove(tmp)
            except OSError:
                pass
            return None
        shard = _shard_of(prefix_tokens if len(prefix_tokens) else seg_tokens, self.page_size)
        ref = ExtentRef(path=path, n_seg=int(len(seg_tokens)), nbytes=len(data), shard=shard)
        with self._lock:
            replaced = self._extents.get(path)
            self._extents[path] = ref
            self._resident_bytes += len(data) - (replaced.nbytes if replaced else 0)
            self.spilled_tokens += ref.n_seg
            self.bytes_written += len(data)
            dur = time.monotonic() - t0
            self.io_seconds["write"] += dur
            self._set_gauges()
        self._m_spilled.inc(ref.n_seg)
        self._m_bytes_rw["write"].inc(len(data))
        self._m_io_rw["write"].observe(dur)
        self._note_move("demote", shard)
        self._enforce_capacity(protect=path)
        return ref

    def _enforce_capacity(self, protect: str | None = None) -> None:
        """Drop the oldest extents (by mtime) until under capacity (PLANE
        WORKER): one locked snapshot, one stat per victim, one sort. A
        dropped extent leaves its in-tree ref dangling: the next restore of
        that node fails verification by absence and degrades to a
        recompute."""
        with self._lock:
            excess = self._resident_bytes - self.capacity_bytes
            if excess <= 0:
                return
            victims = [r for p, r in self._extents.items() if p != protect]
        victims.sort(key=lambda r: os.path.getmtime(r.path) if os.path.exists(r.path) else 0.0)
        for victim in victims:
            if excess <= 0:
                return
            if self.has(victim):  # identity: skip since-replaced paths
                excess -= victim.nbytes
                self._unlink(victim)
                self._note_move("drop", victim.shard)

    def has(self, ref: ExtentRef) -> bool:
        """True while THIS ref is the live extent at its path (identity,
        not path equality: a re-spill replaces the mapping)."""
        with self._lock:
            return self._extents.get(ref.path) is ref

    def _unlink(self, ref: ExtentRef) -> None:
        """Remove ``ref``'s file and books, identity-guarded: a stale ref
        (its path since re-committed) must not delete the live extent."""
        with self._lock:
            if self._extents.get(ref.path) is not ref:
                return
            self._extents.pop(ref.path, None)
            self._resident_bytes -= ref.nbytes
            self._set_gauges()
        try:
            os.remove(ref.path)
        except OSError:
            pass

    # ------------------------------------------------------------------
    # read path (plane worker)
    # ------------------------------------------------------------------

    def read_extent(self, ref: ExtentRef) -> tuple[torch.Tensor, torch.Tensor | None] | None:
        """Read and VERIFY one extent (PLANE WORKER). Returns ``(kv,
        scales)`` as CPU tensors, or None when the extent is missing, torn
        or corrupt: the corrupt file is unlinked and counted, and the
        caller degrades to a shorter hit (never serves the bytes)."""
        t0 = time.monotonic()
        try:
            with open(ref.path, "rb") as fh:
                raw = fh.read()
        except OSError:
            self._count_corrupt("io")
            self._forget(ref)
            return None
        try:
            _, _, _, kv, scales = self._decode(raw)
        except ValueError as e:
            cause = str(e) if str(e) in self.corrupt_by else "checksum"
            self.log.warning(
                "dropping corrupt extent %s (%s): degrading to a shorter verified prefix",
                os.path.basename(ref.path), cause,
            )
            self._count_corrupt(cause)
            self._unlink(ref)
            return None
        if kv.shape[2] != ref.n_seg:
            self._count_corrupt("schema")
            self._unlink(ref)
            return None
        dur = time.monotonic() - t0
        with self._lock:
            self.bytes_read += len(raw)
            self.io_seconds["read"] += dur
        self._m_bytes_rw["read"].inc(len(raw))
        self._m_io_rw["read"].observe(dur)
        return kv, scales

    def _forget(self, ref: ExtentRef) -> None:
        with self._lock:
            if self._extents.get(ref.path) is ref:
                self._extents.pop(ref.path, None)
                self._resident_bytes -= ref.nbytes
                self._set_gauges()

    # ------------------------------------------------------------------
    # retire queue (engine thread enqueues; worker unlinks)
    # ------------------------------------------------------------------

    def retire(self, ref) -> None:
        """Queue an extent for deletion (ANY thread: an in-memory append;
        the file dies at the worker's next :meth:`drain_retired`).
        Undeleted retirees after a crash re-graft at the next boot:
        stale-but-valid data."""
        if isinstance(ref, ExtentRef):
            with self._lock:
                self._retired.append(ref)

    def drain_retired(self) -> int:
        """Unlink every queued retiree (PLANE WORKER / cold paths)."""
        n = 0
        while True:
            with self._lock:
                if not self._retired:
                    return n
                ref = self._retired.popleft()
            self._unlink(ref)
            n += 1

    # ------------------------------------------------------------------
    # boot-time scan (cold path)
    # ------------------------------------------------------------------

    def scan(self) -> list[ExtentMeta]:
        """Verify every extent in the directory (COLD PATH: boot). Corrupt
        and torn extents are dropped and counted; leftover temp files (a
        kill mid-write) are removed. Returns verified metas sorted
        shallow-first, so grafting parents precedes children."""
        metas: list[ExtentMeta] = []
        for name in sorted(os.listdir(self.dir)):
            full = os.path.join(self.dir, name)
            if ".tmp." in name:
                # An uncommitted write the crash interrupted: nothing
                # references it.
                try:
                    os.remove(full)
                except OSError:
                    pass
                continue
            if not (name.startswith("ext-") and name.endswith(".kv")):
                continue
            try:
                with open(full, "rb") as fh:
                    raw = fh.read()
            except OSError:
                self._count_corrupt("io")
                continue
            try:
                hdr, prefix, seg, _, _ = self._decode(raw)
            except ValueError as e:
                cause = str(e) if str(e) in self.corrupt_by else "checksum"
                self.log.warning("scan: dropping corrupt extent %s (%s)", name, cause)
                self._count_corrupt(cause)
                try:
                    os.remove(full)
                except OSError:
                    pass
                continue
            if int(hdr["page_size"]) != self.page_size:
                # Another paging regime's extents cannot graft into this
                # tree: refuse rather than misalign.
                self._count_corrupt("schema")
                continue
            shard = _shard_of(prefix if len(prefix) else seg, self.page_size)
            ref = ExtentRef(path=full, n_seg=int(len(seg)), nbytes=len(raw), shard=shard)
            with self._lock:
                if full not in self._extents:
                    self._extents[full] = ref
                    self._resident_bytes += ref.nbytes
                    self._set_gauges()
            metas.append(ExtentMeta(ref=ref, prefix_tokens=prefix, seg_tokens=seg))
        metas.sort(key=lambda m: len(m.prefix_tokens) + len(m.seg_tokens))
        return metas
