"""Anti-entropy repair plane: fingerprint-driven replica self-healing.

RadixMesh replication is best-effort: a transmit failure or a full
outbound queue silently drops the oplog frame (``mesh_cache.py``
``_sender_loop`` / ``_send_bytes``), so a partition or a slow successor
leaves replicas *permanently* diverged until unrelated traffic happens
to re-insert the same prefix. The fleet plane (``obs/fleet_plane.py``)
can **detect** that divergence — gossiped tree fingerprints disagree —
but nothing could **repair** it. This module closes the loop,
Dynamo-style (DeCandia et al. 2007 §4.7: Merkle-tree anti-entropy
between replicas), scaled to this tree's needs:

1. **Localize.** The radix tree maintains a fixed 64-bucket fingerprint
   vector next to its scalar fingerprint (``radix_tree.FP_BUCKETS``):
   each token-position contribution XORs into bucket
   ``splitmix64(chain_hash) mod 64``. Still insert-order-independent
   and split-invariant; ≤ 512 B on the wire.
2. **Probe.** A node whose scan observes a *stale* divergence with a
   peer (its own fingerprint vs the peer's gossiped digest, older than
   ``age_threshold_s`` — or immediately after a local data-frame drop
   armed an early probe) sends a ``REPAIR_PROBE`` carrying its bucket
   vector over a dedicated point-to-point channel (the PREFETCH
   router-channel pattern — repair traffic never rides the ring).
3. **Summarize.** The peer answers ``REPAIR_SUMMARY``: its own vector,
   the (budget-capped) diverged bucket ids, and 64-bit path hashes of
   its entries touching those buckets. The initiator replies with the
   same summary shape so both sides learn the one-sided set.
4. **Re-replicate.** Each side re-broadcasts its one-sided entries as
   ORDINARY idempotent ``INSERT`` oplogs on the ring — through the
   existing rank conflict-resolution path, reaching every replica
   (router included, via master fan-out), so one session heals the
   whole fleet, not just the probed pair. Routers hold no indices and
   never send on the ring, so they only *pull* (probe + summarize);
   their one-sided extras are tolerated (cache semantics) and age out.

Storm-control invariants (lint + tests pin these):

- **Rate-limited**: at most one in-flight session per peer, with
  exponential backoff + jitter between rounds against the same peer.
- **Bounded**: per-session bucket budget and key (re-publication)
  budget; a pathological divergence heals over several rounds instead
  of flooding the ring in one.
- **Quiescent**: a probe is sent only while the peer's gossiped
  fingerprint disagrees with ours — once converged, repair traffic is
  exactly zero (the chaos acceptance scenario asserts this).
- **Convergent-by-construction**: repair introduces no new apply
  semantics. Every mutation lands via the same idempotent
  ``_mesh_insert`` path as live replication, so repair can never
  produce a state live traffic couldn't.

DELETE loss heals by *resurrection*: the side that kept the entry
re-replicates it (fingerprints converge on the union). True deletion
propagation would need tombstones, which nothing downstream requires —
a resurrected cache entry costs a replica one extra hit, not
correctness (``mesh_cache.py`` consistency model).
"""

from __future__ import annotations

import struct
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np

from radixmesh_tpu_torch.cache.oplog import DATA_KINDS, Oplog, OplogType
from radixmesh_tpu_torch.cache.radix_tree import FP_BUCKETS
from radixmesh_tpu_torch.cache.sharding import _to_i32
from radixmesh_tpu_torch.obs.metrics import REPAIR_SECONDS_BUCKETS, get_registry
from radixmesh_tpu_torch.obs.trace_plane import get_recorder
from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = [
    "RepairConfig",
    "RepairPlane",
    "encode_probe",
    "decode_probe",
    "encode_summary",
    "decode_summary",
    "is_shard_frame",
    "encode_shard_probe",
    "decode_shard_probe",
    "encode_shard_session_summary",
    "decode_shard_session_summary",
]

_FP_MASK = (1 << 64) - 1


@dataclass
class RepairConfig:
    """Session pacing + storm-control bounds. Defaults suit a production
    cadence; tests/benches shrink the timers."""

    # Scan cadence: how often the plane compares its fingerprint against
    # the fleet view's gossiped digests.
    interval_s: float = 1.0
    # A divergence must persist this long before a probe fires (live
    # replication usually converges within a gossip interval or two; a
    # probe for every transient disagreement would storm the ring).
    age_threshold_s: float = 10.0
    # After a LOCAL data-frame drop the threshold is waived for this
    # long — the node KNOWS it diverged someone downstream, so waiting
    # for the staleness clock just delays the heal.
    early_probe_window_s: float = 30.0
    # Per-session bounds: buckets summarized per probe, entries
    # re-replicated per summary. A wider divergence heals over several
    # backed-off rounds.
    bucket_budget: int = 16
    key_budget: int = 256
    # Exponential backoff between rounds against one peer, with
    # multiplicative jitter so a fleet-wide event doesn't synchronize
    # every node's round schedule.
    backoff_base_s: float = 2.0
    backoff_max_s: float = 60.0
    jitter_frac: float = 0.25
    # Accounting bound: the bench/acceptance scenario asserts an episode
    # (divergence detected → converged) heals within this many rounds.
    round_budget: int = 8
    # Warm-join bulk sessions (policy/lifecycle.py): a BOOTSTRAPPING
    # peer is trying to ingest a WHOLE replica, not heal a few dropped
    # frames — so bootstrap sessions summarize every bucket and push an
    # order of magnitude more entries per round, over the dedicated
    # bootstrap channel (MeshCache._bootstrap_comms). Steady-state
    # sessions keep the tight budgets above.
    bootstrap_bucket_budget: int = FP_BUCKETS
    bootstrap_key_budget: int = 2048


# ---------------------------------------------------------------------------
# wire payloads (ride Oplog.value as int32 arrays, like NodeDigest)
# ---------------------------------------------------------------------------

_MAGIC = 0xAE
_VERSION = 1
_PROBE_HDR = struct.Struct("<BBBB")  # magic, version, flags, pad
_SUMMARY_HDR = struct.Struct("<BBBBii")  # magic, version, flags, pad, n_buckets, n_hashes
_FLAG_REPLY = 1
# Owner-scoped (sharded) session frames (cache/sharding.py): the
# whole-tree bucket vector is meaningless when replicas legitimately
# hold different shards, so sharded sessions carry (shard id,
# fingerprint) pairs instead, and summaries list path hashes for the
# diverged SHARDS rather than buckets. Same magic/version/flag byte —
# decoders branch on this bit.
_FLAG_SHARD = 2
_SHARD_PAIR = struct.Struct("<iQ")  # shard id, fingerprint


def encode_probe(vec: np.ndarray) -> np.ndarray:
    """Bucket vector → ``Oplog.value`` payload (≤ 4 + 512 B)."""
    vec = np.ascontiguousarray(vec, dtype="<u8")
    if len(vec) != FP_BUCKETS:
        raise ValueError(f"bucket vector must have {FP_BUCKETS} entries")
    return _to_i32(_PROBE_HDR.pack(_MAGIC, _VERSION, 0, 0) + vec.tobytes())


def decode_probe(arr: np.ndarray) -> np.ndarray:
    raw = np.ascontiguousarray(np.asarray(arr, dtype=np.int32)).tobytes()
    if len(raw) < _PROBE_HDR.size + 8 * FP_BUCKETS:
        raise ValueError(f"probe payload too short ({len(raw)} bytes)")
    magic, version, _, _ = _PROBE_HDR.unpack_from(raw, 0)
    if magic != _MAGIC:
        raise ValueError(f"bad repair magic {magic:#x}")
    if version != _VERSION:
        raise ValueError(f"unsupported repair version {version}")
    return np.frombuffer(
        raw, dtype="<u8", count=FP_BUCKETS, offset=_PROBE_HDR.size
    ).copy()


def encode_summary(
    vec: np.ndarray,
    buckets,
    hashes,
    reply: bool,
) -> np.ndarray:
    """Responder's vector + diverged bucket ids + path hashes of its
    entries touching them. ``reply`` marks the initiator's answering
    summary, which must NOT be answered again (loop guard)."""
    vec = np.ascontiguousarray(vec, dtype="<u8")
    if len(vec) != FP_BUCKETS:
        raise ValueError(f"bucket vector must have {FP_BUCKETS} entries")
    b = np.asarray(sorted(int(x) for x in buckets), dtype=np.int32)
    h = np.asarray(sorted(int(x) & _FP_MASK for x in hashes), dtype="<u8")
    raw = (
        _SUMMARY_HDR.pack(
            _MAGIC, _VERSION, _FLAG_REPLY if reply else 0, 0, len(b), len(h)
        )
        + b.tobytes()
        + vec.tobytes()
        + h.tobytes()
    )
    return _to_i32(raw)


def decode_summary(arr: np.ndarray) -> tuple[np.ndarray, list[int], set[int], bool]:
    """→ (vector, bucket ids, path-hash set, is_reply)."""
    raw = np.ascontiguousarray(np.asarray(arr, dtype=np.int32)).tobytes()
    if len(raw) < _SUMMARY_HDR.size:
        raise ValueError(f"summary payload too short ({len(raw)} bytes)")
    magic, version, flags, _, n_b, n_h = _SUMMARY_HDR.unpack_from(raw, 0)
    if magic != _MAGIC:
        raise ValueError(f"bad repair magic {magic:#x}")
    if version != _VERSION:
        raise ValueError(f"unsupported repair version {version}")
    off = _SUMMARY_HDR.size
    need = off + 4 * n_b + 8 * FP_BUCKETS + 8 * n_h
    if len(raw) < need:
        raise ValueError(
            f"summary payload truncated ({len(raw)} < {need} bytes)"
        )
    buckets = np.frombuffer(raw, dtype=np.int32, count=n_b, offset=off)
    off += 4 * n_b
    vec = np.frombuffer(raw, dtype="<u8", count=FP_BUCKETS, offset=off).copy()
    off += 8 * FP_BUCKETS
    hashes = np.frombuffer(raw, dtype="<u8", count=n_h, offset=off)
    return vec, [int(x) for x in buckets], {int(x) for x in hashes}, bool(
        flags & _FLAG_REPLY
    )


def is_shard_frame(arr: np.ndarray) -> bool:
    """True when a repair payload is an owner-scoped (sharded) frame."""
    raw = np.ascontiguousarray(np.asarray(arr, dtype=np.int32)).tobytes()
    return (
        len(raw) >= _PROBE_HDR.size
        and raw[0] == _MAGIC
        and bool(raw[2] & _FLAG_SHARD)
    )


def encode_shard_probe(pairs) -> np.ndarray:
    """Owner-scoped probe: the initiator's (shard id, fingerprint) for
    the shards it sees diverged with the peer (≤ bucket budget)."""
    pairs = sorted((int(s), int(f) & _FP_MASK) for s, f in pairs)
    raw = _PROBE_HDR.pack(_MAGIC, _VERSION, _FLAG_SHARD, 0)
    raw += struct.pack("<I", len(pairs))
    for sid, fp in pairs:
        raw += _SHARD_PAIR.pack(sid, fp)
    return _to_i32(raw)


def decode_shard_probe(arr: np.ndarray) -> list[tuple[int, int]]:
    raw = np.ascontiguousarray(np.asarray(arr, dtype=np.int32)).tobytes()
    if len(raw) < _PROBE_HDR.size + 4:
        raise ValueError(f"shard probe too short ({len(raw)} bytes)")
    magic, version, flags, _ = _PROBE_HDR.unpack_from(raw, 0)
    if magic != _MAGIC or not flags & _FLAG_SHARD:
        raise ValueError("not a shard-scoped repair probe")
    if version != _VERSION:
        raise ValueError(f"unsupported repair version {version}")
    (n,) = struct.unpack_from("<I", raw, _PROBE_HDR.size)
    off = _PROBE_HDR.size + 4
    if len(raw) < off + n * _SHARD_PAIR.size:
        raise ValueError("shard probe truncated")
    out = []
    for _ in range(n):
        sid, fp = _SHARD_PAIR.unpack_from(raw, off)
        off += _SHARD_PAIR.size
        out.append((sid, fp))
    return out


def encode_shard_session_summary(pairs, hashes, reply: bool) -> np.ndarray:
    """Owner-scoped summary: the responder's (shard id, fingerprint)
    for the session's diverged shards + path hashes of its entries in
    them (the exclude set for the peer's push)."""
    pairs = sorted((int(s), int(f) & _FP_MASK) for s, f in pairs)
    h = np.asarray(sorted(int(x) & _FP_MASK for x in hashes), dtype="<u8")
    raw = _SUMMARY_HDR.pack(
        _MAGIC, _VERSION,
        _FLAG_SHARD | (_FLAG_REPLY if reply else 0), 0,
        len(pairs), len(h),
    )
    for sid, fp in pairs:
        raw += _SHARD_PAIR.pack(sid, fp)
    raw += h.tobytes()
    return _to_i32(raw)


def decode_shard_session_summary(
    arr: np.ndarray,
) -> tuple[list[tuple[int, int]], set[int], bool]:
    """→ ((shard id, fingerprint) pairs, path-hash set, is_reply)."""
    raw = np.ascontiguousarray(np.asarray(arr, dtype=np.int32)).tobytes()
    if len(raw) < _SUMMARY_HDR.size:
        raise ValueError(f"shard summary too short ({len(raw)} bytes)")
    magic, version, flags, _, n_p, n_h = _SUMMARY_HDR.unpack_from(raw, 0)
    if magic != _MAGIC or not flags & _FLAG_SHARD:
        raise ValueError("not a shard-scoped repair summary")
    if version != _VERSION:
        raise ValueError(f"unsupported repair version {version}")
    off = _SUMMARY_HDR.size
    need = off + n_p * _SHARD_PAIR.size + 8 * n_h
    if len(raw) < need:
        raise ValueError(f"shard summary truncated ({len(raw)} < {need})")
    pairs = []
    for _ in range(n_p):
        sid, fp = _SHARD_PAIR.unpack_from(raw, off)
        off += _SHARD_PAIR.size
        pairs.append((sid, fp))
    hashes = np.frombuffer(raw, dtype="<u8", count=n_h, offset=off)
    return pairs, {int(x) for x in hashes}, bool(flags & _FLAG_REPLY)


# ---------------------------------------------------------------------------
# the per-node repair loop
# ---------------------------------------------------------------------------


class RepairPlane:
    """One per node (every role — routers probe too; they just never
    push). Receive handlers run on the mesh transport reader thread and
    only ENQUEUE; all tree enumeration, payload assembly, and channel
    sends happen on this plane's worker thread."""

    def __init__(self, mesh, cfg: RepairConfig | None = None, seed: int = 0):
        self.mesh = mesh
        self.cfg = cfg or RepairConfig()
        self.log = get_logger(f"repair.{mesh._node_label}")
        self._rng = np.random.default_rng(seed ^ (mesh.rank << 16))
        # Inbound REPAIR frames, appended under the mesh lock by the
        # reader thread; bounded — repair is best-effort, an overflowing
        # inbox just means another probe round later.
        self._inbox: deque = deque(maxlen=256)
        self._evt = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # rank → {"since": first-diverged mono, "next_probe_at": mono,
        #         "backoff_s": float, "rounds": int, "probe_sent_at": mono}
        self._peers: dict[int, dict] = {}
        self._early_until = 0.0  # waive age threshold until this instant
        # Episode accounting for the chaos artifact: rounds it took each
        # healed divergence episode, worst case retained.
        self.max_episode_rounds = 0
        self.heals = 0

        reg = get_registry()
        node = mesh._node_label
        self._m_probes_sent = reg.counter(
            "radixmesh_repair_probes_sent_total",
            "anti-entropy repair probes originated by this node",
            ("node",),
        ).labels(node=node)
        self._m_probes_rcvd = reg.counter(
            "radixmesh_repair_probes_received_total",
            "repair probes answered by this node",
            ("node",),
        ).labels(node=node)
        self._m_summaries = reg.counter(
            "radixmesh_repair_summaries_sent_total",
            "repair summaries (bucket diffs + key hashes) sent",
            ("node",),
        ).labels(node=node)
        self._m_keys = reg.counter(
            "radixmesh_repair_keys_pushed_total",
            "one-sided entries re-replicated on the ring by repair",
            ("node",),
        ).labels(node=node)
        self._m_oplogs = reg.counter(
            "radixmesh_repair_oplogs_reemitted_total",
            "ordinary INSERT oplogs re-broadcast by repair pushes",
            ("node",),
        ).labels(node=node)
        self._m_rounds = reg.counter(
            "radixmesh_repair_rounds_total",
            "completed repair rounds (probe answered by a summary)",
            ("node",),
        ).labels(node=node)
        self._m_heals = reg.counter(
            "radixmesh_repair_heals_total",
            "divergence episodes that ended converged",
            ("node",),
        ).labels(node=node)
        self._m_round_s = reg.histogram(
            "radixmesh_repair_round_seconds",
            "probe → answering summary latency per repair round",
            ("node",),
            buckets=REPAIR_SECONDS_BUCKETS,
        ).labels(node=node)

        # Wire into the mesh: REPAIR frames + dropped-frame early probes.
        mesh.on_repair = self.note_frame
        mesh.on_oplog_dropped = self.note_loss

    # -- mesh-side hooks (MUST stay cheap: reader thread / under lock) --

    def note_frame(self, op: Oplog) -> None:
        self._inbox.append(op)
        self._evt.set()

    def note_loss(self, cause: str, kind: int) -> None:
        """A locally-originated/forwarded frame was dropped. Data-kind
        losses arm an early probe: downstream replicas are now known-
        diverged, so the staleness threshold is waived for a window."""
        if kind in _DATA_KIND_INTS:
            self._early_until = (
                time.monotonic() + self.cfg.early_probe_window_s
            )
            self._evt.set()

    # -- lifecycle ------------------------------------------------------

    def start(self) -> "RepairPlane":
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="repair-plane"
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        self._evt.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        # Detach the mesh hooks so a closed plane can't be re-entered.
        if self.mesh.on_repair is self.note_frame:
            self.mesh.on_repair = None
        if self.mesh.on_oplog_dropped is self.note_loss:
            self.mesh.on_oplog_dropped = None

    def _run(self) -> None:
        while not self._stop.is_set():
            self._evt.wait(timeout=self.cfg.interval_s)
            self._evt.clear()
            if self._stop.is_set():
                return
            try:
                while self._inbox:
                    self._handle(self._inbox.popleft())
                self.scan_once()
            except Exception:  # noqa: BLE001 — repair must not kill the node
                self.log.exception("repair pass failed")

    # -- scan: detect stale divergence, originate probes ----------------

    def scan_once(self) -> int:
        """One detector pass (tests drive this directly; the thread calls
        it on its timer). Returns the number of probes sent.

        Full replica: compare scalar tree fingerprints (any pair of
        replicas must converge). Sharded (``mesh.sharded``): whole-tree
        fingerprints diverge BY DESIGN, so the pass compares per-shard
        fingerprints between CO-OWNERS only (``diverged_shards_with``),
        and probes are shard-scoped. Storm control (staleness threshold,
        per-peer backoff, budgets, probe-only-while-diverged) is shared
        by both modes."""
        mesh = self.mesh
        now = time.monotonic()
        sharded = bool(getattr(mesh, "sharded", False))
        if sharded:
            # Reporters of shard summaries are the comparable peer set
            # (a peer that never summarized cannot be audited yet).
            fps = mesh.fleet.shard_fingerprints()
            my_fp = 0  # unused in sharded mode
        else:
            my_fp = mesh.tree.fingerprint_ & _FP_MASK
            fps = mesh.fleet.fingerprints()
        # Forget peers that left the fleet view (decommissioned or
        # retained-out); a rejoiner starts a fresh episode.
        for rank in [r for r in self._peers if r not in fps]:
            del self._peers[rank]
        probes = 0
        for rank, fp in fps.items():
            if rank == mesh.rank:
                continue
            if sharded:
                diverged_sids = mesh.diverged_shards_with(rank)
                converged = not diverged_sids
            else:
                diverged_sids = []
                converged = (fp & _FP_MASK) == my_fp
            if converged:
                st = self._peers.pop(rank, None)
                if st is not None:
                    # Episode healed: record how many rounds it took.
                    self.heals += 1
                    self._m_heals.inc()
                    self.max_episode_rounds = max(
                        self.max_episode_rounds, st.get("rounds", 0)
                    )
                continue
            st = self._peers.setdefault(
                rank,
                {
                    "since": now,
                    "next_probe_at": 0.0,
                    "backoff_s": self.cfg.backoff_base_s,
                    "rounds": 0,
                    "probe_sent_at": 0.0,
                },
            )
            age = now - st["since"]
            threshold = (
                0.0 if now < self._early_until else self.cfg.age_threshold_s
            )
            if age < threshold or now < st["next_probe_at"]:
                continue
            sent = (
                self._send_shard_probe(rank, diverged_sids)
                if sharded
                else self._send_probe(rank)
            )
            if sent:
                probes += 1
                st["probe_sent_at"] = now
                st["rounds"] += 1
                # Exponential backoff + jitter before the NEXT round
                # against this peer (storm control).
                jitter = 1.0 + self.cfg.jitter_frac * float(self._rng.random())
                st["next_probe_at"] = now + st["backoff_s"] * jitter
                st["backoff_s"] = min(
                    st["backoff_s"] * 2.0, self.cfg.backoff_max_s
                )
        return probes

    def _send_probe(self, rank: int, bootstrap: bool = False) -> bool:
        with self.mesh._lock:
            vec = self.mesh.tree.fingerprint_buckets()
        ok = self.mesh.send_repair(
            rank, OplogType.REPAIR_PROBE, encode_probe(vec),
            bootstrap=bootstrap,
        )
        if ok:
            self._m_probes_sent.inc()
        return ok

    def _send_shard_probe(
        self, rank: int, sids, bootstrap: bool = False
    ) -> bool:
        """Owner-scoped probe: my (shard, fingerprint) pairs for the
        shards I see diverged with ``rank`` (≤ bucket budget — a wide
        divergence heals over several backed-off rounds)."""
        budget = (
            self.cfg.bootstrap_bucket_budget if bootstrap
            else self.cfg.bucket_budget
        )
        sids = list(sids)[:budget]
        if not sids:
            return False
        with self.mesh._lock:
            mine = self.mesh.tree.shard_fingerprints()
        pairs = [(sid, mine.get(sid, 0)) for sid in sids]
        ok = self.mesh.send_repair(
            rank, OplogType.REPAIR_PROBE, encode_shard_probe(pairs),
            bootstrap=bootstrap,
        )
        if ok:
            self._m_probes_sent.inc()
        return ok

    def bootstrap_probe(self, rank: int) -> bool:
        """One warm-join bulk-session round against donor ``rank``
        (driven by the lifecycle plane's bootstrap pacing — no age
        threshold, no backoff: the joiner KNOWS it is cold). Raised
        budgets apply on both sides: this side marks the peer state
        bootstrap; the donor recognizes the joiner's gossiped
        BOOTSTRAPPING lifecycle. Frames ride the dedicated bootstrap
        channel so bulk traffic never queues behind steady-state
        repair."""
        st = self._peers.setdefault(
            rank,
            {
                "since": time.monotonic(),
                "next_probe_at": 0.0,
                "backoff_s": self.cfg.backoff_base_s,
                "rounds": 0,
                "probe_sent_at": 0.0,
            },
        )
        st["bootstrap"] = True
        mesh = self.mesh
        if getattr(mesh, "sharded", False):
            # Owner-scoped bootstrap: probe the donor for every shard we
            # BOTH own (the joiner bootstraps only ITS shards — the
            # whole point of sharded membership). Shards the donor does
            # not co-own are pulled from their own owners by the
            # steady-state sharded scan.
            own = mesh.ownership
            sids = [
                sid for sid in own.owned_shards(mesh.rank)
                if own.is_owner(rank, sid)
            ] if own is not None else []
            sent = self._send_shard_probe(rank, sids, bootstrap=True)
        else:
            sent = self._send_probe(rank, bootstrap=True)
        if sent:
            now = time.monotonic()
            st["probe_sent_at"] = now
            st["rounds"] += 1
            # Hold the regular scan off this peer for a backoff window:
            # the lifecycle plane owns bootstrap pacing, and a scan-path
            # probe racing it would just double the round count.
            st["next_probe_at"] = now + self.cfg.backoff_base_s
            return True
        return False

    def _is_bootstrap_session(self, rank: int) -> bool:
        """True when the session with ``rank`` should use bulk budgets:
        either WE are bootstrapping from it (peer state marked by
        ``bootstrap_probe``) or IT gossips a BOOTSTRAPPING lifecycle (we
        are its donor). Gossip lag degrades this to an ordinary
        steady-state session — slower, never wrong."""
        st = self._peers.get(rank)
        if st is not None and st.get("bootstrap"):
            return True
        try:
            return self.mesh.fleet.lifecycle_of(rank) == "bootstrapping"
        except Exception:  # noqa: BLE001 — telemetry must not break repair
            return False

    # -- inbound session handling (worker thread) -----------------------

    def _handle(self, op: Oplog) -> None:
        if op.op_type is OplogType.REPAIR_PROBE:
            self._handle_probe(op)
        elif op.op_type is OplogType.REPAIR_SUMMARY:
            self._handle_summary(op)

    def _diff_buckets(
        self, mine: np.ndarray, theirs: np.ndarray, budget: int | None = None
    ) -> list[int]:
        diff = [int(i) for i in np.nonzero(mine != theirs)[0]]
        return diff[: self.cfg.bucket_budget if budget is None else budget]

    def _summary_for(self, buckets) -> tuple[np.ndarray, list[int]]:
        """(my bucket vector, path hashes of my entries touching
        ``buckets``) — one mesh-lock hold."""
        mesh = self.mesh
        with mesh._lock:
            vec = mesh.tree.fingerprint_buckets()
            hashes = [
                mesh.tree.path_hash(n)
                for n in mesh.tree.nodes_touching_buckets(buckets)
            ]
        return vec, hashes

    def _handle_probe(self, op: Oplog) -> None:
        self._m_probes_rcvd.inc()
        if is_shard_frame(op.value):
            self._handle_shard_probe(op)
            return
        try:
            their_vec = decode_probe(op.value)
        except ValueError:
            self.log.warning("malformed repair probe from rank %d", op.origin_rank)
            return
        # Bulk budgets + dedicated channel when the peer is a warm-join
        # bootstrapper (this node is its donor) — see RepairConfig.
        bootstrap = self._is_bootstrap_session(op.origin_rank)
        bucket_budget = (
            self.cfg.bootstrap_bucket_budget if bootstrap else None
        )
        # One lock hold for vector + diff + summaries; a converged-probe
        # race (empty diff — the steady-state case) costs O(buckets),
        # never a tree walk, and still answers so the initiator's round
        # completes cleanly.
        mesh = self.mesh
        with mesh._lock:
            vec = mesh.tree.fingerprint_buckets()
            buckets = self._diff_buckets(vec, their_vec, budget=bucket_budget)
            hashes = [
                mesh.tree.path_hash(n)
                for n in mesh.tree.nodes_touching_buckets(buckets)
            ]
        if mesh.send_repair(
            op.origin_rank,
            OplogType.REPAIR_SUMMARY,
            encode_summary(vec, buckets, hashes, reply=False),
            bootstrap=bootstrap,
        ):
            self._m_summaries.inc()

    def _handle_shard_probe(self, op: Oplog) -> None:
        """Owner-scoped probe answer: for every probed shard whose
        fingerprint disagrees with ours, summarize our entries (path
        hashes) so the initiator can push its one-sided set — and
        include our per-shard fingerprints so it can diff symmetrically."""
        try:
            pairs = decode_shard_probe(op.value)
        except ValueError:
            self.log.warning(
                "malformed shard probe from rank %d", op.origin_rank
            )
            return
        bootstrap = self._is_bootstrap_session(op.origin_rank)
        mesh = self.mesh
        with mesh._lock:
            mine = mesh.tree.shard_fingerprints()
            diverged = [
                sid for sid, fp in pairs
                if (mine.get(sid, 0) & _FP_MASK) != (fp & _FP_MASK)
            ]
            my_pairs = [(sid, mine.get(sid, 0)) for sid in diverged]
            hashes = [
                mesh.tree.path_hash(n)
                for nodes in mesh.tree.nodes_in_shards(diverged).values()
                for n in nodes
            ]
        if mesh.send_repair(
            op.origin_rank,
            OplogType.REPAIR_SUMMARY,
            encode_shard_session_summary(my_pairs, hashes, reply=False),
            bootstrap=bootstrap,
        ):
            self._m_summaries.inc()

    def _handle_shard_summary_frame(self, op: Oplog) -> None:
        """Owner-scoped summary: push my one-sided entries for the
        session's shards as sharded data re-emissions (they land on the
        whole owner set, healing every co-owner in one push), then close
        the exchange if I initiated it."""
        try:
            pairs, their_hashes, is_reply = decode_shard_session_summary(
                op.value
            )
        except ValueError:
            self.log.warning(
                "malformed shard summary from rank %d", op.origin_rank
            )
            return
        bootstrap = self._is_bootstrap_session(op.origin_rank)
        sids = [sid for sid, _ in pairs]
        keys, oplogs = self.mesh.repair_push_shards(
            sids, their_hashes,
            self.cfg.bootstrap_key_budget if bootstrap else self.cfg.key_budget,
        )
        if keys:
            self._m_keys.inc(keys)
            self._m_oplogs.inc(oplogs)
        if not is_reply:
            mesh = self.mesh
            with mesh._lock:
                mine = mesh.tree.shard_fingerprints()
                my_pairs = [(sid, mine.get(sid, 0)) for sid in sids]
                hashes = [
                    mesh.tree.path_hash(n)
                    for nodes in mesh.tree.nodes_in_shards(sids).values()
                    for n in nodes
                ]
            if mesh.send_repair(
                op.origin_rank,
                OplogType.REPAIR_SUMMARY,
                encode_shard_session_summary(my_pairs, hashes, reply=True),
                bootstrap=bootstrap,
            ):
                self._m_summaries.inc()
            self._m_rounds.inc()
            st = self._peers.get(op.origin_rank)
            sent_at = st["probe_sent_at"] if st else 0.0
            if sent_at:
                self._m_round_s.observe(
                    max(0.0, time.monotonic() - sent_at)
                )

    def _handle_summary(self, op: Oplog) -> None:
        if is_shard_frame(op.value):
            self._handle_shard_summary_frame(op)
            return
        try:
            their_vec, buckets, their_hashes, is_reply = decode_summary(op.value)
        except ValueError:
            self.log.warning(
                "malformed repair summary from rank %d", op.origin_rank
            )
            return
        t0 = time.monotonic()
        bootstrap = self._is_bootstrap_session(op.origin_rank)
        # Push MY one-sided entries for the session's buckets as ordinary
        # ring INSERTs (no-op on routers: they hold no indices and never
        # ring-send). A donor answering a bootstrapper pushes with the
        # raised bulk budget.
        keys, oplogs = self.mesh.repair_push_keys(
            buckets, their_hashes,
            self.cfg.bootstrap_key_budget if bootstrap else self.cfg.key_budget,
        )
        if keys:
            self._m_keys.inc(keys)
            self._m_oplogs.inc(oplogs)
        if not is_reply:
            # I initiated this session: close the exchange by sending my
            # side's summary so the PEER can push its one-sided entries.
            vec, hashes = self._summary_for(buckets)
            if self.mesh.send_repair(
                op.origin_rank,
                OplogType.REPAIR_SUMMARY,
                encode_summary(vec, buckets, hashes, reply=True),
                bootstrap=bootstrap,
            ):
                self._m_summaries.inc()
            self._m_rounds.inc()
            st = self._peers.get(op.origin_rank)
            sent_at = st["probe_sent_at"] if st else 0.0
            dur = max(0.0, time.monotonic() - sent_at) if sent_at else 0.0
            if sent_at:
                self._m_round_s.observe(dur)
            rec = get_recorder()
            if rec.enabled and sent_at:
                rec.event(
                    f"repair:{self.mesh._node_label}",
                    "repair_round",
                    sent_at,
                    dur,
                    cat="repair",
                    peer_rank=int(op.origin_rank),
                    buckets=len(buckets),
                    keys_pushed=int(keys),
                )
        self.log.debug(
            "repair summary from rank %d: %d buckets, pushed %d keys "
            "(%d oplogs) in %.4fs",
            op.origin_rank, len(buckets), keys, oplogs,
            time.monotonic() - t0,
        )

    # -- introspection --------------------------------------------------

    def stats(self) -> dict:
        # list() snapshots are single C-level operations under the GIL;
        # the worker thread mutates _peers concurrently, and a plain
        # Python-level iteration over the live dict could raise
        # "dictionary changed size during iteration" mid-read.
        peer_states = list(self._peers.items())
        return {
            "probes_sent": int(self._m_probes_sent.value),
            "probes_received": int(self._m_probes_rcvd.value),
            "summaries_sent": int(self._m_summaries.value),
            "keys_pushed": int(self._m_keys.value),
            "oplogs_reemitted": int(self._m_oplogs.value),
            "rounds": int(self._m_rounds.value),
            "heals": self.heals,
            "max_episode_rounds": self.max_episode_rounds,
            # Episodes still in flight count their rounds here so a
            # non-heal can never under-report its probe spend.
            "max_inflight_rounds": max(
                (st.get("rounds", 0) for _, st in peer_states), default=0
            ),
            "diverged_peers": sorted(r for r, _ in peer_states),
            "bootstrap_peers": sorted(
                r for r, st in peer_states if st.get("bootstrap")
            ),
        }


_DATA_KIND_INTS = frozenset(int(k) for k in DATA_KINDS)
