"""Disaggregated prefill→decode serving with KV handoff (the JAX package's
``engine/disagg.py``).

A :class:`PrefillWorker` computes a prompt's KV and first token and ships
them, as a :class:`HandoffPacket`, to a :class:`DecodeWorker`, which writes
the KV into its own pool and continues generation there.

- **Wire format** (:func:`pack_handoff` / :func:`unpack_handoff`): ``[4-byte
  big-endian header length][JSON header][KV bytes][float32 scale bytes]``,
  byte for byte the JAX package's: the same header fields in the same order,
  the KV token-major ``[2, L, n, Hkv, D]`` in C order. bf16 KV is written
  and read as its 16-bit patterns under the header name ``"bfloat16"``
  (no ``ml_dtypes``). A JAX prefill node and a port decode node, or the
  other way round, hand off to each other over any length-framed
  :class:`~radixmesh_tpu_torch.comm.communicator.Communicator`.
- **Tail-only handoff**: the decode side re-checks its own radix cache and
  writes only the uncached tail. The prefill side can skip the bytes too:
  ``skip_prefix`` from :meth:`DecodeWorker.cached_prefix_len`.
- **Streamed handoff** (:meth:`PrefillWorker.prefill_handoff_stream`):
  chunked packets sent from the KV plane's handoff lane
  (``cache/kv_transfer.py`` ``submit_task``), so one chunk's device→host
  copy and send overlap the next chunk's gather; the decode side stages
  each chunk as it lands and admits the request when all have arrived.
  Partial streams expire after ``chunk_ttl_s`` (120 s).
- **Layer staging** (``DecodeWorker(stage_layers=N)``): a packet's KV is
  split into blocks of N layers whose host→device copies start on the
  receiving thread; the engine writes each block
  (``PagedKVPool.write_block``) when it admits the request.

On the card (the JAX package leans on XLA's async dispatch; here the order
is built by hand):

- Prefill side: each chunk's ``gather_raw`` (made contiguous) is enqueued
  on the compute stream right after the prefill, before the request's
  slots are released, so stream order puts it ahead of any later prefill
  that reuses them. An event is recorded after it; the device→host copy
  waits on that event on the worker's own copy stream, into pinned memory,
  and the gathered tensor is marked with ``record_stream`` and held by the
  task until the copy has landed.
- Decode side: :func:`unpack_handoff` copies the message's bytes once, into
  pinned memory; the host→device copy runs on the decode worker's copy
  stream with an event after it, and ``write_block`` makes the compute
  stream wait on that event (and marks the staged tensors as used by it)
  before it scatters. A quantized packet bound for a full-precision pool is
  dequantized on the copy stream after the copy.
- ``device_kv=True`` keeps a packet's KV a CUDA tensor; a decode worker on
  the same card writes it without a host round trip. A block on another
  device is refused (``_colocate``), never copied quietly.
- On a mesh (an engine over tp, pp or both): a :class:`PrefillWorker`
  gathers the prefix's K/V and int8 scales from its ranks (heads over tp,
  layers over pp) and its leader (engine index 0) ships the JAX wire
  format, so a decode node of any shape, one device included, takes the
  packet; the other ranks return None. A :class:`DecodeWorker` receives on
  the leader only; the step agreement (``parallel/step_sync.py``) hands
  each packet to every rank at the next pass boundary, and each rank
  stages and writes (``write_block``) its own heads and layers.
- :class:`IciHandoff` (the JAX package's ICI path) moves a ``device_kv``
  packet between two ranks of one mesh axis as a point-to-point tensor
  transfer over the job's process group (``parallel/collectives.p2p``):
  device to device with nccl across two cards; through pinned host memory
  with gloo, the one transport two ranks on one card have.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from radixmesh_tpu_torch.cache.host_cache import HierarchicalCache
from radixmesh_tpu_torch.cache.kv_tier import _KV_DTYPES, _KV_NAMES
from radixmesh_tpu_torch.comm.communicator import Communicator
from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.engine.request import Request, RequestState, SamplingParams
from radixmesh_tpu_torch.obs.trace_plane import get_recorder
from radixmesh_tpu_torch.ops.quant import dequantize_kv
from radixmesh_tpu_torch.parallel.collectives import all_gather, p2p
from radixmesh_tpu_torch.parallel.step_sync import Source
from radixmesh_tpu_torch.utils.device import resolve_device
from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = [
    "HandoffPacket",
    "PrefillWorker",
    "DecodeWorker",
    "IciHandoff",
    "pack_handoff",
    "unpack_handoff",
]


@dataclass
class HandoffPacket:
    """Everything a decode node needs to continue a prefilled request."""

    prompt: np.ndarray  # int32 [n]
    first_token: int  # sampled from the prefill logits
    kv: torch.Tensor  # [2, L, n - kv_start, Hkv, D], pool dtype
    sampling: SamplingParams = field(default_factory=SamplingParams)
    rid: int = -1
    submit_time: float = 0.0
    first_token_time: float = 0.0
    # KV covers prompt[kv_start:]; > 0 when the sender knows the receiver
    # already caches the first kv_start tokens (tail-only shipping).
    kv_start: int = 0
    # Per-(token, head) scales of an int8 payload ([2, L, n - kv_start, Hkv]).
    kv_scale: torch.Tensor | None = None
    # The prefill leg was traced: the decode leg follows this bit (and
    # adopts trace_id) instead of flipping its own coin.
    traced: bool = False
    trace_id: int = 0
    # Streamed handoff: chunk ``chunk_seq`` of ``chunk_of`` covers tokens
    # prompt[kv_start : kv_start + kv.shape[2]]; chunk_of = 0 is a whole
    # packet.
    chunk_seq: int = -1
    chunk_of: int = 0


@dataclass
class _StagedKV:
    """One staged block of handoff KV: layers ``[layer0, layer0 +
    kv.shape[1])`` of prompt tokens ``[tok0, tok0 + kv.shape[2])``.
    ``ready``: the CUDA event after its host→device copy (None when it was
    made on the compute stream or on the CPU)."""

    kv: torch.Tensor  # token-major [2, nL, n, H, D]
    scale: torch.Tensor | None  # [2, nL, n, H] when quantized
    layer0: int
    tok0: int
    ready: object = None

    @property
    def n_tokens(self) -> int:
        return int(self.kv.shape[2])


def _copy_stream(device: torch.device):
    return torch.cuda.Stream(device=device) if device.type == "cuda" else None


def _shard_of(engine: Engine, kv: torch.Tensor, scale: torch.Tensor | None):
    """This rank's block of a whole packet's ``kv [2, L, n, Hkv, D]`` and
    ``scale [2, L, n, Hkv]``: its stage's layers and its tp heads (the
    whole packet on one rank)."""
    if engine._ranks == 1:
        return kv, scale
    mesh, L, H = engine.device_mesh, engine.model.n_layers, engine.model.n_kv_heads
    l0, h0 = mesh.index("pp") * L, mesh.index("tp") * H
    kv = kv[:, l0 : l0 + L, :, h0 : h0 + H].contiguous()
    if scale is not None:
        scale = scale[:, l0 : l0 + L, :, h0 : h0 + H].contiguous()
    return kv, scale


class PrefillWorker(Engine):
    """A PREFILL-role node: runs prompt prefill with local radix-cache
    reuse, then hands the request off instead of decoding it. It is an
    :class:`Engine`, so admission, prefix reuse, publish, locks and eviction
    are the collocated path's; a request's life here ends at its first
    token. It never runs a decode step."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        # The streamed handoff's device→host copies (created at first use).
        self._d2h_stream = None
        # The mesh gathers of the last handoff (zero on one rank).
        self.gather_s = 0.0
        self.gather_bytes = 0

    @property
    def _leader(self) -> bool:
        return self._ranks == 1 or self.device_mesh.engine_index == 0

    def _admit_one_prompt(self, prompt, sampling) -> Request:
        """Admit and prefill ``prompt`` alone; its first token is on the
        host when this returns (the admission wave's finalize)."""
        req = self.add_request(prompt, sampling)
        self._admit()
        if req.state is not RequestState.RUNNING:
            # Leave no residue: a stale queued request would be admitted by
            # the next call and hold a batch row forever.
            self.waiting = [r for r in self.waiting if r is not req]
            raise RuntimeError("prefill pool exhausted; could not admit request")
        if not req.output_tokens:
            raise RuntimeError("admission returned without the first token")
        return req

    def _packet(self, req: Request, kv, kv_scale, kv_start: int, **chunk) -> HandoffPacket:
        return HandoffPacket(
            prompt=req.prompt,
            first_token=req.output_tokens[0],
            kv=kv,
            sampling=req.sampling,
            rid=req.rid,
            submit_time=req.submit_time,
            first_token_time=req.first_token_time,
            kv_start=kv_start,
            kv_scale=kv_scale,
            traced=req.trace is not None,
            trace_id=req.trace.trace_id if req.trace is not None else 0,
            **chunk,
        )

    def _gather(self, req: Request, lo: int, hi: int):
        """``gather_raw`` of the request's tokens ``[lo, hi)``, made
        contiguous in the wire's token-major order, on the compute stream.
        On a mesh the ranks' shards are gathered, heads over tp and layers
        over pp (every rank of the engine takes part)."""
        kv, scale = self.pool.gather_raw(req.token_slots[lo:hi])
        kv, scale = kv.contiguous(), None if scale is None else scale.contiguous()
        if self._ranks > 1:
            t0 = time.perf_counter()
            mesh = self.device_mesh
            kv = all_gather(all_gather(kv, mesh, "tp", dim=3), mesh, "pp", dim=1)
            if scale is not None:
                scale = all_gather(all_gather(scale, mesh, "tp", dim=3), mesh, "pp", dim=1)
            self.gather_s += time.perf_counter() - t0
            self.gather_bytes += kv.numel() * kv.element_size() + (0 if scale is None else scale.numel() * 4)
        return kv, scale

    def prefill_handoff(
        self,
        prompt: Sequence[int],
        sampling: SamplingParams | None = None,
        skip_prefix: int = 0,
        device_kv: bool = False,
    ) -> HandoffPacket:
        """Prefill ``prompt`` and return its handoff packet. ``skip_prefix``
        omits the first N tokens' KV (page-aligned: the receiver caches
        them, :meth:`DecodeWorker.cached_prefix_len`). With ``device_kv``
        the packet's KV stays on the device; otherwise it is copied to
        pinned host memory (on the card). On a mesh every rank calls it and
        the leader gets the packet, the others None."""
        self.gather_s, self.gather_bytes = 0.0, 0
        req = self._admit_one_prompt(prompt, sampling)
        tr = req.trace
        t_pack = time.monotonic() if tr is not None else 0.0
        # Gather before release: release publishes the page-aligned prefix
        # to the tree but frees the tail's partial page.
        kv, kv_scale = self._gather(req, skip_prefix, len(req.token_slots))
        if not device_kv:
            kv, kv_scale = (_to_host(t) for t in (kv, kv_scale))
        if tr is not None:
            tr.add(
                "disagg_handoff_pack", t_pack, time.monotonic() - t_pack, cat="disagg",
                kv_tokens=int(len(req.token_slots) - skip_prefix),
                skip_prefix=int(skip_prefix),
            )
        pkt = self._packet(req, kv, kv_scale, skip_prefix) if self._leader else None
        req.state = RequestState.FINISHED
        self._release(req)
        return pkt

    def prefill_handoff_stream(
        self,
        prompt: Sequence[int],
        sampling: SamplingParams | None = None,
        *,
        send,
        chunk_tokens: int = 1024,
        skip_prefix: int = 0,
        plane=None,
    ) -> int:
        """Prefill ``prompt`` and stream its handoff as ``chunk_of`` chunk
        packets through ``send(bytes)``. Each chunk's gather is enqueued
        here (the engine thread); its device→host copy, pack and send run
        on the KV plane's handoff lane (``plane.submit_task``), so chunk i's
        send overlaps chunk i+1's copy. With ``plane=None`` the chunks are
        shipped inline (the same packets, no overlap). Returns the number of
        chunks. On a mesh every rank calls it and only the leader sends."""
        self.gather_s, self.gather_bytes = 0.0, 0
        req = self._admit_one_prompt(prompt, sampling)
        tr = req.trace
        n = len(req.token_slots)
        spans = [(lo, min(n, lo + chunk_tokens)) for lo in range(skip_prefix, n, chunk_tokens)]
        if not spans:
            # The receiver caches the whole prompt: one empty-KV chunk still
            # carries the request and its first token.
            spans = [(skip_prefix, skip_prefix)]
        chunk_of = len(spans)
        cuda = self.pool.device.type == "cuda"
        if cuda and self._d2h_stream is None:
            self._d2h_stream = _copy_stream(self.pool.device)
        for seq, (lo, hi) in enumerate(spans):
            t_pack = time.monotonic()
            # Enqueued before the release below returns the slots to the
            # allocator: any later write to them is behind it on the stream.
            kv, kv_scale = self._gather(req, lo, hi)
            gathered = None
            if cuda:
                gathered = torch.cuda.Event()
                gathered.record(torch.cuda.current_stream(self.pool.device))

            def _ship(kv=kv, kv_scale=kv_scale, gathered=gathered, lo=lo, seq=seq, t0=t_pack):
                host_kv, host_scale = _to_host_after(kv, kv_scale, gathered, self._d2h_stream)
                pkt = self._packet(req, host_kv, host_scale, lo, chunk_seq=seq, chunk_of=chunk_of)
                send(pack_handoff(pkt))
                if plane is not None:
                    plane.note_handoff(pkt.kv.shape[2], self.pool, time.monotonic() - t0)

            if not self._leader:
                continue
            if plane is not None:
                plane.submit_task(_ship)
            else:
                _ship()
        if tr is not None:
            tr.add(
                "disagg_handoff_pack", time.monotonic(), 0.0, cat="disagg",
                kv_tokens=int(n - skip_prefix), skip_prefix=int(skip_prefix),
                chunks=chunk_of, streamed=True,
            )
        req.state = RequestState.FINISHED
        self._release(req)
        return chunk_of


def _to_host(t: torch.Tensor | None) -> torch.Tensor | None:
    """A host copy of ``t`` (pinned, for a CUDA tensor), landed when this
    returns."""
    if t is None or t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host


def _to_host_after(kv, scale, gathered, stream):
    """Pinned host copies of ``kv`` and ``scale`` made on ``stream`` after
    the event ``gathered`` (recorded after the gather on the compute
    stream); landed when this returns. CPU tensors are returned as they
    are."""
    if kv.device.type == "cpu":
        return kv, scale
    out = []
    with torch.cuda.device(kv.device), torch.cuda.stream(stream):
        stream.wait_event(gathered)
        for t in (kv, scale):
            if t is None:
                out.append(None)
                continue
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            t.record_stream(stream)  # allocated on the compute stream
            out.append(host)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return out[0], out[1]


class DecodeWorker:
    """A DECODE-role node: receives handoff packets (directly through
    :meth:`submit`, or from a :class:`Communicator`), writes the shipped KV
    into its own pool and drives continuous-batching decode through the
    wrapped :class:`Engine`.

    Transport callbacks land on reader threads and the engine is single
    threaded, so packets queue under a lock and :meth:`step` admits them on
    the scheduling thread. Host→device copies start on the reader thread,
    on the worker's copy stream (module docstring).

    On an engine over several ranks every rank builds its worker and runs
    :meth:`step` (or :meth:`run_until_drained`) alike, but only the leader
    takes packets in (``comm`` and :meth:`submit` there alone): they queue
    whole, and the step agreement gives each to every rank at the next
    pass, where each stages its own shard."""

    def __init__(self, engine: Engine, comm: Communicator | None = None, plane=None,
                 stage_layers: int = 0):
        self.engine = engine
        self.log = get_logger("disagg.decode")
        self._pending: list[tuple[Request, list[_StagedKV], int]] = []
        self._lock = threading.Lock()
        self.dropped = 0  # tail-only handoffs whose advertised prefix vanished
        # Staged placement: > 0 splits a packet's KV into blocks of this many
        # layers, each copied to the device on its own.
        self.plane = plane
        self.stage_layers = int(stage_layers)
        # Streamed-handoff reassembly: (rid, origin submit stamp) →
        # {"t": first seen, "parts": {seq: (packet, staged block)}}. rids
        # are per process, so the stamp keeps two prefill nodes apart;
        # stale partial streams expire so their staged tensors are freed.
        self._chunks: dict[tuple, dict] = {}
        self.chunk_ttl_s = 120.0
        self._h2d_stream = _copy_stream(engine.pool.device)
        # An engine over several ranks: the leader's inbox of packed packets
        # (and the Request a submit already returned), handed to every rank
        # by the step agreement.
        self._sync = None
        if engine._ranks > 1:
            self._leader = engine.device_mesh.engine_index == 0
            if comm is not None and not self._leader:
                raise ValueError("only the leader rank of a multi-rank engine receives handoff packets")
            self._inbox: list[tuple[bytes, Request | None]] = []
            self._taken: list[Request | None] = []
            self._sync = engine._bind_step_sync()
            self._sync.add_source("handoff", Source(
                pending=lambda: len(self._inbox), take=self._take_inbox, apply=self._apply_inbox))
        self._comm = comm
        if comm is not None:
            comm.register_rcv_callback(self._on_packet)

    # -- ingestion ------------------------------------------------------

    def _on_packet(self, data: bytes) -> None:
        if self._sync is not None:
            with self._lock:
                self._inbox.append((bytes(data), None))
            return
        pkt = unpack_handoff(data, pin_memory=self._h2d_stream is not None)
        if pkt.chunk_of > 0:
            self._submit_chunk(pkt)
        else:
            self.submit(pkt)

    def _take_inbox(self) -> list[bytes]:
        """LEADER, at a pass boundary: the packets received since the last."""
        with self._lock:
            taken, self._inbox = self._inbox, []
        self._taken = [req for _, req in taken]
        return [data for data, _ in taken]

    def _apply_inbox(self, packets: list[bytes]) -> None:
        """EVERY RANK, at a pass boundary: stage this rank's shard of each
        packet the leader received, in its order."""
        reqs = self._taken if self._leader else [None] * len(packets)
        self._taken = []
        for data, req in zip(packets, reqs, strict=True):
            pkt = unpack_handoff(data, pin_memory=self._h2d_stream is not None)
            pkt.kv, pkt.kv_scale = _shard_of(self.engine, pkt.kv, pkt.kv_scale)
            if pkt.chunk_of > 0:
                self._submit_chunk(pkt, now=self._sync.now)
            else:
                self._submit_local(pkt, req)

    def _stage(self, kv: torch.Tensor, scale: torch.Tensor | None, layer0: int,
               tok0: int) -> _StagedKV:
        """One block onto the pool's device. A host block is copied on the
        copy stream (an event after it); a quantized block bound for a
        full-precision pool is dequantized there too."""
        pool = self.engine.pool
        dequant = scale is not None and pool.quant is None
        if kv.device.type == "cpu" and pool.device.type == "cuda":
            s = self._h2d_stream
            with torch.cuda.device(pool.device), torch.cuda.stream(s):
                kv, scale = _h2d(kv, pool.device), None if scale is None else _h2d(scale, pool.device)
                if dequant:
                    kv, scale = dequantize_kv(kv, scale), None
                ready = torch.cuda.Event()
                ready.record(s)
            return _StagedKV(kv, scale, layer0, tok0, ready)
        if dequant:
            kv, scale = dequantize_kv(kv, scale.to(kv.device)), None
        return _StagedKV(kv, scale, layer0, tok0)

    def _stage_blocks(self, pkt: HandoffPacket) -> list[_StagedKV]:
        """A packet as staged blocks: one block, or blocks of
        ``stage_layers`` layers for a host payload."""
        kv, scale = pkt.kv, pkt.kv_scale
        if self.stage_layers <= 0 or kv.device.type != "cpu" or kv.shape[1] <= self.stage_layers:
            return [self._stage(kv, scale, 0, int(pkt.kv_start))]
        t0 = time.monotonic()
        blocks = []
        for l0 in range(0, kv.shape[1], self.stage_layers):
            l1 = min(kv.shape[1], l0 + self.stage_layers)
            blocks.append(self._stage(kv[:, l0:l1], None if scale is None else scale[:, l0:l1],
                                      l0, int(pkt.kv_start)))
        if self.plane is not None:
            self.plane.note_handoff(int(kv.shape[2]), self.engine.pool, time.monotonic() - t0)
        return blocks

    def _make_request(self, pkt: HandoffPacket) -> Request:
        # Engine.make_request's bound: a longer prompt would overflow this
        # node's page table mid-admission.
        if not (0 < len(pkt.prompt) < self.engine.max_seq_len):
            raise ValueError(
                f"prompt length {len(pkt.prompt)} out of range for decode "
                f"engine (max_seq_len={self.engine.max_seq_len})"
            )
        req = Request(prompt=np.asarray(pkt.prompt, np.int32), sampling=pkt.sampling)
        req.output_tokens = [int(pkt.first_token)]
        req.submit_time = pkt.submit_time or time.monotonic()
        req.first_token_time = pkt.first_token_time or time.monotonic()
        if pkt.traced:
            # The prefill node flipped the coin: follow it, and adopt its
            # trace id (0 from senders that carry none: a fresh id).
            req.trace = get_recorder().trace(
                f"req:{req.rid}", force=True, trace_id=pkt.trace_id or None,
                node=self.engine.name,
            )
        if req.trace is not None:
            req.trace.add(
                "disagg_handoff_receive", time.monotonic(), 0.0, cat="disagg",
                handoff_rid=int(pkt.rid), kv_start=int(pkt.kv_start),
            )
        return req

    def submit(self, pkt: HandoffPacket) -> Request:
        """Queue a whole packet; its KV starts moving to the device now (on
        a multi-rank engine: on the leader, at the next pass boundary)."""
        if self._sync is not None:
            if not self._leader:
                raise ValueError("only the leader rank of a multi-rank engine takes handoff packets")
            req = self._make_request(pkt)
            with self._lock:
                self._inbox.append((pack_handoff(pkt), req))
            return req
        return self._submit_local(pkt, None)

    def _submit_local(self, pkt: HandoffPacket, req: Request | None) -> Request:
        req = req or self._make_request(pkt)
        blocks = self._stage_blocks(pkt)
        with self._lock:
            self._pending.append((req, blocks, int(pkt.kv_start)))
        return req

    def _submit_chunk(self, pkt: HandoffPacket, now: float | None = None) -> Request | None:
        """One chunk of a streamed handoff: stage it now and queue the
        request when the set is complete. Returns the Request then, None
        while chunks are outstanding. ``now``: the agreed clock (a
        multi-rank engine), else this host's."""
        t0 = time.monotonic()
        staged = self._stage(pkt.kv, pkt.kv_scale, 0, int(pkt.kv_start))
        if self.plane is not None:
            self.plane.note_handoff(staged.n_tokens, self.engine.pool, time.monotonic() - t0)
        key = (int(pkt.rid), float(pkt.submit_time))
        now = time.monotonic() if now is None else now
        with self._lock:
            self._prune_stale_chunks_locked(now)
            entry = self._chunks.setdefault(key, {"t": now, "parts": {}})
            got = entry["parts"]
            got[int(pkt.chunk_seq)] = (pkt, staged)
            if len(got) < pkt.chunk_of:
                return None
            del self._chunks[key]
        ordered = [got[i] for i in sorted(got)]
        first_pkt = ordered[0][0]
        req = self._make_request(first_pkt)
        with self._lock:
            self._pending.append((req, [st for _, st in ordered], int(first_pkt.kv_start)))
        return req

    def cached_prefix_len(self, prompt: Sequence[int]) -> int:
        """How many leading tokens of ``prompt`` this node caches
        (page-aligned, capped as admission caps reuse): the safe
        ``skip_prefix`` for a tail-only handoff of it."""
        eng = self.engine
        prompt = np.asarray(prompt, np.int32)
        match = eng.tree.match_prefix(prompt)
        return min(match.length, (len(prompt) - 1) // eng.page_size * eng.page_size)

    # -- scheduling -----------------------------------------------------

    def step(self) -> None:
        eng = self.engine
        if self._sync is not None and eng._agreed is None:
            eng._agree()  # this pass's packets reach every rank first
        self._admit_pending()
        eng.step()

    def has_work(self) -> bool:
        # The engine's answer first: on a mesh it runs the pass's agreement,
        # which hands the leader's packets to every rank.
        busy = self.engine.has_work()
        with self._lock:
            return busy or bool(self._pending)

    def run_until_drained(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if not self.has_work():
                return
            self.step()
        raise RuntimeError("step budget exhausted with work remaining")

    def _prune_stale_chunks_locked(self, now: float) -> None:
        """Expire abandoned partial streams (a sender that died mid
        handoff). Caller holds the lock. Runs from the chunk receive path
        and from every scheduler drain, so a stream stranded when chunked
        traffic stops still expires."""
        for stale in [k for k, e in self._chunks.items() if now - e["t"] > self.chunk_ttl_s]:
            self.log.error("dropping stale partial handoff stream %s", stale)
            del self._chunks[stale]

    def _admit_pending(self) -> None:
        with self._lock:
            if self._chunks:
                self._prune_stale_chunks_locked(
                    time.monotonic() if self._sync is None else self._sync.now)
            pending, self._pending = self._pending, []
        for i, (req, blocks, kv_start) in enumerate(pending):
            if not self._admit_one(req, blocks, kv_start):
                # Re-queue the failed packet and everything after it:
                # admission stops at the first failure (row or pool
                # pressure) and must not drop the rest of the batch.
                with self._lock:
                    self._pending[:0] = pending[i:]
                return

    def _admit_one(self, req: Request, blocks: list[_StagedKV], kv_start: int) -> bool:
        eng = self.engine
        row = eng._free_row()
        if row < 0:
            return False
        n = len(req.prompt)
        # A token-identical prefix already in this node's pool is reusable
        # (same model, deterministic prefill): only the tail is written.
        if isinstance(eng.tree, HierarchicalCache):
            # Host-resident extensions are restored into device slots as
            # part of the match (the copy beats rewriting them).
            match = eng.tree.match_and_load(req.prompt)
        else:
            match = eng.tree.match_prefix(req.prompt)
        acquired = eng._acquire_prompt_slots(req, match)
        if acquired is None:
            return False
        reuse, prefix_slots, own = acquired
        if reuse < kv_start:
            # Tail-only packet whose cached prefix is gone (evicted between
            # advertisement and arrival): the KV for [reuse, kv_start)
            # exists nowhere on this node. Drop it loudly.
            eng.tree.dec_lock_ref(req.lock_node)
            req.lock_node = None
            eng.pool.free(own)
            req.own_slots = np.empty(0, dtype=np.int32)
            req.state = RequestState.FINISHED
            self.log.error(
                "dropping handoff rid=%d: packet omits KV for [%d, %d) but "
                "local cache only covers %d tokens", req.rid, 0, kv_start, reuse,
            )
            self.dropped += 1
            return True  # consumed, not re-queued
        n_new = n - reuse
        tr = req.trace
        t_write = time.monotonic() if tr is not None else 0.0
        # One pool scatter per staged block.
        for b in blocks:
            lo = max(reuse, b.tok0)
            hi = min(n, b.tok0 + b.n_tokens)
            if hi <= lo:
                continue  # covered by local reuse
            sl, sh = lo - b.tok0, hi - b.tok0
            tail = self._colocate(b.kv[:, :, sl:sh])
            scale = None if b.scale is None else self._colocate(b.scale[:, :, sl:sh])
            # Int8 end to end stores the shipped ints verbatim; an int8
            # pool given floats quantizes on store; plain pools cast.
            eng.pool.write_block(own[lo - reuse : hi - reuse], tail, b.layer0, scales=scale,
                                 ready=b.ready)
        req.kv_len = n
        req.token_slots = np.concatenate([prefix_slots, own[:n_new]])
        req.own_slots = own
        if tr is not None:
            tr.add(
                "disagg_kv_write", t_write, time.monotonic() - t_write, cat="disagg",
                kv_tokens=int(n_new), reused_tokens=int(reuse), blocks=len(blocks),
            )
        eng._install_running(req, row, reuse)
        return True

    def _colocate(self, t: torch.Tensor) -> torch.Tensor:
        """The JAX package re-places an ICI-moved block onto the pool's
        devices here. On one card a block is on the pool's device or it is
        refused."""
        if t.device != self.engine.pool.device:
            raise ValueError(
                f"handoff block on {t.device}, decode pool on {self.engine.pool.device}"
            )
        return t


def _h2d(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Non-blocking copy of host ``t`` ``[2, ...]`` onto ``device`` on the
    current stream, one copy per K/V half (each half of a layer block of a
    token-major packet is contiguous, so a pinned source stays a DMA)."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    for i in range(t.shape[0]):
        out[i].copy_(t[i], non_blocking=True)
    return out


class IciHandoff:
    """Prefill→decode KV movement between two ranks of one mesh axis (the
    JAX package's ``IciHandoff``, which rides a ``ppermute`` over the TPU
    slice's ICI). When the prefill and the decode worker are ranks of one
    job, a handoff packet's KV block moves as tensors over the axis's
    process group, with no wire format and no JSON.

    :meth:`move` is collective over the axis line: every rank of it calls
    it. The source rank passes its ``device_kv=True`` packet (KV and int8
    scales); the packet's fields travel in a header broadcast over the
    axis, the KV and scales by point-to-point from the source to the
    destination, which gets the packet back with its KV on ``device``,
    ready for :meth:`DecodeWorker.submit`. Every other rank, the source
    included, gets None.

    Transport: the mesh's backend. nccl moves the block device to device
    (one card per rank); two ranks that share one card must run gloo, and
    the block then goes through pinned host memory on both sides. Nothing
    falls back quietly: a backend that cannot move it raises. The JAX
    class pads blocks to power-of-two page counts for ``jit``; a process
    group moves any shape, so ``page_size`` is kept for the JAX signature
    only."""

    def __init__(self, mesh, axis_name: str, src_rank: int, dst_rank: int, page_size: int = 16,
                 device=None):
        self.mesh = mesh
        self.axis = axis_name
        self.src = src_rank
        self.dst = dst_rank
        self.page_size = page_size
        self.n_ranks = mesh.size(axis_name)
        if not (0 <= src_rank < self.n_ranks and 0 <= dst_rank < self.n_ranks):
            raise ValueError(
                f"ranks ({src_rank}->{dst_rank}) outside axis {axis_name} of size {self.n_ranks}"
            )
        self.device = resolve_device(device)

    def move(self, pkt: HandoffPacket | None) -> HandoffPacket | None:
        """Relocate the source's packet to the destination rank (see the
        class docstring); ``pkt`` is read on the source rank only."""
        i = self.mesh.index(self.axis)
        if i == self.src and pkt is None:
            raise ValueError("the source rank must pass its handoff packet")
        if self.src == self.dst:
            return pkt if i == self.src else None
        head = [None]
        if i == self.src:
            scale = pkt.kv_scale
            head = [(dataclasses.replace(pkt, kv=None, kv_scale=None), tuple(pkt.kv.shape), pkt.kv.dtype,
                     None if scale is None else (tuple(scale.shape), scale.dtype))]
        torch.distributed.broadcast_object_list(head, src=self.mesh.peer(self.axis, self.src),
                                                group=self.mesh.group(self.axis))
        meta, kv_shape, kv_dtype, scale_meta = head[0]
        if i == self.src:
            blocks = [pkt.kv] + ([] if pkt.kv_scale is None else [pkt.kv_scale])
            # meshcheck: ok[timeout-audit] the handoff's p2p send is bounded by the process
            # group's timeout (init_multihost(timeout_s=), parallel/multihost.py): an unmatched
            # collective ends in an error, never a hang. No timeout= here: on NCCL it would turn
            # the stream-side wait into a host-blocking one.
            p2p(self.mesh, self.axis, blocks, to=self.dst).wait()
            return None
        if i != self.dst:
            return None
        likes = [torch.empty(kv_shape, dtype=kv_dtype, device=self.device)]
        if scale_meta is not None:
            likes.append(torch.empty(scale_meta[0], dtype=scale_meta[1], device=self.device))
        # meshcheck: ok[timeout-audit] the handoff's p2p receive is bounded by the process
        # group's timeout (init_multihost(timeout_s=), parallel/multihost.py): an unmatched
        # collective ends in an error, never a hang. No timeout= here: on NCCL it would turn the
        # stream-side wait into a host-blocking one.
        got = p2p(self.mesh, self.axis, recv_like=likes, frm=self.src).wait()
        return dataclasses.replace(meta, kv=got[0], kv_scale=got[1] if scale_meta is not None else None)


# ----------------------------------------------------------------------
# wire format
# ----------------------------------------------------------------------

_HEADER_LEN_BYTES = 4


def _raw_bytes(t: torch.Tensor) -> memoryview:
    """The tensor's bytes in C order (its bit patterns)."""
    return memoryview(t.detach().cpu().contiguous().view(torch.uint8).reshape(-1).numpy())


def pack_handoff(pkt: HandoffPacket) -> bytes:
    """``[4-byte header length][JSON header][raw KV bytes][f32 scales]``:
    the JAX package's bytes for the same packet."""
    kv = torch.as_tensor(pkt.kv)
    scale = None if pkt.kv_scale is None else torch.as_tensor(pkt.kv_scale).float()
    header = json.dumps(
        {
            "prompt": np.asarray(pkt.prompt).tolist(),
            "first_token": int(pkt.first_token),
            "rid": pkt.rid,
            "submit_time": pkt.submit_time,
            "first_token_time": pkt.first_token_time,
            "kv_shape": list(kv.shape),
            "kv_dtype": _KV_NAMES[kv.dtype],
            "kv_start": int(pkt.kv_start),
            "traced": bool(pkt.traced),
            "trace_id": int(pkt.trace_id),
            "chunk_seq": int(pkt.chunk_seq),
            "chunk_of": int(pkt.chunk_of),
            "scale_shape": None if scale is None else list(scale.shape),
            "sampling": {
                "temperature": pkt.sampling.temperature,
                "top_p": pkt.sampling.top_p,
                "top_k": pkt.sampling.top_k,
                "max_new_tokens": pkt.sampling.max_new_tokens,
                "stop_token_ids": list(pkt.sampling.stop_token_ids),
            },
        }
    ).encode()
    parts = [len(header).to_bytes(_HEADER_LEN_BYTES, "big"), header, _raw_bytes(kv)]
    if scale is not None:
        parts.append(_raw_bytes(scale))
    return b"".join(parts)


def _from_bytes(data, offset: int, dtype: torch.dtype, shape, pin_memory: bool) -> torch.Tensor:
    """A tensor of ``dtype`` and ``shape`` holding a copy of ``data``'s bytes
    at ``offset`` (pinned on request)."""
    n = int(np.prod(shape)) * torch.empty(0, dtype=dtype).element_size()
    raw = torch.empty(n, dtype=torch.uint8, pin_memory=pin_memory)
    if n:
        raw.numpy()[:] = np.frombuffer(data, np.uint8, n, offset)
    return raw.view(dtype).reshape(shape)


def unpack_handoff(data: bytes, pin_memory: bool = False) -> HandoffPacket:
    """Inverse of :func:`pack_handoff` (reads the JAX package's packets
    too). The KV and scales are copied out of ``data`` once, into pinned
    memory with ``pin_memory`` (a receiver on the card)."""
    hlen = int.from_bytes(data[:_HEADER_LEN_BYTES], "big")
    h = json.loads(bytes(data[_HEADER_LEN_BYTES : _HEADER_LEN_BYTES + hlen]))
    kv_dtype = _KV_DTYPES[h["kv_dtype"]][0]
    off = _HEADER_LEN_BYTES + hlen
    kv = _from_bytes(data, off, kv_dtype, h["kv_shape"], pin_memory)
    scale = None
    if h.get("scale_shape"):
        off += kv.numel() * kv.element_size()
        scale = _from_bytes(data, off, torch.float32, h["scale_shape"], pin_memory)
    s = h["sampling"]
    return HandoffPacket(
        prompt=np.asarray(h["prompt"], np.int32),
        first_token=h["first_token"],
        kv=kv,
        sampling=SamplingParams(
            temperature=s["temperature"],
            top_p=s["top_p"],
            top_k=s.get("top_k", 0),  # absent in pre-top-k packets
            max_new_tokens=s["max_new_tokens"],
            stop_token_ids=tuple(s["stop_token_ids"]),
        ),
        rid=h["rid"],
        submit_time=h["submit_time"],
        first_token_time=h["first_token_time"],
        kv_start=h.get("kv_start", 0),
        kv_scale=scale,
        traced=bool(h.get("traced", False)),
        trace_id=int(h.get("trace_id", 0)),
        chunk_seq=int(h.get("chunk_seq", -1)),
        chunk_of=int(h.get("chunk_of", 0)),
    )
