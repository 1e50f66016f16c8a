"""The collectives of the port's parallel paths, over one axis of a
:class:`~radixmesh_tpu_torch.parallel.sharding.ProcessMesh`.

Each is a no-op on an axis of one rank. Besides the collectives, the
point-to-point moves of the pipeline and the device handoff: :func:`p2p`
(a send to one index and a receive from another, posted together),
:func:`pipe_shift` (the non-cyclic shift ``i -> i + 1`` of the JAX
``ppermute`` with ``[(i, i + 1)]``, one send and one receive a rank, so a
stage may receive without sending and the other way round),
:func:`permute` (a ``ppermute`` over a whole permutation) and
:func:`broadcast`. Two transports:

- ``nccl`` moves CUDA tensors device to device.
- ``gloo`` moves host memory: a CUDA tensor is copied to the host, the
  collective runs there and the result is copied back. This is how ranks
  that share one card communicate (NCCL refuses two ranks on one device),
  and it is also what gloo's point-to-point needs (it takes CPU tensors
  only). CPU tensors (the tests) move as they are.

Every call adds its wall time and payload bytes to :func:`collective_stats`
(a per-process tally, reset by :func:`reset_collective_stats`).

The collectives above detach their inputs: no gradient crosses a rank. The
training path (``parallel/train.py``, the pipeline's train step) calls their
differentiable counterparts, each an ``autograd.Function`` over the same
call, which under ``torch.is_grad_enabled()`` false (the serving forwards
run under ``inference_mode``) are the plain call:

- :func:`copy_to` — identity forward, all-reduce backward (Megatron's ``f``:
  before a column-parallel product, whose replicated input gets only a
  partial gradient on each rank);
- :func:`reduce_from` — all-reduce forward, identity backward (Megatron's
  ``g``: after a row-parallel product, a vocab-parallel embedding, a loss
  summed over the data ranks);
- :func:`gather_from` — all-gather forward, this rank's slice of the
  gradient backward (the vocab-parallel LM head: every rank computes the
  same loss from the whole row);
- :func:`gather_seq` — all-gather forward, reduce-scatter (sum) backward
  (K and V over sp: every rank's queries read every block);
- :func:`broadcast_from` — broadcast forward; backward, the source keeps
  one copy of its gradient and the others pass none (the pipeline's last
  stage: every rank computes the same loss from the broadcast state).

:func:`all_reduce_coalesced` sums a list of tensors in place in buckets (a
step's gradients over the data ranks).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

__all__ = [
    "all_reduce",
    "all_gather",
    "all_to_all",
    "ring_shift",
    "p2p",
    "pipe_shift",
    "permute",
    "broadcast",
    "copy_to",
    "reduce_from",
    "gather_from",
    "gather_seq",
    "broadcast_from",
    "all_reduce_coalesced",
    "collective_stats",
    "reset_collective_stats",
]

_STATS: dict = {}


def collective_stats() -> dict:
    """``{op: {"calls", "seconds", "bytes"}}`` since the last reset."""
    return {k: dict(v) for k, v in _STATS.items()}


def reset_collective_stats() -> None:
    _STATS.clear()


def _note(op: str, t0: float, nbytes: int) -> None:
    s = _STATS.setdefault(op, {"calls": 0, "seconds": 0.0, "bytes": 0})
    s["calls"] += 1
    s["seconds"] += time.perf_counter() - t0
    s["bytes"] += int(nbytes)


def _host(mesh, x: torch.Tensor) -> bool:
    """Whether ``x`` moves through host memory on ``mesh``'s transport."""
    return x.is_cuda and mesh.backend == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of CUDA tensor ``x`` (the caching host allocator
    reuses the pinned blocks from call to call)."""
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x.detach())
    return out


def all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (a new tensor; ``x`` is not changed)."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    t0 = time.perf_counter()
    buf = _to_host(x) if _host(mesh, x) else x.detach().clone()
    dist.all_reduce(buf, group=mesh.group(axis))
    out = buf.to(x.device) if _host(mesh, x) else buf
    _note("all_reduce", t0, x.numel() * x.element_size())
    return out


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated in rank order along
    ``dim``."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    t0 = time.perf_counter()
    host = _host(mesh, x)
    src = _to_host(x) if host else x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size(axis))]
    dist.all_gather(parts, src, group=mesh.group(axis))
    out = torch.cat(parts, dim=dim)
    if host:
        out = out.to(x.device)
    _note("all_gather", t0, x.numel() * x.element_size() * mesh.size(axis))
    return out


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x [n, ...]``: block ``j`` of dim 0 goes to rank ``j`` of ``axis``;
    the result's block ``i`` came from rank ``i``."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    t0 = time.perf_counter()
    host = _host(mesh, x)
    src = _to_host(x) if host else x.detach().contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group(axis))
    if host:
        out = out.to(x.device)
    _note("all_to_all", t0, x.numel() * x.element_size())
    return out


class _Shift:
    """An in-flight :func:`ring_shift` or :func:`p2p`; ``wait()`` returns the
    received tensors on ``device`` (sent tensors may be reused only after
    it)."""

    def __init__(self, works, recvs, device, t0, nbytes, op="ring_shift"):
        self._works, self._recvs, self._device = works, recvs, device
        self._t0, self._nbytes, self._op = t0, nbytes, op

    def wait(self) -> list[torch.Tensor]:
        for w in self._works:
            # meshcheck: ok[timeout-audit] a process-group Work is bounded by the process
            # group's timeout (init_multihost(timeout_s=), parallel/multihost.py): an unmatched
            # collective ends in an error, never a hang. No timeout= here: on NCCL it would turn
            # the stream-side wait into a host-blocking one.
            w.wait()
        out = [r.to(self._device) for r in self._recvs]
        _note(self._op, self._t0, self._nbytes)
        return out


def ring_shift(xs: list[torch.Tensor], mesh, axis: str) -> _Shift:
    """Start sending each of ``xs`` to the next rank of ``axis`` (index + 1,
    wrapping) while receiving the previous rank's, with
    ``batch_isend_irecv``; ``.wait()`` returns the received tensors. The
    caller may compute while the shift is in flight."""
    t0 = time.perf_counter()
    n, i = mesh.size(axis), mesh.index(axis)
    host = any(_host(mesh, x) for x in xs)
    sends = [_to_host(x) if host else x.detach().contiguous() for x in xs]
    recvs = [torch.empty_like(s) for s in sends]
    nxt, prv = mesh.peer(axis, i + 1), mesh.peer(axis, i - 1)
    group = mesh.group(axis)
    ops = []
    for s, r in zip(sends, recvs):
        ops.append(dist.P2POp(dist.isend, s, nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    works = dist.batch_isend_irecv(ops)
    nbytes = sum(s.numel() * s.element_size() for s in sends)
    return _Shift(works, recvs, xs[0].device, t0, nbytes)


def p2p(mesh, axis: str, send=(), to: int | None = None, recv_like=(), frm: int | None = None,
        device=None) -> _Shift:
    """Start sending each of ``send`` to index ``to`` of ``axis`` and receiving
    a tensor shaped like each of ``recv_like`` from index ``frm``, posted
    together through ``batch_isend_irecv`` (either side may be empty or its
    index None); ``.wait()`` returns the received tensors on ``device`` (by
    default that of the first tensor given). Under gloo a CUDA tensor goes
    through pinned host memory both ways. Tallied as ``p2p``: the bytes this
    rank sends and receives."""
    t0 = time.perf_counter()
    send = list(send) if to is not None else []
    recv_like = list(recv_like) if frm is not None else []
    first = (send + recv_like)[0] if send or recv_like else None
    device = device if device is not None else (first.device if first is not None else None)
    host = any(_host(mesh, x) for x in send + recv_like)
    sends = [_to_host(x) if host else x.detach().contiguous() for x in send]
    recvs = [torch.empty(r.shape, dtype=r.dtype, pin_memory=host) if host else torch.empty_like(r)
             for r in recv_like]
    group = mesh.group(axis)
    ops = [dist.P2POp(dist.isend, s, mesh.peer(axis, to), group) for s in sends]
    ops += [dist.P2POp(dist.irecv, r, mesh.peer(axis, frm), group) for r in recvs]
    works = dist.batch_isend_irecv(ops) if ops else []
    nbytes = sum(x.numel() * x.element_size() for x in sends + recvs)
    return _Shift(works, recvs, device, t0, nbytes, op="p2p")


def pipe_shift(send, mesh, axis: str, recv_like=()) -> _Shift:
    """The non-cyclic shift along ``axis`` (the JAX ``ppermute`` with
    ``[(i, i + 1)]``): start sending each of ``send`` to index + 1 (none from
    the last index) and receiving tensors like ``recv_like`` from index - 1
    (none at index 0). Pass either side empty to only send or only
    receive."""
    n, i = mesh.size(axis), mesh.index(axis)
    return p2p(mesh, axis, send, i + 1 if i < n - 1 else None, recv_like, i - 1 if i > 0 else None)


def permute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """The JAX ``ppermute`` of ``x`` over ``axis``: every rank passes a
    tensor of one shape; for each ``(src, dst)`` of ``perm`` (indices along
    ``axis``, destinations unique) the source's ``x`` lands on the
    destination; a rank that is no destination gets zeros."""
    i = mesh.index(axis)
    dst = next((d for s, d in perm if s == i), None)
    src = next((s for s, d in perm if d == i), None)
    if len({d for _, d in perm}) != len(perm):
        raise ValueError(f"permutation {perm} has repeated destinations")
    if dst == i and src == i:
        return x.clone()
    # meshcheck: ok[timeout-audit] the permutation's p2p is bounded by the process group's
    # timeout (init_multihost(timeout_s=), parallel/multihost.py): an unmatched collective ends
    # in an error, never a hang. No timeout= here: on NCCL it would turn the stream-side wait
    # into a host-blocking one.
    got = p2p(mesh, axis, [x], dst, [x], src).wait()
    return got[0] if got else torch.zeros_like(x)


def broadcast(x: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """Index ``src``'s ``x`` on every rank of ``axis`` (a new tensor on each;
    the others pass a tensor of the same shape and dtype, whose values are
    not read)."""
    if mesh is None or mesh.size(axis) == 1:
        return x
    t0 = time.perf_counter()
    host = _host(mesh, x)
    buf = _to_host(x) if host else x.detach().clone()
    dist.broadcast(buf, src=mesh.peer(axis, src), group=mesh.group(axis))
    out = buf.to(x.device) if host else buf
    _note("broadcast", t0, x.numel() * x.element_size())
    return out


# The largest bucket :func:`all_reduce_coalesced` flattens into one buffer.
_BUCKET_BYTES = 256 << 20


def all_reduce_coalesced(tensors, mesh, axis: str) -> None:
    """Sum each of ``tensors`` over ``axis`` in place, as few all-reduces as
    buckets of at most ``_BUCKET_BYTES`` (one dtype a bucket; a larger tensor
    is a bucket of its own): each bucket is flattened into one buffer,
    reduced and copied back, so the transient memory is one bucket."""
    if mesh is None or mesh.size(axis) == 1:
        return
    bucket: list = []
    size = 0

    def flush():
        nonlocal bucket, size
        if bucket:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            out = all_reduce(flat, mesh, axis)
            off = 0
            for t in bucket:
                t.copy_(out[off:off + t.numel()].view_as(t))
                off += t.numel()
        bucket, size = [], 0

    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > _BUCKET_BYTES or t.dtype != bucket[0].dtype):
            flush()
        bucket.append(t)
        size += nbytes
    flush()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.contiguous(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, reduce_back):
        ctx.slice = (dim, mesh.index(axis) * x.shape[dim], x.shape[dim])
        ctx.mesh, ctx.axis, ctx.reduce_back = mesh, axis, reduce_back
        return all_gather(x.contiguous(), mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_back:
            g = all_reduce(g.contiguous(), ctx.mesh, ctx.axis)
        return g.narrow(*ctx.slice), None, None, None, None


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, src):
        ctx.source = mesh.index(axis) == src
        return broadcast(x, mesh, axis, src)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.source else torch.zeros_like(g)), None, None, None


def _trains(mesh, axis: str) -> bool:
    """Whether a collective over ``axis`` moves anything and autograd is on."""
    return mesh is not None and mesh.size(axis) > 1 and torch.is_grad_enabled()


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` itself; under autograd its gradient is summed over ``axis``."""
    return _CopyTo.apply(x, mesh, axis) if _trains(mesh, axis) else x


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """:func:`all_reduce`; under autograd the gradient passes through as it
    is (every rank holds the same gradient of the sum)."""
    return _ReduceFrom.apply(x, mesh, axis) if _trains(mesh, axis) else all_reduce(x, mesh, axis)


def gather_from(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """:func:`all_gather`; under autograd each rank keeps its own slice of
    the gradient (every rank computes the same function of the whole)."""
    if not _trains(mesh, axis):
        return all_gather(x, mesh, axis, dim)
    return _GatherFrom.apply(x, mesh, axis, dim, False)


def gather_seq(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """:func:`all_gather`; under autograd the gradient is reduce-scattered:
    summed over ``axis`` (an all-reduce: gloo has no reduce-scatter) and
    this rank's slice kept (each rank's block is read by every rank)."""
    if not _trains(mesh, axis):
        return all_gather(x, mesh, axis, dim)
    return _GatherFrom.apply(x, mesh, axis, dim, True)


def broadcast_from(x: torch.Tensor, mesh, axis: str, src: int) -> torch.Tensor:
    """:func:`broadcast`; under autograd the source keeps one copy of its
    gradient (not the sum over ``axis``) and the other ranks' ``x``, whose
    values were never read, get zeros."""
    if not _trains(mesh, axis):
        return broadcast(x, mesh, axis, src)
    return _BroadcastFrom.apply(x, mesh, axis, src)
