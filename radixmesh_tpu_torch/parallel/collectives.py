"""The collectives of the port's parallel paths, over one axis of a
:class:`~radixmesh_tpu_torch.parallel.sharding.ProcessMesh`.

Each is a no-op on an axis of one rank. Two transports:

- ``nccl`` moves CUDA tensors device to device.
- ``gloo`` moves host memory: a CUDA tensor is copied to the host, the
  collective runs there and the result is copied back. This is how ranks
  that share one card communicate (NCCL refuses two ranks on one device),
  and it is also what gloo's point-to-point needs (it takes CPU tensors
  only). CPU tensors (the tests) move as they are.

Every call adds its wall time and payload bytes to :func:`collective_stats`
(a per-process tally, reset by :func:`reset_collective_stats`).
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
    """An in-flight :func:`ring_shift`; ``wait()`` returns the received
    tensors on the sender's device."""

    def __init__(self, works, recvs, device, t0, nbytes):
        self._works, self._recvs, self._device = works, recvs, device
        self._t0, self._nbytes = t0, nbytes

    def wait(self) -> list[torch.Tensor]:
        for w in self._works:
            w.wait()
        out = [r.to(self._device) for r in self._recvs]
        _note("ring_shift", self._t0, self._nbytes)
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
