"""The step agreement of an engine that spans several ranks.

A multi-rank engine (``Engine(device_mesh=...)`` over ``pp × sp × tp``
ranks) runs one scheduler per rank, and the ranks stay in step only because
every input a scheduler sees is the same on every rank: then every rank
takes the same decisions and issues the same collectives. The JAX engine
is one controller, so it never has to ask. Asynchronous sources break that
rule: a staged restore chunk lands when its copy event says so, a spill
commits when the plane's worker finishes it, a handoff packet or a prefetch
hint arrives on a transport thread of one rank, a mesh replica frees slots
from its apply thread, and the disk destage runs on a wall-clock cadence.

:class:`StepSync` makes them agree, once per scheduler pass, with one small
all-reduce (MIN over int64) over the engine's process group
(``ProcessMesh.engine_group``):

- **Completions.** Each rank contributes its count of locally completed
  items (restore units, spills), which complete in stream order, and a code
  per item (negated, so MIN is the largest): an item counts as done only
  when it is done on every rank, and as failed when it failed on any.
- **Cadences.** The leader (engine index 0) decides every time-based
  choice; the others contribute the largest int64, so MIN is the leader's
  value. The leader's monotonic clock rides in every pass, and the tree's
  clock under the agreement (:meth:`StepSync.clock`) reads it, so LRU order
  and node heat are the same on every rank.
- **Arrivals.** Sources registered with :meth:`StepSync.add_source` queue
  their inputs on the leader; a pass whose leader reports any broadcasts
  them (one object broadcast) and every rank applies them at the pass
  boundary.

A collective that fails or times out (``init_multihost``'s ``timeout_s``)
raises: nothing degrades to one rank. Each call is tallied in
``collective_stats()`` as ``agree`` (and ``agree_broadcast`` for arrivals).
"""

from __future__ import annotations

import pickle
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from radixmesh_tpu_torch.parallel.collectives import _note

__all__ = ["StepSync", "Source", "MeshPoolProxy", "NONE"]

# A non-leader's contribution to a leader field: MIN picks the leader's.
NONE = (1 << 63) - 1


class StepSync:
    """One engine's agreement over its ranks (module docstring). Every rank
    of the engine builds one, registers the same sources in the same
    order, and calls :meth:`agree` at the same points."""

    def __init__(self, mesh, device: torch.device):
        self.group = mesh.engine_group()
        if self.group is None:
            raise ValueError(
                f"the step agreement needs the engine's process group ({mesh}): build the mesh "
                "with make_mesh after init_multihost"
            )
        self.mesh = mesh
        self.leader = mesh.engine_index == 0
        self._src = mesh.engine_leader()
        # nccl reduces device tensors; gloo host ones.
        self._device = device if mesh.backend == "nccl" else torch.device("cpu")
        self.sources: dict[str, object] = {}
        self.passes = 0
        self.now = 0.0  # the leader's monotonic clock at the last pass, seconds
        self._ticks = 0

    def add_source(self, name: str, source) -> None:
        """Register an arrival source: ``pending() -> int`` and ``take()``
        are called on the leader, ``apply(payload)`` on every rank."""
        if name in self.sources:
            raise ValueError(f"arrival source {name!r} is already bound")
        self.sources[name] = source

    def clock(self) -> float:
        """The agreed clock: the leader's time at the last pass, plus a
        nanosecond per read since, so reads in one pass stay ordered."""
        self._ticks += 1
        return self.now + self._ticks * 1e-9

    def reduce_min(self, values: list[int]) -> list[int]:
        t0 = time.perf_counter()
        buf = torch.tensor(values, dtype=torch.int64, device=self._device)
        dist.all_reduce(buf, op=dist.ReduceOp.MIN, group=self.group)
        out = buf.tolist()
        _note("agree", t0, 8 * len(values))
        return out

    def broadcast(self, obj):
        """The leader's ``obj`` on every rank (the others pass None)."""
        t0 = time.perf_counter()
        box = [pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL) if self.leader else None]
        dist.broadcast_object_list(box, src=self._src, group=self.group)
        _note("agree_broadcast", t0, len(box[0]))
        return pickle.loads(box[0])

    def agree(self, local: list[int], leader: list[int]) -> tuple[list[int], list[int]]:
        """One pass: MIN of ``local`` over the ranks, the leader's
        ``leader`` fields, and the arrivals of every source applied on every
        rank. Returns ``(agreed local, leader fields)``."""
        names = list(self.sources)
        lead = [time.monotonic_ns(), *leader, *(int(self.sources[n].pending()) for n in names)]
        if not self.leader:
            lead = [NONE] * len(lead)
        out = self.reduce_min([int(v) for v in local] + lead)
        got, lead = out[: len(local)], out[len(local):]
        self.passes += 1
        self.now, self._ticks = lead[0] / 1e9, 0
        counts = lead[1 + len(leader):]
        if any(counts):
            payload = ({n: self.sources[n].take() for n, c in zip(names, counts) if c}
                       if self.leader else None)
            for n, items in self.broadcast(payload).items():
                self.sources[n].apply(items)
        return got, lead[1 : 1 + len(leader)]

    def any_rank(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any (a one-off
        decision, such as whether the leader binds a mesh replica)."""
        return self.reduce_min([-int(bool(flag))])[0] < 0

    def common(self, names: list[str]) -> set[str]:
        """The names every rank holds (the disk extents that verified on
        every rank at boot)."""
        t0 = time.perf_counter()
        every = [None] * dist.get_world_size(self.group)
        dist.all_gather_object(every, sorted(names), group=self.group)
        _note("agree_gather", t0, sum(len(n) for n in names))
        keep = set(every[0])
        for other in every[1:]:
            keep &= set(other)
        return keep


class Source:
    """An arrival source made of three callables (``StepSync.add_source``):
    ``pending() -> int`` and ``take()`` on the leader, ``apply(payload)`` on
    every rank."""

    def __init__(self, pending, take, apply):
        self.pending, self.take, self.apply = pending, take, apply


class MeshPoolProxy:
    """The pool a pool-bound mesh replica sees on the leader of an engine
    over several ranks. Only the leader holds the replica (the ring has one
    node per engine), but a slot it frees must be freed on every rank's
    allocator at the same point of the schedule: :meth:`free` (the replica's
    apply and GC threads) queues the ids, and the step agreement applies
    them on every rank at the next pass boundary (this object is also that
    arrival source). Everything else, ``allocator.is_allocated`` included,
    reads the local pool, whose allocator is equal on every rank."""

    def __init__(self, pool):
        self._pool = pool
        self._lock = threading.Lock()
        self._frees: list = []

    def __getattr__(self, name):
        return getattr(self._pool, name)

    def free(self, slots) -> None:
        slots = np.asarray(slots, dtype=np.int32).copy()
        if len(slots):
            with self._lock:
                self._frees.append(slots)

    def pending(self) -> int:
        with self._lock:
            return len(self._frees)

    def take(self) -> list:
        with self._lock:
            out, self._frees = self._frees, []
        return out

    def apply(self, frees: list) -> None:
        for slots in frees:
            self._pool.free(slots)
