"""Epoch-numbered topology views for elastic ring membership.

The reference lists node-failure detection and dynamic add/remove as
roadmap (``README.md:49-50``) and marks the missing topology-check thread
with a TODO (``radix_mesh.py:143-146``). Here membership is first-class:

- A :class:`TopologyView` is ``(epoch, alive ranks)``. Every node holds
  one; all TTLs and GC unanimity counts derive from the *current* view's
  ring size, not the static config.
- **Detection is sender-side**: the ring is unidirectional, so the only
  node that can reliably observe a death is the dead node's predecessor —
  its transmit channel stops delivering. After ``failure_timeout_s`` of
  undeliverable sends, the predecessor declares the successor dead, adopts
  ``(epoch+1, alive − dead)``, reconnects to the next alive rank, and
  rings a TOPO oplog announcing the view.
- **Higher epoch wins** on receipt. Concurrent detections (two failures,
  two detectors, same epoch, different alive sets) merge by adopting the
  intersection at ``epoch+1`` — monotonically shrinking, so it converges.
- **Rejoin**: a restarted node rings JOIN; the surviving view-master (the
  lowest alive rank) answers with a fresh view that re-includes it.

Views travel as oplogs (see ``cache/oplog.py``), so routers learn them via
the master fan-out like everything else, and use them to retire/restore
hash-ring members (``router/cache_aware_router.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from radixmesh_tpu_torch.config import MeshConfig

__all__ = ["TopologyView", "encode_view", "decode_view", "membership_gauges"]


@dataclass(frozen=True)
class TopologyView:
    """Immutable membership view: which P/D global ranks are alive."""

    epoch: int
    alive: tuple[int, ...]  # sorted global ranks of live ring members

    @classmethod
    def initial(cls, cfg: MeshConfig) -> "TopologyView":
        return cls(epoch=0, alive=tuple(range(cfg.num_ring)))

    @property
    def ring_size(self) -> int:
        return len(self.alive)

    def contains(self, rank: int) -> bool:
        return rank in self.alive

    def successor_of(self, rank: int) -> int | None:
        """Next alive rank after ``rank`` in ring order (ascending global
        rank with wraparound — the reference's prefill-then-decode order,
        ``sync_algo.py:57-75``). None if no *other* member is alive."""
        others = [r for r in self.alive if r != rank]
        if not others:
            return None
        for r in others:
            if r > rank:
                return r
        return others[0]

    def master_rank(self) -> int | None:
        """View master: the lowest alive rank (generalizes the reference's
        rank-0 master, ``sync_algo.py:54-55``, to survive rank 0 dying)."""
        return self.alive[0] if self.alive else None

    def without(self, rank: int) -> "TopologyView":
        return TopologyView(
            epoch=self.epoch + 1,
            alive=tuple(r for r in self.alive if r != rank),
        )

    def including(self, rank: int) -> "TopologyView":
        return TopologyView(
            epoch=self.epoch + 1,
            alive=tuple(sorted(set(self.alive) | {rank})),
        )

    def merged_with(self, other: "TopologyView") -> "TopologyView":
        """Deterministic resolution of an equal-epoch conflict: adopt the
        intersection one epoch up (both detectors' removals take effect)."""
        return TopologyView(
            epoch=self.epoch + 1,
            alive=tuple(sorted(set(self.alive) & set(other.alive))),
        )


def encode_view(view: TopologyView) -> np.ndarray:
    """Pack a view into an oplog value array: ``[epoch, *alive]``."""
    return np.asarray([view.epoch, *view.alive], dtype=np.int32)


def decode_view(value: np.ndarray) -> TopologyView:
    a = np.asarray(value, dtype=np.int32)
    if a.size < 1:
        raise ValueError("empty TOPO payload")
    return TopologyView(epoch=int(a[0]), alive=tuple(int(r) for r in a[1:]))


def membership_gauges(
    view: TopologyView,
    rank: int,
    *,
    alive: tuple[int, ...] | None = None,
    hier=None,
    succ_rank: int | None = None,
) -> dict[str, float]:
    """Gauge values for this node's membership state — failover and hier
    re-election were previously visible only in logs; ``MeshCache``
    exports these on ``/metrics`` (suffix-matched to the metric names it
    registers). ``hier`` is the node's :class:`~radixmesh_tpu_torch.policy.
    hierarchy.HierPlan` (None = flat ring, where "leader" means the view
    master); ``alive`` defaults to the view's alive set."""
    a = view.alive if alive is None else alive
    if hier is not None:
        leader = bool(hier.is_leader(rank, a))
        spine = len(hier.nonempty_groups(a))
    else:
        leader = view.master_rank() == rank
        spine = 0
    return {
        "view_epoch": float(view.epoch),
        "alive_nodes": float(len(view.alive)),
        "leader_flag": 1.0 if leader else 0.0,
        "spine_nodes": float(spine),
        "successor_rank": float(-1 if succ_rank is None else succ_rank),
    }
