"""Ring-sync topology policy: who sends to whom, and how long oplogs live.

Capability parity with the reference's ``policy/sync_algo.py``:

- The replication topology is a **unidirectional ring of prefill + decode
  nodes** (prefill ranks first, then decode), successor = ``(rank+1) % N``
  (``sync_algo.py:57-75``). Routers sit *outside* the ring and receive a
  fan-out copy of every oplog from the **master** (global rank 0, the first
  prefill node — ``sync_algo.py:54-55``, ``radix_mesh.py:344-347``).
- TTLs count ring hops: data oplogs live one full lap (``ttl = N``), ticks
  live two laps for two-round topology verification (``sync_algo.py:98-104``,
  reference ``README.md:91-93``), GC queries one lap so unanimity can be
  counted at the origin (``sync_algo.py:106-107``).
- Send/receive permissions: prefill + decode send, everyone receives,
  routers never send (``sync_algo.py:80-96``). The tick originator is the
  first decode node, falling back to the master when there are no decode
  nodes (the reference has no fallback, ``sync_algo.py:109-110``).

This layer is transport-agnostic: it only names addresses; the actual wire
lives in ``comm/``. Across hosts the same policy drives the oplog ring,
while KV-page payloads move on their own path (``engine/disagg.py``;
SURVEY §5 "Distributed communication backend").
"""

from __future__ import annotations

import abc
from dataclasses import dataclass

from radixmesh_tpu_torch.config import MeshConfig, NodeRole

__all__ = ["TopoResult", "BaseSyncAlgo", "RingSyncAlgo", "get_sync_algo"]


@dataclass
class TopoResult:
    """This node's view of the topology (reference ``sync_algo.py:10-14``)."""

    next_node: str | None  # ring successor address (None for routers)
    routers: list[str]  # router addresses to fan out to (master only)
    bind_addr: str  # address this node listens on


class BaseSyncAlgo(abc.ABC):
    """Strategy interface (reference ``sync_algo.py:16-47``)."""

    @abc.abstractmethod
    def topo(self, cfg: MeshConfig) -> TopoResult: ...

    @abc.abstractmethod
    def master_rank(self, cfg: MeshConfig) -> int: ...

    @abc.abstractmethod
    def ring(self, cfg: MeshConfig) -> list[str]: ...

    @abc.abstractmethod
    def can_send(self, cfg: MeshConfig) -> bool: ...

    @abc.abstractmethod
    def can_recv(self, cfg: MeshConfig) -> bool: ...

    def view_tick_origin(self, cfg: MeshConfig, alive) -> int:
        """Tick origin for a RUNTIME membership view (``alive`` = iterable
        of alive global ranks). Defaults to the static origin; algos
        override to fail origination over when it dies."""
        return self.tick_origin_rank(cfg)

    @abc.abstractmethod
    def tick_origin_rank(self, cfg: MeshConfig) -> int:
        """Global rank of the node that originates heartbeat ticks — the
        rank every node's startup barrier watches for."""

    @abc.abstractmethod
    def data_ttl(self, cfg: MeshConfig) -> int: ...

    @abc.abstractmethod
    def tick_ttl(self, cfg: MeshConfig) -> int: ...

    @abc.abstractmethod
    def gc_ttl(self, cfg: MeshConfig) -> int: ...


class RingSyncAlgo(BaseSyncAlgo):
    """The sole production policy (reference ``sync_algo.py:50-110``)."""

    def ring(self, cfg: MeshConfig) -> list[str]:
        return list(cfg.prefill_nodes) + list(cfg.decode_nodes)

    def master_rank(self, cfg: MeshConfig) -> int:
        return 0  # first prefill node (sync_algo.py:54-55)

    def topo(self, cfg: MeshConfig) -> TopoResult:
        role, rank, _ = cfg.local_identity()
        if role is NodeRole.ROUTER:
            return TopoResult(next_node=None, routers=[], bind_addr=cfg.local_addr)
        ring = self.ring(cfg)
        successor = ring[(rank + 1) % len(ring)]
        routers = (
            list(cfg.router_nodes) if rank == self.master_rank(cfg) else []
        )  # only the master feeds routers (sync_algo.py:63-66)
        return TopoResult(next_node=successor, routers=routers, bind_addr=cfg.local_addr)

    def can_send(self, cfg: MeshConfig) -> bool:
        return cfg.local_role in (NodeRole.PREFILL, NodeRole.DECODE)

    def can_recv(self, cfg: MeshConfig) -> bool:
        return True

    def tick_origin_rank(self, cfg: MeshConfig) -> int:
        # INITIAL tick origin: the first decode node (sync_algo.py:109-110),
        # falling back to the master when the cluster has no decode nodes.
        return cfg.num_prefill if cfg.num_decode > 0 else self.master_rank(cfg)

    def view_tick_origin(self, cfg: MeshConfig, alive) -> int:
        # Runtime origination follows the view so a dead origin fails
        # over: lowest alive decode rank, else lowest alive rank. On the
        # initial full view this equals ``tick_origin_rank``.
        alive = list(alive)
        decode = [r for r in alive if cfg.is_decode_rank(r)]
        pool = decode or alive
        return min(pool) if pool else self.tick_origin_rank(cfg)

    def data_ttl(self, cfg: MeshConfig) -> int:
        return cfg.num_ring  # one full lap (sync_algo.py:98-101)

    def tick_ttl(self, cfg: MeshConfig) -> int:
        return 2 * cfg.num_ring  # two-round verification (sync_algo.py:103-104)

    def gc_ttl(self, cfg: MeshConfig) -> int:
        return cfg.num_ring  # unanimity over one lap (sync_algo.py:106-107)


_ALGOS = {"ring": RingSyncAlgo}


def get_sync_algo(name: str = "ring") -> BaseSyncAlgo:
    """Factory (reference ``sync_algo.py:113-114``)."""
    try:
        return _ALGOS[name]()
    except KeyError:
        raise ValueError(f"unknown sync algo {name!r}; known: {sorted(_ALGOS)}")
