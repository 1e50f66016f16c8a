"""Consistent-hash ring for cold-start routing.

Capability parity with the reference's ``ConsistentHash``
(``router/cache_aware_router.py:42-121``): virtual nodes, sorted ring,
bisect lookup with wraparound, dynamic add/remove. Differences by design:
blake2b instead of truncated MD5 (faster, no deprecation baggage), and the
ring is built once and mutated incrementally instead of rebuilt per call
(the reference constructs a fresh ring on every miss,
``cache_aware_router.py:30-37`` — O(nodes log nodes) per request).
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from typing import Iterable, Sequence

__all__ = ["ConsistentHash"]


def _hash32(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=4).digest(), "big")


class ConsistentHash:
    """Ring of node addresses with ``virtual_nodes`` replicas each."""

    def __init__(self, nodes: Iterable[str] = (), virtual_nodes: int = 3):
        self.virtual_nodes = virtual_nodes
        self._ring: list[int] = []  # sorted hash points
        self._owner: dict[int, str] = {}
        # add/remove run on the mesh transport-reader thread (topology view
        # changes) while get_node serves requests on other threads.
        self._lock = threading.Lock()
        for node in nodes:
            self.add_node(node)

    def _points(self, node: str) -> list[int]:
        return [
            _hash32(f"{node}#{i}".encode()) for i in range(self.virtual_nodes)
        ]

    def add_node(self, node: str) -> None:
        with self._lock:
            for h in self._points(node):
                if h in self._owner:  # hash collision: first owner keeps it
                    continue
                bisect.insort(self._ring, h)
                self._owner[h] = node

    def remove_node(self, node: str) -> None:
        with self._lock:
            for h in self._points(node):
                if self._owner.get(h) == node:
                    self._ring.remove(h)
                    del self._owner[h]

    @staticmethod
    def _key_bytes(key: Sequence[int] | bytes | str) -> bytes:
        if isinstance(key, str):
            return key.encode()
        if isinstance(key, bytes):
            return key
        return b",".join(str(int(t)).encode() for t in key)

    def get_node(
        self,
        key: Sequence[int] | bytes | str,
        exclude: set[str] | None = None,
    ) -> str | None:
        """Owner of ``key``: first ring point clockwise from hash(key)
        whose owner is not in ``exclude`` (overload shedding needs the
        next-best owner when the natural one is the node being avoided);
        ``None`` when every owner is excluded."""
        h = _hash32(self._key_bytes(key))
        with self._lock:
            if not self._ring:
                return None
            idx = bisect.bisect_right(self._ring, h)
            for step in range(len(self._ring)):
                owner = self._owner[self._ring[(idx + step) % len(self._ring)]]
                if not exclude or owner not in exclude:
                    return owner
            return None

    def get_nodes(
        self,
        key: Sequence[int] | bytes | str,
        n: int,
        exclude: set[str] | None = None,
    ) -> list[str]:
        """The first ``n`` DISTINCT owners clockwise from hash(key) — the
        replication-factor successor walk (cache/sharding.py): owner sets
        are a deterministic pure function of (ring membership, key), so
        every node derives the same set from the same view with no
        coordination. Wraps around the ring; returns fewer than ``n``
        when the ring holds fewer distinct nodes (the N < RF degeneracy —
        every node owns everything). Walk order is preserved: the first
        entry is the natural single owner (``get_node``'s answer)."""
        if n <= 0:
            return []
        h = _hash32(self._key_bytes(key))
        out: list[str] = []
        seen: set[str] = set()
        with self._lock:
            if not self._ring:
                return []
            idx = bisect.bisect_right(self._ring, h)
            for step in range(len(self._ring)):
                owner = self._owner[self._ring[(idx + step) % len(self._ring)]]
                if owner in seen or (exclude and owner in exclude):
                    continue
                seen.add(owner)
                out.append(owner)
                if len(out) == n:
                    break
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(set(self._owner.values()))
