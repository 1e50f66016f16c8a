"""Two-level hierarchical replication topology (groups + leader spine).

The reference's open roadmap question — "better topo if nodes over some
number (like 50?)" (the reference's ``README.md:57``) — made concrete. On
the flat ring every oplog takes O(N) *serial* hops to propagate
(``RINGSCALE_r04.json``: lap p50 grows 12x from N=6 to N=50). Here the
static ring ranks are partitioned into contiguous **groups** of
``group_size``; each group runs its own small ring, and the **leaders**
(lowest alive rank per group) form a second ring — the **spine** — that
bridges groups. Propagation becomes

    origin --group lap--> leader --spine--> remote leaders --group laps-->

a critical path of O(group_size + N/group_size) serial hops, minimized at
``group_size ~ sqrt(N)`` (the crossover analysis lives in
ARCHITECTURE.md's ring-scale section).

Circulation rules (enforced by ``MeshCache._circulate``):

- An op originates on its **group ring** (scope GROUP, TTL = one group
  lap, so it returns to the origin like the flat ring's lap).
- The origin group's **leader**, on seeing a GROUP op originated in its
  own group, re-emits it on the **spine** (scope SPINE, TTL = one spine
  lap). A leader-origin emits both scopes directly.
- A leader receiving a SPINE op from another group forwards it along the
  spine and **injects** a GROUP copy into its own ring (TTL = one group
  lap, dying back at the injector by TTL — the injector is not the
  origin, so the origin-drop rule cannot terminate it).
- A SPINE op arriving at a leader whose group *contains the origin* has
  completed its spine lap and is dropped.

Every node applies each op at least once (idempotence tolerates the
leaders' double-copy overlap); total frames stay O(N) per op — the win is
the serial critical path, not byte volume.

All functions derive from (static config ranks, current alive set), so
elastic membership composes: view changes reshuffle leaders/successors
exactly like they reshuffle the flat ring's successor, and a dead leader
is succeeded by the next-lowest alive rank of its group.

Groups are STATIC partitions of the configured rank space — membership
holes (dead ranks) shrink a group but never re-partition it, so two nodes
always agree on ``group_of`` regardless of view skew.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Sequence

__all__ = ["HierPlan", "auto_group_size"]


def auto_group_size(ring_size: int) -> int:
    """sqrt(N) balances the two serial segments (group lap + spine lap)."""
    return max(2, int(round(math.sqrt(max(1, ring_size)))))


@dataclass(frozen=True)
class HierPlan:
    """Pure partition math for the two-level topology. ``ring_size`` is the
    STATIC ring member count (P+D); ``alive`` arguments are the current
    view's alive ranks (any iterable of ints)."""

    ring_size: int
    group_size: int

    def __post_init__(self):
        if self.group_size < 2:
            raise ValueError(f"group_size must be >= 2, got {self.group_size}")
        if self.ring_size < 1:
            raise ValueError("ring_size must be >= 1")

    # ---- static partition ----

    @property
    def n_static_groups(self) -> int:
        return (self.ring_size + self.group_size - 1) // self.group_size

    def group_of(self, rank: int) -> int:
        if not 0 <= rank < self.ring_size:
            raise ValueError(f"rank {rank} outside ring [0, {self.ring_size})")
        return rank // self.group_size

    def same_group(self, a: int, b: int) -> bool:
        return self.group_of(a) == self.group_of(b)

    def group_ranks(self, g: int) -> range:
        return range(
            g * self.group_size, min((g + 1) * self.group_size, self.ring_size)
        )

    # ---- alive-set-dependent structure ----

    def group_alive(self, g: int, alive: Iterable[int]) -> list[int]:
        lo, hi = g * self.group_size, min((g + 1) * self.group_size, self.ring_size)
        return sorted(r for r in alive if lo <= r < hi)

    def leader_of(self, g: int, alive: Iterable[int]) -> int | None:
        members = self.group_alive(g, alive)
        return members[0] if members else None

    def is_leader(self, rank: int, alive: Iterable[int]) -> bool:
        return self.leader_of(self.group_of(rank), alive) == rank

    def nonempty_groups(self, alive: Iterable[int]) -> list[int]:
        alive = list(alive)
        return [g for g in range(self.n_static_groups) if self.group_alive(g, alive)]

    def group_successor(self, rank: int, alive: Iterable[int]) -> int | None:
        """Next alive rank within ``rank``'s group, cyclic. None when alone
        (a sole member has nobody to ring — its leader duties still bridge
        the op onto the spine)."""
        members = self.group_alive(self.group_of(rank), alive)
        others = [r for r in members if r != rank]
        if not others:
            return None
        for r in others:
            if r > rank:
                return r
        return others[0]

    def spine_successor(self, rank: int, alive: Iterable[int]) -> int | None:
        """Leader of the next nonempty group, cyclic over groups. None when
        this group is the only nonempty one (degenerate: flat semantics)."""
        alive = list(alive)
        g = self.group_of(rank)
        groups = self.nonempty_groups(alive)
        nxt = [x for x in groups if x > g] + [x for x in groups if x < g]
        if not nxt:
            return None
        return self.leader_of(nxt[0], alive)

    # ---- TTLs (hops at each level) ----

    def group_ttl(self, rank: int, alive: Iterable[int]) -> int:
        """One full lap of ``rank``'s group ring (returns to the sender)."""
        return max(1, len(self.group_alive(self.group_of(rank), alive)))

    def spine_ttl(self, alive: Iterable[int]) -> int:
        """One full lap of the leader spine."""
        return max(1, len(self.nonempty_groups(alive)))

    # ---- diagnostics ----

    def describe(self, alive: Sequence[int]) -> str:
        parts = []
        for g in self.nonempty_groups(alive):
            members = self.group_alive(g, alive)
            parts.append(f"g{g}[{members[0]}*{',' if len(members) > 1 else ''}"
                         f"{','.join(str(r) for r in members[1:])}]")
        return " ".join(parts)
