"""Master-free multi-writer conflict resolution.

Reference ``policy/conflict_resolve.py:1-6``: when two nodes insert
different KV values for the same token prefix, every node deterministically
keeps the value whose *origin rank* is lowest — no coordination required,
and all replicas converge because the rule is a total order independent of
arrival order.
"""

from __future__ import annotations


class NodeRankConflictResolver:
    """Keep the existing value iff its origin rank is <= the new value's."""

    @staticmethod
    def keep(existing_rank: int, new_rank: int) -> bool:
        return existing_rank <= new_rank
