"""Eviction counters by cause (the port's copy of ``EVICTION_CAUSES`` and
``eviction_counters`` from the JAX package's ``obs/fleet_plane.py``; the
rest of that module, the fleet digest and view, is not ported)."""

from __future__ import annotations

from radixmesh_tpu_torch.obs.metrics import get_registry

__all__ = ["EVICTION_CAUSES", "eviction_counters"]

# Eviction causes every dashboard distinguishes: pressure (capacity /
# preempt — the pool is too small for the traffic) vs policy (ttl expiry /
# mesh replica trim — deliberate bounds; the port's engine evicts only
# under pressure).
EVICTION_CAUSES = ("capacity", "ttl", "preempt", "mesh_trim")


def eviction_counters(node: str):
    """Per-cause eviction counter children for one node/engine label —
    the single registration point, so the family's label schema cannot
    drift. All four children materialize eagerly so the series exist at 0
    from process start."""
    fam = get_registry().counter(
        "radixmesh_cache_evicted_tokens_total",
        "KV tokens evicted from the radix cache, by cause (capacity/"
        "preempt = pool pressure; ttl/mesh_trim = policy bounds)",
        ("node", "cause"),
    )
    return {c: fam.labels(node=node, cause=c) for c in EVICTION_CAUSES}
