"""KV-page movement between ranks of one mesh axis (the JAX package's
``parallel/kv_transfer.py``).

The bytes path of the disaggregated handoff (``engine/disagg.py``
``pack_handoff``) crosses hosts over a framed transport. When the prefill
and the decode ranks are processes of one job, a handoff's page block can
move as a point-to-point tensor transfer over the job's process group
instead (``engine/disagg.IciHandoff``). Prefill and decode ranks are
indices along one mesh axis: prefill ``[0, P)`` then decode ``[P, P + D)``,
the reference's global rank space.

The transport is the mesh's backend (``parallel/collectives.py``): with
nccl across two cards the block moves device to device; ranks that share
one card must use gloo, which moves it through pinned host memory. Nothing
falls back: a backend that cannot move the tensor raises.

The JAX version pads a block to a static page count for ``jit``; a
process group takes any shape, so blocks move as they are.
"""

from __future__ import annotations

import torch

from radixmesh_tpu_torch.parallel.collectives import permute

__all__ = ["make_kv_page_transfer", "prefill_to_decode_perm"]


def prefill_to_decode_perm(n_prefill: int, n_decode: int) -> list[tuple[int, int]]:
    """Source→destination index pairs sending each prefill rank's block to a
    decode rank. Ranks follow the reference's global rank space: prefill
    ``[0, P)`` then decode ``[P, P+D)`` (``config/cache_config.py:20-28``).

    Requires ``n_prefill <= n_decode``: one permutation needs unique
    destinations, and a destination buffer can hold one source block. With
    more prefill than decode ranks, issue one transfer per round of
    ``n_decode`` senders instead (each round is a valid injective map)."""
    if n_prefill <= 0 or n_decode <= 0:
        raise ValueError("need at least one prefill and one decode rank")
    if n_prefill > n_decode:
        raise ValueError(
            f"{n_prefill} prefill ranks cannot hand off to {n_decode} decode "
            "ranks in one transfer (destinations must be unique); batch the "
            "handoff into ceil(P/D) rounds"
        )
    return [(i, n_prefill + i) for i in range(n_prefill)]


def make_kv_page_transfer(mesh, axis_name: str, perm: list[tuple[int, int]]):
    """Returns ``transfer(block)``, collective over ``axis_name``: every rank
    of the axis passes a block of one shape (its page batch); each source
    rank's block lands on its destination rank. Ranks that are not a
    destination get zeros: the caller's page table decides what is live,
    so junk pages are never referenced (the engine's scratch-page
    discipline)."""
    n = mesh.size(axis_name)
    for src, dst in perm:
        if not (0 <= src < n and 0 <= dst < n):
            raise ValueError(f"pair ({src}->{dst}) outside axis {axis_name} of size {n}")

    def transfer(block: torch.Tensor) -> torch.Tensor:
        return permute(block, mesh, axis_name, perm)

    return transfer
