"""Ulysses sequence parallelism: two all-to-all swaps between sequence and
heads (the JAX package's ``parallel/ulysses.py``).

1. The inputs arrive sequence-sharded ``[B, S/n, H, D]``; an all-to-all
   turns them head-sharded ``[B, S, H/n, D]``: each rank sees the whole
   sequence for its slice of heads.
2. Dense causal attention runs locally (:func:`_dense_causal`).
3. A second all-to-all swaps the output back to sequence-sharded.

It needs ``Hq % n == 0``. With fewer kv heads than ranks (GQA) the K/V
cannot be split ``n`` ways, so they are all-gathered over the axis instead
and each rank slices the kv heads its query heads attend to; the query-head
span per rank and the group size must divide one another.
"""

from __future__ import annotations

import math

import torch

from radixmesh_tpu_torch.parallel.collectives import all_gather, all_to_all
from radixmesh_tpu_torch.parallel.sharding import ProcessMesh

__all__ = ["ulysses_attention", "ulysses_self_attention"]

_NEG_INF = -1e30


def _dense_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal attention; q [B,S,Hq,D], k/v [B,S,Hkv,D]."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = (q.float() * (1.0 / math.sqrt(d))).reshape(b, s, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    pos = torch.arange(s, device=q.device)
    scores = torch.where(pos[:, None] >= pos[None, :], scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d).to(q.dtype)


def _seq_to_heads(x: torch.Tensor, mesh: ProcessMesh, axis: str) -> torch.Tensor:
    """[B, s, H, D] (this rank's sequence block) -> [B, n*s, H/n, D] (this
    rank's heads over the whole sequence)."""
    n = mesh.size(axis)
    b, s, h, d = x.shape
    blocks = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4)  # [n, B, s, H/n, D]
    got = all_to_all(blocks, mesh, axis)  # block i: rank i's sequence block
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)


def _heads_to_seq(x: torch.Tensor, mesh: ProcessMesh, axis: str) -> torch.Tensor:
    """[B, S, h, D] (this rank's heads) -> [B, S/n, n*h, D] (this rank's
    sequence block, every head)."""
    n = mesh.size(axis)
    b, S, h, d = x.shape
    blocks = x.reshape(b, n, S // n, h, d).permute(1, 0, 2, 3, 4)  # [n, B, S/n, h, D]
    got = all_to_all(blocks, mesh, axis)  # block i: rank i's heads
    return got.permute(1, 2, 0, 3, 4).reshape(b, S // n, n * h, d)


def ulysses_attention(
    q: torch.Tensor,  # [B, S/n, Hq, D] this rank's sequence block
    k: torch.Tensor,  # [B, S/n, Hkv, D]
    v: torch.Tensor,
    mesh: ProcessMesh,
    axis: str = "sp",
) -> torch.Tensor:
    """Every rank of ``axis`` calls it with its sequence block; returns the
    local output ``[B, S/n, Hq, D]``."""
    n = mesh.size(axis)
    hq, hkv = q.shape[2], k.shape[2]
    if hq % n:
        raise ValueError(f"Ulysses needs query heads ({hq}) divisible by sp ({n})")
    ql = _seq_to_heads(q, mesh, axis)
    if hkv % n == 0:
        kl, vl = _seq_to_heads(k, mesh, axis), _seq_to_heads(v, mesh, axis)
    else:
        # GQA with fewer kv heads than ranks: replicate K/V (G x smaller
        # than Q) and slice the group each local query-head slice reads.
        kg = all_gather(k, mesh, axis, dim=1)
        vg = all_gather(v, mesh, axis, dim=1)
        g = hq // hkv  # query heads per kv head
        span = hq // n  # query heads per rank
        if span % g and g % span:
            raise ValueError(
                f"Ulysses GQA needs query-head span ({span}) and group size ({g}) to divide "
                "one another; use ring attention instead"
            )
        kv_lo = mesh.index(axis) * span // g
        kv_span = max(1, span // g)
        kl, vl = kg[:, :, kv_lo:kv_lo + kv_span], vg[:, :, kv_lo:kv_lo + kv_span]
    out = _dense_causal(ql, kl, vl)
    return _heads_to_seq(out, mesh, axis)


def ulysses_self_attention(
    q: torch.Tensor,  # [B, S, Hq, D] the whole sequence, on every rank
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: ProcessMesh,
    axis: str = "sp",
) -> torch.Tensor:
    """Convenience mirroring ``ring_self_attention``: this rank's sequence
    block through :func:`ulysses_attention`, the blocks gathered back."""
    n, i = mesh.size(axis), mesh.index(axis)
    S = q.shape[1]
    if S % n:
        raise ValueError(f"sequence length {S} does not divide {axis}={n}")
    c = S // n
    blk = slice(i * c, (i + 1) * c)
    out = ulysses_attention(q[:, blk].contiguous(), k[:, blk].contiguous(), v[:, blk].contiguous(),
                            mesh, axis)
    return all_gather(out, mesh, axis, dim=1)
