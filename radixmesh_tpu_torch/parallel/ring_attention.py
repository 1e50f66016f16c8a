"""Ring attention: causal self-attention over a sequence sharded across the
``sp`` ranks (the JAX package's ``parallel/ring_attention.py``).

Each rank keeps its query block; the K/V blocks travel around the ring
(``parallel/collectives.ring_shift``: ``batch_isend_irecv`` to the next
rank, from the previous one), and the next block's transfer is in flight
while the current block's products run. Query block ``i`` attends fully to
earlier blocks, triangularly to its own and not at all to later ones; the
online softmax (running max, sum and accumulator in float32) makes the
blockwise result exact. The block products are ``torch`` einsums in
float32, as the JAX body is ``jnp``.
"""

from __future__ import annotations

import math

import torch

from radixmesh_tpu_torch.parallel.collectives import all_gather, ring_shift
from radixmesh_tpu_torch.parallel.sharding import ProcessMesh

__all__ = ["ring_attention", "ring_self_attention"]

_NEG_INF = -1e30
_SCORE_BYTES = 1 << 28


def ring_attention(
    q: torch.Tensor,  # [B, C, Hq, D] this rank's query block
    k: torch.Tensor,  # [B, C, Hkv, D] this rank's key block
    v: torch.Tensor,  # [B, C, Hkv, D]
    mesh: ProcessMesh,
    axis: str = "sp",
) -> torch.Tensor:
    """Every rank of ``axis`` calls it with its own sequence block (block
    ``i`` holds positions ``[i*C, (i+1)*C)``). Returns the local output
    block ``[B, C, Hq, D]`` in q's dtype."""
    n = mesh.size(axis)
    idx = mesh.index(axis)
    b, c, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = (q.float() * (1.0 / math.sqrt(d))).reshape(b, c, hkv, g, d)
    q_pos = idx * c + torch.arange(c, device=q.device)
    m = torch.full((b, hkv, g, c), float("-inf"), device=q.device)
    l = torch.zeros((b, hkv, g, c), device=q.device)
    acc = torch.zeros((b, hkv, g, c, d), device=q.device)
    # Kv heads per score block: at most _SCORE_BYTES of float32 scores at a
    # time (an 8192-token prompt over 2 ranks would otherwise hold 2 GB of
    # scores, and their softmax temporaries, per layer).
    hb = max(1, min(hkv, _SCORE_BYTES // (4 * b * g * c * c)))
    k_cur, v_cur = k, v
    for step in range(n):
        # Start the next rotation before this block's products.
        shift = ring_shift([k_cur, v_cur], mesh, axis) if step + 1 < n else None
        j = (idx - step) % n  # the block held now
        kv_pos = j * c + torch.arange(c, device=q.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
        for h in range(0, hkv, hb):
            hs = slice(h, h + hb)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg[:, :, hs], k_cur[:, :, hs].float())
            s = torch.where(mask, s, _NEG_INF)
            m_new = torch.maximum(m[:, hs], s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m[:, hs] - m_new)
            l[:, hs] = l[:, hs] * corr + p.sum(dim=-1)
            acc[:, hs] = acc[:, hs] * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v_cur[:, :, hs].float())
            m[:, hs] = m_new
            del s, p
        if shift is not None:
            # meshcheck: ok[timeout-audit] the ring's K/V shift is bounded by the process
            # group's timeout (init_multihost(timeout_s=), parallel/multihost.py): an unmatched
            # collective ends in an error, never a hang. No timeout= here: on NCCL it would turn
            # the stream-side wait into a host-blocking one.
            k_cur, v_cur = shift.wait()
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, c, hq, d).to(q.dtype)


def ring_self_attention(
    q: torch.Tensor,  # [B, S, Hq, D] the whole sequence, on every rank
    k: torch.Tensor,  # [B, S, Hkv, D]
    v: torch.Tensor,
    mesh: ProcessMesh,
    axis: str = "sp",
) -> torch.Tensor:
    """Convenience: cut the sequence of full tensors into ``axis`` blocks,
    run :func:`ring_attention` on this rank's and gather the blocks back
    (every rank returns the whole ``[B, S, Hq, D]``). ``S`` must divide by
    the axis size."""
    n, i = mesh.size(axis), mesh.index(axis)
    S = q.shape[1]
    if S % n:
        raise ValueError(f"sequence length {S} does not divide {axis}={n}")
    c = S // n
    blk = slice(i * c, (i + 1) * c)
    out = ring_attention(q[:, blk].contiguous(), k[:, blk].contiguous(), v[:, blk].contiguous(),
                         mesh, axis)
    return all_gather(out, mesh, axis, dim=1)
