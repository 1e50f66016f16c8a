"""Attention: dense prefill with cached-prefix reuse, the gather-based paged
references, and the dispatchers the model calls (the JAX package's
``ops/attention.py``).

- ``attend_prefill`` is plain PyTorch: the JAX package runs it as plain XLA,
  with no Pallas kernel behind it.
- ``attend_decode_ref`` and ``attend_chunk_hybrid`` are the gather-based
  references the JAX package holds its kernels against;
  ``attend_prefill_paged`` is the blockwise chunk attention over pages
  alone (the chunk already written to the pool), the oracle of
  ``attend_chunk_hybrid``'s merge. All three are plain PyTorch, as the JAX
  package runs them as plain XLA.
- ``paged_decode_attention`` / ``paged_chunk_attention`` /
  ``paged_attention_pool`` (with ``paged_attention_pool_bucketed`` and the
  single-layer ``paged_attention``) dispatch to the wrappers in
  ``ops/paged_attention.py``: a CUDA tensor launches the hand-written
  kernel (or raises), a CPU tensor takes the kernel's plain version. No
  argument selects the plain version for a CUDA tensor.
- Every paged entry takes an int8 pool with ``kv_scales [2, L, Hkv, P,
  page]`` float32 (``ops/quant.py``).
- ``paged_attention_pool_kernel_sharded``,
  ``paged_chunk_attention_kernel_sharded`` and ``paged_decode_fused_sharded``
  are the tensor-parallel entries, the unsharded kernel wrappers under the
  JAX package's names: each rank passes its local shard (Hq/tp query heads,
  a pool of Hkv/tp heads). Heads are independent in attention, so there is
  no collective here; the ``wo`` projection's all-reduce follows in the
  model, and the model calls the dispatchers above on its shards.
- ``select_paged`` is the engine's per-wave paged-vs-dense crossover for
  decode (``--paged-min-batch``), recorded for ``last_dispatch``. Its dense
  leg is the compact working set (``Llama.decode_multi_compact``), which on
  the card still runs the decode kernel, over the gathered sub-pool.

Layouts are the JAX package's: queries ``[B, S, Hq, D]``, the pool's pages
view ``[2, L, Hkv, P, page, D]``, page tables ``[B, max_pages]`` int32.
Query head ``h`` belongs to kv head ``h // G`` (``G = Hq // Hkv``).
"""

from __future__ import annotations

import math

import torch

from radixmesh_tpu_torch.ops.paged_attention import (
    paged_attention_pool_kernel,
    paged_chunk_attention_kernel,
    paged_decode_fused_kernel,
)
from radixmesh_tpu_torch.ops.quant import dequantize_kv

__all__ = [
    "attend_prefill",
    "attend_decode_ref",
    "attend_chunk_hybrid",
    "attend_prefill_paged",
    "batch_bucket",
    "default_use_kernel",
    "last_dispatch",
    "note_dispatch",
    "paged_attention",
    "paged_attention_pool",
    "paged_attention_pool_bucketed",
    "paged_attention_pool_kernel_sharded",
    "paged_chunk_attention",
    "paged_chunk_attention_kernel_sharded",
    "paged_decode_attention",
    "paged_decode_fused_sharded",
    "select_paged",
]

_NEG_INF = -1e30


def attend_prefill(
    q: torch.Tensor,  # [B, S_new, Hq, D]
    k: torch.Tensor,  # [B, S_ctx, Hkv, D] (cached prefix ++ new, rotated)
    v: torch.Tensor,  # [B, S_ctx, Hkv, D]
    q_positions: torch.Tensor,  # [B, S_new] index-space positions of q
    kv_lengths: torch.Tensor,  # [B] valid context end (index space)
    kv_start: torch.Tensor | None = None,  # [B] valid context begin
) -> torch.Tensor:
    """Causal attention where queries start mid-context: the query at
    index-space position ``p`` attends to ``[kv_start, min(p+1,
    kv_lengths))``. Queries are grouped per kv head instead of repeating
    K/V; scores and softmax are float32. Returns ``[B, S_new, Hq, D]``."""
    B, S_new, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.float().reshape(B, S_new, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    logits = logits * (1.0 / math.sqrt(D))
    kv_pos = torch.arange(k.shape[1], device=q.device)
    causal = kv_pos <= q_positions[:, None, None, :, None]  # [B,1,1,Q,K]
    valid = kv_pos < kv_lengths[:, None, None, None, None]
    if kv_start is not None:
        valid = valid & (kv_pos >= kv_start[:, None, None, None, None])
    logits = torch.where(causal & valid, logits, _NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", weights, v.float())
    return out.reshape(B, S_new, Hq, D).to(q.dtype)


def attend_decode_ref(
    q: torch.Tensor,  # [B, Hq, D]
    k_pages: torch.Tensor,  # [Hkv, P, page, D] one layer
    v_pages: torch.Tensor,  # [Hkv, P, page, D]
    page_table: torch.Tensor,  # [B, max_pages]
    lengths: torch.Tensor,  # [B] context length incl. current token
    k_scales: torch.Tensor | None = None,  # [Hkv, P, page] int8-pool scales
    v_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """Gather-based paged decode attention over ``lengths[b]`` pool tokens
    (the JAX package's numerics reference). With ``*_scales`` the pages are
    int8 and value ≈ page · scale."""
    B, Hq, D = q.shape
    Hkv, _, page, _ = k_pages.shape
    G = Hq // Hkv
    max_ctx = page_table.shape[1] * page
    pt = page_table.long()
    k = k_pages[:, pt].reshape(Hkv, B, max_ctx, D).permute(1, 2, 0, 3).float()
    v = v_pages[:, pt].reshape(Hkv, B, max_ctx, D).permute(1, 2, 0, 3).float()
    if k_scales is not None:
        ks = k_scales[:, pt].reshape(Hkv, B, max_ctx).permute(1, 2, 0)
        vs = v_scales[:, pt].reshape(Hkv, B, max_ctx).permute(1, 2, 0)
        k, v = dequantize_kv(k, ks), dequantize_kv(v, vs)
    qg = q.float().reshape(B, Hkv, G, D)
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, k) * (1.0 / math.sqrt(D))
    valid = torch.arange(max_ctx, device=q.device) < lengths[:, None, None, None]
    logits = torch.where(valid, logits, _NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", weights, v)
    return out.reshape(B, Hq, D).to(q.dtype)


def _page_block_softmax(
    q: torch.Tensor,  # [B, C, Hq, D]
    kv_pages: torch.Tensor,  # [2, L, Hkv, P, page, D]
    page_table: torch.Tensor,  # [B, max_pages]
    q_positions: torch.Tensor,  # [B, C]
    kv_bound: torch.Tensor,  # [B] pool tokens to attend (< bound)
    layer: int,
    kv_block_pages: int,
    kv_scales: torch.Tensor | None = None,  # [2, L, Hkv, P, page] int8 pools
):
    """Scan fixed-size page blocks of one layer's pool context with an
    online softmax ``(m, l, acc)`` in ``[B, Hkv, G, C, ·]`` layout, causal
    against ``q_positions`` and bounded by ``kv_bound``; int8 pages are
    dequantized by their scales."""
    B, C, Hq, D = q.shape
    Hkv, page = kv_pages.shape[2], kv_pages.shape[4]
    G = Hq // Hkv
    max_pages = page_table.shape[1]
    assert max_pages % kv_block_pages == 0, (max_pages, kv_block_pages)
    bk = kv_block_pages * page
    qg = (q.float() * (1.0 / math.sqrt(D))).reshape(B, C, Hkv, G, D).permute(0, 2, 3, 1, 4)
    k_layer, v_layer = kv_pages[0, layer], kv_pages[1, layer]
    qpos = q_positions[:, None, None, :, None]
    bound = kv_bound[:, None, None, None, None]
    m = torch.full((B, Hkv, G, C, 1), _NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, C, 1), device=q.device)
    acc = torch.zeros((B, Hkv, G, C, D), device=q.device)
    pt = page_table.long()
    for blk in range(max_pages // kv_block_pages):
        pids = pt[:, blk * kv_block_pages:(blk + 1) * kv_block_pages]
        k = k_layer[:, pids].reshape(Hkv, B, bk, D).transpose(0, 1).float()
        v = v_layer[:, pids].reshape(Hkv, B, bk, D).transpose(0, 1).float()
        if kv_scales is not None:
            ks = kv_scales[0, layer][:, pids].reshape(Hkv, B, bk).transpose(0, 1)
            vs = kv_scales[1, layer][:, pids].reshape(Hkv, B, bk).transpose(0, 1)
            k, v = k * ks[..., None], v * vs[..., None]
        s = torch.einsum("bhgcd,bhkd->bhgck", qg, k)
        kv_pos = blk * bk + torch.arange(bk, device=q.device)
        ok = (kv_pos <= qpos) & (kv_pos < bound)
        s = torch.where(ok, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhgck,bhkd->bhgcd", p, v)
        m = m_new
    return m, l, acc


def attend_prefill_paged(
    q: torch.Tensor,  # [B, C, Hq, D] one chunk of new tokens
    kv_pages: torch.Tensor,  # [2, L, Hkv, P, page, D]
    page_table: torch.Tensor,  # [B, max_pages] this request's pages, in order
    q_positions: torch.Tensor,  # [B, C] absolute positions of the chunk
    kv_lengths: torch.Tensor,  # [B] valid context tokens (incl. this chunk)
    layer: int,
    kv_block_pages: int = 32,
    kv_scales: torch.Tensor | None = None,  # [2, L, Hkv, P, page] int8 pools
) -> torch.Tensor:
    """Blockwise causal attention for chunked prefill over the paged pool:
    a chunk of C queries attends to the whole context so far (cached prefix
    plus chunk K/V already written to the pool) by scanning blocks of
    ``kv_block_pages`` pages with an online softmax, so memory stays
    O(C · block). ``max_pages`` must be a multiple of ``kv_block_pages``.
    Returns ``[B, C, Hq, D]`` (zeros where the softmax sum is 0)."""
    B, C, Hq, D = q.shape
    _, l, acc = _page_block_softmax(
        q, kv_pages, page_table, q_positions, kv_lengths, layer, kv_block_pages, kv_scales
    )
    out = torch.where(l > 0, acc / l.clamp_min(1e-30), 0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, Hq, D).to(q.dtype)


def attend_chunk_hybrid(
    q: torch.Tensor,  # [B, C, Hq, D] one chunk of new tokens
    k_cur: torch.Tensor,  # [B, C, Hkv, D] this chunk's K (post-rope)
    v_cur: torch.Tensor,  # [B, C, Hkv, D]
    kv_pages: torch.Tensor,  # [2, L, Hkv, P, page, D]
    page_table: torch.Tensor,  # [B, max_pages]
    q_positions: torch.Tensor,  # [B, C] absolute positions of the chunk
    prior_lengths: torch.Tensor,  # [B] context tokens BEFORE this chunk
    kv_lengths: torch.Tensor,  # [B] valid context incl. this chunk
    layer: int,
    kv_block_pages: int = 32,
) -> torch.Tensor:
    """Chunk attention with the chunk's own K/V taken dense from the layer
    activations: prior context streams blockwise from pages, the chunk is
    one causal dense block, merged through the online softmax (the JAX
    package's reference for the chunk kernel). Returns ``[B, C, Hq, D]``."""
    B, C, Hq, D = q.shape
    Hkv = k_cur.shape[2]
    m, l, acc = _page_block_softmax(
        q, kv_pages, page_table, q_positions, prior_lengths, layer, kv_block_pages
    )
    qg = (q.float() * (1.0 / math.sqrt(D))).reshape(B, C, Hkv, Hq // Hkv, D).permute(0, 2, 3, 1, 4)
    qpos = q_positions[:, None, None, :, None]
    kc = k_cur.float().transpose(1, 2)  # [B, Hkv, C, D]
    vc = v_cur.float().transpose(1, 2)
    s2 = torch.einsum("bhgcd,bhkd->bhgck", qg, kc)
    kv_abs = prior_lengths[:, None, None, None, None] + torch.arange(C, device=q.device)
    ok2 = (kv_abs <= qpos) & (kv_abs < kv_lengths[:, None, None, None, None])
    s2 = torch.where(ok2, s2, _NEG_INF)
    m_f = torch.maximum(m, s2.amax(dim=-1, keepdim=True))
    p2 = torch.exp(s2 - m_f)
    corr = torch.exp(m - m_f)
    l_f = l * corr + p2.sum(dim=-1, keepdim=True)
    acc_f = acc * corr + torch.einsum("bhgck,bhkd->bhgcd", p2, vc)
    out = torch.where(l_f > 0, acc_f / l_f.clamp_min(1e-30), 0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, Hq, D).to(q.dtype)


def paged_chunk_attention(
    q: torch.Tensor,  # [B, C, Hq, D]
    k_cur: torch.Tensor,  # [B, C, Hkv, D]
    v_cur: torch.Tensor,  # [B, C, Hkv, D]
    kv_pages: torch.Tensor,  # [2, L, Hkv, P, page, D]
    page_table: torch.Tensor,  # [B, max_pages]
    prior_lengths: torch.Tensor,  # [B]
    kv_lengths: torch.Tensor,  # [B]
    layer: int,
    kv_scales: torch.Tensor | None = None,  # [2, L, Hkv, P, page] int8 pools
) -> torch.Tensor:
    """Chunk-prefill attention for canonical query positions
    (``prior + arange(C)``, the only form the engine produces): the CUDA
    chunk kernel for a CUDA tensor, its plain version for a CPU tensor.
    For int8 pools ``k_cur``/``v_cur`` are the dequantized float32 rows."""
    return paged_chunk_attention_kernel(
        q, k_cur, v_cur, kv_pages, page_table, prior_lengths, kv_lengths, layer, kv_scales
    )


def paged_decode_attention(
    q: torch.Tensor,  # [B, Hq, D]
    k_new: torch.Tensor,  # [B, Hkv, D] this token's K (post-rope)
    v_new: torch.Tensor,  # [B, Hkv, D]
    kv_pages: torch.Tensor,  # [2, L, Hkv, P, page, D] — updated in place
    slots: torch.Tensor,  # [B]
    page_table: torch.Tensor,  # [B, max_pages]
    lengths: torch.Tensor,  # [B] incl. current token
    layer: int,
    kv_scales: torch.Tensor | None = None,  # [2, L, Hkv, P, page] — updated in place
) -> torch.Tensor:
    """One decode step's KV write + paged attention, fused: the CUDA
    decode kernel for a CUDA tensor, its plain version for a CPU tensor.
    Returns ``attn [B, Hq, D]``; ``kv_pages`` (and ``kv_scales`` for int8
    pools) are updated in place. For int8 pools ``k_new``/``v_new`` are
    the raw rows in q's dtype; the kernel quantizes them."""
    return paged_decode_fused_kernel(
        q, k_new, v_new, kv_pages, slots, page_table, lengths, layer, kv_scales
    )


# The tensor-parallel entries (the JAX package's ``*_sharded`` wrappers).
# Each rank passes its local shard (Hq/tp query heads, a pool of Hkv/tp
# heads) and launches the same kernel on it: heads are independent in
# attention, so no collective is needed, and the kernels check the GQA
# group at the head counts they are given.
paged_attention_pool_kernel_sharded = paged_attention_pool_kernel
paged_chunk_attention_kernel_sharded = paged_chunk_attention_kernel
paged_decode_fused_sharded = paged_decode_fused_kernel


def batch_bucket(n: int, floor: int = 1) -> int:
    """Batch bucket of a decode launch: the smallest power of two ``>= n``
    (and ``>= floor``)."""
    b = max(1, int(floor))
    n = max(1, int(n))
    while b < n:
        b <<= 1
    return b


def default_use_kernel(head_dim: int, device: torch.device | str) -> bool:
    """The backend/shape policy of the paged decode path: a CUDA device and
    a ``head_dim`` that is a multiple of 128 (every production Llama-3
    width). Elsewhere the engine decodes over the compact working set."""
    return torch.device(device).type == "cuda" and head_dim % 128 == 0


# The last ``select_paged`` decision in this process (a plain dict, read
# without a lock by the frontend's ``/stats``).
_LAST_DISPATCH: dict = {}


def note_dispatch(path: str, batch: int, bucket: int, max_len: int) -> None:
    """Record one dispatch decision."""
    _LAST_DISPATCH.update(path=path, batch=int(batch), bucket=int(bucket), max_len=int(max_len))


def last_dispatch() -> dict | None:
    """A copy of the latest ``select_paged`` decision, or None before the
    first."""
    return dict(_LAST_DISPATCH) if _LAST_DISPATCH else None


def select_paged(
    batch: int,
    head_dim: int,
    device: torch.device | str,
    min_batch: int = 0,
    max_len: int = 0,
) -> bool:
    """The per-wave paged-vs-dense crossover for decode launches: True for
    the paged path (``decode_step`` over the whole pool), False for the
    dense leg (``decode_multi_compact`` over the gathered live pages) —
    taken where ``default_use_kernel`` is false, or the batch has fewer
    than ``min_batch`` rows (0 = always paged where the policy allows).
    Records the decision for ``last_dispatch``."""
    paged = default_use_kernel(head_dim, device) and not (0 < min_batch and batch < min_batch)
    note_dispatch("paged" if paged else "dense", batch, batch_bucket(batch), max_len)
    return paged


def paged_attention_pool(
    q: torch.Tensor,  # [B, Hq, D]
    kv_pages: torch.Tensor,  # [2, L, Hkv, P, page, D] full-pool pages view
    page_table: torch.Tensor,  # [B, max_pages]
    lengths: torch.Tensor,  # [B]
    layer: int,
    kv_scales: torch.Tensor | None = None,  # [2, L, Hkv, P, page] int8 pools
) -> torch.Tensor:
    """Decode attention over ``lengths[b]`` tokens of ``layer``'s pages,
    read straight out of the whole multi-layer pool (no per-layer slice is
    copied): the CUDA pool kernel for a CUDA tensor, its plain version for
    a CPU tensor."""
    return paged_attention_pool_kernel(q, kv_pages, page_table, lengths, layer, kv_scales)


def paged_attention_pool_bucketed(
    q: torch.Tensor,  # [B, Hq, D]
    kv_pages: torch.Tensor,  # [2, L, Hkv, P, page, D]
    page_table: torch.Tensor,  # [B, max_pages]
    lengths: torch.Tensor,  # [B]
    layer: int,
    kv_scales: torch.Tensor | None = None,
) -> torch.Tensor:
    """``paged_attention_pool`` with the batch padded up to its power-of-two
    bucket, as the JAX package does to bound its compiled variants. Pad
    rows repeat row 0's query and page row with length 1 (one real token,
    never an out-of-bounds page id) and are sliced off the result; a batch
    already at a bucket passes through."""
    B = q.shape[0]
    nb = batch_bucket(B)
    if nb == B:
        return paged_attention_pool(q, kv_pages, page_table, lengths, layer, kv_scales)
    pad = nb - B
    q_p = torch.cat([q, q[:1].expand(pad, *q.shape[1:])]).contiguous()
    pt_p = torch.cat([page_table, page_table[:1].expand(pad, -1)]).contiguous()
    len_p = torch.cat([lengths, lengths.new_ones(pad)])
    return paged_attention_pool(q_p, kv_pages, pt_p, len_p, layer, kv_scales)[:B]


def paged_attention(
    q: torch.Tensor,  # [B, Hq, D]
    k_pages: torch.Tensor,  # [Hkv, P, page, D] one layer
    v_pages: torch.Tensor,  # [Hkv, P, page, D]
    page_table: torch.Tensor,  # [B, max_pages]
    lengths: torch.Tensor,  # [B]
) -> torch.Tensor:
    """Single-layer decode attention over radix-cache pages (the JAX
    package's ``paged_attention``): the pool kernel over a one-layer pool
    stacked from ``k_pages``/``v_pages``."""
    kv_pages = torch.stack([k_pages, v_pages])[:, None]  # [2, 1, Hkv, P, page, D]
    return paged_attention_pool(q, kv_pages, page_table, lengths, 0)
