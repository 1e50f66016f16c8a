"""The two paged-attention kernels of the serving path, with their plain
PyTorch versions beside them.

- ``paged_decode_fused_kernel`` replaces the JAX package's Pallas kernel of
  the same name (``radixmesh_tpu/ops/paged_attention.py``: bodies
  ``_mh_fused_kernel`` and ``_fused_kernel``). It writes each row's current
  K/V into the pool slot ``slots[b]`` of ``layer`` in place, then runs GQA
  attention of the row's queries over its ``lengths[b] - 1`` pool tokens
  plus the current token, which it folds in from registers — never read
  back from the pool. Rows with ``lengths[b] == 0`` output zeros and write
  nothing.
- ``paged_chunk_attention_kernel`` replaces ``paged_chunk_attention_kernel``
  (body ``_chunk_kernel``): ``C`` queries per row at canonical positions
  ``prior + arange(C)`` attend to ``prior_lengths[b]`` pool tokens, then to
  the chunk's dense K/V, causal within the chunk and bounded by
  ``kv_lengths[b]``. Rows whose softmax denominator is 0 output zeros.

Both keep the JAX kernels' masking rule: a masked position contributes an
exact zero to both factors of ``p·v``, so NaN or Inf in an unreferenced or
padded page never reaches the sum. Both are held in float32 and output the
query's dtype.

Dispatch is by the tensors' device alone: a CUDA tensor launches the
hand-written CUDA kernel (``ops/csrc/``, built at first use by
``ops/_build.py``) or raises; a CPU tensor takes the plain version. There is
no fallback from one to the other. Each wrapper counts its launches in a
plain integer attribute (``<wrapper>.launches``) and each plain version its
calls (``<plain>.calls``), so a run can show which path it took.
"""

from __future__ import annotations

import ctypes
import math

import torch

__all__ = [
    "paged_decode_fused_kernel",
    "paged_decode_fused_plain",
    "paged_chunk_attention_kernel",
    "paged_chunk_attention_plain",
    "chunk_query_block",
    "reset_counters",
]

# Finite mask value of the JAX kernels (exp(finite - MASK) == 0 without the
# NaN of -inf - -inf).
_MASK = -0.7 * torch.finfo(torch.float32).max

# dtype codes of the C entry points.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Head dims and GQA group sizes the CUDA kernels are instantiated for.
_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _gather_rows(kv_pages, which, layer, page_table):
    """``[B, max_pages*page, Hkv, D]`` float32 tokens of one layer's K or V
    in page-table order."""
    Hkv, page, D = kv_pages.shape[2], kv_pages.shape[4], kv_pages.shape[5]
    B, maxp = page_table.shape
    pages = kv_pages[which, layer][:, page_table.long()]  # [Hkv, B, maxp, page, D]
    return pages.reshape(Hkv, B, maxp * page, D).permute(1, 2, 0, 3).float()


def paged_decode_fused_plain(
    q: torch.Tensor,  # [B, Hq, D]
    k_new: torch.Tensor,  # [B, Hkv, D]
    v_new: torch.Tensor,  # [B, Hkv, D]
    kv_pages: torch.Tensor,  # [2, L, Hkv, P, page, D] — written in place
    slots: torch.Tensor,  # [B]
    page_table: torch.Tensor,  # [B, max_pages]
    lengths: torch.Tensor,  # [B] incl. the current token
    layer: int,
) -> torch.Tensor:
    """Plain version of the fused decode kernel, same semantics: attend the
    ``lengths-1`` pool tokens plus the current token taken from ``k_new`` /
    ``v_new`` (so rows that share the scratch slot each see their own
    token), then write the current row into the pool for rows with
    ``lengths > 0``."""
    paged_decode_fused_plain.calls += 1
    B, Hq, D = q.shape
    Hkv, page = kv_pages.shape[2], kv_pages.shape[4]
    G = Hq // Hkv
    n_ctx = page_table.shape[1] * page
    lengths = lengths.long()
    hbm_len = (lengths - 1).clamp(0, n_ctx)
    k = _gather_rows(kv_pages, 0, layer, page_table)  # [B, ctx, Hkv, D]
    v = _gather_rows(kv_pages, 1, layer, page_table)
    pos = torch.arange(n_ctx, device=q.device)
    valid = pos[None, :] < hbm_len[:, None]  # [B, ctx]
    # Current token appended as one more key position, valid iff length>0.
    k = torch.cat([k, k_new.float()[:, None]], dim=1)
    v = torch.cat([v, v_new.float()[:, None]], dim=1)
    valid = torch.cat([valid, (lengths > 0)[:, None]], dim=1)
    v = torch.where(valid[:, :, None, None], v, 0.0)
    qg = q.float().reshape(B, Hkv, G, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k)
    ok = valid[:, None, None, :]
    s = torch.where(ok, s, _MASK)
    p = torch.where(ok, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v)
    out = torch.where(l > 0, out / l.clamp_min(1e-30), 0.0)
    live = lengths > 0
    if bool(live.any()):
        sl = slots.long()[live]
        pg, off = sl // page, sl % page
        # In-place pool update (the JAX kernel's aliased output): per-layer
        # views [Hkv, P, page, D] indexed at [:, pg, off] take [Hkv, n, D].
        for which, new in ((0, k_new), (1, v_new)):
            kv_pages[which, layer][:, pg, off] = new[live].to(kv_pages.dtype).transpose(0, 1)
    return out.reshape(B, Hq, D).to(q.dtype)


paged_decode_fused_plain.calls = 0


def paged_chunk_attention_plain(
    q: torch.Tensor,  # [B, C, Hq, D]
    k_cur: torch.Tensor,  # [B, C, Hkv, D]
    v_cur: torch.Tensor,  # [B, C, Hkv, D]
    kv_pages: torch.Tensor,  # [2, L, Hkv, P, page, D]
    page_table: torch.Tensor,  # [B, max_pages]
    prior_lengths: torch.Tensor,  # [B]
    kv_lengths: torch.Tensor,  # [B]
    layer: int,
) -> torch.Tensor:
    """Plain version of the chunk kernel, same semantics: gather the row's
    pool context, keep tokens ``< prior``, append the chunk's dense keys
    (valid while ``prior + c_k < kv_lengths``, causal ``c_k <= c_q``), one
    masked softmax in float32 with exact zeros at masked positions."""
    paged_chunk_attention_plain.calls += 1
    B, C, Hq, D = q.shape
    Hkv, page = kv_pages.shape[2], kv_pages.shape[4]
    G = Hq // Hkv
    n_ctx = page_table.shape[1] * page
    prior = prior_lengths.long().clamp(0, n_ctx)
    n_dense = (kv_lengths.long() - prior).clamp(0, C)
    k = _gather_rows(kv_pages, 0, layer, page_table)
    v = _gather_rows(kv_pages, 1, layer, page_table)
    pos = torch.arange(n_ctx, device=q.device)
    kv_ok = pos[None, :] < prior[:, None]  # [B, ctx]
    c = torch.arange(C, device=q.device)
    dense_ok = c[None, :] < n_dense[:, None]  # [B, C]
    k = torch.cat([k, k_cur.float()], dim=1)  # [B, ctx + C, Hkv, D]
    v = torch.cat([v, v_cur.float()], dim=1)
    key_ok = torch.cat([kv_ok, dense_ok], dim=1)  # [B, ctx + C]
    k = torch.where(key_ok[:, :, None, None], k, 0.0)
    v = torch.where(key_ok[:, :, None, None], v, 0.0)
    causal = torch.cat(
        [torch.ones(C, n_ctx, dtype=torch.bool, device=q.device), c[None, :] <= c[:, None]],
        dim=1,
    )  # [C (query), ctx + C]
    ok = key_ok[:, None, None, None, :] & causal[None, None, None]  # [B,1,1,C,K]
    qg = (q.float() * (1.0 / math.sqrt(D))).reshape(B, C, Hkv, G, D)
    s = torch.einsum("bchgd,bkhd->bhgck", qg, k)
    s = torch.where(ok, s, _MASK)
    p = torch.where(ok, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgck,bkhd->bhgcd", p, v)
    out = torch.where(l > 0, out / l.clamp_min(1e-30), 0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, Hq, D).to(q.dtype)


paged_chunk_attention_plain.calls = 0


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_LIBS: dict[str, ctypes.CDLL] = {}


def _lib(name: str) -> ctypes.CDLL:
    """The kernel library ``name`` (built from ``ops/csrc/<name>.cu`` at
    first use), with its C entry point's argument types declared."""
    lib = _LIBS.get(name)
    if lib is None:
        from radixmesh_tpu_torch.ops._build import load_library

        lib = load_library(name)
        P, I = ctypes.c_void_p, ctypes.c_int
        if name == "paged_decode":
            lib.paged_decode_launch.argtypes = [I] + [P] * 8 + [I] * 9 + [P]
            lib.paged_decode_launch.restype = I
        else:
            lib.paged_chunk_launch.argtypes = [I] + [P] * 8 + [I] * 11 + [P]
            lib.paged_chunk_launch.restype = I
        _LIBS[name] = lib
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_common(name, q, kv_pages, page_table, int_vectors):
    dev = q.device
    _check(q.dtype in _DTYPES, f"{name}: dtype {q.dtype} not supported (bf16/f32)")
    _check(kv_pages.dtype == q.dtype, f"{name}: pool dtype {kv_pages.dtype} != q dtype {q.dtype}")
    _check(kv_pages.dim() == 6, f"{name}: kv_pages must be [2, L, Hkv, P, page, D]")
    _check(kv_pages.is_contiguous(), f"{name}: kv_pages must be contiguous")
    for t in (kv_pages, page_table, *int_vectors):
        _check(t.device == dev, f"{name}: every tensor must be on {dev}")
    for t in (page_table, *int_vectors):
        _check(t.dtype == torch.int32 and t.is_contiguous(),
               f"{name}: index tensors must be contiguous int32")
    D = kv_pages.shape[5]
    _check(D in _HEAD_DIMS, f"{name}: head_dim {D} not in {_HEAD_DIMS}")
    # 32-bit offsets inside the kernels index one layer of the pool.
    _check(kv_pages[0, 0].numel() < 2 ** 31, f"{name}: pool layer too large")


def _raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")


def paged_decode_fused_kernel(
    q: torch.Tensor,  # [B, Hq, D]
    k_new: torch.Tensor,  # [B, Hkv, D] pool dtype
    v_new: torch.Tensor,  # [B, Hkv, D]
    kv_pages: torch.Tensor,  # [2, L, Hkv, P, page, D] — written in place
    slots: torch.Tensor,  # [B] int32
    page_table: torch.Tensor,  # [B, max_pages] int32
    lengths: torch.Tensor,  # [B] int32, incl. the current token
    layer: int,
) -> torch.Tensor:
    """Fused decode step: ``attn [B, Hq, D]`` in q's dtype; the pool
    receives each live row's current K/V in place."""
    if q.device.type == "cpu":
        return paged_decode_fused_plain(
            q, k_new, v_new, kv_pages, slots, page_table, lengths, layer
        )
    name = "paged_decode_fused_kernel"
    _check(q.device.type == "cuda", f"{name}: unsupported device {q.device}")
    _check_common(name, q, kv_pages, page_table, (slots, lengths))
    B, Hq, D = q.shape
    _, L, Hkv, P, page, _ = kv_pages.shape
    _check(Hq % Hkv == 0 and Hq // Hkv in _GROUPS, f"{name}: GQA group Hq/Hkv={Hq}/{Hkv} unsupported")
    _check(0 <= layer < L, f"{name}: layer {layer} out of range")
    for t, shape in ((q, (B, Hq, D)), (k_new, (B, Hkv, D)), (v_new, (B, Hkv, D))):
        _check(tuple(t.shape) == shape and t.dtype == q.dtype and t.is_contiguous()
               and t.device == q.device, f"{name}: expected contiguous {shape} {q.dtype} on {q.device}")
    _check(page_table.dim() == 2 and page_table.shape[0] == B, f"{name}: page_table must be [B, max_pages]")
    _check(tuple(slots.shape) == (B,) and tuple(lengths.shape) == (B,), f"{name}: slots/lengths must be [B]")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib("paged_decode").paged_decode_launch(
            _DTYPES[q.dtype], q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            kv_pages.data_ptr(), slots.data_ptr(), page_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, D, L, P * page, page, page_table.shape[1], int(layer),
            stream,
        )
    _raise_on_error(name, rc)
    paged_decode_fused_kernel.launches += 1
    return out


paged_decode_fused_kernel.launches = 0


def chunk_query_block(C: int, G: int, max_rows: int = 64) -> int:
    """Queries per CTA of the chunk kernel: the largest power-of-two
    divisor of ``C`` whose row count ``Cblk * G`` fits the kernel's 64-row
    tile."""
    cblk = 1
    while C % (cblk * 2) == 0 and cblk * 2 * G <= max_rows:
        cblk *= 2
    return cblk


def paged_chunk_attention_kernel(
    q: torch.Tensor,  # [B, C, Hq, D]
    k_cur: torch.Tensor,  # [B, C, Hkv, D]
    v_cur: torch.Tensor,  # [B, C, Hkv, D]
    kv_pages: torch.Tensor,  # [2, L, Hkv, P, page, D]
    page_table: torch.Tensor,  # [B, max_pages] int32
    prior_lengths: torch.Tensor,  # [B] int32
    kv_lengths: torch.Tensor,  # [B] int32
    layer: int,
) -> torch.Tensor:
    """Chunk-prefill attention ``[B, C, Hq, D]`` in q's dtype."""
    if q.device.type == "cpu":
        return paged_chunk_attention_plain(
            q, k_cur, v_cur, kv_pages, page_table, prior_lengths, kv_lengths, layer
        )
    name = "paged_chunk_attention_kernel"
    _check(q.device.type == "cuda", f"{name}: unsupported device {q.device}")
    _check_common(name, q, kv_pages, page_table, (prior_lengths, kv_lengths))
    B, C, Hq, D = q.shape
    _, L, Hkv, P, page, _ = kv_pages.shape
    _check(Hq % Hkv == 0 and Hq // Hkv in _GROUPS, f"{name}: GQA group Hq/Hkv={Hq}/{Hkv} unsupported")
    _check(0 <= layer < L, f"{name}: layer {layer} out of range")
    _check(tuple(q.shape) == (B, C, Hq, D) and q.is_contiguous(), f"{name}: q must be contiguous [B, C, Hq, D]")
    for t in (k_cur, v_cur):
        _check(tuple(t.shape) == (B, C, Hkv, D) and t.dtype == q.dtype and t.is_contiguous()
               and t.device == q.device, f"{name}: k_cur/v_cur must be contiguous [B, C, Hkv, D] {q.dtype}")
    _check(page_table.dim() == 2 and page_table.shape[0] == B, f"{name}: page_table must be [B, max_pages]")
    _check(tuple(prior_lengths.shape) == (B,) and tuple(kv_lengths.shape) == (B,),
           f"{name}: prior_lengths/kv_lengths must be [B]")
    G = Hq // Hkv
    cblk = chunk_query_block(C, G)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib("paged_chunk").paged_chunk_launch(
            _DTYPES[q.dtype], q.data_ptr(), k_cur.data_ptr(), v_cur.data_ptr(),
            kv_pages.data_ptr(), page_table.data_ptr(), prior_lengths.data_ptr(),
            kv_lengths.data_ptr(), out.data_ptr(),
            B, C, Hq, Hkv, D, L, P * page, page, page_table.shape[1], int(layer),
            cblk, stream,
        )
    _raise_on_error(name, rc)
    paged_chunk_attention_kernel.launches += 1
    return out


paged_chunk_attention_kernel.launches = 0


def reset_counters() -> None:
    """Zero every wrapper's launch count and every plain version's call
    count."""
    paged_decode_fused_kernel.launches = 0
    paged_chunk_attention_kernel.launches = 0
    paged_decode_fused_plain.calls = 0
    paged_chunk_attention_plain.calls = 0
