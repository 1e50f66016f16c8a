"""The paged-attention kernels of the serving path, with their plain PyTorch
versions beside them.

- ``paged_decode_fused_kernel`` replaces the JAX package's Pallas kernel of
  the same name (``radixmesh_tpu/ops/paged_attention.py``: bodies
  ``_mh_fused_kernel`` and ``_fused_kernel``). It runs GQA attention of
  each row's queries over its ``lengths[b] - 1`` pool tokens plus the
  current token, which it folds in from registers — never read back from
  the pool — and writes the row's current K/V into the pool slot
  ``slots[b]`` of ``layer`` in place. Rows with ``lengths[b] == 0`` output
  zeros and write nothing.
- ``paged_chunk_attention_kernel`` replaces ``paged_chunk_attention_kernel``
  (body ``_chunk_kernel``): ``C`` queries per row at canonical positions
  ``prior + arange(C)`` attend to ``prior_lengths[b]`` pool tokens, then to
  the chunk's dense K/V, causal within the chunk and bounded by
  ``kv_lengths[b]``. Rows whose softmax denominator is 0 output zeros.
- ``paged_attention_pool_kernel`` replaces ``paged_attention_pool_kernel``
  (bodies ``_kernel`` and ``_mh_kernel``): read-only GQA decode attention
  over ``lengths[b]`` pool tokens of ``layer``, with no write and no
  fold-in; rows with ``lengths[b] <= 0`` output zeros.

On the card, the two decode kernels split each row's context over
``decode_splits`` CTAs (flash-decoding) in one launch: each split writes
float32 partials and the last to finish merges them (and, fused, writes
the current row and folds it in). The chunk kernel has two bodies:
bfloat16 queries run on the tensor cores (``csrc/paged_chunk_tc.cu``:
wgmma fed by TMA, its query blocks from ``chunk_tc_query_block`` and each
block's tiles split over ``chunk_splits`` CTAs, merged in the same
launch), float32 queries on the CUDA cores (``csrc/paged_chunk.cu``,
blocks from ``chunk_query_block``), counted apart in
``launches_f32_body``; ``launches_by_c`` counts the chunk kernel's
launches by chunk length C. The split kernels' counters (``_counters``)
are allocated once per device and stream and left at 0 by every launch.

Each takes an int8 pool with its scales ``kv_scales [2, L, Hkv, P, page]``
float32 (value ≈ int8 · scale, ``ops/quant.py``). The decode kernel then
quantizes the current row itself, writes the int8 payload and the scale in
place (bit-exact with ``quantize_kv``) and folds in the float32
dequantized twin; the chunk kernel takes its dense K/V already dequantized,
in float32.

All keep the JAX kernels' masking rule: a masked position contributes an
exact zero to both factors of ``p·v``, so NaN or Inf in an unreferenced or
padded page (or its scale) never reaches the sum. All are held in float32
and output the query's dtype.

Dispatch is by the tensors' device alone: a CUDA tensor launches the
hand-written CUDA kernel (``ops/csrc/``, built at first use by
``ops/_build.py``) or raises; a CPU tensor takes the plain version. There is
no fallback from one to the other. Each wrapper counts its launches in plain
integer attributes (``<wrapper>.launches`` for bf16/f32 pools,
``<wrapper>.launches_int8`` for int8 pools) and each plain version its
calls (``<plain>.calls`` / ``.calls_int8``), so a run can show which path
it took.
"""

from __future__ import annotations

import ctypes
import math

import torch

from radixmesh_tpu_torch.ops.quant import dequantize_kv, quantize_kv

__all__ = [
    "paged_decode_fused_kernel",
    "paged_decode_fused_plain",
    "paged_chunk_attention_kernel",
    "paged_chunk_attention_plain",
    "paged_attention_pool_kernel",
    "paged_attention_pool_plain",
    "chunk_query_block",
    "chunk_tc_query_block",
    "chunk_splits",
    "decode_splits",
    "reset_counters",
    "plain_calls",
    "launch_counts",
]

# Finite mask value of the JAX kernels (exp(finite - MASK) == 0 without the
# NaN of -inf - -inf).
_MASK = -0.7 * torch.finfo(torch.float32).max

# dtype codes of the C entry points (int8 for pools only).
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_Q_DTYPES = (torch.float32, torch.bfloat16)
# Head dims and GQA group sizes (Hq / Hkv) the CUDA kernels are
# instantiated for: every group of the Llama-3 and Qwen2 presets (1 to 8).
_HEAD_DIMS = (64, 128)
_GROUPS = tuple(range(1, 9))


def _count(fn, attr: str, kv_scales) -> None:
    """Add one to ``fn.<attr>`` (bf16/f32 pools) or ``fn.<attr>_int8``."""
    name = attr if kv_scales is None else f"{attr}_int8"
    setattr(fn, name, getattr(fn, name) + 1)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _gather_rows(kv_pages, which, layer, page_table, kv_scales=None):
    """``[B, max_pages*page, Hkv, D]`` float32 tokens of one layer's K or V
    in page-table order, dequantized for int8 pools."""
    Hkv, page, D = kv_pages.shape[2], kv_pages.shape[4], kv_pages.shape[5]
    B, maxp = page_table.shape
    pt = page_table.long()
    rows = kv_pages[which, layer][:, pt].reshape(Hkv, B, maxp * page, D)
    if kv_scales is not None:
        sc = kv_scales[which, layer][:, pt].reshape(Hkv, B, maxp * page)
        return dequantize_kv(rows, sc).permute(1, 2, 0, 3)
    return rows.permute(1, 2, 0, 3).float()


def _masked_attention(q, k, v, valid):
    """GQA attention of ``q [B, Hq, D]`` over keys ``k``/``v [B, K, Hkv, D]``
    (float32) where ``valid [B, K]``, in float32: masked keys get exact
    zeros in both ``p`` and ``v``; rows with no valid key output zeros.
    Returns ``[B, Hq, D]`` float32."""
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    v = torch.where(valid[:, :, None, None], v, 0.0)
    qg = q.float().reshape(B, Hkv, G, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k)
    ok = valid[:, None, None, :]
    s = torch.where(ok, s, _MASK)
    p = torch.where(ok, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v)
    out = torch.where(l > 0, out / l.clamp_min(1e-30), 0.0)
    return out.reshape(B, Hq, D)


def paged_decode_fused_plain(
    q: torch.Tensor,  # [B, Hq, D]
    k_new: torch.Tensor,  # [B, Hkv, D]
    v_new: torch.Tensor,  # [B, Hkv, D]
    kv_pages: torch.Tensor,  # [2, L, Hkv, P, page, D] — written in place
    slots: torch.Tensor,  # [B]
    page_table: torch.Tensor,  # [B, max_pages]
    lengths: torch.Tensor,  # [B] incl. the current token
    layer: int,
    kv_scales: torch.Tensor | None = None,  # [2, L, Hkv, P, page] — written in place
) -> torch.Tensor:
    """Plain version of the fused decode kernel, same semantics: attend the
    ``lengths-1`` pool tokens plus the current token taken from ``k_new`` /
    ``v_new`` (so rows that share the scratch slot each see their own
    token), then write the current row into the pool for rows with
    ``lengths > 0``. With ``kv_scales`` the row is quantized first
    (``quantize_kv``), the float32 dequantized twin is attended, and the
    int8 payload and its scales are written."""
    _count(paged_decode_fused_plain, "calls", kv_scales)
    page = kv_pages.shape[4]
    n_ctx = page_table.shape[1] * page
    lengths = lengths.long()
    hbm_len = (lengths - 1).clamp(0, n_ctx)
    if kv_scales is not None:
        k_store, k_sc = quantize_kv(k_new)
        v_store, v_sc = quantize_kv(v_new)
        k_cur, v_cur = dequantize_kv(k_store, k_sc), dequantize_kv(v_store, v_sc)
    else:
        k_store, v_store = k_new.to(kv_pages.dtype), v_new.to(kv_pages.dtype)
        k_cur, v_cur = k_new.float(), v_new.float()
    k = _gather_rows(kv_pages, 0, layer, page_table, kv_scales)  # [B, ctx, Hkv, D]
    v = _gather_rows(kv_pages, 1, layer, page_table, kv_scales)
    pos = torch.arange(n_ctx, device=q.device)
    # Current token appended as one more key position, valid iff length>0.
    k = torch.cat([k, k_cur[:, None]], dim=1)
    v = torch.cat([v, v_cur[:, None]], dim=1)
    valid = torch.cat([pos[None, :] < hbm_len[:, None], (lengths > 0)[:, None]], dim=1)
    out = _masked_attention(q, k, v, valid)
    live = lengths > 0
    if bool(live.any()):
        sl = slots.long()[live]
        pg, off = sl // page, sl % page
        # In-place pool update (the JAX kernel's aliased output): per-layer
        # views [Hkv, P, page, D] indexed at [:, pg, off] take [Hkv, n, D].
        for which, new in ((0, k_store), (1, v_store)):
            kv_pages[which, layer][:, pg, off] = new[live].transpose(0, 1)
        if kv_scales is not None:
            for which, sc in ((0, k_sc), (1, v_sc)):
                kv_scales[which, layer][:, pg, off] = sc[live].transpose(0, 1)
    return out.to(q.dtype)


paged_decode_fused_plain.calls = 0
paged_decode_fused_plain.calls_int8 = 0


def paged_attention_pool_plain(
    q: torch.Tensor,  # [B, Hq, D]
    kv_pages: torch.Tensor,  # [2, L, Hkv, P, page, D]
    page_table: torch.Tensor,  # [B, max_pages]
    lengths: torch.Tensor,  # [B]
    layer: int,
    kv_scales: torch.Tensor | None = None,  # [2, L, Hkv, P, page]
) -> torch.Tensor:
    """Plain version of the read-only pool kernel, same semantics: attend
    ``lengths[b]`` pool tokens of ``layer``; rows with ``lengths <= 0``
    output zeros (the Pallas kernel's rule, which ``attend_decode_ref``
    does not follow)."""
    _count(paged_attention_pool_plain, "calls", kv_scales)
    n_ctx = page_table.shape[1] * kv_pages.shape[4]
    n = lengths.long().clamp(0, n_ctx)
    k = _gather_rows(kv_pages, 0, layer, page_table, kv_scales)
    v = _gather_rows(kv_pages, 1, layer, page_table, kv_scales)
    valid = torch.arange(n_ctx, device=q.device)[None, :] < n[:, None]
    return _masked_attention(q, k, v, valid).to(q.dtype)


paged_attention_pool_plain.calls = 0
paged_attention_pool_plain.calls_int8 = 0


def paged_chunk_attention_plain(
    q: torch.Tensor,  # [B, C, Hq, D]
    k_cur: torch.Tensor,  # [B, C, Hkv, D]
    v_cur: torch.Tensor,  # [B, C, Hkv, D]
    kv_pages: torch.Tensor,  # [2, L, Hkv, P, page, D]
    page_table: torch.Tensor,  # [B, max_pages]
    prior_lengths: torch.Tensor,  # [B]
    kv_lengths: torch.Tensor,  # [B]
    layer: int,
    kv_scales: torch.Tensor | None = None,  # [2, L, Hkv, P, page]
) -> torch.Tensor:
    """Plain version of the chunk kernel, same semantics: gather the row's
    pool context (dequantized for int8 pools), keep tokens ``< prior``,
    append the chunk's dense keys (valid while ``prior + c_k < kv_lengths``,
    causal ``c_k <= c_q``), one masked softmax in float32 with exact zeros
    at masked positions."""
    _count(paged_chunk_attention_plain, "calls", kv_scales)
    B, C, Hq, D = q.shape
    Hkv, page = kv_pages.shape[2], kv_pages.shape[4]
    G = Hq // Hkv
    n_ctx = page_table.shape[1] * page
    prior = prior_lengths.long().clamp(0, n_ctx)
    n_dense = (kv_lengths.long() - prior).clamp(0, C)
    k = _gather_rows(kv_pages, 0, layer, page_table, kv_scales)
    v = _gather_rows(kv_pages, 1, layer, page_table, kv_scales)
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
paged_chunk_attention_plain.calls_int8 = 0


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_LIBS: dict[str, ctypes.CDLL] = {}
# Argument types of each library's C entry point.
_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY = {
    "paged_decode": ("paged_decode_launch", [_I, _I] + [_P] * 11 + [_I] * 11 + [_P]),
    "paged_pool": ("paged_pool_launch", [_I, _I] + [_P] * 8 + [_I] * 11 + [_P]),
    "paged_chunk": ("paged_chunk_launch", [_I, _I] + [_P] * 9 + [_I] * 11 + [_P]),
    "paged_chunk_tc": ("paged_chunk_tc_launch", [_I, _I] + [_P] * 11 + [_I] * 13 + [_P]),
}


def _entry(name: str):
    """The C entry point of kernel library ``name`` (built from
    ``ops/csrc/<name>.cu`` at first use), its argument types declared."""
    lib = _LIBS.get(name)
    if lib is None:
        from radixmesh_tpu_torch.ops._build import load_library

        lib = load_library(name)
        fn_name, argtypes = _ENTRY[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = _I
        _LIBS[name] = lib
    return getattr(lib, _ENTRY[name][0])


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_common(name, q, kv_pages, page_table, int_vectors, kv_scales):
    dev = q.device
    _check(q.dtype in _Q_DTYPES, f"{name}: q dtype {q.dtype} not supported (bf16/f32)")
    _check(kv_pages.dim() == 6, f"{name}: kv_pages must be [2, L, Hkv, P, page, D]")
    _check(kv_pages.is_contiguous(), f"{name}: kv_pages must be contiguous")
    if kv_scales is None:
        _check(kv_pages.dtype == q.dtype, f"{name}: pool dtype {kv_pages.dtype} != q dtype {q.dtype}")
    else:
        _check(kv_pages.dtype == torch.int8, f"{name}: kv_scales given for a {kv_pages.dtype} pool")
        _check(kv_scales.dtype == torch.float32 and kv_scales.is_contiguous()
               and tuple(kv_scales.shape) == tuple(kv_pages.shape[:5]),
               f"{name}: kv_scales must be contiguous float32 [2, L, Hkv, P, page]")
    for t in (kv_pages, page_table, *int_vectors) + (() if kv_scales is None else (kv_scales,)):
        _check(t.device == dev, f"{name}: every tensor must be on {dev}")
    for t in (page_table, *int_vectors):
        _check(t.dtype == torch.int32 and t.is_contiguous(),
               f"{name}: index tensors must be contiguous int32")
    D = kv_pages.shape[5]
    _check(D in _HEAD_DIMS, f"{name}: head_dim {D} not in {_HEAD_DIMS}")
    # 32-bit offsets inside the kernels index one layer of the pool.
    _check(kv_pages[0, 0].numel() < 2 ** 31, f"{name}: pool layer too large")


def _check_gqa(name, Hq, Hkv, layer, L):
    _check(Hkv > 0 and Hq % Hkv == 0 and Hq // Hkv in _GROUPS,
           f"{name}: GQA group Hq/Hkv={Hq}/{Hkv} unsupported (the kernels take groups "
           f"{_GROUPS[0]}..{_GROUPS[-1]})")
    _check(0 <= layer < L, f"{name}: layer {layer} out of range")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


# Split counters per (device, stream): int32, all 0 between launches (the
# CTA that merges a split puts its counter back to 0), so no launch needs
# a memset. Each stream has its own: two engines launching on their own
# streams would race on a shared one.
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}
_MIN_COUNTERS = 4096


def _counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed split counters for ``stream`` on ``device``,
    allocated at first use and grown (zeroed again) only when a launch needs
    more."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        size = max(n, _MIN_COUNTERS, 0 if buf is None else 2 * buf.numel())
        buf = _COUNTERS[key] = torch.zeros(size, dtype=torch.int32, device=device)
    return buf


# Stands in ``_launch``'s arguments for the stream's split counters.
_COUNTER_PTR = object()


def _launch(lib: str, q: torch.Tensor, *args, counters: int = 0) -> None:
    """Call ``lib``'s entry point on q's current stream; raise on a
    refused launch (a launch that never ran is not reported by a later
    synchronize). ``_COUNTER_PTR`` in ``args`` becomes that stream's split
    counters (at least ``counters`` of them), or a null pointer when
    ``counters`` is 0."""
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ctr = _counters(q.device, stream, counters).data_ptr() if counters else None
        rc = _entry(lib)(*(ctr if a is _COUNTER_PTR else a for a in args), stream)
    if rc != 0:
        raise RuntimeError(f"{_ENTRY[lib][0]}: CUDA launch failed with cudaError_t {rc}")


# Split selection of the decode kernels: the kernel's tile, the CTAs per
# SM a split aims for, and the fewest tiles per split (a split pays its
# pipeline's fill and its partials' write over at least that many tiles).
_DECODE_TILE = 64
_CTAS_PER_SM = 4
_MIN_SPLIT_TILES = 4
_SM_COUNTS: dict[torch.device, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA ``device`` (read once per
    device)."""
    n = _SM_COUNTS.get(device)
    if n is None:
        n = _SM_COUNTS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def decode_splits(n_ctx: int, rows: int, sms: int) -> tuple[int, int]:
    """``(splits, span)`` of the decode kernels' context split, from shapes
    alone: ``n_ctx`` is the page table's width in tokens (``max_pages *
    page``, which the engine buckets to a power of two), ``rows`` is ``B *
    Hkv`` and ``sms`` the card's SM count (``sm_count``). Split ``s``
    attends tokens ``[s * span, (s + 1) * span)``; ``span`` is a multiple
    of the 64-token tile, ``splits * span >= n_ctx`` and every split starts
    below ``n_ctx``. The grid aims at about ``_CTAS_PER_SM`` CTAs per SM
    with at least four tiles per split, so ``rows >= 4 * sms`` takes one
    split. Never reads ``lengths``: choosing from them would cost a
    host-device sync per decode step."""
    tiles = max(1, -(-n_ctx // _DECODE_TILE))
    want = -(-(sms * _CTAS_PER_SM) // max(rows, 1))
    splits = max(1, min(want, tiles // _MIN_SPLIT_TILES))
    span = -(-tiles // splits) * _DECODE_TILE
    return -(-max(n_ctx, 1) // span), span


def _split_workspace(q: torch.Tensor, splits: int) -> torch.Tensor | None:
    """Float32 partials of the split decode, none for one split: per (row,
    kv head, split), m and l ``[G]`` then O ``[G, D]``."""
    B, Hq, D = q.shape
    if splits == 1:
        return None
    return torch.empty(B * Hq * splits * (D + 2), dtype=torch.float32, device=q.device)


def paged_decode_fused_kernel(
    q: torch.Tensor,  # [B, Hq, D]
    k_new: torch.Tensor,  # [B, Hkv, D] q's dtype
    v_new: torch.Tensor,  # [B, Hkv, D]
    kv_pages: torch.Tensor,  # [2, L, Hkv, P, page, D] — written in place
    slots: torch.Tensor,  # [B] int32
    page_table: torch.Tensor,  # [B, max_pages] int32
    lengths: torch.Tensor,  # [B] int32, incl. the current token
    layer: int,
    kv_scales: torch.Tensor | None = None,  # [2, L, Hkv, P, page] f32 — written in place
) -> torch.Tensor:
    """Fused decode step: ``attn [B, Hq, D]`` in q's dtype; the pool (and
    for int8 pools its scales) receives each live row's current K/V in
    place. ``k_new``/``v_new`` are in q's dtype, which is the pool's for
    bf16/f32 pools; int8 pools quantize them in the kernel."""
    if q.device.type == "cpu":
        return paged_decode_fused_plain(
            q, k_new, v_new, kv_pages, slots, page_table, lengths, layer, kv_scales
        )
    name = "paged_decode_fused_kernel"
    _check(q.device.type == "cuda", f"{name}: unsupported device {q.device}")
    _check_common(name, q, kv_pages, page_table, (slots, lengths), kv_scales)
    B, Hq, D = q.shape
    _, L, Hkv, P, page, _ = kv_pages.shape
    _check_gqa(name, Hq, Hkv, layer, L)
    for t, shape in ((q, (B, Hq, D)), (k_new, (B, Hkv, D)), (v_new, (B, Hkv, D))):
        _check(tuple(t.shape) == shape and t.dtype == q.dtype and t.is_contiguous()
               and t.device == q.device, f"{name}: expected contiguous {shape} {q.dtype} on {q.device}")
    _check(page_table.dim() == 2 and page_table.shape[0] == B, f"{name}: page_table must be [B, max_pages]")
    _check(tuple(slots.shape) == (B,) and tuple(lengths.shape) == (B,), f"{name}: slots/lengths must be [B]")
    splits, span = decode_splits(page_table.shape[1] * page, B * Hkv, sm_count(q.device))
    ws = _split_workspace(q, splits)
    out = torch.empty_like(q)
    _launch(
        "paged_decode", q, _DTYPES[q.dtype], _DTYPES[kv_pages.dtype], q.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), kv_pages.data_ptr(), _ptr(kv_scales),
        slots.data_ptr(), page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        _ptr(ws), _COUNTER_PTR, B, Hq, Hkv, D, L, P * page, page, page_table.shape[1],
        int(layer), splits, span, counters=B * Hkv if splits > 1 else 0,
    )
    _count(paged_decode_fused_kernel, "launches", kv_scales)
    return out


paged_decode_fused_kernel.launches = 0
paged_decode_fused_kernel.launches_int8 = 0


def paged_attention_pool_kernel(
    q: torch.Tensor,  # [B, Hq, D]
    kv_pages: torch.Tensor,  # [2, L, Hkv, P, page, D]
    page_table: torch.Tensor,  # [B, max_pages] int32
    lengths: torch.Tensor,  # [B] int32
    layer: int,
    kv_scales: torch.Tensor | None = None,  # [2, L, Hkv, P, page] f32 (int8 pools)
) -> torch.Tensor:
    """Read-only paged decode attention over ``lengths[b]`` pool tokens of
    ``layer``: ``[B, Hq, D]`` in q's dtype, zeros for rows with
    ``lengths <= 0``. Reads only ``layer``'s pages; writes nothing else."""
    if q.device.type == "cpu":
        return paged_attention_pool_plain(q, kv_pages, page_table, lengths, layer, kv_scales)
    name = "paged_attention_pool_kernel"
    _check(q.device.type == "cuda", f"{name}: unsupported device {q.device}")
    _check_common(name, q, kv_pages, page_table, (lengths,), kv_scales)
    B, Hq, D = q.shape
    _, L, Hkv, P, page, _ = kv_pages.shape
    _check_gqa(name, Hq, Hkv, layer, L)
    _check(q.dim() == 3 and q.is_contiguous(), f"{name}: q must be contiguous [B, Hq, D]")
    _check(page_table.dim() == 2 and page_table.shape[0] == B, f"{name}: page_table must be [B, max_pages]")
    _check(tuple(lengths.shape) == (B,), f"{name}: lengths must be [B]")
    splits, span = decode_splits(page_table.shape[1] * page, B * Hkv, sm_count(q.device))
    ws = _split_workspace(q, splits)
    out = torch.empty_like(q)
    _launch(
        "paged_pool", q, _DTYPES[q.dtype], _DTYPES[kv_pages.dtype], q.data_ptr(),
        kv_pages.data_ptr(), _ptr(kv_scales), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), _ptr(ws), _COUNTER_PTR, B, Hq, Hkv, D, L, P * page, page,
        page_table.shape[1], int(layer), splits, span, counters=B * Hkv if splits > 1 else 0,
    )
    _count(paged_attention_pool_kernel, "launches", kv_scales)
    return out


paged_attention_pool_kernel.launches = 0
paged_attention_pool_kernel.launches_int8 = 0


# Query rows (Cblk * G) per CTA of the chunk kernel's two bodies (``kRows``
# in each source): two 64-row warpgroups on the tensor cores (bf16
# queries), 256 threads of 8 rows each on the CUDA cores (float32 queries).
CHUNK_ROWS = {torch.bfloat16: 128, torch.float32: 128}
# The tensor-core body's key tile, and its prior split's aim: CTAs per SM
# and the fewest tiles per split.
_CHUNK_TILE = 64
_CHUNK_CTAS_PER_SM = 4
_CHUNK_MIN_SPLIT_TILES = 4


def chunk_query_block(C: int, G: int, max_rows: int = 128) -> int:
    """Queries per CTA of the chunk kernel's CUDA-core body: the largest
    power-of-two divisor of ``C`` whose row count ``Cblk * G`` fits
    ``max_rows`` (the body's rows per CTA, ``CHUNK_ROWS``)."""
    cblk = 1
    while C % (cblk * 2) == 0 and cblk * 2 * G <= max_rows:
        cblk *= 2
    return cblk


def chunk_tc_query_block(C: int, G: int) -> int:
    """Queries per CTA of the tensor-core body: all ``C`` queries of a
    (row, kv head) while ``C * G`` fits its 128 rows, else as many as fit;
    the last of the ``ceil(C / cblk)`` blocks may be ragged."""
    return max(1, min(C, CHUNK_ROWS[torch.bfloat16] // G))


def chunk_splits(n_ctx: int, C: int, cblk: int, rows: int, sms: int) -> tuple[int, int]:
    """``(splits, tiles_per_split)`` of the tensor-core body, from shapes
    alone: ``n_ctx`` is the page table's width in tokens, ``rows`` is ``B *
    Hkv`` and ``sms`` the card's SM count. A (row, kv head, query block)
    has at most ``ceil(n_ctx / 64)`` prior tiles then ``ceil(C / 64)``
    dense ones; split ``s`` takes tiles ``[s * tps, (s + 1) * tps)`` of that
    list, ``splits * tps`` covers it and every split starts inside it. A
    grid that fills half the card or more takes one split: the body holds
    one CTA per SM, so splitting it adds waves and merges. A smaller one
    (a verify at C = 5 or a mixed wave at C = 16 over a few rows) aims at
    about ``_CHUNK_CTAS_PER_SM`` CTAs per SM, most of them short or empty
    on ragged rows, with at least four tiles per split. Never reads
    lengths."""
    tiles = -(-max(n_ctx, 0) // _CHUNK_TILE) + -(-C // _CHUNK_TILE)
    ctas = max(rows, 1) * -(-C // cblk)
    want = -(-(sms * _CHUNK_CTAS_PER_SM) // ctas) if 2 * ctas < sms else 1
    splits = max(1, min(want, tiles // _CHUNK_MIN_SPLIT_TILES))
    tps = -(-tiles // splits)
    return -(-tiles // tps), tps


def paged_chunk_attention_kernel(
    q: torch.Tensor,  # [B, C, Hq, D]
    k_cur: torch.Tensor,  # [B, C, Hkv, D]
    v_cur: torch.Tensor,  # [B, C, Hkv, D]
    kv_pages: torch.Tensor,  # [2, L, Hkv, P, page, D]
    page_table: torch.Tensor,  # [B, max_pages] int32
    prior_lengths: torch.Tensor,  # [B] int32
    kv_lengths: torch.Tensor,  # [B] int32
    layer: int,
    kv_scales: torch.Tensor | None = None,  # [2, L, Hkv, P, page] f32 (int8 pools)
) -> torch.Tensor:
    """Chunk-prefill attention ``[B, C, Hq, D]`` in q's dtype. ``k_cur`` /
    ``v_cur`` are in the pool dtype for bf16/f32 pools and float32 (already
    dequantized) for int8 pools."""
    if q.device.type == "cpu":
        return paged_chunk_attention_plain(
            q, k_cur, v_cur, kv_pages, page_table, prior_lengths, kv_lengths, layer, kv_scales
        )
    name = "paged_chunk_attention_kernel"
    _check(q.device.type == "cuda", f"{name}: unsupported device {q.device}")
    _check_common(name, q, kv_pages, page_table, (prior_lengths, kv_lengths), kv_scales)
    B, C, Hq, D = q.shape
    _, L, Hkv, P, page, _ = kv_pages.shape
    _check_gqa(name, Hq, Hkv, layer, L)
    _check(tuple(q.shape) == (B, C, Hq, D) and q.is_contiguous(), f"{name}: q must be contiguous [B, C, Hq, D]")
    cur_dtype = q.dtype if kv_scales is None else torch.float32
    for t in (k_cur, v_cur):
        _check(tuple(t.shape) == (B, C, Hkv, D) and t.dtype == cur_dtype and t.is_contiguous()
               and t.device == q.device, f"{name}: k_cur/v_cur must be contiguous [B, C, Hkv, D] {cur_dtype}")
    _check(page_table.dim() == 2 and page_table.shape[0] == B, f"{name}: page_table must be [B, max_pages]")
    _check(tuple(prior_lengths.shape) == (B,) and tuple(kv_lengths.shape) == (B,),
           f"{name}: prior_lengths/kv_lengths must be [B]")
    G, maxp = Hq // Hkv, page_table.shape[1]
    out = torch.empty_like(q)
    common = (q.data_ptr(), k_cur.data_ptr(), v_cur.data_ptr(), kv_pages.data_ptr(), _ptr(kv_scales),
              page_table.data_ptr(), prior_lengths.data_ptr(), kv_lengths.data_ptr(), out.data_ptr())
    if q.dtype == torch.bfloat16:
        cblk = chunk_tc_query_block(C, G)
        n_blocks = B * Hkv * -(-C // cblk)
        splits, tps = chunk_splits(maxp * page, C, cblk, B * Hkv, sm_count(q.device))
        ws = (None if splits == 1 else
              torch.empty(n_blocks * splits * cblk * G * (D + 2), dtype=torch.float32, device=q.device))
        _launch(
            "paged_chunk_tc", q, _DTYPES[q.dtype], _DTYPES[kv_pages.dtype], *common, _ptr(ws),
            _COUNTER_PTR, B, C, Hq, Hkv, D, L, P * page, page, maxp, int(layer), cblk, splits, tps,
            counters=n_blocks if splits > 1 else 0,
        )
    else:
        _launch(
            "paged_chunk", q, _DTYPES[q.dtype], _DTYPES[kv_pages.dtype], *common,
            B, C, Hq, Hkv, D, L, P * page, page, maxp, int(layer),
            chunk_query_block(C, G, CHUNK_ROWS[q.dtype]),
        )
        paged_chunk_attention_kernel.launches_f32_body += 1
    _count(paged_chunk_attention_kernel, "launches", kv_scales)
    by_c = paged_chunk_attention_kernel.launches_by_c
    by_c[C] = by_c.get(C, 0) + 1
    return out


paged_chunk_attention_kernel.launches = 0
paged_chunk_attention_kernel.launches_int8 = 0
# Launches of the CUDA-core body (float32 queries, any pool); the rest of
# ``launches`` + ``launches_int8`` ran on the tensor cores.
paged_chunk_attention_kernel.launches_f32_body = 0
# Launches of either body by chunk length C (both pool kinds).
paged_chunk_attention_kernel.launches_by_c = {}

_COUNTED = (
    (paged_decode_fused_kernel, "launches"),
    (paged_chunk_attention_kernel, "launches"),
    (paged_attention_pool_kernel, "launches"),
    (paged_decode_fused_plain, "calls"),
    (paged_chunk_attention_plain, "calls"),
    (paged_attention_pool_plain, "calls"),
)


def reset_counters() -> None:
    """Zero every wrapper's launch counts and every plain version's call
    counts (bf16/f32 and int8 pools), and clear the chunk kernel's
    ``launches_by_c``."""
    for fn, attr in _COUNTED:
        setattr(fn, attr, 0)
        setattr(fn, f"{attr}_int8", 0)
    paged_chunk_attention_kernel.launches_f32_body = 0
    paged_chunk_attention_kernel.launches_by_c = {}


def plain_calls() -> int:
    """Calls of every plain version since the last :func:`reset_counters`."""
    return sum(getattr(fn, a) + getattr(fn, f"{a}_int8") for fn, a in _COUNTED[3:])


def launch_counts() -> dict:
    """Every wrapper's launches and every plain version's calls since the
    last :func:`reset_counters`, by name (``<name>`` for bf16/f32 pools,
    ``<name>[int8]`` for int8 pools), plus the CUDA-core chunk body's
    launches: what ``/stats`` reports as ``kernels``."""
    out = {}
    for fn, attr in _COUNTED:
        out[fn.__name__] = getattr(fn, attr)
        out[f"{fn.__name__}[int8]"] = getattr(fn, f"{attr}_int8")
    out["paged_chunk_attention_kernel[f32 body]"] = paged_chunk_attention_kernel.launches_f32_body
    return out
