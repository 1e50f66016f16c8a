"""Paged KV pool: one preallocated device tensor for every layer of one model
replica (the JAX package's ``cache/kv_pool.py``: ``SlotAllocator`` and
``PagedKVPool``, bf16/f32 pools and int8 pools with per-token scales).

- ``kv`` is ``[2, L, Hkv, num_slots, D]`` (K and V stacked, head-major),
  allocated once; its pages view ``[2, L, Hkv, P, page, D]`` is a pure
  reshape, the layout the paged-attention kernels read.
- ``quant="int8"`` stores ``kv`` as int8 beside ``kv_scale`` float32
  ``[2, L, Hkv, num_slots]`` (value ≈ int8 · scale, ``ops/quant.py``); its
  pages view ``[2, L, Hkv, P, page]`` is again a reshape. ``write``
  quantizes on store and ``gather`` dequantizes.
- A host-side :class:`SlotAllocator` free list hands out whole pages of
  token slots; the radix tree stores slot ids as node values and returns
  them on eviction.
- Writes update ``kv`` in place (index assignment), where the JAX package
  donates the pool through jitted scatters.
- ``gather_raw``/``write_raw`` move the stored representation (int8 with
  its scales) in the token-major ``[2, L, n, Hkv, D]`` format that the
  host and disk tiers keep (``cache/host_cache.py``, ``cache/kv_tier.py``).
- ``write_block`` stores such a block for a range of layers: the
  disaggregated handoff's write (``engine/disagg.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from radixmesh_tpu_torch.ops.quant import KV_QUANT_DTYPES, dequantize_kv, quantize_kv
from radixmesh_tpu_torch.utils.device import resolve_device

__all__ = ["SlotAllocator", "PagedKVPool"]


class SlotAllocator:
    """Host-side free-list allocator of KV token slots, page-granular.

    ``alloc(n)`` returns slot indices covering ``ceil(n/page_size)`` whole
    pages. Freeing accepts any subset of slots and returns a page to the
    free list once every slot in it is free.
    """

    def __init__(self, num_slots: int, page_size: int = 1):
        if num_slots % page_size != 0:
            raise ValueError("num_slots must be a multiple of page_size")
        self.num_slots = num_slots
        self.page_size = page_size
        self.num_pages = num_slots // page_size
        # LIFO free list of pages with zero allocated slots.
        self._free_pages: list[int] = list(range(self.num_pages - 1, -1, -1))
        # Per-slot allocation state and per-page count of allocated slots:
        # a page re-enters the free list exactly when its count returns to
        # zero, so the unused tail slots of a partial page go back with it.
        self._slot_allocated = np.zeros(num_slots, dtype=bool)
        self._page_alloc_count = np.zeros(self.num_pages, dtype=np.int32)

    @property
    def free_slots(self) -> int:
        return len(self._free_pages) * self.page_size

    def is_allocated(self, slots: np.ndarray) -> np.ndarray:
        """Per-slot allocation state; out-of-range ids report False."""
        slots = np.asarray(slots, dtype=np.int64)
        ok = (slots >= 0) & (slots < self.num_slots)
        out = np.zeros(len(slots), dtype=bool)
        out[ok] = self._slot_allocated[slots[ok]]
        return out

    def alloc(self, n_tokens: int) -> np.ndarray | None:
        """Slots for ``n_tokens`` tokens (whole pages), or ``None`` if the
        pool can't satisfy the request (the caller evicts and retries)."""
        if n_tokens <= 0:
            return np.empty(0, dtype=np.int32)
        n_pages = -(-n_tokens // self.page_size)
        if n_pages > len(self._free_pages):
            return None
        pages = [self._free_pages.pop() for _ in range(n_pages)]
        slots = (
            np.asarray(pages, dtype=np.int32)[:, None] * self.page_size
            + np.arange(self.page_size, dtype=np.int32)[None, :]
        ).reshape(-1)[:n_tokens]
        self._slot_allocated[slots] = True
        pg, counts = np.unique(slots // self.page_size, return_counts=True)
        self._page_alloc_count[pg] = counts.astype(np.int32)
        return slots

    def reserve(self, slots: np.ndarray) -> None:
        """Claim specific slots; raises if any is already allocated."""
        slots = np.asarray(slots, dtype=np.int32)
        if slots.size == 0:
            return
        if np.any(self._slot_allocated[slots]):
            raise ValueError("cannot reserve: slot(s) already allocated")
        self._slot_allocated[slots] = True
        pages, counts = np.unique(slots // self.page_size, return_counts=True)
        newly_used = pages[self._page_alloc_count[pages] == 0]
        self._page_alloc_count[pages] += counts.astype(np.int32)
        used = set(int(p) for p in newly_used)
        self._free_pages = [p for p in self._free_pages if p not in used]

    def free(self, slots: np.ndarray) -> None:
        slots = np.asarray(slots, dtype=np.int32)
        if slots.size == 0:
            return
        if len(np.unique(slots)) != len(slots) or not np.all(
            self._slot_allocated[slots]
        ):
            # Checked before any mutation so the allocator stays consistent.
            raise ValueError("double free of KV slots")
        self._slot_allocated[slots] = False
        pages, counts = np.unique(slots // self.page_size, return_counts=True)
        self._page_alloc_count[pages] -= counts.astype(np.int32)
        for p in pages[self._page_alloc_count[pages] == 0]:
            self._free_pages.append(int(p))


class PagedKVPool:
    """Preallocated paged KV storage for every layer of one model replica."""

    def __init__(
        self,
        num_slots: int,
        num_layers: int,
        num_kv_heads: int,
        head_dim: int,
        page_size: int = 1,
        dtype: torch.dtype = torch.bfloat16,
        device: torch.device | str | None = None,
        quant: str | None = None,
    ):
        device = resolve_device(device)
        if quant is not None:
            if quant not in KV_QUANT_DTYPES:
                raise ValueError(f"unknown kv quantization {quant!r}")
            dtype = KV_QUANT_DTYPES[quant]
        elif dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"pool dtype {dtype} is not supported (bf16/f32, or quant='int8')")
        self.num_slots = num_slots
        self.num_layers = num_layers
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.page_size = page_size
        self.dtype = dtype
        self.quant = quant
        self.allocator = SlotAllocator(num_slots, page_size)
        self.kv = torch.zeros(
            (2, num_layers, num_kv_heads, num_slots, head_dim),
            dtype=dtype,
            device=device,
        )
        self.kv_scale = None
        if quant is not None:
            self.kv_scale = torch.zeros(
                (2, num_layers, num_kv_heads, num_slots), dtype=torch.float32, device=device
            )

    @property
    def device(self) -> torch.device:
        return self.kv.device

    @property
    def num_pages(self) -> int:
        return self.allocator.num_pages

    # ---- allocation (host side) ----

    def alloc(self, n_tokens: int) -> np.ndarray | None:
        return self.allocator.alloc(n_tokens)

    def free(self, slots: np.ndarray) -> None:
        self.allocator.free(slots)

    def reserve(self, slots: np.ndarray) -> None:
        self.allocator.reserve(slots)

    @property
    def free_slots(self) -> int:
        return self.allocator.free_slots

    def fill_free_fraction(self) -> float:
        """Free fraction of the pool, 0..1: the fleet digest's ``pool_fill``
        complement (``obs/fleet_plane.py``)."""
        if self.num_slots <= 0:
            return 1.0
        return self.free_slots / self.num_slots

    # ---- device ops ----

    def _index(self, slots) -> torch.Tensor:
        return torch.as_tensor(np.asarray(slots, dtype=np.int64), device=self.kv.device)

    def write(self, slots, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write per-layer K/V for ``n`` tokens at ``slots``; ``k``/``v``
        are ``[L, n, kv_heads, head_dim]``. Updates ``kv`` (and, for int8
        pools, ``kv_scale``) in place; int8 pools quantize on store."""
        if len(slots) == 0:
            return
        new_kv = torch.stack([k, v]).permute(0, 1, 3, 2, 4)  # [2, L, H, n, D]
        idx = self._index(slots)
        if self.quant is not None:
            q, scale = quantize_kv(new_kv)
            self.kv[:, :, :, idx] = q
            self.kv_scale[:, :, :, idx] = scale
        else:
            self.kv[:, :, :, idx] = new_kv.to(self.dtype)

    def pages(self) -> torch.Tensor:
        """Zero-copy pages view ``[2, L, Hkv, P, page, D]``."""
        return self.kv.view(
            2, self.num_layers, self.num_kv_heads, self.num_pages,
            self.page_size, self.head_dim,
        )

    def scale_pages(self) -> torch.Tensor | None:
        """Zero-copy scales view ``[2, L, Hkv, P, page]`` (int8 pools), or
        None."""
        if self.kv_scale is None:
            return None
        return self.kv_scale.view(
            2, self.num_layers, self.num_kv_heads, self.num_pages, self.page_size
        )

    def pages_for_layer(self, layer: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(k_pages, v_pages), each ``[Hkv, P, page, D]`` — views."""
        p = self.pages()
        return p[0, layer], p[1, layer]

    def gather(self, slots) -> torch.Tensor:
        """``[2, L, n, kv_heads, head_dim]`` for the given slots,
        dequantized to float32 for int8 pools."""
        idx = self._index(slots)
        if self.quant is not None:
            kv = dequantize_kv(self.kv[:, :, :, idx], self.kv_scale[:, :, :, idx])
        else:
            kv = self.kv[:, :, :, idx]
        return kv.permute(0, 1, 3, 2, 4)

    def gather_raw(self, slots) -> tuple[torch.Tensor, torch.Tensor | None]:
        """``(kv [2, L, n, H, D] in the POOL dtype, scales [2, L, n, H] |
        None)`` on the pool's device: the exact stored representation, in
        the token-major interchange format of the host and disk tiers (an
        int8 pool ships its ints and scales, never a dequantized copy).
        One indexing gather, enqueued on the current stream. The result is
        a token-major VIEW of slot-major storage (``permute(2, 0, 1, 3, 4)``
        of it is contiguous ``[n, 2, L, H, D]``): each token's K/V is one
        contiguous block, so a run of tokens moves to or from the host
        arena as one copy."""
        idx = self._index(slots)
        kv = self.kv.permute(3, 0, 1, 2, 4)[idx].permute(1, 2, 0, 3, 4)
        if self.quant is None:
            return kv, None
        return kv, self.kv_scale.permute(3, 0, 1, 2)[idx].permute(1, 2, 0, 3)

    def write_raw(self, slots, kv: torch.Tensor, scales: torch.Tensor | None = None) -> None:
        """Store a token-major ``[2, L, n, H, D]`` block verbatim at
        ``slots`` (inverse of :meth:`gather_raw`; ``scales`` ``[2, L, n,
        H]`` for int8 pools). No cast and no quantization: ``kv`` must be
        in the pool dtype, so a round trip is bit-exact. Unlike the JAX
        package's ``write_raw`` (int8 pools only) it serves every pool
        dtype, which the tiers' restores use. The JAX package pads the
        token count to a power-of-two bucket for its jit cache; eager
        PyTorch compiles nothing per shape, so the write is exactly ``n``
        tokens. Any strides are taken (the tiers pass views)."""
        if len(slots) == 0:
            return
        if kv.dtype != self.dtype:
            raise ValueError(f"write_raw takes the pool dtype {self.dtype}, got {kv.dtype}")
        if (scales is None) != (self.quant is None):
            raise ValueError("write_raw takes scales exactly for quantized pools")
        idx = self._index(slots)
        self.kv[:, :, :, idx] = kv.to(self.kv.device).permute(0, 1, 3, 2, 4)
        if scales is not None:
            self.kv_scale[:, :, :, idx] = scales.to(self.kv.device).permute(0, 1, 3, 2)

    def write_block(self, slots, kv: torch.Tensor, layer0: int = 0,
                    scales: torch.Tensor | None = None, ready=None) -> None:
        """Store a token-major ``[2, nL, n, H, D]`` block covering layers
        ``[layer0, layer0 + nL)`` at ``slots`` (the staged handoff's write,
        ``engine/disagg.py``). The JAX package's dtype dispatch: ``scales``
        given → the ints and scales verbatim (int8 pools only); an int8
        pool without scales → quantize on store; a plain pool → cast and
        store. A full-layer block goes through :meth:`write` /
        :meth:`write_raw`. ``ready``: a CUDA event recorded after the copy
        that produced ``kv`` on another stream; the current stream waits on
        it before the scatter, and the block's memory is marked as used by
        the current stream."""
        if len(slots) == 0:
            return
        if scales is not None and self.quant is None:
            raise ValueError("raw quantized blocks target quantized pools")
        if ready is not None:
            stream = torch.cuda.current_stream(self.kv.device)
            stream.wait_event(ready)
            for t in (kv, scales):
                if t is not None:
                    t.record_stream(stream)
        nl = kv.shape[1]
        if layer0 == 0 and nl == self.num_layers:
            if scales is not None:
                self.write_raw(slots, kv, scales)
            else:
                self.write(slots, kv[0], kv[1])
            return
        idx = self._index(slots)
        layers = slice(layer0, layer0 + nl)
        new_kv = kv.permute(0, 1, 3, 2, 4)  # token- → head-major [2, nL, H, n, D]
        if scales is not None:
            self.kv[:, layers, :, idx] = new_kv.to(self.dtype)
            self.kv_scale[:, layers, :, idx] = scales.permute(0, 1, 3, 2).float()
        elif self.quant is not None:
            q, scale = quantize_kv(new_kv)
            self.kv[:, layers, :, idx] = q
            self.kv_scale[:, layers, :, idx] = scale
        else:
            self.kv[:, layers, :, idx] = new_kv.to(self.dtype)

    def page_table(self, slots: np.ndarray) -> np.ndarray:
        """Page ids covering a page-aligned run of slots."""
        slots = np.asarray(slots, dtype=np.int32)
        if slots.size == 0:
            return np.empty(0, dtype=np.int32)
        if self.page_size == 1:
            return slots
        heads = slots[:: self.page_size]
        if np.any(heads % self.page_size != 0):
            raise ValueError("slots are not page-aligned")
        return heads // self.page_size
