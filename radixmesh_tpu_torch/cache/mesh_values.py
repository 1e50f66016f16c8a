"""Rank-tagged tree values for the distributed mesh cache.

Capability parity with the reference's value wrappers
(``radix_mesh.py:21-63``): prefill/decode nodes store KV slot indices tagged
with the *origin rank* that owns the actual KV pages; the router stores only
the rank (it never holds KV). Two deliberate fixes over the reference:

- ``RouterValue`` carries its true token length (the reference's
  ``RouterRadixMeshTreeValue.__len__`` returns 1, ``radix_mesh.py:61-63``,
  under-reporting router-side match lengths).
- Equality is by origin rank (two values conflict iff their origin ranks
  differ; same-origin values for the same key are identical by protocol),
  stated explicitly instead of relying on tensor comparison.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PrefillValue", "AdvertisedValue", "RouterValue"]


class PrefillValue:
    """KV slot indices + origin rank (reference ``PrefillRadixMeshTreeValue``,
    ``radix_mesh.py:21-44``). The indices address the *origin node's* paged
    KV pool; they are only usable for attention on that node."""

    __slots__ = ("indices", "rank")

    def __init__(self, indices: np.ndarray, rank: int):
        self.indices = np.asarray(indices, dtype=np.int32)
        self.rank = rank

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, item) -> "PrefillValue":
        if not isinstance(item, slice):
            raise TypeError("PrefillValue supports slice indexing only")
        return PrefillValue(self.indices[item], self.rank)

    def __eq__(self, other) -> bool:
        return isinstance(other, PrefillValue) and self.rank == other.rank

    def __array__(self, dtype=None, copy=None):
        arr = self.indices if dtype is None else self.indices.astype(dtype)
        return np.array(arr, copy=True) if copy else arr

    def __repr__(self) -> str:
        return f"PrefillValue(rank={self.rank}, n={len(self.indices)})"


class AdvertisedValue(PrefillValue):
    """A PrefillValue whose indices are an ADVERTISEMENT, not pool
    ownership — the cold-cell resurrection re-announce
    (``Engine.announce_resurrected``): the origin serves the prefix
    through a staged disk restore at admission time, so its local pool
    owns nothing here and the authoritative tree-path frees
    (``MeshCache._free_local``) must NOT release these ids. On the wire
    it is indistinguishable from a normal publish (receivers store
    rank-tagged values either way)."""

    __slots__ = ()

    def __getitem__(self, item) -> "AdvertisedValue":
        if not isinstance(item, slice):
            raise TypeError("PrefillValue supports slice indexing only")
        return AdvertisedValue(self.indices[item], self.rank)

    def __eq__(self, other) -> bool:
        """DELIBERATELY asymmetric vs PrefillValue: an advertisement is
        not equal to a same-rank REAL value, so the origin's later true
        publish triggers the conflict hook and UPGRADES the placeholder
        (``MeshCache._resolve_conflict``) instead of being swallowed by
        rank-only equality. The reverse direction (real existing value,
        advertised incoming) keeps PrefillValue's rank equality — a
        late advertisement must never displace real KV."""
        return isinstance(other, AdvertisedValue) and self.rank == other.rank


class RouterValue:
    """Origin rank + token length, no indices (reference
    ``RouterRadixMeshTreeValue``, ``radix_mesh.py:47-63``)."""

    __slots__ = ("rank", "length")

    def __init__(self, rank: int, length: int):
        self.rank = rank
        self.length = length

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, item) -> "RouterValue":
        if not isinstance(item, slice):
            raise TypeError("RouterValue supports slice indexing only")
        start, stop, step = item.indices(self.length)
        if step != 1:
            raise ValueError("RouterValue slices must be contiguous")
        return RouterValue(self.rank, max(0, stop - start))

    def __eq__(self, other) -> bool:
        return isinstance(other, RouterValue) and self.rank == other.rank

    def __repr__(self) -> str:
        return f"RouterValue(rank={self.rank}, n={self.length})"
