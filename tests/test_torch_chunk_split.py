"""The tensor-core chunk body's host-side choices and its split over the
prior, on the CPU.

- ``chunk_tc_query_block``: the query blocks cover every query of C exactly
  once, all in one CTA while C * G fits the body's 128 rows, the last block
  ragged otherwise.
- ``chunk_splits``: from shapes alone (page-table width, C, the query
  block, B * Hkv, the SM count; never lengths), the splits of a (row, kv
  head, query block)'s 64-key tiles — prior, then dense — cover every tile
  exactly once for any prior and chunk fill, every split starts inside the
  longest list, and a split holds at least four tiles where it splits.
- A plain version of the split and its log-sum-exp merge (test-only, here:
  each split's float32 partials m, l and O over its share of the tiles,
  then the merge in split order, as the kernel's last CTA does) equals
  ``paged_chunk_attention_plain`` and the JAX package's
  ``paged_chunk_attention_kernel`` in interpret mode, at C in {5, 16, 64}
  and splits in {1, 2, 7}, with empty splits, an all-padding row
  (kv_lengths = prior), NaN-poisoned pad pages and page tails (for int8
  pools the NaN sits in the scales), over float32 and int8 pools. Tiles are
  8 keys here (the kernel's are 64) so that small shapes split many ways.
  Tolerance: float32 atol 1e-5 (summation order).
"""

import functools
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.ops import quant as jquant
from radixmesh_tpu.ops.paged_attention import paged_chunk_attention_kernel as j_chunk_kernel
from radixmesh_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)  # the suite runs in parallel worker processes
ATOL = 1e-5
MASK = tpa._MASK
TILE = 8  # keys per tile of the plain split


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=0, atol=atol
    )


# ---------------------------------------------------------------------------
# host-side choices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G", range(1, 9))
def test_query_blocks_cover_every_query_once(G):
    for C in (1, 2, 5, 16, 17, 32, 64, 100, 128, 256, 512):
        cblk = tpa.chunk_tc_query_block(C, G)
        assert 1 <= cblk * G <= 128 and cblk <= C
        assert cblk == C or (cblk + 1) * G > 128  # as many as fit
        covered = np.zeros(C, np.int32)
        for c0 in range(0, C, cblk):
            covered[c0 : min(c0 + cblk, C)] += 1
        assert (covered == 1).all()


@pytest.mark.parametrize("n_ctx", [64, 256, 512, 1024, 2048, 4096, 8192])
def test_chunk_splits_cover_every_tile_once(n_ctx):
    for sms in (114, 132):
        for C, G in ((5, 4), (16, 4), (16, 7), (64, 8), (512, 4), (512, 7), (512, 1)):
            cblk = tpa.chunk_tc_query_block(C, G)
            for rows in (1, 2, 8, 32, 64, 256):
                splits, tps = tpa.chunk_splits(n_ctx, C, cblk, rows, sms)
                tiles = -(-n_ctx // 64) + -(-C // 64)
                assert splits >= 1 and tps >= 1
                assert splits * tps >= tiles and (splits - 1) * tps < tiles
                assert splits == 1 or tps >= 4
                # Any prior and chunk fill: tiles [0, total) split as
                # [s * tps, (s + 1) * tps), each exactly once.
                for total in range(tiles + 1):
                    covered = np.zeros(total, np.int32)
                    parts = max(1, -(-total // tps))
                    assert parts <= splits
                    for s in range(parts):
                        covered[s * tps : min((s + 1) * tps, total)] += 1
                    assert (covered == 1).all()


def test_chunk_splits_by_shape():
    # A grid that fills half the card or more takes one split: C = 512 at
    # B = 8 (1024 CTAs) or B = 1 (128); a verify (C = 5) or a mixed wave
    # (C = 16) over 8 rows (64 CTAs) several, and a single row at C = 512
    # over two kv heads (32 CTAs) too.
    assert tpa.chunk_splits(4096, 512, 32, 64, 132) == (1, 72)
    assert tpa.chunk_splits(4096, 512, 32, 8, 132) == (1, 72)
    assert tpa.chunk_splits(4096, 5, 5, 64, 132) == (9, 8)
    assert tpa.chunk_splits(4096, 16, 16, 64, 132) == (9, 8)
    assert tpa.chunk_splits(4096, 512, 32, 2, 132) == (15, 5)
    assert tpa.chunk_splits(64, 5, 5, 64, 132) == (1, 2)  # two tiles: no split


def test_never_needs_lengths_or_a_sync():
    assert list(inspect.signature(tpa.chunk_splits).parameters) == ["n_ctx", "C", "cblk", "rows", "sms"]
    assert list(inspect.signature(tpa.chunk_tc_query_block).parameters) == ["C", "G"]
    for fn in (tpa.paged_chunk_attention_kernel, tpa.chunk_splits, tpa.chunk_tc_query_block):
        src = inspect.getsource(fn)
        for call in (".item()", ".cpu()", ".tolist()", ".numpy()"):
            assert call not in src, f"{fn.__name__} calls {call}"


def test_launches_by_c_is_cleared_with_the_counters():
    tpa.paged_chunk_attention_kernel.launches_by_c.update({5: 3, 512: 32})
    tpa.reset_counters()
    assert tpa.paged_chunk_attention_kernel.launches_by_c == {}
    # launch_counts() keeps its keys; the counts by C stay on the wrapper.
    assert "paged_chunk_attention_kernel" in tpa.launch_counts()
    assert not any("by_c" in k for k in tpa.launch_counts())


# ---------------------------------------------------------------------------
# the split and the merge, plain
# ---------------------------------------------------------------------------


def split_chunk(q, k_cur, v_cur, kv_pages, page_table, prior_lengths, kv_lengths, layer,
                kv_scales, splits, tile=TILE):
    """The chunk kernel's output by its split: each (row, kv head) lists
    its tiles of ``tile`` keys — the prior's, then the chunk's dense keys —
    and split ``s`` attends those of tiles ``[s * tps, (s + 1) * tps)``,
    writing float32 partials (m, l, O per query row; a row that sees no key
    there holds m = MASK, l = O = 0). The merge weighs each split by
    exp(m_s - max m), in split order; rows whose denominator is 0 output
    zeros."""
    B, C, Hq, D = q.shape
    Hkv, page = kv_pages.shape[2], kv_pages.shape[4]
    G = Hq // Hkv
    n_ctx = page_table.shape[1] * page
    prior = prior_lengths.long().clamp(0, n_ctx)
    n_dense = (kv_lengths.long() - prior).clamp(0, C)
    k = torch.cat([tpa._gather_rows(kv_pages, 0, layer, page_table, kv_scales), k_cur.float()], dim=1)
    v = torch.cat([tpa._gather_rows(kv_pages, 1, layer, page_table, kv_scales), v_cur.float()], dim=1)
    pos = torch.arange(n_ctx)
    c = torch.arange(C)
    n_prior_tiles = -(-prior // tile)  # [B]
    # Each key's tile in its row's list: prior keys by position, dense keys
    # after the prior's tiles.
    tile_of = torch.cat([pos[None, :].expand(B, n_ctx) // tile,
                         n_prior_tiles[:, None] + c[None, :] // tile], dim=1)  # [B, K]
    key_ok = torch.cat([pos[None, :] < prior[:, None], c[None, :] < n_dense[:, None]], dim=1)
    causal = torch.cat([torch.ones(C, n_ctx, dtype=torch.bool), c[None, :] <= c[:, None]], dim=1)
    tiles = -(-n_ctx // tile) + -(-C // tile)
    tps = -(-tiles // splits)
    qg = (q.float() * (1.0 / math.sqrt(D))).reshape(B, C, Hkv, G, D)
    s_all = torch.einsum("bchgd,bkhd->bhgck", qg, k)  # [B, Hkv, G, C, K]
    ms, ls, os_ = [], [], []
    for sp in range(splits):
        in_split = (tile_of >= sp * tps) & (tile_of < (sp + 1) * tps)  # [B, K]
        ok = (key_ok & in_split)[:, None, None, None, :] & causal[None, None, None]
        sm = torch.where(ok, s_all, MASK)
        m = sm.amax(dim=-1)
        p = torch.where(ok, torch.exp(sm - m[..., None]), 0.0)
        vz = torch.where((key_ok & in_split)[:, :, None, None], v, 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        os_.append(torch.einsum("bhgck,bkhd->bhgcd", p, vz))
    M = torch.stack(ms).amax(dim=0)
    L = torch.zeros_like(M)
    O = torch.zeros_like(os_[0])
    for m, l, o in zip(ms, ls, os_):  # split order
        w = torch.exp(m - M)
        L = L + w * l
        O = O + w[..., None] * o
    out = torch.where(L[..., None] > 0, O / L.clamp_min(1e-30)[..., None], 0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, Hq, D)


# Rows: cold (prior 0), mid-page prior, long prior with a partial chunk,
# an all-padding row (no chunk keys), a prior ending on a page boundary.
PRIOR = [0, 5, 27, 13, 16]


def _case(C, kind, Hq=8, Hkv=2, D=32, page=8, maxp=8, L=2, seed=0):
    """Disjoint permuted pages per row; page-table pads point at a NaN page
    and every slot of a row's last prior page at or past its prior is NaN
    (K/V for float32 pools, the scales for int8 pools)."""
    rng = np.random.default_rng(seed + C)
    B = len(PRIOR)
    P = B * maxp + 1
    nan_page = P - 1
    prior = np.asarray(PRIOR, np.int32)
    fill = np.asarray([C, C, max(1, C // 2), 0, C - 1], np.int32)
    q = rng.normal(size=(B, C, Hq, D)).astype(np.float32)
    kc = rng.normal(size=(B, C, Hkv, D)).astype(np.float32)
    vc = rng.normal(size=(B, C, Hkv, D)).astype(np.float32)
    kv = rng.normal(size=(2, L, Hkv, P, page, D)).astype(np.float32)
    pt = rng.permutation(P - 1)[: B * maxp].reshape(B, maxp).astype(np.int32)
    scales = None
    if kind == "int8":
        q8, sc = jquant.quantize_kv(jnp.asarray(kv), axis=-1)
        kv, scales = np.asarray(q8), np.array(sc)
        *_, kc, vc = jquant.quantize_for_store(jnp.asarray(kc), jnp.asarray(vc))
        kc, vc = np.asarray(kc), np.asarray(vc)
    poisoned = scales if kind == "int8" else kv
    for b in range(B):
        used = -(-int(prior[b]) // page)
        pt[b, used:] = nan_page
        if prior[b] % page:
            poisoned[:, :, :, pt[b, used - 1], prior[b] % page:] = np.nan
    poisoned[:, :, :, nan_page] = np.nan
    return q, kc, vc, kv, scales, pt, prior, prior + fill


@functools.lru_cache(maxsize=None)
def _reference(C, kind):
    """The plain version's and the JAX kernel's outputs (interpret mode)."""
    q, kc, vc, kv, sc, pt, prior, kvlen = _case(C, kind)
    layer = 1
    plain = tpa.paged_chunk_attention_plain(
        *(_t(a) for a in (q, kc, vc, kv, pt, prior, kvlen)), layer, _t(sc)).numpy()
    want_j = np.asarray(j_chunk_kernel(
        *(jnp.asarray(a) for a in (q, kc, vc, kv, pt, prior, kvlen)), layer,
        interpret=True, kv_scales=None if sc is None else jnp.asarray(sc)))
    return plain, want_j


@pytest.mark.parametrize("splits", [1, 2, 7])
@pytest.mark.parametrize("C", [5, 16, 64])
@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_split_merge_equals_plain_and_pallas(kind, C, splits):
    q, kc, vc, kv, sc, pt, prior, kvlen = _case(C, kind)
    got = split_chunk(*(_t(a) for a in (q, kc, vc, kv, pt, prior, kvlen)), 1, _t(sc), splits)
    assert torch.isfinite(got).all()
    plain, want_j = _reference(C, kind)
    _close(got, plain)
    _close(got, want_j)
    # The all-padding row still attends its prior; the cold row's queries
    # attend their own chunk alone.
    assert torch.count_nonzero(got[3]) > 0


def test_empty_splits_change_nothing():
    """Seven splits over a short table leave most splits of a row empty
    (and every split of the cold row's prior); the merge skips them by
    weight alone."""
    q, kc, vc, kv, sc, pt, prior, kvlen = _case(5, "float32")
    args = [_t(a) for a in (q, kc, vc, kv, pt, prior, kvlen)]
    one = split_chunk(*args, 1, None, 1)
    many = split_chunk(*args, 1, None, 7)
    per_key = split_chunk(*args, 1, None, 40, tile=1)  # a split per key, most empty
    _close(many, one)
    _close(per_key, one)
