"""The chunk kernel's float32 body on the CUDA cores (``csrc/paged_chunk.cu``),
on the CPU.

- A numpy emulation of the body's algorithm, held against the JAX package's
  Pallas kernel in interpret mode: CTAs of ``Cblk * G <= 128`` query rows
  (rows past ``R`` are padding, masked), 64-key tiles in page-table order with
  every key past the prior zero-filled, then the chunk's dense keys in
  64-key tiles, causal per row; an online softmax in base 2 (queries
  pre-scaled by log2(e)/sqrt(D)) across the prior → dense boundary with
  masked scores at the finite mask value, masked probabilities exactly 0
  and each row's sum kept as 16 per-thread partials (thread tx holds keys
  tx + 16j) added after the last tile, as the kernel does; int8 pages
  widened and multiplied by their token's scale as they are staged.
  Float32 and int8 pools at G 1, 4 and 7, with a cold row, a mid-page
  prior, a partial chunk, an exhausted row (``kv_lengths == prior``) and a
  NaN-poisoned page behind every page-table pad and page tail (NaN scales
  for int8). Tolerance atol 1e-5: online against one-shot softmax, base 2
  against base e, and int8 scales applied before the dot (here) or after
  it (the Pallas kernel).
- The body's row count: ``CHUNK_ROWS[torch.float32]`` is ``kRows`` of the
  source, and ``chunk_query_block`` gives the block the body is launched
  with at G 1..8 and C in {512, 64, 16, 5}.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.ops import quant as jquant
from radixmesh_tpu.ops.paged_attention import paged_chunk_attention_kernel as j_chunk_kernel
from radixmesh_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)  # the suite runs in parallel worker processes
ATOL = 1e-5
CSRC = pathlib.Path(tpa.__file__).resolve().parent / "csrc"
ROWS, KEYS, THREADS_PER_ROW = 128, 64, 16
MASK = np.float32(-0.7 * 3.4028234663852886e38)  # kMask of common.cuh
LOG2E = np.float32(1.4426950408889634)
# The thread (of the 16 that share a row) whose scores hold key t.
KEY_THREAD = np.arange(KEYS) % THREADS_PER_ROW
HKV, D, PAGE, MAXP, LAYER = 2, 32, 8, 32, 1


def _body(q, k_cur, v_cur, kv, pt, prior_lengths, kv_lengths, layer, kv_scales=None):
    """What ``paged_chunk.cu`` computes, step by step, in float32 numpy."""
    f32 = np.float32
    B, C, Hq, Dh = q.shape
    Hkv, page = kv.shape[2], kv.shape[4]
    G = Hq // Hkv
    cblk = tpa.chunk_query_block(C, G, ROWS)
    R = cblk * G
    scale = LOG2E / np.sqrt(f32(Dh))
    out = np.zeros((B, C, Hq, Dh), f32)
    for b in range(B):
        prior = min(max(int(prior_lengths[b]), 0), pt.shape[1] * page)
        n_dense = min(max(int(kv_lengths[b]) - prior, 0), C)
        for h in range(Hkv):
            def pool_tile(which, t0, n):
                # Keys t < n through the page table; the rest zero-filled.
                tile = np.zeros((KEYS, Dh), f32)
                tok = t0 + np.arange(n)
                pg, off = pt[b, tok // page], tok % page
                rows = kv[which, layer, h, pg, off].astype(f32)
                if kv_scales is not None:
                    rows = rows * kv_scales[which, layer, h, pg, off][:, None]
                tile[:n] = rows
                return tile

            for cb in range(C // cblk):
                c0 = cb * cblk
                Q = np.zeros((ROWS, Dh), f32)
                for r in range(R):
                    Q[r] = q[b, c0 + r // G, h * G + r % G].astype(f32) * scale
                rows = np.arange(ROWS)
                m = np.full(ROWS, MASK, f32)
                l_part = np.zeros((ROWS, THREADS_PER_ROW), f32)
                o = np.zeros((ROWS, Dh), f32)
                k_end = min(c0 + cblk, n_dense)
                tiles = [("prior", t0) for t0 in range(0, prior, KEYS)]
                tiles += [("dense", k0) for k0 in range(0, k_end, KEYS)]
                for kind, t0 in tiles:
                    if kind == "prior":
                        n = min(KEYS, prior - t0)
                        K, V = pool_tile(0, t0, n), pool_tile(1, t0, n)
                        lim = np.where(rows < R, n, 0)
                    else:
                        n = min(KEYS, k_end - t0)
                        K = np.zeros((KEYS, Dh), f32)
                        V = np.zeros((KEYS, Dh), f32)
                        K[:n] = k_cur[b, t0 : t0 + n, h]
                        V[:n] = v_cur[b, t0 : t0 + n, h]
                        lim = np.where(rows < R, np.minimum(n, c0 + rows // G - t0 + 1), 0)
                    vis = np.arange(KEYS)[None, :] < lim[:, None]
                    s = np.where(vis, Q @ K.T, MASK).astype(f32)
                    m_new = np.maximum(m, s.max(axis=1))
                    p = np.where(vis, np.exp2(s - m_new[:, None]), f32(0)).astype(f32)
                    corr = np.exp2(m - m_new).astype(f32)
                    part = np.stack([p[:, KEY_THREAD == tx].sum(axis=1)
                                     for tx in range(THREADS_PER_ROW)], axis=1)
                    l_part = l_part * corr[:, None] + part
                    o = o * corr[:, None] + p @ V
                    m = m_new
                l = l_part.sum(axis=1)
                res = np.where(l[:, None] > 0, o / np.where(l > 0, l, 1)[:, None], f32(0))
                for r in range(R):
                    out[b, c0 + r // G, h * G + r % G] = res[r]
    return out


def _case(G, C, kind, seed):
    """Rows: cold (prior 0, a whole chunk); a mid-page prior with a
    partial chunk; an exhausted row (prior over three 64-key tiles, no
    chunk keys); a prior of whole pages with five chunk keys. Page-table
    pads and the slots past each row's prior hold NaN (the scales, for
    int8 pools)."""
    rng = np.random.default_rng(seed)
    prior = np.asarray([0, 37, 150, 200], np.int32)
    n_valid = np.asarray([C, C // 2 + 3, 0, 5], np.int32)
    B, P = len(prior), len(prior) * MAXP + 1
    nan_page = P - 1
    pt = rng.permutation(P - 1)[: B * MAXP].reshape(B, MAXP).astype(np.int32)
    kv = rng.normal(size=(2, 2, HKV, P, PAGE, D)).astype(np.float32)
    sc = None
    if kind == "int8":
        q8, sc = jquant.quantize_kv(jnp.asarray(kv), axis=-1)
        kv, sc = np.array(q8), np.array(sc)
    poison = sc if kind == "int8" else kv
    poison[:, :, :, nan_page] = np.nan
    for b in range(B):
        used = -(-int(prior[b]) // PAGE)
        pt[b, used:] = nan_page
        if prior[b] % PAGE:
            poison[:, :, :, pt[b, used - 1], prior[b] % PAGE:] = np.nan
    q = rng.normal(size=(B, C, HKV * G, D)).astype(np.float32)
    k = rng.normal(size=(B, C, HKV, D)).astype(np.float32)
    v = rng.normal(size=(B, C, HKV, D)).astype(np.float32)
    if kind == "int8":  # the chunk's K/V arrive dequantized, in float32
        *_, k, v = jquant.quantize_for_store(jnp.asarray(k), jnp.asarray(v))
        k, v = np.asarray(k), np.asarray(v)
    return q, k, v, kv, pt, prior, prior + n_valid, sc


@pytest.mark.parametrize("kind", ["float32", "int8"])
@pytest.mark.parametrize("G,C", [(1, 128), (4, 32), (7, 16)], ids=["G1", "G4", "G7"])
def test_emulated_body_matches_pallas(G, C, kind):
    q, k, v, kv, pt, prior, kvlen, sc = _case(G, C, kind, seed=40 + G)
    want = np.asarray(j_chunk_kernel(
        *(jnp.asarray(a) for a in (q, k, v, kv, pt, prior, kvlen)), LAYER, interpret=True,
        kv_scales=None if sc is None else jnp.asarray(sc)))
    got = _body(q, k, v, kv, pt, prior, kvlen, LAYER, sc)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # The exhausted row attends its prior alone; the cold row sees its chunk.
    assert np.abs(got[2]).max() > 0 and np.abs(got[0]).max() > 0


def test_emulated_body_matches_the_plain_version():
    """The plain version (what the card run holds the kernel to) and the
    emulation agree on one int8 case at G 4, so the kernel's algorithm and
    its reference compute the same function."""
    q, k, v, kv, pt, prior, kvlen, sc = _case(4, 32, "int8", seed=7)
    want = tpa.paged_chunk_attention_plain(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, kv, pt, prior, kvlen)), LAYER,
        torch.from_numpy(sc))
    got = _body(q, k, v, kv, pt, prior, kvlen, LAYER, sc)
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=ATOL)


def test_row_count_matches_the_source():
    src = (CSRC / "paged_chunk.cu").read_text()
    rows = int(re.search(r"constexpr int kRows = (\d+);", src).group(1))
    keys = int(re.search(r"constexpr int kKeys = (\d+);", src).group(1))
    assert tpa.CHUNK_ROWS[torch.float32] == rows == ROWS
    assert keys == KEYS


# The query block the body is launched with: the largest power-of-two
# divisor of C with Cblk * G <= 128 rows.
BLOCKS = {
    512: {1: 128, 2: 64, 3: 32, 4: 32, 5: 16, 6: 16, 7: 16, 8: 16},
    64: {1: 64, 2: 64, 3: 32, 4: 32, 5: 16, 6: 16, 7: 16, 8: 16},
    16: {G: 16 for G in range(1, 9)},
    5: {G: 1 for G in range(1, 9)},
}


@pytest.mark.parametrize("C", sorted(BLOCKS))
@pytest.mark.parametrize("G", range(1, 9))
def test_query_block_at_every_group(G, C):
    cblk = tpa.chunk_query_block(C, G, tpa.CHUNK_ROWS[torch.float32])
    assert cblk == BLOCKS[C][G]
    assert C % cblk == 0 and cblk * G <= ROWS
