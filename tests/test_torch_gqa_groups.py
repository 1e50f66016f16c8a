"""GQA groups 1 to 8 in the port's three kernel families (B1 decode, B2
chunk, B3 pool), on the CPU.

- The wrappers' group check takes every group the kernels are instantiated
  for (1..8) and refuses a larger one by name.
- ``chunk_query_block`` at groups 3, 5, 6 and 7: the largest power-of-two
  divisor of C whose rows fit the CUDA-core body's CTA (128 rows; the
  64-row cases keep the rule pinned at another width); and
  ``chunk_tc_query_block``, the tensor-core body's rule at those groups: all
  C queries while C * G fits its 128 rows, else floor(128 / G), a ragged
  last block covering the rest (so G 3, 5, 6 and 7 fill 126, 125, 126 and
  126 of the 128 rows at C = 512).
- The plain versions against the JAX package's Pallas kernels in interpret
  mode at G 3, 5 and 7 (Qwen2-7B's 7, Qwen2.5-14B/32B's 5, llama3.2-3b's 3)
  over float32, bf16 and int8 pools, with length-0 and length-1 rows,
  permuted page tables and NaN-poisoned pads. Tolerances: float32 and int8
  outputs atol 1e-5 (summation order); bf16 outputs atol 1e-2 (both compute
  in float32 from the same bf16 inputs; one bf16 rounding of an output below
  2 is at most 2^-7); pool payloads after the decode write bit-equal, int8
  scales rtol 1e-6 (XLA multiplies by 1/127 where eager code divides).
- The CUDA sources' template switches have a case for every group of
  ``_GROUPS``: with no ``nvcc`` here, this is the CPU's only guard on the
  instantiation. The kernels themselves are held against the plain versions
  at G 3 and 7 on the card by ``chip_smoke.py``.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.ops import quant as jquant
from radixmesh_tpu.ops.paged_attention import (
    paged_attention_pool_kernel as j_pool_kernel,
    paged_chunk_attention_kernel as j_chunk_kernel,
    paged_decode_fused_kernel as j_decode_kernel,
)
from radixmesh_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)  # the suite runs in parallel worker processes
ATOL = {"float32": 1e-5, "bfloat16": 1e-2, "int8": 1e-5}
CSRC = pathlib.Path(tpa.__file__).resolve().parent / "csrc"
HKV, D, PAGE, MAXP, L = 2, 32, 8, 4, 2


def test_groups_cover_one_to_eight():
    assert tpa._GROUPS == (1, 2, 3, 4, 5, 6, 7, 8)


@pytest.mark.parametrize("G", range(1, 9))
def test_check_gqa_accepts_every_instantiated_group(G):
    tpa._check_gqa("k", G * 4, 4, 0, 1)


@pytest.mark.parametrize("Hq,Hkv", [(128, 8), (12, 8), (8, 0)], ids=["G16", "ragged", "no-kv"])
def test_check_gqa_refuses_by_name(Hq, Hkv):
    with pytest.raises(ValueError, match=f"GQA group Hq/Hkv={Hq}/{Hkv} unsupported"):
        tpa._check_gqa("paged_chunk_attention_kernel", Hq, Hkv, 0, 1)


@pytest.mark.parametrize("G,C,rows,want", [
    (3, 512, 128, 32), (5, 512, 128, 16), (6, 512, 128, 16), (7, 512, 128, 16),
    (3, 512, 64, 16), (5, 512, 64, 8), (6, 512, 64, 8), (7, 512, 64, 8),
    (3, 16, 128, 16), (5, 16, 128, 16), (6, 16, 128, 16), (7, 16, 128, 16),
    (3, 16, 64, 16), (5, 16, 64, 8), (6, 16, 64, 8), (7, 16, 64, 8),
    (3, 5, 128, 1), (5, 5, 128, 1), (6, 5, 128, 1), (7, 5, 128, 1),
    (3, 5, 64, 1), (7, 5, 64, 1),
])
def test_chunk_query_block_at_odd_groups(G, C, rows, want):
    cblk = tpa.chunk_query_block(C, G, rows)
    assert cblk == want
    assert C % cblk == 0 and cblk * G <= rows


@pytest.mark.parametrize("G,C,want", [
    (3, 512, 42), (5, 512, 25), (6, 512, 21), (7, 512, 18),
    (3, 16, 16), (5, 16, 16), (6, 16, 16), (7, 16, 16),
    (3, 5, 5), (5, 5, 5), (6, 5, 5), (7, 5, 5), (7, 64, 18), (3, 64, 42),
])
def test_chunk_tc_query_block_at_odd_groups(G, C, want):
    cblk = tpa.chunk_tc_query_block(C, G)
    assert cblk == want and cblk * G <= 128
    # The blocks cover every query once; only the last may be ragged.
    blocks = [range(c0, min(c0 + cblk, C)) for c0 in range(0, C, cblk)]
    assert sorted(c for blk in blocks for c in blk) == list(range(C))
    assert all(len(blk) == cblk for blk in blocks[:-1])


@pytest.mark.parametrize("source,pattern", [
    ("paged_decode.cuh", r"case (\d+): return launch<TQ, TP, D, \1, kFused>"),
    ("paged_chunk_tc.cu", r"case (\d+): return launch<TP, TC, D, \1, kGather>"),
    ("paged_chunk.cu", r"case (\d+): return launch<TQ, TP, TC, D, \1>"),
])
def test_cuda_switches_instantiate_every_group(source, pattern):
    cases = {int(g) for g in re.findall(pattern, (CSRC / source).read_text())}
    assert cases == set(tpa._GROUPS)


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------


def _pool(rng, kind, P, nan_page):
    """A float32 pool rounded to the kind: bf16 (as 16-bit patterns both
    packages read), or int8 with scales (NaN scales on ``nan_page``)."""
    kv = rng.normal(size=(2, L, HKV, P, PAGE, D)).astype(np.float32)
    if kind == "int8":
        q8, sc = jquant.quantize_kv(jnp.asarray(kv), axis=-1)
        sc = np.array(sc)
        sc[:, :, :, nan_page] = np.nan
        return np.array(q8), sc
    kv[:, :, :, nan_page] = np.nan
    return kv, None


def _both(a, kind):
    """(jax array, torch tensor) of a float32 array in ``kind``'s query
    dtype (bf16 for bf16 pools, float32 otherwise)."""
    if kind == "bfloat16":
        j = jnp.asarray(a, jnp.bfloat16)
        return j, torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(got, want, kind):
    np.testing.assert_allclose(np.asarray(got.float(), np.float32), np.asarray(want, np.float32),
                               rtol=0, atol=ATOL[kind])


def _tables(rng, lengths, P, nan_page):
    pt = rng.permutation(P - 1)[: len(lengths) * MAXP].reshape(len(lengths), MAXP).astype(np.int32)
    for b, n in enumerate(lengths):
        pt[b, -(-max(int(n), 1) // PAGE):] = nan_page
    return pt


KINDS = ["float32", "bfloat16", "int8"]
GROUPS = [3, 5, 7]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("G", GROUPS)
def test_plain_decode_matches_pallas(G, kind):
    rng = np.random.default_rng(G)
    lengths = np.asarray([0, 1, 13, MAXP * PAGE], np.int32)
    B, P, layer = len(lengths), len(lengths) * MAXP + 1, 1
    kv, sc = _pool(rng, kind, P, P - 1)
    pt = _tables(rng, lengths, P, P - 1)
    pos = np.maximum(lengths - 1, 0)
    slots = (pt[np.arange(B), pos // PAGE] * PAGE + pos % PAGE).astype(np.int32)
    q = rng.normal(size=(B, HKV * G, D)).astype(np.float32)
    k_new = (rng.normal(size=(B, HKV, D)) * 3).astype(np.float32)
    v_new = rng.normal(size=(B, HKV, D)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, kind) for a in (q, k_new, v_new))
    jkv, tkv = _both(kv, kind) if kind != "int8" else (jnp.asarray(kv), torch.from_numpy(kv.copy()))
    idx = [jnp.asarray(a) for a in (slots, pt, lengths)]
    if kind == "int8":
        want_attn, want_kv, want_sc = j_decode_kernel(jq, jk, jv, jkv, *idx, layer, interpret=True,
                                                      kv_scales=jnp.asarray(sc))
    else:
        want_attn, want_kv = j_decode_kernel(jq, jk, jv, jkv, *idx, layer, interpret=True)
    tsc = None if sc is None else torch.from_numpy(sc.copy())
    got = tpa.paged_decode_fused_plain(tq, tk, tv, tkv, *(torch.from_numpy(a) for a in (slots, pt, lengths)),
                                       layer, tsc)
    assert torch.isfinite(got).all()
    assert torch.count_nonzero(got[0]) == 0
    _close(got, want_attn, kind)
    np.testing.assert_array_equal(tkv.float().numpy(), np.asarray(want_kv, np.float32))
    if kind == "int8":
        np.testing.assert_allclose(tsc.numpy(), np.asarray(want_sc), rtol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("G", GROUPS)
def test_plain_chunk_matches_pallas(G, kind):
    """Rows cold, mid-page prior, long prior with a partial chunk, and
    exhausted (no chunk keys)."""
    rng = np.random.default_rng(10 + G)
    C, layer = 8, 1
    prior = np.asarray([0, 5, 17, 9], np.int32)
    kvlen = prior + np.asarray([C, C, 3, 0], np.int32)
    B, P = len(prior), len(prior) * MAXP + 1
    kv, sc = _pool(rng, kind, P, P - 1)
    pt = _tables(rng, kvlen, P, P - 1)
    q = rng.normal(size=(B, C, HKV * G, D)).astype(np.float32)
    k = rng.normal(size=(B, C, HKV, D)).astype(np.float32)
    v = rng.normal(size=(B, C, HKV, D)).astype(np.float32)
    if kind == "int8":  # the chunk's K/V arrive dequantized, in float32
        *_, k, v = jquant.quantize_for_store(jnp.asarray(k), jnp.asarray(v))
        k, v = np.asarray(k), np.asarray(v)
    cur_kind = "bfloat16" if kind == "bfloat16" else "float32"
    (jq, tq) = _both(q, kind)
    (jk, tk), (jv, tv) = _both(k, cur_kind), _both(v, cur_kind)
    jkv, tkv = _both(kv, kind) if kind != "int8" else (jnp.asarray(kv), torch.from_numpy(kv))
    idx = [jnp.asarray(a) for a in (pt, prior, kvlen)]
    want = j_chunk_kernel(jq, jk, jv, jkv, *idx, layer, interpret=True,
                          kv_scales=None if sc is None else jnp.asarray(sc))
    got = tpa.paged_chunk_attention_plain(tq, tk, tv, tkv, *(torch.from_numpy(a) for a in (pt, prior, kvlen)),
                                          layer, None if sc is None else torch.from_numpy(sc))
    assert torch.isfinite(got).all()
    _close(got, want, kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("G", GROUPS)
def test_plain_pool_matches_pallas(G, kind):
    rng = np.random.default_rng(20 + G)
    lengths = np.asarray([0, 1, 11, MAXP * PAGE], np.int32)
    B, P = len(lengths), len(lengths) * MAXP + 1
    kv, sc = _pool(rng, kind, P, P - 1)
    pt = _tables(rng, lengths, P, P - 1)
    jq, tq = _both(rng.normal(size=(B, HKV * G, D)).astype(np.float32), kind)
    jkv, tkv = _both(kv, kind) if kind != "int8" else (jnp.asarray(kv), torch.from_numpy(kv))
    want = j_pool_kernel(jq, jkv, jnp.asarray(pt), jnp.asarray(lengths), 1, interpret=True,
                         kv_scales=None if sc is None else jnp.asarray(sc))
    got = tpa.paged_attention_pool_plain(tq, tkv, torch.from_numpy(pt), torch.from_numpy(lengths), 1,
                                         None if sc is None else torch.from_numpy(sc))
    assert torch.isfinite(got).all()
    assert torch.count_nonzero(got[0]) == 0
    _close(got, want, kind)
