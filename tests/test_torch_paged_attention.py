"""The plain versions of the port's two paged-attention kernels, held against
the JAX package's Pallas kernels run in interpret mode (and its jnp
references) on the CPU.

On a CPU tensor the wrappers take the plain versions; these tests pin that
the plain versions compute exactly what the TPU kernels compute, including
their edge semantics: permuted page tables, length-0 and length-1 decode
rows, GQA group 4, exhausted chunk rows, and NaN-poisoned pages that no
row references. The CUDA kernels are held against the same plain versions
on the card by ``chip_smoke.py``. Tolerance: float32, atol 1e-5 (online vs
one-shot softmax summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.ops.attention import attend_chunk_hybrid as j_hybrid
from radixmesh_tpu.ops.paged_attention import (
    paged_chunk_attention_kernel as j_chunk_kernel,
    paged_decode_fused_kernel as j_decode_kernel,
)
from radixmesh_tpu_torch.ops import paged_attention as tpa
from radixmesh_tpu_torch.ops.attention import (
    paged_chunk_attention,
    paged_decode_attention,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)  # the suite runs in parallel worker processes
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=0, atol=atol
    )


def _decode_case(seed, lengths, Hq=8, Hkv=2, D=32, page=8, maxp=4, L=2, poison=False):
    """Per-row disjoint pages from a permuted pool; each row's current slot
    is position length-1 of its own pages. With ``poison``, the page-table
    pad entries point at a NaN page and every slot past a row's current
    token is NaN."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    n_pages = B * maxp + 2
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    k_new = rng.normal(size=(B, Hkv, D)).astype(np.float32)
    v_new = rng.normal(size=(B, Hkv, D)).astype(np.float32)
    kv = rng.normal(size=(2, L, Hkv, n_pages, page, D)).astype(np.float32)
    perm = rng.permutation(n_pages)
    pt = perm[: B * maxp].reshape(B, maxp).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    pos = np.maximum(lengths - 1, 0)
    slots = (pt[np.arange(B), pos // page] * page + pos % page).astype(np.int32)
    if poison:
        nan_page = perm[-1]
        kv[:, :, :, nan_page] = np.nan
        for b in range(B):
            used = -(-max(int(lengths[b]), 1) // page)
            pt[b, used:] = nan_page
            tail = pos[b] % page + 1
            kv[:, :, :, pt[b, used - 1], tail:] = np.nan
    return q, k_new, v_new, kv, slots, pt, lengths


class TestPlainFusedDecode:
    @pytest.mark.parametrize("fuse_heads", [True, False], ids=["mh", "per_head"])
    @pytest.mark.parametrize("layer", [0, 1])
    def test_matches_pallas_interpret(self, fuse_heads, layer):
        case = _decode_case(3, [1, 11, 32])
        want_attn, want_kv = j_decode_kernel(
            *(jnp.asarray(a) for a in case), layer, interpret=True, fuse_heads=fuse_heads
        )
        q, k_new, v_new, kv, slots, pt, lengths = (_t(a) for a in case)
        got = tpa.paged_decode_fused_plain(q, k_new, v_new, kv, slots, pt, lengths, layer)
        _close(got, want_attn)
        # The row writes landed in place, and nothing else changed.
        np.testing.assert_array_equal(kv.numpy(), np.asarray(want_kv))

    def test_length_zero_and_one_rows(self):
        """length 0 → zeros and no write; length 1 → attention over the
        current token alone (its V, for every head of the group)."""
        case = _decode_case(4, [0, 1, 20, 9])
        want_attn, want_kv = j_decode_kernel(
            *(jnp.asarray(a) for a in case), 0, interpret=True
        )
        q, k_new, v_new, kv, slots, pt, lengths = (_t(a) for a in case)
        before = kv.clone()
        got = tpa.paged_decode_fused_plain(q, k_new, v_new, kv, slots, pt, lengths, 0)
        _close(got, want_attn)
        np.testing.assert_array_equal(kv.numpy(), np.asarray(want_kv))
        assert torch.count_nonzero(got[0]) == 0
        _close(got[1], torch.repeat_interleave(v_new[1], 4, dim=0))
        s0 = int(slots[0])
        assert torch.equal(kv[:, 0, :, s0 // 8, s0 % 8], before[:, 0, :, s0 // 8, s0 % 8])

    def test_shared_scratch_slot_rows(self):
        """Rows parked on one scratch slot each attend their OWN current
        token (folded from k_new/v_new, not read back from the pool)."""
        q, k_new, v_new, kv, slots, pt, lengths = _decode_case(5, [1, 1, 1])
        slots[:] = slots[0]
        pt[:] = pt[0]
        got = tpa.paged_decode_fused_plain(
            _t(q), _t(k_new), _t(v_new), _t(kv), _t(slots), _t(pt), _t(lengths), 1
        )
        _close(got, np.repeat(v_new, 4, axis=1))

    def test_nan_poisoned_pages_never_reach_the_sum(self):
        case = _decode_case(6, [3, 17, 30, 8], poison=True)
        want_attn, _ = j_decode_kernel(*(jnp.asarray(a) for a in case), 1, interpret=True)
        assert np.isfinite(np.asarray(want_attn)).all()
        got = paged_decode_attention(*(_t(a) for a in case), 1)
        assert torch.isfinite(got).all()
        _close(got, want_attn)

    def test_dispatch_counts_plain_calls_on_cpu(self):
        tpa.reset_counters()
        case = [_t(a) for a in _decode_case(7, [5, 6])]
        paged_decode_attention(*case, 0)
        assert tpa.paged_decode_fused_plain.calls == 1
        assert tpa.paged_decode_fused_kernel.launches == 0


def _chunk_case(seed, prior, n_valid, C=8, Hq=4, Hkv=2, D=32, page=4, maxp=8, L=2,
                poison=False):
    rng = np.random.default_rng(seed)
    B = len(prior)
    P = B * maxp + 2
    q = rng.normal(size=(B, C, Hq, D)).astype(np.float32)
    kc = rng.normal(size=(B, C, Hkv, D)).astype(np.float32)
    vc = rng.normal(size=(B, C, Hkv, D)).astype(np.float32)
    kv = rng.normal(size=(2, L, Hkv, P, page, D)).astype(np.float32)
    perm = rng.permutation(P)
    pt = perm[: B * maxp].reshape(B, maxp).astype(np.int32)
    prior = np.asarray(prior, np.int32)
    kvlen = prior + np.asarray(n_valid, np.int32)
    if poison:
        nan_page = perm[-1]
        kv[:, :, :, nan_page] = np.nan
        for b in range(B):
            used = -(-int(prior[b]) // page)
            pt[b, used:] = nan_page
            if prior[b] % page:
                kv[:, :, :, pt[b, used - 1], prior[b] % page:] = np.nan
    return q, kc, vc, kv, pt, prior, kvlen


class TestPlainChunk:
    @pytest.mark.parametrize(
        "Hq,Hkv", [(4, 2), (8, 2)], ids=["G2", "G4"]
    )
    @pytest.mark.parametrize("layer", [0, 1])
    def test_matches_pallas_interpret_and_hybrid(self, Hq, Hkv, layer):
        """Row 0 cold (prior 0), row 1 mid-page prior, row 2 long prior
        with a partial chunk (3 valid of 8)."""
        C = 8
        q, kc, vc, kv, pt, prior, kvlen = _chunk_case(
            layer, [0, 5, 17], [C, C, 3], C=C, Hq=Hq, Hkv=Hkv
        )
        got = tpa.paged_chunk_attention_plain(
            *(_t(a) for a in (q, kc, vc, kv, pt, prior, kvlen)), layer
        )
        want_k = j_chunk_kernel(
            *(jnp.asarray(a) for a in (q, kc, vc, kv, pt, prior, kvlen)), layer,
            interpret=True,
        )
        # The kernel semantics hold for every query row, padded ones too.
        _close(got, want_k)
        pos = prior[:, None] + np.arange(C)[None]
        want_h = j_hybrid(
            *(jnp.asarray(a) for a in (q, kc, vc, kv, pt, pos, prior, kvlen)), layer,
            kv_block_pages=4,
        )
        valid = np.arange(C)[None, :] < (kvlen - prior)[:, None]
        _close(got.numpy()[valid], np.asarray(want_h)[valid])

    def test_exhausted_row_and_poisoned_pages(self):
        """An exhausted row (kv_lengths == prior: no chunk keys) attends
        its prior alone; NaN in pad pages and page tails stays out."""
        case = _chunk_case(9, [6, 0, 13], [0, 8, 5], Hq=8, poison=True)
        want = j_chunk_kernel(*(jnp.asarray(a) for a in case), 1, interpret=True)
        assert np.isfinite(np.asarray(want)).all()
        got = paged_chunk_attention(*(_t(a) for a in case), 1)
        assert torch.isfinite(got).all()
        _close(got, want)

    def test_query_block_choice(self):
        # The CUDA-core body (float32 queries): 128 rows per CTA.
        rows = tpa.CHUNK_ROWS[torch.float32]
        assert rows == 128
        assert tpa.chunk_query_block(512, 4, rows) == 32
        assert tpa.chunk_query_block(512, 7, rows) == 16
        assert tpa.chunk_query_block(16, 4, rows) == 16
        assert tpa.chunk_query_block(8, 2, rows) == 8
        assert tpa.chunk_query_block(24, 8, rows) == 8
        assert tpa.chunk_query_block(1, 4, rows) == 1
        # The tensor-core body (bf16 queries): 128 rows per CTA, all C
        # queries of a (row, kv head) while they fit, a ragged last block.
        assert tpa.chunk_tc_query_block(512, 4) == 32
        assert tpa.chunk_tc_query_block(24, 8) == 16
        assert tpa.chunk_tc_query_block(5, 4) == 5
        assert tpa.chunk_tc_query_block(512, 7) == 18


class TestKernelWrappersOnCuda:
    @pytest.mark.parametrize("wrapper", ["paged_decode_fused_kernel", "paged_chunk_attention_kernel"])
    def test_cuda_tensors_never_take_the_plain_path(self, wrapper):
        """A tensor on a device the wrapper can't serve raises instead of
        falling back (the meta device stands in for 'not the CPU')."""
        tpa.reset_counters()
        q = torch.empty(2, 8, 32, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            getattr(tpa, wrapper)(q, q, q, q, q, q, q, 0)
        assert tpa.paged_decode_fused_plain.calls == 0
        assert tpa.paged_chunk_attention_plain.calls == 0
        assert getattr(tpa, wrapper).launches == 0
