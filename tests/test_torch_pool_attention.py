"""The read-only paged pool attention of the port (B3) on the CPU, held
against the JAX package.

- The plain pool version against ``paged_attention_pool_kernel(...,
  interpret=True)`` for both Pallas grids (``fuse_heads`` True and False),
  with length-0 and length-1 rows, permuted page tables, a NaN-poisoned pad
  page and page tails (for int8 pools the NaN sits in the scales), over
  bf16, float32 and int8 pools. The Pallas kernel, not ``attend_decode_ref``,
  is the reference here: only the kernel zeros length-0 rows and masked
  ``v``. Tolerance: float32 outputs atol 1e-5 (summation order); bf16
  outputs atol 1e-2 (both sides compute in float32 from the same bf16
  inputs; one bf16 rounding step of an output below 2 is at most 2^-7).
- ``paged_attention`` (single layer) and ``paged_attention_pool_bucketed``
  (an off-bucket batch pads and slices, an at-bucket batch passes through)
  against the JAX dispatchers of the same names on the CPU, float32 atol
  1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.ops import attention as jatt
from radixmesh_tpu.ops import quant as jquant
from radixmesh_tpu.ops.paged_attention import paged_attention_pool_kernel as j_pool_kernel
from radixmesh_tpu_torch.ops import attention as tatt
from radixmesh_tpu_torch.ops import paged_attention as tpa

torch.set_num_threads(1)  # the suite runs in parallel worker processes
ATOL = {"float32": 1e-5, "bfloat16": 1e-2, "int8": 1e-5}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=0, atol=atol
    )


def _pool_case(seed, lengths, kind, Hq=8, Hkv=2, D=32, page=8, maxp=4, L=2, poison=True):
    """Disjoint permuted pages per row; page-table pads point at a NaN page
    and every slot past a row's length in its last page is NaN (K/V for
    bf16/f32 pools, scales for int8 pools). Returns numpy arrays
    ``(q, kv, scales or None, page_table, lengths)``."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    P = B * maxp + 1
    nan_page = P - 1
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    kv = rng.normal(size=(2, L, Hkv, P, page, D)).astype(np.float32)
    pt = rng.permutation(P - 1)[: B * maxp].reshape(B, maxp).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    scales = None
    if kind == "int8":
        q8, sc = jquant.quantize_kv(jnp.asarray(kv), axis=-1)
        kv, scales = np.asarray(q8), np.array(sc)
    poisoned = scales if kind == "int8" else kv
    if poison:
        poisoned[:, :, :, nan_page] = np.nan
        for b in range(B):
            used = -(-max(int(lengths[b]), 1) // page)
            pt[b, used:] = nan_page
            if lengths[b] % page:
                poisoned[:, :, :, pt[b, used - 1], lengths[b] % page:] = np.nan
    if kind == "bfloat16":
        q = np.asarray(jnp.asarray(q, jnp.bfloat16))
        kv = np.asarray(jnp.asarray(kv, jnp.bfloat16))
    return q, kv, scales, pt, lengths


def _torch(a):
    if a is None:
        return None
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return _t(a)


class TestPlainPool:
    @pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
    @pytest.mark.parametrize("fuse_heads", [True, False], ids=["mh", "per_head"])
    def test_matches_pallas_interpret(self, fuse_heads, kind):
        q, kv, sc, pt, lengths = _pool_case(1, [0, 1, 11, 32], kind)
        for layer in (0, 1):
            want = j_pool_kernel(
                jnp.asarray(q), jnp.asarray(kv), jnp.asarray(pt), jnp.asarray(lengths), layer,
                interpret=True, fuse_heads=fuse_heads,
                kv_scales=None if sc is None else jnp.asarray(sc),
            )
            assert np.isfinite(np.asarray(want, np.float32)).all()
            got = tpa.paged_attention_pool_plain(
                _torch(q), _torch(kv), _t(pt), _t(lengths), layer, _torch(sc)
            )
            assert got.dtype == (torch.bfloat16 if kind == "bfloat16" else torch.float32)
            assert torch.isfinite(got).all()
            assert torch.count_nonzero(got[0]) == 0  # length 0 → zeros
            _close(got.float(), want, ATOL[kind])

    def test_length_one_row_is_its_single_value(self):
        """A length-1 row attends one token: every head of a group outputs
        that token's V row."""
        q, kv, _, pt, lengths = _pool_case(2, [1, 5], "float32", Hq=8, Hkv=2)
        got = tpa.paged_attention_pool_plain(_t(q), _t(kv), _t(pt), _t(lengths), 1)
        v0 = kv[1, 1, :, pt[0, 0], 0]  # [Hkv, D]
        _close(got[0], np.repeat(v0, 4, axis=0), 1e-6)

    def test_dispatch_counts_plain_calls_and_cuda_refusal(self):
        tpa.reset_counters()
        q, kv, sc, pt, lengths = (_torch(a) for a in _pool_case(3, [3, 9], "int8"))
        tatt.paged_attention_pool(q, kv, pt, lengths, 0, kv_scales=sc)
        assert tpa.paged_attention_pool_plain.calls_int8 == 1
        assert tpa.paged_attention_pool_kernel.launches_int8 == 0
        # A tensor on a device the wrapper can't serve raises instead of
        # falling back (the meta device stands in for 'not the CPU').
        m = torch.empty(2, 8, 32, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            tpa.paged_attention_pool_kernel(m, m, m, m, 0)
        assert tpa.paged_attention_pool_plain.calls == 0


class TestPoolDispatchers:
    def test_batch_bucket_matches_jax(self):
        for n in (0, 1, 2, 3, 5, 8, 9, 33):
            for floor in (1, 4):
                assert tatt.batch_bucket(n, floor) == jatt.batch_bucket(n, floor)

    def test_single_layer_paged_attention(self):
        q, kv, _, pt, lengths = _pool_case(4, [3, 17, 32], "float32", poison=False)
        want = jatt.paged_attention(
            jnp.asarray(q), jnp.asarray(kv[0, 1]), jnp.asarray(kv[1, 1]),
            jnp.asarray(pt), jnp.asarray(lengths),
        )
        got = tatt.paged_attention(_t(q), _t(kv[0, 1]), _t(kv[1, 1]), _t(pt), _t(lengths))
        _close(got, want, 1e-5)

    @pytest.mark.parametrize("B", [5, 4], ids=["off_bucket", "at_bucket"])
    @pytest.mark.parametrize("kind", ["float32", "int8"])
    def test_bucketed_pads_and_slices(self, B, kind):
        q, kv, sc, pt, lengths = _pool_case(5 + B, list(range(3, 3 + 7 * B, 7)), kind, poison=False)
        want = jatt.paged_attention_pool_bucketed(
            jnp.asarray(q), jnp.asarray(kv), jnp.asarray(pt), jnp.asarray(lengths), 1,
            kv_scales=None if sc is None else jnp.asarray(sc),
        )
        tpa.reset_counters()
        got = tatt.paged_attention_pool_bucketed(_t(q), _t(kv), _t(pt), _t(lengths), 1, _torch(sc))
        assert tuple(got.shape) == (B, 8, 32)
        calls = tpa.paged_attention_pool_plain.calls + tpa.paged_attention_pool_plain.calls_int8
        assert calls == 1
        _close(got, want, 1e-5)
