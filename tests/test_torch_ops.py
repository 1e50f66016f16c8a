"""PyTorch port ops held against the JAX package's jnp functions on the CPU.

Inputs are made with numpy from fixed seeds and fed to both packages.
Tolerances: float32 ops agree to atol 1e-5 (different summation order and
transcendental implementations, nothing else).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.ops import attention as jattn
from radixmesh_tpu.ops import norm as jnorm
from radixmesh_tpu.ops import rope as jrope
from radixmesh_tpu.ops import sampling as jsamp
from radixmesh_tpu_torch.ops import attention as tattn
from radixmesh_tpu_torch.ops import norm as tnorm
from radixmesh_tpu_torch.ops import rope as trope
from radixmesh_tpu_torch.ops import sampling as tsamp

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)  # the suite runs in parallel worker processes
ATOL = 1e-5

LLAMA3_SCALING = (
    ("factor", 8.0),
    ("low_freq_factor", 1.0),
    ("high_freq_factor", 4.0),
    ("original_max_position_embeddings", 8192),
)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32),
        rtol=0, atol=atol,
    )


class TestRmsNorm:
    @pytest.mark.parametrize("shape", [(3, 64), (2, 5, 128)])
    def test_matches_jnp(self, shape):
        rng = np.random.default_rng(0)
        x = rng.normal(size=shape).astype(np.float32) * 3
        w = rng.normal(size=shape[-1:]).astype(np.float32)
        _close(tnorm.rms_norm(_t(x), _t(w)), jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w)))

    def test_bf16_input_roundtrips_through_fp32(self):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(4, 32)).astype(np.float32)
        w = np.ones(32, np.float32)
        got = tnorm.rms_norm(_t(x).bfloat16(), _t(w).bfloat16())
        assert got.dtype == torch.bfloat16
        want = jnorm.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
        _close(got.float(), np.asarray(want, np.float32), atol=1e-2)


class TestRope:
    @pytest.mark.parametrize("scaling", [None, LLAMA3_SCALING], ids=["plain", "llama3"])
    def test_frequencies(self, scaling):
        got = trope.rope_frequencies(128, 500000.0, scaling)
        want = jrope.rope_frequencies(128, 500000.0, scaling)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)

    @pytest.mark.parametrize("scaling", [None, LLAMA3_SCALING], ids=["plain", "llama3"])
    def test_apply_rope(self, scaling):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
        pos = rng.integers(0, 9000, size=(2, 7)).astype(np.int32)
        got = trope.apply_rope(_t(x), _t(pos), trope.rope_frequencies(32, 500000.0, scaling))
        want = jrope.apply_rope(
            jnp.asarray(x), jnp.asarray(pos), jrope.rope_frequencies(32, 500000.0, scaling)
        )
        _close(got, want)


class TestAttention:
    def test_attend_prefill_with_ragged_prefix(self):
        rng = np.random.default_rng(3)
        B, S, P, Hq, Hkv, D = 2, 5, 8, 4, 2, 16
        q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
        k = rng.normal(size=(B, P + S, Hkv, D)).astype(np.float32)
        v = rng.normal(size=(B, P + S, Hkv, D)).astype(np.float32)
        prefix = np.array([3, 8], np.int32)
        pad = P - prefix
        pos = (prefix[:, None] + np.arange(S)[None]).astype(np.int32) + pad[:, None]
        kv_end = np.full(B, P + S, np.int32)
        got = tattn.attend_prefill(_t(q), _t(k), _t(v), _t(pos), _t(kv_end), kv_start=_t(pad))
        want = jattn.attend_prefill(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
            jnp.asarray(kv_end), kv_start=jnp.asarray(pad),
        )
        _close(got, want)

    def test_attend_decode_ref(self):
        rng = np.random.default_rng(4)
        B, Hq, Hkv, D, P, page, maxp = 3, 8, 2, 16, 12, 4, 3
        q = rng.normal(size=(B, Hq, D)).astype(np.float32)
        kp = rng.normal(size=(Hkv, P, page, D)).astype(np.float32)
        vp = rng.normal(size=(Hkv, P, page, D)).astype(np.float32)
        pt = rng.permutation(P)[: B * maxp].reshape(B, maxp).astype(np.int32)
        lengths = np.array([1, 6, 12], np.int32)
        got = tattn.attend_decode_ref(_t(q), _t(kp), _t(vp), _t(pt), _t(lengths))
        want = jattn.attend_decode_ref(*(jnp.asarray(a) for a in (q, kp, vp, pt, lengths)))
        _close(got, want)

    def test_attend_chunk_hybrid(self):
        rng = np.random.default_rng(5)
        B, C, Hq, Hkv, D, page, L, maxp, kvb = 2, 8, 8, 2, 16, 4, 2, 8, 4
        kv = rng.normal(size=(2, L, Hkv, 64, page, D)).astype(np.float32)
        q = rng.normal(size=(B, C, Hq, D)).astype(np.float32)
        kc = rng.normal(size=(B, C, Hkv, D)).astype(np.float32)
        vc = rng.normal(size=(B, C, Hkv, D)).astype(np.float32)
        pt = rng.permutation(64)[: B * maxp].reshape(B, maxp).astype(np.int32)
        prior = np.array([9, 17], np.int32)
        kvlen = prior + np.array([C, C - 3], np.int32)
        pos = (prior[:, None] + np.arange(C)[None]).astype(np.int32)
        args = (q, kc, vc, kv, pt, pos, prior, kvlen)
        got = tattn.attend_chunk_hybrid(*(_t(a) for a in args), 1, kv_block_pages=kvb)
        want = jattn.attend_chunk_hybrid(*(jnp.asarray(a) for a in args), 1, kv_block_pages=kvb)
        _close(got, want)

    @staticmethod
    def _paged_case(seed, quant=False):
        """Two rows with ragged, mid-page priors; the second row's chunk is
        partial. Returns numpy inputs, the chunk written into its slots
        (int8 pools: quantized, with scales)."""
        rng = np.random.default_rng(seed)
        B, C, Hq, Hkv, D, page, L, maxp = 2, 8, 8, 2, 32, 4, 2, 8
        prior = np.array([9, 17])
        n_valid = np.array([C, C - 3])
        kv = rng.normal(size=(2, L, Hkv, 64, page, D)).astype(np.float32)
        q = rng.normal(size=(B, C, Hq, D)).astype(np.float32)
        k_cur = rng.normal(size=(B, C, Hkv, D)).astype(np.float32)
        v_cur = rng.normal(size=(B, C, Hkv, D)).astype(np.float32)
        pt = rng.permutation(64)[: B * maxp].reshape(B, maxp).astype(np.int32)
        positions = (prior[:, None] + np.arange(C)[None]).astype(np.int32)
        kv_len = (prior + n_valid).astype(np.int32)
        kv_o = kv.copy()
        for b in range(B):
            for j in range(int(n_valid[b])):
                pos = prior[b] + j
                pg, off = pt[b, pos // page], pos % page
                kv_o[0, 1, :, pg, off] = k_cur[b, j]
                kv_o[1, 1, :, pg, off] = v_cur[b, j]
        sc = None
        if quant:
            from radixmesh_tpu.ops.quant import quantize_kv

            q8, sc = quantize_kv(jnp.asarray(kv_o), axis=-1)
            kv_o, sc = np.array(q8), np.array(sc)
        return q, k_cur, v_cur, kv, kv_o, sc, pt, positions, prior.astype(np.int32), kv_len

    @pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
    def test_attend_prefill_paged_matches_jax(self, quant):
        """The blockwise paged chunk attention over the pool (the chunk
        already written) against the JAX function, float32 and int8 pools
        (twin of tests/test_ops.py's TestChunkHybrid oracle)."""
        q, _, _, _, kv_o, sc, pt, positions, _, kv_len = self._paged_case(11, quant)
        got = tattn.attend_prefill_paged(_t(q), _t(kv_o), _t(pt), _t(positions), _t(kv_len), 1,
                                         kv_block_pages=4, kv_scales=None if sc is None else _t(sc))
        want = jattn.attend_prefill_paged(
            *(jnp.asarray(a) for a in (q, kv_o, pt, positions, kv_len)), 1, kv_block_pages=4,
            kv_scales=None if sc is None else jnp.asarray(sc))
        _close(got, want)

    def test_hybrid_matches_paged_oracle(self):
        """attend_chunk_hybrid (the chunk dense, the prior from pages) equals
        attend_prefill_paged with the chunk written to the pool, on every
        valid query."""
        q, kc, vc, kv, kv_o, _, pt, positions, prior, kv_len = self._paged_case(11)
        got = tattn.attend_chunk_hybrid(*(_t(a) for a in (q, kc, vc, kv, pt, positions, prior, kv_len)),
                                        1, kv_block_pages=4)
        want = tattn.attend_prefill_paged(_t(q), _t(kv_o), _t(pt), _t(positions), _t(kv_len), 1,
                                          kv_block_pages=4)
        valid = np.arange(q.shape[1])[None, :] < (kv_len - prior)[:, None]
        _close(got.numpy()[valid], want.numpy()[valid])


class TestSampling:
    def test_greedy_exact(self):
        rng = np.random.default_rng(6)
        logits = rng.normal(size=(16, 300)).astype(np.float32)
        logits[3, 7] = logits[3, 11] = logits[3].max() + 1.0  # tie → first index
        got = tsamp.sample_tokens(_t(logits), torch.Generator().manual_seed(0))
        want = jsamp.sample_tokens(jnp.asarray(logits), jnp.zeros(2, jnp.uint32))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(got[3]) == 7

    @pytest.mark.parametrize(
        "temperature,top_k,top_p",
        [(1.0, 5, 1.0), (0.7, 0, 0.8), (1.3, 20, 0.5), (1.0, 0, 0.0)],
    )
    def test_filter_support_matches_jax(self, temperature, top_k, top_p):
        """top-k/top-p keep exactly the tokens JAX keeps, with the same
        temperature-scaled logits."""
        rng = np.random.default_rng(7)
        logits = rng.normal(size=(4, 64)).astype(np.float32) * 2
        n = logits.shape[0]
        got = tsamp._filtered_logits(
            _t(logits), torch.full((n,), temperature), torch.full((n,), top_p),
            torch.full((n,), top_k, dtype=torch.int64),
        ).numpy()
        want = np.asarray(jsamp._filtered_logits(
            jnp.asarray(logits), jnp.full((n,), temperature), jnp.full((n,), top_p), top_k,
        ))
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        _close(np.where(np.isfinite(got), got, 0), np.where(np.isfinite(want), want, 0))

    def test_draws_stay_in_support(self):
        rng = np.random.default_rng(8)
        logits = _t(rng.normal(size=(64, 50)).astype(np.float32))
        gen = torch.Generator().manual_seed(1)
        top = torch.topk(logits, 3, dim=-1).indices
        for _ in range(5):
            tok = tsamp.sample_tokens(logits, gen, temperature=1.0, top_k=3)
            assert bool((top == tok[:, None]).any(dim=-1).all())

    def test_temperature_by_distribution(self):
        """Empirical frequencies of 20k draws match softmax(logits / T)
        (JAX's categorical over the same filtered logits) within 4
        binomial standard deviations per token."""
        logits = np.array([2.0, 1.0, 0.5, -1.0], np.float32)
        T, n = 0.8, 20000
        gen = torch.Generator().manual_seed(2)
        draws = tsamp.sample_tokens(
            _t(np.tile(logits, (n, 1))), gen, temperature=T
        ).numpy()
        freq = np.bincount(draws, minlength=4) / n
        p = np.asarray(jnp.exp(jnp.asarray(logits) / T) / jnp.exp(jnp.asarray(logits) / T).sum())
        sd = np.sqrt(p * (1 - p) / n)
        assert np.all(np.abs(freq - p) < 4 * sd + 1e-9), (freq, p)

    def test_greedy_rows_in_mixed_batch(self):
        rng = np.random.default_rng(9)
        logits = _t(rng.normal(size=(6, 40)).astype(np.float32))
        temps = torch.tensor([0.0, 1.0, 0.0, 0.5, 0.0, 2.0])
        tok = tsamp.sample_tokens(logits, torch.Generator().manual_seed(3), temperature=temps)
        greedy = torch.argmax(logits, dim=-1)
        assert torch.equal(tok[temps == 0], greedy[temps == 0])
