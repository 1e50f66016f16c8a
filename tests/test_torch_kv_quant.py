"""Int8 KV serving in the port, held against the JAX package on the CPU.

- Quantization (``ops/quant.py``) is bit-exact with jnp on the same float32
  input: random vectors over many magnitudes, zero vectors, and values that
  fall exactly on ±0.5 ties (round half to even).
- The int8 pool writes the same payload as the JAX pool, and scales within
  rtol 1e-6 (the JAX pool quantizes under jit, where XLA multiplies by
  1/127 instead of dividing), and gathers them back dequantized.
- The int8-aware ``attend_decode_ref`` matches the JAX one, and the int8
  plain decode and chunk versions match the JAX Pallas kernels run
  in interpret mode with ``kv_scales``: attention within float32 atol 1e-5
  (online vs one-shot softmax summation order); the decode's pool payload
  bit-equal, its scales within rtol 1e-6.
- The port's int8 ``Engine`` (tiny, float32) is greedy-token-exact against
  ``Engine(kv_quant="int8")`` of the JAX package on the same weights: a
  group prefill, a prefix-cache hit and a chunked long prompt.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.cache.kv_pool import PagedKVPool as JPool
from radixmesh_tpu.engine.engine import Engine as JEngine
from radixmesh_tpu.engine.request import SamplingParams as JSampling
from radixmesh_tpu.models import llama as jl
from radixmesh_tpu.ops import attention as jatt
from radixmesh_tpu.ops import quant as jquant
from radixmesh_tpu.ops.paged_attention import (
    paged_chunk_attention_kernel as j_chunk_kernel,
    paged_decode_fused_kernel as j_decode_kernel,
)
from radixmesh_tpu_torch.cache.kv_pool import PagedKVPool as TPool
from radixmesh_tpu_torch.engine.engine import Engine as TEngine
from radixmesh_tpu_torch.engine.request import SamplingParams as TSampling
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import ModelConfig
from radixmesh_tpu_torch.ops import attention as tatt
from radixmesh_tpu_torch.ops import paged_attention as tpa
from radixmesh_tpu_torch.ops import quant as tquant

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)  # the suite runs in parallel worker processes
ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=0, atol=atol
    )


def _quant_input(kind, rng):
    if kind == "random":
        return (rng.normal(size=(16, 4, 128)) * rng.uniform(1e-6, 1e3, size=(16, 4, 1))).astype(np.float32)
    if kind == "zeros":
        x = rng.normal(size=(6, 2, 64)).astype(np.float32)
        x[::2] = 0.0
        return x
    # Exact ties: amax 127 gives scale 1.0, so every k + 0.5 sits on a tie.
    x = (np.round(rng.uniform(-126, 126, size=(8, 4, 128))) + 0.5).astype(np.float32)
    x[..., 0] = 127.0
    x[1, :, 0] = -127.0
    return x


class TestQuantHelpers:
    @pytest.mark.parametrize("kind", ["random", "zeros", "ties"])
    def test_quantize_bit_exact_with_jnp(self, kind):
        x = _quant_input(kind, np.random.default_rng(0))
        jq, js = jquant.quantize_kv(jnp.asarray(x), axis=-1)
        tq, ts = tquant.quantize_kv(torch.from_numpy(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        if kind == "ties":  # half to even: 0.5 → 0, 1.5 → 2, -2.5 → -2
            assert tq.abs().max() == 127 and (tq.numpy()[..., 1:] % 2 == 0).all()

    def test_dequantize_and_quantize_for_store_bit_exact(self):
        rng = np.random.default_rng(1)
        k = (rng.normal(size=(3, 5, 2, 32)) * 4).astype(np.float32)
        v = rng.normal(size=(3, 5, 2, 32)).astype(np.float32)
        want = jquant.quantize_for_store(jnp.asarray(k), jnp.asarray(v))
        got = tquant.quantize_for_store(torch.from_numpy(k), torch.from_numpy(v))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


class TestQuantPool:
    def test_write_gather_match_jax_pool(self):
        rng = np.random.default_rng(1)
        kw = dict(num_slots=64, num_layers=2, num_kv_heads=2, head_dim=16, page_size=4)
        jp, tp = JPool(quant="int8", **kw), TPool(quant="int8", device="cpu", **kw)
        assert tp.kv.dtype == torch.int8 and tp.kv_scale.shape == (2, 2, 2, 64)
        slots = tp.alloc(10)
        np.testing.assert_array_equal(slots, jp.alloc(10))
        k = rng.normal(size=(2, 10, 2, 16)).astype(np.float32)
        v = rng.normal(size=(2, 10, 2, 16)).astype(np.float32)
        jp.write(slots, jnp.asarray(k), jnp.asarray(v))
        tp.write(slots, torch.from_numpy(k), torch.from_numpy(v))
        np.testing.assert_array_equal(tp.kv.numpy(), np.asarray(jp.kv))
        # The JAX pool quantizes under jit, where XLA turns the division by
        # 127 into a product with its reciprocal: scales may differ from
        # the IEEE quotient (eager jnp, the port) in the last bit.
        np.testing.assert_allclose(tp.kv_scale.numpy(), np.asarray(jp.kv_scale), rtol=1e-6)
        got = tp.gather(slots).numpy()  # dequantized [2, L, n, H, D]
        np.testing.assert_allclose(got, np.asarray(jp.gather(slots)), rtol=1e-6, atol=0)
        for src, back in ((k, got[0]), (v, got[1])):
            amax = np.max(np.abs(src), axis=-1, keepdims=True)
            assert np.all(np.abs(back - src) <= amax / 250 + 1e-7)
        assert tp.scale_pages().shape == (2, 2, 2, 16, 4)

    def test_rejects_unknown_quant(self):
        with pytest.raises(ValueError, match="unknown kv quantization"):
            TPool(num_slots=8, num_layers=1, num_kv_heads=1, head_dim=8, quant="fp4", device="cpu")


def _int8_pool(rng, L, Hkv, P, page, D, nan_page=None):
    kv = rng.normal(size=(2, L, Hkv, P, page, D)).astype(np.float32)
    q8, sc = jquant.quantize_kv(jnp.asarray(kv), axis=-1)
    sc = np.array(sc)
    if nan_page is not None:
        sc[:, :, :, nan_page] = np.nan
    return np.asarray(q8), sc


def test_attend_decode_ref_int8_matches_jax():
    """The gather-based reference over an int8 pool (float32 atol 1e-5)."""
    rng = np.random.default_rng(2)
    kv, sc = _int8_pool(rng, 1, 2, 12, 4, 32)
    pt = rng.permutation(12)[:9].reshape(3, 3).astype(np.int32)
    lengths = np.asarray([1, 6, 12], np.int32)
    q = rng.normal(size=(3, 8, 32)).astype(np.float32)
    args = (q, kv[0, 0], kv[1, 0], pt, lengths, sc[0, 0], sc[1, 0])
    want = jatt.attend_decode_ref(*(jnp.asarray(a) for a in args))
    got = tatt.attend_decode_ref(*(_t(a) for a in args))
    _close(got, want)


class TestInt8PlainDecode:
    @pytest.mark.parametrize("fuse_heads", [True, False], ids=["mh", "per_head"])
    def test_matches_pallas_interpret(self, fuse_heads):
        """Rows of length 0 (no write, zeros), 1, mid-page and full, over a
        permuted pool; pad pages' scales are NaN."""
        rng = np.random.default_rng(3)
        B, Hq, Hkv, D, page, maxp, L, layer = 4, 8, 2, 32, 8, 4, 2, 1
        P = B * maxp + 1
        kv, sc = _int8_pool(rng, L, Hkv, P, page, D, nan_page=P - 1)
        pt = rng.permutation(P - 1)[: B * maxp].reshape(B, maxp).astype(np.int32)
        lengths = np.asarray([0, 1, 13, maxp * page], np.int32)
        for b in range(B):
            pt[b, -(-max(int(lengths[b]), 1) // page):] = P - 1  # pads → NaN scales
        pos = np.maximum(lengths - 1, 0)
        slots = (pt[np.arange(B), pos // page] * page + pos % page).astype(np.int32)
        q = rng.normal(size=(B, Hq, D)).astype(np.float32)
        k_new = (rng.normal(size=(B, Hkv, D)) * 3).astype(np.float32)
        v_new = rng.normal(size=(B, Hkv, D)).astype(np.float32)
        want_attn, want_kv, want_sc = j_decode_kernel(
            *(jnp.asarray(a) for a in (q, k_new, v_new, kv, slots, pt, lengths)), layer,
            interpret=True, kv_scales=jnp.asarray(sc), fuse_heads=fuse_heads,
        )
        kv_t, sc_t = _t(kv), _t(sc)
        got = tpa.paged_decode_fused_plain(
            _t(q), _t(k_new), _t(v_new), kv_t, _t(slots), _t(pt), _t(lengths), layer, sc_t
        )
        assert torch.isfinite(got).all()
        _close(got, want_attn)
        assert torch.count_nonzero(got[0]) == 0
        np.testing.assert_array_equal(kv_t.numpy(), np.asarray(want_kv))
        np.testing.assert_allclose(sc_t.numpy(), np.asarray(want_sc), rtol=1e-6)

    def test_dispatch_counts_int8_plain_calls(self):
        tpa.reset_counters()
        rng = np.random.default_rng(4)
        kv, sc = _int8_pool(rng, 1, 2, 4, 4, 32)
        out = tatt.paged_decode_attention(
            _t(rng.normal(size=(1, 4, 32)).astype(np.float32)),
            _t(rng.normal(size=(1, 2, 32)).astype(np.float32)),
            _t(rng.normal(size=(1, 2, 32)).astype(np.float32)),
            _t(kv), _t(np.asarray([5], np.int32)), _t(np.asarray([[0, 1]], np.int32)),
            _t(np.asarray([6], np.int32)), 0, _t(sc),
        )
        assert out.shape == (1, 4, 32)
        assert tpa.paged_decode_fused_plain.calls_int8 == 1
        assert tpa.paged_decode_fused_plain.calls == 0
        assert tpa.paged_decode_fused_kernel.launches_int8 == 0


class TestInt8PlainChunk:
    @pytest.mark.parametrize("Hq,Hkv", [(4, 2), (8, 2)], ids=["G2", "G4"])
    def test_matches_pallas_interpret(self, Hq, Hkv):
        """Row 0 cold, row 1 mid-page prior, row 2 long prior with a partial
        chunk, row 3 exhausted (no chunk keys); the chunk's K/V arrive
        dequantized in float32, pad pages' scales are NaN."""
        rng = np.random.default_rng(5)
        B, C, D, page, maxp, L, layer = 4, 8, 32, 4, 8, 2, 1
        P = B * maxp + 1
        kv, sc = _int8_pool(rng, L, Hkv, P, page, D, nan_page=P - 1)
        pt = rng.permutation(P - 1)[: B * maxp].reshape(B, maxp).astype(np.int32)
        prior = np.asarray([0, 5, 17, 9], np.int32)
        kvlen = prior + np.asarray([C, C, 3, 0], np.int32)
        for b in range(B):
            pt[b, -(-int(kvlen[b]) // page):] = P - 1
        q = rng.normal(size=(B, C, Hq, D)).astype(np.float32)
        k = rng.normal(size=(B, C, Hkv, D)).astype(np.float32)
        v = rng.normal(size=(B, C, Hkv, D)).astype(np.float32)
        *_, kc, vc = jquant.quantize_for_store(jnp.asarray(k), jnp.asarray(v))
        kc, vc = np.asarray(kc), np.asarray(vc)
        want = j_chunk_kernel(
            *(jnp.asarray(a) for a in (q, kc, vc, kv, pt, prior, kvlen)), layer,
            interpret=True, kv_scales=jnp.asarray(sc),
        )
        got = tpa.paged_chunk_attention_plain(
            *(_t(a) for a in (q, kc, vc, kv, pt, prior, kvlen)), layer, _t(sc)
        )
        assert torch.isfinite(got).all()
        _close(got, want)


ENGINE_KW = dict(
    num_slots=512, page_size=4, max_batch=4, max_seq_len=256,
    long_prefill_threshold=16, prefill_chunk=16,
)


@pytest.fixture(scope="module")
def quant_engines():
    jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(7))
    tcfg = ModelConfig.tiny().replace(dtype=torch.float32)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    return (
        JEngine(jcfg, jparams, kv_quant="int8", **ENGINE_KW),
        TEngine(tcfg, tparams, device="cpu", kv_quant="int8", **ENGINE_KW),
    )


def test_int8_engine_token_exact_against_jax(quant_engines):
    """Group prefill of two prompts, a follow-up that hits the int8 prefix
    cache, then a 90-token prompt that prefills in 16-token chunks."""
    jeng, teng = quant_engines
    assert teng.pool.kv.dtype == torch.int8
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 512, n).tolist() for n in (9, 13)]

    def both(ps, n):
        return (jeng.generate(ps, JSampling(temperature=0.0, max_new_tokens=n)),
                teng.generate(ps, TSampling(temperature=0.0, max_new_tokens=n)))

    want, got = both(prompts, 8)
    assert got == want
    follow = prompts[0] + got[0] + rng.integers(1, 512, 5).tolist()
    want, got = both([follow], 6)
    assert got == want
    assert teng.stats.cached_tokens == jeng.stats.cached_tokens > 0
    chunks0 = teng.stats.prefill_chunks
    want, got = both([rng.integers(1, 512, 90).tolist()], 5)
    assert got == want
    assert teng.stats.prefill_chunks - chunks0 >= 6
    # Every slot but the scratch slot (where inactive rows race) holds the
    # same int8 payload in both engines, and scales within rtol 1e-5: the
    # two models' float32 K/V rows differ in their last bits (product
    # order), and so do their maxima.
    keep = np.ones(teng.pool.num_slots, bool)
    keep[teng._scratch_slot] = False
    np.testing.assert_array_equal(teng.pool.kv.numpy()[:, :, :, keep], np.asarray(jeng.pool.kv)[:, :, :, keep])
    np.testing.assert_allclose(
        teng.pool.kv_scale.numpy()[:, :, :, keep], np.asarray(jeng.pool.kv_scale)[:, :, :, keep], rtol=1e-5
    )
