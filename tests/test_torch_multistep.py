"""Multi-step and compact decode in the port held against the JAX package
(tiny config, CPU, the same weights):

- ``Llama.decode_multi`` and ``Llama.decode_multi_compact`` against their
  JAX counterparts over the same pool: greedy tokens exact, pool pages equal
  (float32 atol 1e-5; int8 payload exact and scales at rtol 1e-6; a bf16
  model's pool bit-equal outside the written rows and the written rows
  within 2**-5, one bf16 step at the rows' largest magnitudes, for the two
  packages' bf16 products round in different orders), the scratch page
  excepted, where inactive rows race;
- the ``Engine`` token-exact against the JAX ``Engine`` with
  ``decode_steps_per_launch`` 3 and 4, with the paged legs forced on the CPU
  (``decode_step`` and ``decode_multi`` over the whole pool, the plain
  versions standing in for the kernel) and with ``paged_min_batch=2``, which
  sends one-row waves to the compact leg;
- an int8 pool under speculative decode and under mixed waves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radixmesh_tpu_torch.engine.engine as tengine_mod
import radixmesh_tpu_torch.ops.attention as tattention
from radixmesh_tpu.engine.engine import Engine as JEngine
from radixmesh_tpu.engine.request import SamplingParams as JSampling
from radixmesh_tpu.models import llama as jl
from radixmesh_tpu_torch.engine.engine import Engine as TEngine
from radixmesh_tpu_torch.engine.request import SamplingParams as TSampling
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import Llama, ModelConfig

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)  # the suite runs in parallel worker processes

PAGE = 4
POOL_ATOL = 1e-5
K_STEPS = 4


@pytest.fixture(scope="module")
def models():
    """(jcfg, jparams, model) per model dtype: float32 and bfloat16."""
    out = {}
    for name, jdt, tdt in (("f32", jnp.float32, torch.float32), ("bf16", jnp.bfloat16, torch.bfloat16)):
        jcfg = jl.ModelConfig.tiny().replace(dtype=jdt)
        jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
        tcfg = ModelConfig.tiny().replace(dtype=tdt)
        np_tree = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)), jparams)
        out[name] = (jcfg, jparams, Llama(tcfg, params_from_jax(np_tree, tcfg, "cpu")))
    return out


def _pools(cfg, pool, num_slots, rng):
    """The same random pool for both packages: ``(jax kv, jax scale,
    torch kv, torch scale)``."""
    shape = (2, cfg.n_layers, cfg.n_kv_heads, num_slots, cfg.head_dim)
    if pool == "int8":
        kv = rng.integers(-127, 128, size=shape).astype(np.int8)
        sc = rng.uniform(0.005, 0.02, size=shape[:4]).astype(np.float32)
        return jnp.asarray(kv), jnp.asarray(sc), torch.from_numpy(kv.copy()), torch.from_numpy(sc.copy())
    kv = rng.normal(size=shape).astype(np.float32)
    if pool == "bf16":
        jkv = jnp.asarray(kv).astype(jnp.bfloat16)
        return jkv, None, torch.tensor(np.asarray(jkv.astype(jnp.float32))).to(torch.bfloat16), None
    return jnp.asarray(kv), None, torch.from_numpy(kv.copy()), None


def _close_pools(tkv, jkv, tsc, jsc, pool, written):
    """Pools equal outside the scratch page (inactive rows race there);
    ``written`` are the slots the steps wrote."""
    keep = np.ones(tkv.shape[3], bool)
    keep[:PAGE] = False
    got, want = tkv.float().numpy(), np.asarray(jkv.astype(jnp.float32))
    if pool == "int8":
        np.testing.assert_array_equal(got[:, :, :, keep], want[:, :, :, keep])
        np.testing.assert_allclose(tsc.numpy()[:, :, :, keep], np.asarray(jsc)[:, :, :, keep], rtol=1e-6)
    elif pool == "bf16":
        rest = keep.copy()
        rest[written] = False
        np.testing.assert_array_equal(got[:, :, :, rest], want[:, :, :, rest])
        np.testing.assert_allclose(got[:, :, :, written], want[:, :, :, written], rtol=0, atol=2.0 ** -5)
    else:
        np.testing.assert_allclose(got[:, :, :, keep], want[:, :, :, keep], rtol=0, atol=POOL_ATOL)


def _written(pt, lengths):
    """Slots the ``K_STEPS`` steps write for the live rows of ``_rows``."""
    out = []
    for b in range(2):
        pos = lengths[b] - 1 + np.arange(K_STEPS)
        out.extend(pt[b, pos // PAGE] * PAGE + pos % PAGE)
    return np.asarray(out)


def _rows(rng):
    """Three rows: two live (9 and 5 tokens of context before the fed
    token, pages permuted) and one inactive on the scratch page 0."""
    B, maxp = 3, 8
    pt = np.zeros((B, maxp), np.int32)
    pt[0] = 1 + np.arange(maxp)
    pt[1] = 1 + maxp + rng.permutation(maxp)
    lengths = np.array([10, 6, 1], np.int32)
    return pt, lengths


CASES = [("f32", "f32"), ("bf16", "bf16"), ("f32", "int8")]


@pytest.mark.parametrize("model_dtype,pool", CASES, ids=[p for _, p in CASES])
def test_decode_multi_matches_jax(models, model_dtype, pool):
    jcfg, jparams, model = models[model_dtype]
    rng = np.random.default_rng(1)
    num_slots = 256
    jkv, jsc, tkv, tsc = _pools(model.cfg, pool, num_slots, rng)
    pt, lengths = _rows(rng)
    tokens = rng.integers(0, 512, size=3).astype(np.int32)
    temps, tops = np.zeros(3, np.float32), np.ones(3, np.float32)
    res = jl.decode_multi(
        jparams, jcfg, jnp.asarray(tokens), jkv, jnp.asarray(pt), jnp.asarray(lengths),
        jax.random.PRNGKey(0), jnp.asarray(temps), jnp.asarray(tops), PAGE, k_steps=K_STEPS,
        kv_scale=jsc,
    )
    got = model.decode_multi(
        torch.from_numpy(tokens), tkv, torch.from_numpy(pt), torch.from_numpy(lengths),
        torch.Generator().manual_seed(0), temps, tops, page_size=PAGE, k_steps=K_STEPS, kv_scale=tsc,
    )
    assert got.shape == (K_STEPS, 3)
    np.testing.assert_array_equal(got.numpy()[:, :2], np.asarray(res[0])[:, :2])
    _close_pools(tkv, res[1], tsc, res[2] if pool == "int8" else None, pool, _written(pt, lengths))


@pytest.mark.parametrize("model_dtype,pool", CASES, ids=[p for _, p in CASES])
def test_decode_multi_compact_matches_jax(models, model_dtype, pool):
    jcfg, jparams, model = models[model_dtype]
    rng = np.random.default_rng(2)
    num_slots = 256
    jkv, jsc, tkv, tsc = _pools(model.cfg, pool, num_slots, rng)
    pt, lengths = _rows(rng)
    # The live pages of the two rows (with K_STEPS of headroom) and the
    # scratch page, padded to 8 by repeating the scratch page; the table
    # rewritten into compact indices.
    need = (lengths[:2] + K_STEPS - 2) // PAGE + 1
    uniq = np.unique(np.concatenate([pt[0, : need[0]], pt[1, : need[1]], [0]])).astype(np.int32)
    n_c = max(8, 1 << int(np.ceil(np.log2(len(uniq)))))
    compact = np.zeros(n_c, np.int32)
    compact[: len(uniq)] = uniq
    pt_c = np.zeros_like(pt)
    for b in range(2):
        pt_c[b, : need[b]] = np.searchsorted(uniq, pt[b, : need[b]])
    tokens = rng.integers(0, 512, size=3).astype(np.int32)
    temps, tops = np.zeros(3, np.float32), np.ones(3, np.float32)
    res = jl.decode_multi_compact(
        jparams, jcfg, jnp.asarray(tokens), jkv, jnp.asarray(compact), jnp.asarray(pt_c),
        jnp.asarray(lengths), jax.random.PRNGKey(0), jnp.asarray(temps), jnp.asarray(tops), PAGE,
        k_steps=K_STEPS, kv_scale=jsc,
    )
    before = tkv.clone()
    got = model.decode_multi_compact(
        torch.from_numpy(tokens), tkv, torch.from_numpy(compact), torch.from_numpy(pt_c),
        torch.from_numpy(lengths), torch.Generator().manual_seed(0), temps, tops,
        page_size=PAGE, k_steps=K_STEPS, kv_scale=tsc,
    )
    np.testing.assert_array_equal(got.numpy()[:, :2], np.asarray(res[0])[:, :2])
    _close_pools(tkv, res[1], tsc, res[2] if pool == "int8" else None, pool, _written(pt, lengths))
    # Pages outside the working set are untouched.
    outside = np.setdiff1d(np.arange(num_slots // PAGE), compact)
    slots = (outside[:, None] * PAGE + np.arange(PAGE)).ravel()
    assert torch.equal(tkv[:, :, :, slots], before[:, :, :, slots])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ENGINE_KW = dict(num_slots=512, page_size=PAGE, max_batch=4, max_seq_len=128,
                 long_prefill_threshold=16, prefill_chunk=16)


@pytest.fixture(scope="module")
def pair():
    """``make(**kw) -> (jax_engine, port_engine)`` on the same float32
    weights."""
    jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(7))
    tcfg = ModelConfig.tiny().replace(dtype=torch.float32)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")

    def make(**kw):
        kw = {**ENGINE_KW, **kw}
        return JEngine(jcfg, jparams, **kw), TEngine(tcfg, tparams, device="cpu", **kw)

    return make


@pytest.fixture
def paged_on_cpu(monkeypatch):
    """The CUDA policy on the CPU: ``default_use_kernel`` true for any head
    dim, so the engine takes the paged legs (``decode_step`` and
    ``decode_multi`` over the whole pool) with the plain versions."""
    monkeypatch.setattr(tattention, "default_use_kernel", lambda head_dim, device: True)
    monkeypatch.setattr(tengine_mod, "default_use_kernel", lambda head_dim, device: True)


def _workload(eng, sampling_cls):
    """A lone request, then three staggered arrivals with different output
    budgets (k shrinks to the binding row; a waiting request blocks
    fusing), then a follow-up that hits the cache. Returns outputs and
    ``prefix_len`` per request."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 512, n).tolist() for n in (13, 9, 30, 6)]
    budgets = [11, 7, 9, 2]
    reqs = [eng.add_request(prompts[0], sampling_cls(max_new_tokens=budgets[0]))]
    for _ in range(2):
        eng.step()
    reqs += [eng.add_request(p, sampling_cls(max_new_tokens=n)) for p, n in zip(prompts[1:], budgets[1:])]
    while eng.has_work():
        eng.step()
    follow = prompts[0] + list(reqs[0].output_tokens) + [5, 6, 7]
    reqs.append(eng.add_request(follow, sampling_cls(max_new_tokens=9)))
    while eng.has_work():
        eng.step()
    return [(list(r.output_tokens), r.prefix_len) for r in reqs]


def _both(pair, **kw):
    jeng, teng = pair(**kw)
    want, got = _workload(jeng, JSampling), _workload(teng, TSampling)
    assert got == want
    assert got[-1][1] > 0, "the follow-up should hit the cache"
    assert teng.stats.cached_tokens == jeng.stats.cached_tokens
    assert teng.stats.decode_steps == jeng.stats.decode_steps
    return teng


class TestEngineMultiStep:
    @pytest.mark.parametrize("k", [3, 4])
    def test_compact_leg_token_exact(self, pair, k):
        # On the CPU every decode wave takes the compact leg (no kernel).
        teng = _both(pair, decode_steps_per_launch=k)
        assert teng.stats.compact_launches > 0 and teng.stats.multi_step_launches == 0
        assert teng._last_dispatch["path"] == "dense"

    @pytest.mark.parametrize("k", [3, 4])
    def test_paged_legs_token_exact(self, pair, paged_on_cpu, k):
        teng = _both(pair, decode_steps_per_launch=k)
        assert teng.stats.multi_step_launches > 0 and teng.stats.compact_launches == 0
        # k steps per launch: fewer decode passes than a step per token.
        assert teng.stats.multi_step_launches < teng.stats.decode_forwards

    def test_paged_min_batch_sends_narrow_waves_to_compact(self, pair, paged_on_cpu):
        teng = _both(pair, paged_min_batch=2)
        assert teng.stats.compact_launches > 0, "no one-row wave took the compact leg"
        single_forwards = teng.stats.decode_forwards - teng.stats.compact_launches
        assert single_forwards > 0, "no wider wave took the paged leg"

    def test_defaults_keep_the_legacy_paged_schedule(self, pair, paged_on_cpu):
        teng = _both(pair)
        st = teng.stats
        assert st.compact_launches == st.multi_step_launches == 0
        assert st.verify_launches == st.mixed_launches == st.inline_launches == 0
        assert st.decode_forwards == st.decode_steps


    def test_stochastic_rows_sample_on_the_device(self, pair, paged_on_cpu):
        # decode_multi's stochastic leg: valid draws, every budget met, and
        # the same stream for the same seed.
        runs = []
        for _ in range(2):
            _, teng = pair(decode_steps_per_launch=4)
            prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8]]
            reqs = [teng.add_request(p, TSampling(temperature=t, top_k=20, max_new_tokens=13))
                    for p, t in zip(prompts, (0.9, 0.0))]
            while teng.has_work():
                teng.step()
            assert teng.stats.multi_step_launches > 0
            assert all(len(r.output_tokens) == 13 for r in reqs)
            assert all(0 <= t < 512 for r in reqs for t in r.output_tokens)
            runs.append([list(r.output_tokens) for r in reqs])
        assert runs[0] == runs[1]


class TestInt8Schedules:
    def test_int8_spec_decode_token_exact(self, pair):
        jeng, teng = pair(kv_quant="int8", spec_decode_tokens=3)
        prompt = [12, 12, 12, 12, 12]
        sp = dict(max_new_tokens=30)
        want = jeng.generate([prompt], JSampling(**sp))
        got = teng.generate([prompt], TSampling(**sp))
        assert got == want
        replay_j = jeng.generate([prompt], JSampling(**sp))
        replay_t = teng.generate([prompt], TSampling(**sp))
        assert replay_t == replay_j
        assert teng.stats.spec_accepted > 0
        assert (teng.stats.spec_proposed, teng.stats.spec_accepted) == (
            jeng.stats.spec_proposed, jeng.stats.spec_accepted)

    def test_int8_mixed_waves_token_exact(self, pair):
        jeng, teng = pair(kv_quant="int8", prefill_inline_budget=8, decode_steps_per_launch=3)
        outs = []
        for eng, samp in ((jeng, JSampling), (teng, TSampling)):
            outs.append(_workload(eng, samp))
        assert outs[1] == outs[0]
        assert teng.stats.mixed_launches > 0
        assert teng.waves.snapshot() == jeng.waves.snapshot()
        keep = np.ones(teng.pool.num_slots, bool)
        keep[teng._scratch_slot : teng._scratch_slot + PAGE] = False
        np.testing.assert_array_equal(
            teng.pool.kv.numpy()[:, :, :, keep], np.asarray(jeng.pool.kv)[:, :, :, keep])
