"""Pipeline-parallel serving in the port, against the JAX package: twins of
``tests/test_pp_serving.py`` (the tree snapshot case through the port's
``checkpoint.py``: the leader gathers the stages' pools into the one
JAX-format file, every rank restores its slice), of
``tests/test_wquant.py::TestWQuantEngine::test_pp_matches_single_device``
and of the PP-serving and kernel-engaged pp decode legs of
``dryrun_multichip``.

The port's ranks are four processes over gloo (``tests/_torch_ranks.py``,
one group for the file) on a ``(pp=2, tp=2)`` mesh, or ``(pp=2, tp=1)`` over
the first two for the host tier; the JAX references run here on conftest's
virtual devices, the JAX ``Engine`` on ``make_pp_serving_mesh(pp=2, tp=2)``.
The port's stage bodies run the plain versions of B1 and B2 on the CPU.
float32: logits at atol 1e-4, greedy tokens exact, pools within 2e-4 (int8
payloads exact, scales at rtol 1e-6). Every rank returns the same tokens
and the same ``EngineStats``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.engine.engine import Engine as JEngine
from radixmesh_tpu.engine.request import SamplingParams as JSampling
from radixmesh_tpu.models import llama as jl
from radixmesh_tpu.parallel.pp_serving import make_pp_serving_mesh as j_pp_mesh
from radixmesh_tpu_torch.models.llama import ModelConfig
from tests._torch_ranks import RankGroup

torch.set_num_threads(1)

JCFG = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
TCFG = ModelConfig.tiny().replace(dtype=torch.float32)
JPARAMS = jl.init_params(JCFG, jax.random.PRNGKey(0))
NP_PARAMS = jax.tree_util.tree_map(np.asarray, JPARAMS)
GREEDY = dict(temperature=0.0, max_new_tokens=6)
KW = dict(num_slots=1024, page_size=4, max_batch=4)
PLAN = (1, 1, 2, 2)  # (dp, sp, tp, pp): the JAX test's pp=2 x tp=2
CASES = "tests._torch_parallel_cases:"
PP = "tests._torch_pp_cases:"


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(4, str(tmp_path_factory.mktemp("ranks")))
    yield g
    g.close()


@pytest.fixture(scope="module")
def jmesh():
    return j_pp_mesh(pp=2, tp=2)


def _live(results):
    return [r for r in results if r is not None]


def _same_on_every_rank(res, n=4):
    assert len(res) == n
    for r in res[1:]:
        assert r["tokens"] == res[0]["tokens"]
        assert r["stats"] == res[0]["stats"]
    return res[0]


def _jax_tokens(runs, mesh=None, params=JPARAMS, cfg=JCFG, **kw):
    eng = JEngine(cfg, params, device_mesh=mesh, **{**KW, **kw})
    return [eng.generate(prompts, JSampling(**skw)) for prompts, skw in runs], eng


def _serve(group, runs, plan=PLAN, np_params=NP_PARAMS, cfg=TCFG, **kw):
    return _same_on_every_rank(
        _live(group.run(CASES + "serve", np_params, cfg, plan, runs, {**KW, **kw})),
        n=plan[2] * plan[3])


def _chunk_inputs(seed):
    B, C, ps, maxp, num_slots = 4, 8, 4, 8, 256
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, JCFG.vocab_size, (B, C)).astype(np.int32)
    prior = np.array([0, 4, 8, 12], np.int32)
    pos = prior[:, None] + np.arange(C, dtype=np.int32)[None]
    kvlen = prior + C
    pt = np.arange(B * maxp, dtype=np.int32).reshape(B, maxp)
    slots = pt[np.arange(B)[:, None], pos // ps] * ps + pos % ps
    pool0 = rng.normal(size=(2, JCFG.n_layers, JCFG.n_kv_heads, num_slots, JCFG.head_dim)).astype(np.float32)
    return toks, pos, pool0, slots, pt, kvlen, ps


@pytest.mark.parametrize("n_micro", [1, 2])
def test_pp_chunk_matches_reference(group, n_micro):
    """``pp_forward_chunk`` against the JAX ``prefill_chunk_paged`` (which the
    JAX ``pp_forward_chunk`` matches): ragged prior contexts, the chunk's K/V
    written into every stage's layers, nothing else of the pool touched."""
    toks, pos, pool0, slots, pt, kvlen, ps = _chunk_inputs(0)
    want_logits, want_pool = jl.prefill_chunk_paged(
        JPARAMS, JCFG, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(pool0), jnp.asarray(slots),
        jnp.asarray(pt), jnp.asarray(kvlen), page_size=ps, kv_block_pages=4)
    res = _live(group.run(PP + "pp_chunk", NP_PARAMS, TCFG, PLAN, n_micro, toks, pos, pool0,
                          slots.astype(np.int64), pt, kvlen, ps))
    assert len(res) == 4
    for r in res:
        np.testing.assert_allclose(r["logits"], np.asarray(want_logits), rtol=0, atol=1e-4)
        np.testing.assert_allclose(r["pool"], np.asarray(want_pool), rtol=2e-4, atol=2e-4)
        untouched = np.ones(pool0.shape[3], bool)
        untouched[slots.reshape(-1)] = False
        np.testing.assert_array_equal(r["pool"][:, :, :, untouched], pool0[:, :, :, untouched])


def test_pp_engine_matches_single_device_and_prefix_hit(group, jmesh):
    """Greedy tokens of a pp=2 x tp=2 engine equal the JAX pp engine's on its
    (pp, tp) mesh; the prefix hit reuses the layer-sharded pool."""
    prompts = [np.random.default_rng(0).integers(1, JCFG.vocab_size, 24).tolist(),
               np.random.default_rng(1).integers(1, JCFG.vocab_size, 17).tolist()]
    hit = list(range(1, 25))
    runs = [(prompts, GREEDY), ([hit], GREEDY), ([hit + [100, 101]], GREEDY)]
    want, jeng = _jax_tokens(runs, jmesh)
    got = _serve(group, runs)
    assert got["tokens"] == want
    assert got["stats"]["cached_tokens"] == jeng.stats.cached_tokens >= 20
    assert got["pool_heads"] == TCFG.n_kv_heads // 2
    # The stages handed activations on and the last one broadcast its hidden
    # state: the pipeline ran, not four copies of one device.
    assert got["collectives"]["p2p"]["calls"] > 0 and got["collectives"]["broadcast"]["calls"] > 0


# The disk tier and the plane, once refused under pp, are served since the
# step agreement (parallel/step_sync.py): those cases serve the tier script
# (prompts a, b, a in a pool that holds one) on the pp = 2 x tp = 2 mesh to
# the JAX pp engine's tokens with the same tier. "tier dir shape" is the
# refusal that came with the per-rank disk layout.
TIER_KW = dict(num_slots=128, page_size=4, max_batch=4)
_TA = np.random.default_rng(0).integers(1, JCFG.vocab_size, 64).tolist()
_TB = np.random.default_rng(1).integers(1, JCFG.vocab_size, 64).tolist()
TIER_RUNS = [([_TA], dict(GREEDY, max_new_tokens=4)), ([_TB], dict(GREEDY, max_new_tokens=4)),
             ([_TA], dict(GREEDY, max_new_tokens=4))]


@pytest.mark.parametrize("what,cfg,plan,match", [
    ("layers", TCFG.replace(n_layers=3), PLAN, "not divisible by"),
    ("disk tier", TCFG, PLAN, "disk KV tier"),
    ("kv plane", TCFG, PLAN, "KV-movement plane"),
    ("tier dir shape", TCFG, PLAN, "another mesh shape"),
])
def test_pp_validations(group, jmesh, tmp_path, what, cfg, plan, match):
    from tests._torch_tier_cases import tier_kw

    if what == "layers":
        for msg in _live(group.run(CASES + "serve_refused", cfg, plan, dict(KW))):
            assert match in msg, msg
        return
    if what == "tier dir shape":
        # Extents written by a pp = 2 engine (two ranks) refuse the pp = 2 x
        # tp = 2 engine by name.
        root = str(tmp_path / "tier")
        two = _live(group.run("tests._torch_tier_cases:serve_tiers", NP_PARAMS, TCFG, (1, 1, 1, 2),
                              TIER_RUNS[:1], TIER_KW, "disk", root))
        assert len(two) == 2
        kw = dict(TIER_KW, **tier_kw("disk", root))
        for msg in _live(group.run("tests._torch_tier_cases:refused", NP_PARAMS, cfg, plan, kw)):
            assert match in msg and "pp" in msg, msg
        return
    tier = "disk" if what == "disk tier" else "plane"
    jkw = tier_kw(tier, str(tmp_path / "jax"))
    jeng = JEngine(JCFG, JPARAMS, device_mesh=jmesh, **TIER_KW, **jkw)
    want = [jeng.generate(p, JSampling(**sk)) for p, sk in TIER_RUNS]
    jeng.kv_transfer.close()
    res = _live(group.run("tests._torch_tier_cases:serve_tiers", NP_PARAMS, cfg, plan, TIER_RUNS, TIER_KW,
                          tier, str(tmp_path / "port")))
    assert len(res) == 4
    for r in res:
        assert r["tokens"] == want
        assert r["stats"] == res[0]["stats"] and r["counters"] == res[0]["counters"]
        assert r["stats"]["cached_tokens"] == jeng.stats.cached_tokens > 0
        assert r["passes"] == res[0]["passes"] > 0


def test_pp_int8_matches_jax_int8_and_hits(group, jmesh):
    """int8 KV under pp: scales shard with their layers and heads, chunks and
    decode steps quantize in-layer; tokens equal the JAX pp int8 engine's,
    prefix reuse included."""
    prompts = [np.random.default_rng(7).integers(1, JCFG.vocab_size, 22).tolist(),
               np.random.default_rng(8).integers(1, JCFG.vocab_size, 15).tolist()]
    runs = [(prompts, GREEDY), ([prompts[0] + [9, 8]], GREEDY)]
    want, jeng = _jax_tokens(runs, jmesh, kv_quant="int8")
    got = _serve(group, runs, kv_quant="int8")
    assert got["tokens"] == want
    assert got["stats"]["cached_tokens"] == jeng.stats.cached_tokens >= 20


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_pp_multi_step_matches_jax(group, jmesh, kv_quant):
    """``decode_steps_per_launch`` = 4 through ``pp_decode_multi``: greedy
    tokens equal the JAX pp engine's, every step a multi-step launch."""
    prompts = [np.random.default_rng(0).integers(1, JCFG.vocab_size, 24).tolist(),
               np.random.default_rng(1).integers(1, JCFG.vocab_size, 17).tolist()]
    runs = [(prompts, dict(temperature=0.0, max_new_tokens=8))]
    want, _ = _jax_tokens(runs, jmesh, kv_quant=kv_quant, decode_steps_per_launch=4)
    got = _serve(group, runs, kv_quant=kv_quant, decode_steps_per_launch=4)
    assert got["tokens"] == want
    assert got["stats"]["multi_step_launches"] > 0


def test_pp_multi_step_stochastic_rows_complete(group):
    """Sampled rows run the same fused schedule: every rank returns the same
    tokens (the last stage samples, every rank's generator stays in step)."""
    runs = [([list(range(1, 20))], dict(temperature=0.8, top_p=0.9, max_new_tokens=8)),
            ([list(range(3, 30))], dict(temperature=0.8, max_new_tokens=5))]
    got = _serve(group, runs, decode_steps_per_launch=4)
    assert [len(t) for r in got["tokens"] for t in r] == [8, 5]
    assert all(0 <= t < TCFG.vocab_size for r in got["tokens"] for o in r for t in o)


@pytest.mark.parametrize("k,kv_quant,seed,ps,maxp,lengths", [
    (4, None, 5, 4, 8, (3, 7, 12, 5)),
    (3, None, 11, 4, 8, (3, 7, 12, 5)),
    (3, "int8", 17, 4, 8, (3, 7, 12, 5)),
    (2, None, 6, 8, 4, (3, 9, 14, 6)),  # dryrun_multichip's kernel-engaged pp decode leg
])
def test_pp_decode_multi_matches_decode_multi(group, k, kv_quant, seed, ps, maxp, lengths):
    """Function level: the rotating pipeline, its stage bodies running B1's
    plain version, emits the JAX ``decode_multi``'s greedy tokens on the
    same pool, and writes the same pool (int8 payloads exact, scales at
    rtol 1e-6)."""
    B = 4
    num_slots = B * maxp * ps
    rng = np.random.default_rng(seed)
    shape = (2, JCFG.n_layers, JCFG.n_kv_heads, num_slots, JCFG.head_dim)
    scale = None
    if kv_quant:
        pool = rng.integers(-127, 128, shape).astype(np.int8)
        scale = (np.abs(rng.normal(size=shape[:4])) * 0.01).astype(np.float32)
    else:
        pool = rng.normal(size=shape).astype(np.float32)
    pt = np.arange(B * maxp, dtype=np.int32).reshape(B, maxp)
    lengths = np.asarray(lengths, np.int32)
    tokens = rng.integers(1, JCFG.vocab_size, B).astype(np.int32)
    zeros, ones = jnp.zeros((B,), jnp.float32), jnp.ones((B,), jnp.float32)
    out = jl.decode_multi(
        JPARAMS, JCFG, jnp.asarray(tokens), jnp.asarray(pool), jnp.asarray(pt), jnp.asarray(lengths),
        jax.random.PRNGKey(9), zeros, ones, page_size=ps, k_steps=k, top_ks=jnp.zeros((B,), jnp.int32),
        kv_scale=None if scale is None else jnp.asarray(scale))
    res = _live(group.run(PP + "pp_multi", NP_PARAMS, TCFG, PLAN, tokens.astype(np.int64), pool, pt,
                          lengths, k, ps, scale))
    assert len(res) == 4
    for r in res:
        np.testing.assert_array_equal(r["tokens"], np.asarray(out[0]))
        if kv_quant:
            np.testing.assert_array_equal(r["pool"], np.asarray(out[1]))
            np.testing.assert_allclose(r["scale"], np.asarray(out[2]), rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_allclose(r["pool"], np.asarray(out[1]), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("max_batch,kv_quant", [(4, None), (1, None), (2, "int8")])
def test_pp_spec_replay_matches_jax(group, jmesh, max_batch, kv_quant):
    """Speculative decode under pp: the verify pass is a C = γ + 1 chunk
    through ``pp_forward_chunk`` (one microbatch where ``max_batch`` does not
    divide by pp). Greedy tokens, first serve and tree-drafted replay,
    equal the JAX pp engine's; the replay accepts drafts."""
    prompt = list(range(1, 28)) if kv_quant is None else list(range(5, 32))
    runs = [([prompt], dict(temperature=0.0, max_new_tokens=8))] * 2
    kw = dict(max_batch=max_batch, spec_decode_tokens=3, kv_quant=kv_quant)
    want, _ = _jax_tokens(runs, jmesh, **kw)
    got = _serve(group, runs, **kw)
    assert got["tokens"] == want
    assert got["stats"]["spec_accepted"] > 0 and got["stats"]["verify_launches"] > 0


@pytest.mark.parametrize("seed", [3, 14])
def test_pp_request_storm_drains_and_balances(group, seed):
    """The JAX storm on the pp x tp engine: admission waves, cancellation,
    preemption on a tight pool, mixed sampling; every request finishes, the
    pool balances, every rank made the same decisions."""
    kw = dict(num_slots=128, page_size=4, max_batch=4, max_seq_len=128,
              decode_steps_per_launch=2 if seed == 3 else 1, spec_decode_tokens=3 if seed == 14 else 0)
    res = _live(group.run(PP + "storm", NP_PARAMS, TCFG, PLAN, seed, kw))
    assert len(res) == 4
    for r in res:
        assert r["requests"] == res[0]["requests"] and r["stats"] == res[0]["stats"]
    for state, cancelled, out, budget in res[0]["requests"]:
        assert state == "finished"
        assert cancelled or len(out) == budget
        assert all(0 <= t < TCFG.vocab_size for t in out)
    free, tree_tokens, slots = res[0]["balance"]
    assert free + tree_tokens + 4 == slots


def test_pp_engine_host_cache_tier(group):
    """pp = 2, tp = 1: a prefix evicted from a small layer-sharded pool goes
    to each rank's host arena (its own layers) and restores on a hit, as
    the JAX engine's host tier does on its pp mesh."""
    from radixmesh_tpu.obs.metrics import Registry, get_registry, set_registry

    prompts = [list(range(1, 60)), list(range(100, 160)), list(range(1, 60))]
    kw = dict(num_slots=128, page_size=4, max_batch=1, max_seq_len=96, host_cache_slots=1024)
    old = get_registry()
    set_registry(Registry())
    try:
        jeng = JEngine(JCFG, JPARAMS, device_mesh=j_pp_mesh(pp=2, tp=1), name="pp-hicache", **kw)
        want = [jeng.generate([p], max_steps=30) for p in prompts]
        jsnap = get_registry().snapshot()
    finally:
        set_registry(old)
    res = _live(group.run(PP + "host_tier", NP_PARAMS, TCFG, (1, 1, 1, 2), prompts, kw))
    assert len(res) == 2
    for r in res:
        assert r["tokens"] == want and r["stats"] == res[0]["stats"]
        assert r["arena_layers"] == TCFG.n_layers // 2
        assert r["cached"] == jeng.stats.cached_tokens > 0
        assert r["backup"] == jsnap["radixmesh_hicache_backup_tokens_total"] > 0
        assert r["restore"] == jsnap["radixmesh_hicache_restore_tokens_total"] > 0


def test_w8a16_pp_matches_single_device(group):
    """``tests/test_wquant.py``'s pp case: W8A16 weights quantized before
    sharding (scales with their weights), a pp = 2 x tp = 2 engine with
    ``decode_steps_per_launch`` = 3, greedy tokens equal to the JAX
    single-device W8A16 engine's."""
    cfg = JCFG
    params = jl.init_params(cfg, jax.random.PRNGKey(11))
    prompts = [np.random.default_rng(9).integers(1, cfg.vocab_size, 14).tolist(),
               np.random.default_rng(10).integers(1, cfg.vocab_size, 9).tolist()]
    runs = [(prompts, GREEDY)]
    want, _ = _jax_tokens(runs, params=params, num_slots=512, max_batch=2, weight_quant="int8")
    got = _serve(group, runs, np_params=jax.tree_util.tree_map(np.asarray, params), num_slots=512,
                 max_batch=2, weight_quant="int8", decode_steps_per_launch=3)
    assert got["tokens"] == want


def test_dryrun_pp_serving_leg(group):
    """``dryrun_multichip``'s PP-serving leg: page size 8, k = 2 fused decode,
    tokens equal to the single-device engine's."""
    params = jl.init_params(JCFG, jax.random.PRNGKey(4))
    prompt = np.random.default_rng(0).integers(1, JCFG.vocab_size, 20).tolist()
    runs = [([prompt], dict(temperature=0.0, max_new_tokens=4))]
    want, _ = _jax_tokens(runs, params=params, page_size=8)
    got = _serve(group, runs, np_params=jax.tree_util.tree_map(np.asarray, params), page_size=8,
                 decode_steps_per_launch=2)
    assert got["tokens"] == want


def test_pp_engine_tree_snapshot_restore(group, jmesh, tmp_path):
    """Serve, snapshot the tree and the pool (``save_tree(..., mesh=)``),
    restore into a fresh pp = 2 x tp = 2 engine: the restored prefix is a
    cache hit and a plain re-serve of the prompt replays the first
    continuation; the tokens equal the JAX pp engine's, and the file the
    ranks wrote restores into that JAX engine too."""
    from radixmesh_tpu.checkpoint import load_tree as j_load_tree

    prompt = list(range(1, 30))
    path = str(tmp_path / "pp-tree.json")
    kw = dict(num_slots=1024, page_size=4, max_batch=2)
    res = _live(group.run("tests._torch_train_cases:pp_tree_snapshot", NP_PARAMS, TCFG, PLAN, prompt, path, kw))
    assert len(res) == 4
    jeng = JEngine(JCFG, JPARAMS, device_mesh=jmesh, **kw)
    want1 = jeng.generate([prompt], JSampling(**GREEDY))[0]
    for r in res:
        assert r == res[0]
        assert r["out1"] == want1 and r["out3"] == r["out1"]
        assert len(r["out2"]) == 6 and r["cached"] >= 24
    jeng2 = JEngine(JCFG, JPARAMS, device_mesh=jmesh, **kw)
    assert j_load_tree(path, jeng2.tree, pool=jeng2.pool) == res[0]["restored"]
    cached0 = jeng2.stats.cached_tokens
    assert jeng2.generate([prompt + [7, 8]], JSampling(**GREEDY))[0] == res[0]["out2"]
    assert jeng2.stats.cached_tokens - cached0 >= 24
