"""Tensor- and sequence-parallel serving in the port, against the JAX
package (twins of ``tests/test_sharded_serving.py`` and the serving legs of
``dryrun_multichip``).

The port's ranks are eight processes over gloo (``tests/_torch_ranks.py``,
one group for the file); the JAX references run here, on conftest's eight
virtual CPU devices, with the JAX ``Engine`` on ``make_mesh(MeshPlan(dp=1,
sp=2, tp=4))``. Greedy tokens are compared exactly in float32; logits at
atol 1e-4. Every rank of a mesh must return the same tokens and the same
``EngineStats`` (wall-clock fields aside).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.engine.engine import Engine as JEngine
from radixmesh_tpu.engine.request import SamplingParams as JSampling
from radixmesh_tpu.models import llama as jl
from radixmesh_tpu.ops.attention import attend_decode_ref as j_decode_ref
from radixmesh_tpu.ops.attention import paged_attention_pool_kernel_sharded as j_pool_sharded
from radixmesh_tpu.ops.attention import paged_chunk_attention_kernel_sharded as j_chunk_sharded
from radixmesh_tpu.ops.attention import paged_decode_fused_sharded as j_decode_sharded
from radixmesh_tpu.parallel.sharding import MeshPlan as JPlan
from radixmesh_tpu.parallel.sharding import make_mesh as j_make_mesh
from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.models.llama import ModelConfig, init_params
from radixmesh_tpu_torch.parallel.sharding import MeshPlan, ProcessMesh
from tests._torch_ranks import RankGroup

torch.set_num_threads(1)

JCFG = jl.ModelConfig.tiny().replace(n_heads=4, n_kv_heads=4, dtype=jnp.float32)
TCFG = ModelConfig.tiny().replace(n_heads=4, n_kv_heads=4, dtype=torch.float32)
JPARAMS = jl.init_params(JCFG, jax.random.PRNGKey(0))
NP_PARAMS = jax.tree_util.tree_map(np.asarray, JPARAMS)
GREEDY = dict(temperature=0.0, max_new_tokens=6)
KW = dict(num_slots=1024, page_size=4, max_batch=4)
MESH = (1, 2, 4)  # the JAX test's mesh: 8 ranks
CASES = "tests._torch_parallel_cases:"


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(8, str(tmp_path_factory.mktemp("ranks")))
    yield g
    g.close()


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh(JPlan(dp=1, sp=2, tp=4))


def _prompts():
    return [
        np.random.default_rng(0).integers(1, JCFG.vocab_size, 24).tolist(),
        np.random.default_rng(1).integers(1, JCFG.vocab_size, 17).tolist(),
    ]


def _same_on_every_rank(results):
    live = [r for r in results if r is not None]
    assert live, "no rank was in the mesh"
    for r in live[1:]:
        assert r["tokens"] == live[0]["tokens"]
        assert r["stats"] == live[0]["stats"]
    return live[0]


def _j_generate(engine, runs):
    return [engine.generate(p, JSampling(**s)) for p, s in runs]


@pytest.mark.parametrize("plan", [MESH, (1, 1, 2)], ids=["sp2-tp4", "tp2"])
def test_sharded_engine_matches_single_device(group, jmesh, plan):
    """Same greedy tokens with and without the mesh, in both packages: the
    JAX mesh engine, the port's single-device engine and every port rank."""
    runs = [(_prompts(), GREEDY)]
    jm = jmesh if plan == MESH else j_make_mesh(JPlan(*plan))
    want = _j_generate(JEngine(JCFG, JPARAMS, **KW), runs)
    assert _j_generate(JEngine(JCFG, JPARAMS, device_mesh=jm, **KW), runs) == want
    single = group.run(CASES + "serve", NP_PARAMS, TCFG, None, runs, KW)[0]
    assert single["tokens"] == want
    got = _same_on_every_rank(group.run(CASES + "serve", NP_PARAMS, TCFG, plan, runs, KW))
    assert got["tokens"] == want
    assert got["pool_heads"] == TCFG.n_kv_heads // plan[2]
    # The first-token logits agree with the single-device engine's.
    for a, b in zip(got["first_logits"], single["first_logits"]):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def test_sharded_prefix_hit(group):
    """Cache publish + reuse work against the kv-head-sharded pool."""
    prompt = list(range(1, 25))
    runs = [([prompt], GREEDY), ([prompt + [100, 101]], GREEDY)]
    got = _same_on_every_rank(group.run(CASES + "serve", NP_PARAMS, TCFG, MESH, runs, KW))
    assert got["stats"]["cached_tokens"] >= 24
    single = group.run(CASES + "serve", NP_PARAMS, TCFG, None, runs, KW)[0]
    assert got["tokens"] == single["tokens"]


def test_tp_divisibility_validated(group):
    bad = ModelConfig.tiny()  # 2 kv heads, tp=4
    out = [r for r in group.run(CASES + "serve_refused", bad, MESH, {}) if r is not None]
    assert out and all(r.startswith("ValueError") and "divide tp" in r for r in out), out


def test_shard_map_kernel_matches_oracle(group, jmesh):
    """The sharded pool, chunk and decode wrappers on each rank's head shard
    (plain versions on the CPU), gathered over tp: each against the JAX
    ``shard_map`` wrapper of its Pallas kernel (interpret mode) and the
    unsharded port wrapper, the pool path also against the JAX gather
    oracle."""
    from radixmesh_tpu_torch.ops.attention import paged_chunk_attention, paged_decode_attention

    rng = np.random.default_rng(3)
    B, Hq, Hkv, D, page, P_, L = 2, 8, 4, 128, 8, 16, 2
    max_pages = 4
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    kv = rng.normal(size=(2, L, Hkv, P_, page, D)).astype(np.float32)
    pt = rng.permutation(P_)[: B * max_pages].reshape(B, max_pages).astype(np.int32)
    ln = np.asarray([3, max_pages * page], np.int32)
    layer = 1
    C = 4
    chunk = (rng.normal(size=(B, C, Hq, D)).astype(np.float32),
             rng.normal(size=(B, C, Hkv, D)).astype(np.float32),
             rng.normal(size=(B, C, Hkv, D)).astype(np.float32),
             np.asarray([3, 20], np.int32), np.asarray([3 + C, 20 + C], np.int32))
    got = [r for r in group.run(CASES + "sharded_kernels", MESH, q, kv, pt, ln, layer, chunk)
           if r is not None]
    want = j_decode_ref(jnp.asarray(q), jnp.asarray(kv[0, layer]), jnp.asarray(kv[1, layer]),
                        jnp.asarray(pt), jnp.asarray(ln))
    j_sharded = j_pool_sharded(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(pt), jnp.asarray(ln),
                               layer, jmesh, interpret=True)
    t = {k: torch.as_tensor(v) for k, v in dict(q=q, kv=kv, pt=pt, ln=ln).items()}
    cq, ck, cv, prior, kvlen = (torch.as_tensor(x) for x in chunk)
    chunk_want = paged_chunk_attention(cq, ck, cv, t["kv"], t["pt"], prior, kvlen, layer)
    kv_after = t["kv"].clone()
    slots = (t["pt"][:, 0].long() * page).to(torch.int32)
    dec_want = paged_decode_attention(t["q"], ck[:, 0].contiguous(), cv[:, 0].contiguous(),
                                      kv_after, slots, t["pt"], t["ln"], layer)
    j_chunk = j_chunk_sharded(*(jnp.asarray(x) for x in chunk[:3]), jnp.asarray(kv), jnp.asarray(pt),
                              jnp.asarray(chunk[3]), jnp.asarray(chunk[4]), layer, jmesh, interpret=True)
    j_dec, j_kv_after = j_decode_sharded(
        jnp.asarray(q), jnp.asarray(chunk[1][:, 0]), jnp.asarray(chunk[2][:, 0]), jnp.asarray(kv),
        jnp.asarray(slots.numpy()), jnp.asarray(pt), jnp.asarray(ln), layer, jmesh, interpret=True)
    for r in got:
        np.testing.assert_allclose(r["pool"], np.asarray(want), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["pool"], np.asarray(j_sharded), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["chunk"], np.asarray(j_chunk), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["chunk"], chunk_want.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["decode"], np.asarray(j_dec), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["decode"], dec_want.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(r["pool_after"], np.asarray(j_kv_after))
        np.testing.assert_array_equal(r["pool_after"], kv_after.numpy())


class TestSequenceParallelPrefill:
    """A fresh long prompt prefills sequence-sharded: ring attention over
    the sp ranks, each holding its tp heads."""

    def test_sp_prefill_matches_dense(self, group, jmesh):
        cfg_j = JCFG
        params = jl.init_params(cfg_j, jax.random.PRNGKey(3))
        S = 64
        tokens = np.random.default_rng(2).integers(1, cfg_j.vocab_size, (2, S))
        positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (2, S))
        jtok = jnp.asarray(tokens, jnp.int32)
        j_sp, j_k, _ = jl.prefill_forward_sp(params, cfg_j, jtok, positions, jmesh)
        empty = jnp.zeros((cfg_j.n_layers, 2, 0, cfg_j.n_kv_heads, cfg_j.head_dim), cfg_j.dtype)
        j_dense, j_dk, _ = jl.prefill_forward(params, cfg_j, jtok, positions, empty, empty,
                                              jnp.zeros((2,), jnp.int32))
        np_params = jax.tree_util.tree_map(np.asarray, params)
        got = [r for r in group.run(CASES + "sp_prefill", np_params, TCFG, MESH, tokens)
               if r is not None]
        for r in got:
            np.testing.assert_allclose(r["logits"], np.asarray(j_sp), rtol=0, atol=1e-4)
            np.testing.assert_allclose(r["logits"], np.asarray(j_dense), rtol=2e-4, atol=2e-4)
            np.testing.assert_allclose(r["k"], np.asarray(j_k), rtol=0, atol=1e-4)
            np.testing.assert_allclose(r["k"], np.asarray(j_dk), rtol=2e-4, atol=2e-4)
        # logits_at: one row per prompt, the same on every rank.
        at = np.asarray([S - 1, 17])
        j_at, _, _ = jl.prefill_forward_sp(params, cfg_j, jtok, positions, jmesh,
                                           logits_at=jnp.asarray(at, jnp.int32))
        got = [r for r in group.run(CASES + "sp_prefill", np_params, TCFG, MESH, tokens, at)
               if r is not None]
        for r in got:
            np.testing.assert_allclose(r["logits"], np.asarray(j_at), rtol=0, atol=1e-4)

    def test_engine_sp_prefill_end_to_end(self, group, jmesh):
        """An engine on the mesh routes a fresh long prompt through the sp
        path; its published KV is a valid cache for a follow-up."""
        params = jl.init_params(JCFG, jax.random.PRNGKey(3))
        np_params = jax.tree_util.tree_map(np.asarray, params)
        prompt = np.random.default_rng(5).integers(1, JCFG.vocab_size, 60).tolist()
        runs = [([prompt], GREEDY), ([prompt + [9, 8]], GREEDY)]
        kw = dict(num_slots=2048, page_size=4, max_batch=2)
        j_eng = JEngine(JCFG, params, device_mesh=jmesh, sp_prefill_threshold=48, **kw)
        want = _j_generate(j_eng, runs)
        assert want[0] == _j_generate(JEngine(JCFG, params, **kw), runs[:1])[0]
        got = _same_on_every_rank(group.run(
            CASES + "serve", np_params, TCFG, MESH, runs, dict(kw, sp_prefill_threshold=48)))
        assert got["tokens"][0] == want[0]
        assert len(got["tokens"][1][0]) == 6
        assert got["stats"]["cached_tokens"] >= 56
        # The sp path ran: no chunk launch, one dense-free prefill.
        assert got["stats"]["prefill_chunks"] == 0


SCHEDULES = dict(spec_decode_tokens=3, prefill_inline_budget=16, decode_steps_per_launch=4,
                 long_prefill_threshold=24, prefill_chunk=16)


@pytest.mark.parametrize("variant", ["int8 kv", "w8a16 + int8 kv", "schedules"])
def test_variants_match_single_device(group, jmesh, variant):
    """The serving legs of ``dryrun_multichip`` on the (1, 2, 4) mesh: an
    int8 pool, W8A16 weights with an int8 pool, and the fast schedules (spec
    verify, mixed waves, multi-step decode): on every rank the same greedy
    tokens as the JAX mesh engine and the port's single-device engine with
    the same options, and the single-device engine's stats."""
    kw = dict(KW)
    if variant == "int8 kv":
        kw["kv_quant"] = "int8"
    elif variant == "w8a16 + int8 kv":
        kw.update(kv_quant="int8", weight_quant="int8")
    else:
        kw.update(SCHEDULES)
    p = _prompts()
    runs = [(p, GREEDY), ([p[0] + [5, 6]], GREEDY), ([p[1] * 3], dict(GREEDY, max_new_tokens=10))]
    paged = variant == "schedules"  # the paged legs, as on the card
    j_want = _j_generate(JEngine(JCFG, JPARAMS, device_mesh=jmesh, **kw), runs)
    want = group.run(CASES + "serve", NP_PARAMS, TCFG, None, runs, kw, paged=paged)[0]
    assert want["tokens"] == j_want
    got = _same_on_every_rank(group.run(CASES + "serve", NP_PARAMS, TCFG, MESH, runs, kw,
                                        paged=paged))
    assert got["tokens"] == want["tokens"]
    assert got["stats"] == want["stats"]
    if variant == "schedules":
        s = got["stats"]
        assert s["multi_step_launches"] + s["verify_launches"] + s["mixed_launches"] > 0, s


def test_every_rank_reports_its_collectives(group):
    """Each tp rank runs two all-reduces per layer per forward plus one
    embedding all-reduce, and one logits all-gather."""
    runs = [([_prompts()[0]], dict(GREEDY, max_new_tokens=3))]
    res = [r for r in group.run(CASES + "serve", NP_PARAMS, TCFG, (1, 1, 4), runs, KW)
           if r is not None]
    assert len(res) == 4
    forwards = res[0]["collectives"]["all_gather"]["calls"]
    assert forwards == 3  # the prefill and two decode steps
    for r in res:
        assert r["collectives"]["all_reduce"]["calls"] == forwards * (2 * TCFG.n_layers + 1)


def _fake_mesh(**axes) -> ProcessMesh:
    """A mesh object for refusals raised before any collective."""
    plan = MeshPlan(**{k: v for k, v in axes.items() if k in ("dp", "pp", "sp", "tp")})
    return ProcessMesh(plan=plan, rank=0, coords=(0, 0, 0, 0), backend=None,
                       groups={"dp": None, "pp": None, "sp": None, "tp": None},
                       lines={"dp": (0,), "pp": (0,), "sp": (0,), "tp": (0,)})


# The combinations these tests once pinned as refused under tp are served
# since the step agreement (parallel/step_sync.py): each case now builds the
# same combination on a tp = 2 mesh and serves it. The tier script: prompts
# a, b, a in a pool that holds one, so b evicts a and the second a restores.
TIER_KW = dict(num_slots=128, page_size=4, max_batch=4)
TIER_A = np.random.default_rng(0).integers(1, JCFG.vocab_size, 64).tolist()
TIER_B = np.random.default_rng(1).integers(1, JCFG.vocab_size, 64).tolist()
TIER_RUNS = [([TIER_A], dict(GREEDY, max_new_tokens=4)), ([TIER_B], dict(GREEDY, max_new_tokens=4)),
             ([TIER_A], dict(GREEDY, max_new_tokens=4))]
TIERS = "tests._torch_tier_cases:"


@pytest.mark.parametrize("what,kw,match", [
    ("host tier", dict(host_cache_slots=256), "host KV tier"),
    ("disk tier", dict(host_cache_slots=256, kv_tier_dir="unused"), "disk KV tier"),
    ("kv plane", dict(kv_transfer_async=True), "KV-movement plane"),
    ("mesh pool", dict(mesh=type("M", (), {"pool": object(), "page": 1})()), "page pushes"),
])
def test_refused_under_tp(group, tmp_path, what, kw, match):
    """(Named for when tp refused these.) The combination serves on a tp = 2
    mesh: every rank gives the JAX engine's tokens and ``cached_tokens`` on
    the same mesh with the same tier, and the tiers' counters agree across
    ranks; a pool-bound mesh replica on the leader frees through its proxy
    on every rank."""
    plan = (1, 1, 2)
    if what == "mesh pool":
        want = JEngine(JCFG, JPARAMS, **TIER_KW).generate([TIER_A], JSampling(**GREEDY))
        res = [r for r in group.run(TIERS + "mesh_pool", NP_PARAMS, TCFG, plan, TIER_A, GREEDY, TIER_KW,
                                    ["tp-refusal-p0", "tp-refusal-d0"]) if r]
        assert len(res) == 2 and res[0]["proxy"] == "MeshPoolProxy"
        assert all(r["tokens"] == want and r["balance"] for r in res)
        assert res[0]["free_slots"] == res[1]["free_slots"]
        return
    tier = {"host tier": "host", "disk tier": "disk", "kv plane": "plane"}[what]
    from tests._torch_tier_cases import tier_kw

    jkw = tier_kw(tier, str(tmp_path / "jax"))
    jeng = JEngine(JCFG, JPARAMS, device_mesh=j_make_mesh(JPlan(tp=2)), **TIER_KW, **jkw)
    want = [jeng.generate(p, JSampling(**sk)) for p, sk in TIER_RUNS]
    if getattr(jeng, "kv_transfer", None) is not None:
        jeng.kv_transfer.close()
    res = [r for r in group.run(TIERS + "serve_tiers", NP_PARAMS, TCFG, plan, TIER_RUNS, TIER_KW, tier,
                                str(tmp_path / "port")) if r]
    assert len(res) == 2
    for r in res:
        assert r["tokens"] == want
        assert r["stats"] == res[0]["stats"] and r["counters"] == res[0]["counters"]
        assert r["stats"]["cached_tokens"] == jeng.stats.cached_tokens > 0
        assert r["counters"]["restore_tokens"] > 0


def test_refused_handoff_and_pp(group):
    """(Named for when the handoff and the pp tiers were refused.) A tp = 2
    ``PrefillWorker``'s leader ships the single device's packet (the other
    rank None), a pp = 2 ``DecodeWorker`` decodes it to the single device's
    tokens, a pp = 2 engine serves the async plane, and a tp = 1 mesh (sp
    only) still serves the host tier."""
    from radixmesh_tpu_torch.engine.disagg import unpack_handoff

    prompt = _prompts()[0]
    got = group.run(TIERS + "prefill_packet", NP_PARAMS, TCFG, (1, 1, 2), prompt, GREEDY, KW)
    assert got[0]["packet"] is not None and got[1]["packet"] is None and got[2] is None
    single = group.run(TIERS + "prefill_packet", NP_PARAMS, TCFG, None, prompt, GREEDY, KW)[0]["packet"]
    a, b = unpack_handoff(got[0]["packet"]), unpack_handoff(single)
    assert a.first_token == b.first_token
    np.testing.assert_allclose(a.kv.numpy(), b.kv.numpy(), rtol=0, atol=1e-4)
    want = JEngine(JCFG, JPARAMS, **KW).generate([prompt], JSampling(**GREEDY))
    res = [r for r in group.run(TIERS + "decode_packets", NP_PARAMS, TCFG, (1, 1, 1, 2), [single], KW) if r]
    assert len(res) == 2 and all(r["tokens"] == want for r in res)
    plane = [r for r in group.run(TIERS + "serve_tiers", NP_PARAMS, TCFG, (1, 1, 1, 2), TIER_RUNS, TIER_KW,
                                  "plane") if r]
    assert len(plane) == 2 and plane[0]["tokens"] == plane[1]["tokens"]
    assert plane[0]["counters"]["plane_restored_tokens"] > 0
    params = init_params(TCFG, 0, "cpu")
    Engine(TCFG, params, device="cpu", device_mesh=_fake_mesh(sp=1), host_cache_slots=256,
           **KW).close()


def test_single_device_mesh_is_the_single_device_path():
    """A one-rank mesh (no process group) serves exactly as no mesh."""
    from radixmesh_tpu_torch.engine.request import SamplingParams
    from radixmesh_tpu_torch.parallel import make_mesh

    params = init_params(TCFG, 0, "cpu")
    p = _prompts()
    a = Engine(TCFG, params, device="cpu", **KW).generate(p, SamplingParams(**GREEDY))
    b = Engine(TCFG, params, device="cpu", device_mesh=make_mesh(MeshPlan()), **KW)
    assert b.generate(p, SamplingParams(**GREEDY)) == a
    assert dataclasses.asdict(b.stats)["decode_steps"] > 0
