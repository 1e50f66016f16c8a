"""The KV tiers and the async KV-movement plane on an engine over several
ranks, against the JAX ``Engine`` on the same mesh.

The port's ranks are four processes over gloo (``tests/_torch_ranks.py``,
one group for the file), on a tp = 2, a pp = 2 and a pp = 2 × tp = 2 mesh;
the JAX engine runs here on conftest's virtual devices, on
``make_mesh(MeshPlan(tp=2))`` and ``make_pp_serving_mesh``. The script is
prompts a, b, a in a pool that holds one of them, so b evicts a to the host
tier and the second a restores it. Every rank must give the JAX engine's
greedy tokens (float32) and ``cached_tokens``, and the same stats and tier
counters as every other rank. The step agreement (``parallel/step_sync.py``)
runs only where an asynchronous source is bound, and a rank whose copies
land late holds every rank's parked request until they have landed
everywhere.
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
from radixmesh_tpu.parallel.sharding import MeshPlan as JPlan
from radixmesh_tpu.parallel.sharding import make_mesh as j_make_mesh
from radixmesh_tpu_torch.models.llama import ModelConfig
from tests._torch_ranks import RankGroup
from tests._torch_tier_cases import TIERS, tier_kw

torch.set_num_threads(1)

JCFG = jl.ModelConfig.tiny().replace(n_heads=4, n_kv_heads=4, dtype=jnp.float32)
TCFG = ModelConfig.tiny().replace(n_heads=4, n_kv_heads=4, dtype=torch.float32)
JPARAMS = jl.init_params(JCFG, jax.random.PRNGKey(0))
NP_PARAMS = jax.tree_util.tree_map(np.asarray, JPARAMS)
GREEDY = dict(temperature=0.0, max_new_tokens=4)
KW = dict(num_slots=128, page_size=4, max_batch=4)
CASES = "tests._torch_tier_cases:"
# (dp, sp, tp, pp) -> the JAX mesh of the same shape.
PLANS = {"tp2": (1, 1, 2, 1), "pp2": (1, 1, 1, 2), "pp2tp2": (1, 1, 2, 2)}
A = np.random.default_rng(0).integers(1, JCFG.vocab_size, 64).tolist()
B = np.random.default_rng(1).integers(1, JCFG.vocab_size, 64).tolist()
RUNS = [([A], GREEDY), ([B], GREEDY), ([A], GREEDY)]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(4, str(tmp_path_factory.mktemp("ranks")))
    yield g
    g.close()


def _jmesh(plan):
    _, _, tp, pp = plan
    return j_make_mesh(JPlan(tp=tp)) if pp == 1 else j_pp_mesh(pp=pp, tp=tp)


_JAX = {}


def _jax(plan, tier, root):
    key = (plan, tier)
    if key not in _JAX:
        eng = JEngine(JCFG, JPARAMS, device_mesh=_jmesh(plan), **KW, **tier_kw(tier, root))
        tokens = [eng.generate(p, JSampling(**s)) for p, s in RUNS]
        _JAX[key] = (tokens, eng.stats.cached_tokens)
        if getattr(eng, "kv_transfer", None) is not None:
            eng.kv_transfer.close()
    return _JAX[key]


def _same_on_every_rank(results, n):
    live = [r for r in results if r is not None]
    assert len(live) == n
    for r in live[1:]:
        for k in ("tokens", "stats", "counters", "passes"):
            assert r[k] == live[0][k], (k, r[k], live[0][k])
    return live[0]


@pytest.mark.parametrize("tier", ["host", "disk", "plane"])
@pytest.mark.parametrize("name", list(PLANS))
def test_tiers_match_jax_on_the_mesh(group, tmp_path, name, tier):
    """Every rank gives the JAX engine's tokens and ``cached_tokens`` on the
    same mesh; the restore really ran (the second a hits through the host
    tier), its counters equal on every rank; the disk setup spills."""
    plan = PLANS[name]
    want, want_cached = _jax(plan, tier, str(tmp_path / "jax"))
    res = group.run(CASES + "serve_tiers", NP_PARAMS, TCFG, plan, RUNS, KW, tier, str(tmp_path / "port"))
    got = _same_on_every_rank(res, plan[2] * plan[3])
    assert got["tokens"] == want
    assert got["stats"]["cached_tokens"] == want_cached == 60
    c = got["counters"]
    assert c["backup_tokens"] > 0 and c["restore_tokens"] > 0
    if tier == "disk":
        assert c["spilled_tokens"] > 0 and c["disk_extents"] > 0
    # The agreement runs exactly where an asynchronous source is bound.
    agree = got["collectives"].get("agree", {"calls": 0})["calls"]
    if tier == "host":
        assert got["passes"] is None and agree == 0
    else:
        assert got["passes"] == agree > 0


@pytest.mark.parametrize("name", ["tp2", "pp2"])
def test_no_source_no_agreement(group, name):
    """A mesh with no asynchronous source bound makes no agreement
    collective, and its collective tally is the one it had without tiers."""
    plan = PLANS[name]
    runs = RUNS[:2]
    bare = [r for r in group.run(CASES + "serve_tiers", NP_PARAMS, TCFG, plan, runs, KW, "none") if r]
    host = [r for r in group.run(CASES + "serve_tiers", NP_PARAMS, TCFG, plan, runs, KW, "host") if r]
    for a, b in zip(bare, host, strict=True):
        assert "agree" not in a["collectives"] and "agree" not in b["collectives"]
        assert {k: v["calls"] for k, v in a["collectives"].items()} == \
               {k: v["calls"] for k, v in b["collectives"].items()}
        assert a["tokens"] == b["tokens"]


def test_late_rank_holds_every_rank(group):
    """Rank 1's plane reports its landed copies three pumps late: both ranks
    resume the parked request in the same pass, after the delay, and emit
    the same tokens as the JAX engine, with no collective timing out."""
    plan = PLANS["tp2"]
    want, _ = _jax(plan, "plane", None)
    res = [r for r in group.run(CASES + "agreement_late_rank", NP_PARAMS, TCFG, plan, RUNS, KW, 3) if r]
    assert len(res) == 2
    assert res[0]["tokens"] == res[1]["tokens"] == want
    assert res[0]["resumed_at"] == res[1]["resumed_at"] and len(res[0]["resumed_at"]) == 1
    assert res[1]["held"] == 3 and res[0]["held"] == 0
    assert res[0]["stats"] == res[1]["stats"]


@pytest.mark.parametrize("name", ["tp2", "pp2"])
def test_prefetch_hint_restores_on_every_rank(group, name):
    """A prefetch hint taken in by the leader's plane restores the hinted
    prefix on every rank at the next pass, before any request asks; the
    request then hits it whole and gives the JAX engine's tokens."""
    plan = PLANS[name]
    want, _ = _jax(plan, "plane", None)
    res = [r for r in group.run(CASES + "prefetch_hint", NP_PARAMS, TCFG, plan, RUNS[:2], KW, A) if r]
    assert len(res) == 2
    for r in res:
        assert r["outcomes"] == res[0]["outcomes"] and r["outcomes"]["started"] == 1
        assert r["restored"] == res[0]["restored"] > 0
        assert r["tokens"] == [want[2][0]] and r["hit"] == 60


def test_disk_extents_per_rank_and_resurrection(group, tmp_path):
    """Draining a pp = 2 × tp = 2 engine leaves each rank's shard extents in
    its own subdirectory beside its manifest; a fresh engine on the
    directory grafts the same prefixes on every rank, and an extent that is
    corrupt on one rank is grafted on none."""
    plan = PLANS["pp2tp2"]
    root = str(tmp_path / "tier")
    res = [r for r in group.run(CASES + "serve_tiers", NP_PARAMS, TCFG, plan, RUNS, KW, "disk", root, True)
           if r]
    assert all(r["drain"][1] for r in res)
    names = res[0]["extents"]
    assert "manifest.json" in names and all(r["extents"] == names for r in res)
    extents = [n for n in names if n.endswith(".kv")]
    assert extents
    back = [r for r in group.run(CASES + "resurrect", NP_PARAMS, TCFG, plan, KW, root) if r]
    assert all(r["resurrected"] == back[0]["resurrected"] for r in back)
    assert back[0]["resurrected"]["grafted_nodes"] == len(extents)
    bad = extents[-1]
    again = [r for r in group.run(CASES + "resurrect", NP_PARAMS, TCFG, plan, KW, root, bad) if r]
    assert all(r["resurrected"] == again[0]["resurrected"] for r in again)
    assert again[0]["resurrected"]["grafted_nodes"] < len(extents)
    assert all(bad not in r["extents"] for r in again)
