"""The disaggregated handoff and a pool-bound mesh replica on an engine over
several ranks, against the JAX package.

The port's ranks are four processes over gloo (``tests/_torch_ranks.py``,
one group for the file); the JAX workers run here on conftest's virtual
devices. A port ``PrefillWorker`` on tp = 2, pp = 2 and pp = 2 × tp = 2
gathers every head and layer to its leader, whose packet (the JAX wire
format) holds the JAX ``PrefillWorker``'s K/V from the same mesh (float32,
atol 1e-4) and its first token; a JAX single-device packet decoded by a
port ``DecodeWorker`` on a mesh gives the JAX tokens on every rank. A
pool-bound ``MeshCache`` replica on the leader frees through a proxy whose
frees reach every rank's allocator at the next pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.engine.disagg import DecodeWorker as JDecodeWorker
from radixmesh_tpu.engine.disagg import PrefillWorker as JPrefillWorker
from radixmesh_tpu.engine.disagg import pack_handoff as j_pack
from radixmesh_tpu.engine.engine import Engine as JEngine
from radixmesh_tpu.engine.request import SamplingParams as JSampling
from radixmesh_tpu.models import llama as jl
from radixmesh_tpu.parallel.pp_serving import make_pp_serving_mesh as j_pp_mesh
from radixmesh_tpu.parallel.sharding import MeshPlan as JPlan
from radixmesh_tpu.parallel.sharding import make_mesh as j_make_mesh
from radixmesh_tpu_torch.engine.disagg import unpack_handoff
from radixmesh_tpu_torch.models.llama import ModelConfig
from tests._torch_ranks import RankGroup

torch.set_num_threads(1)

JCFG = jl.ModelConfig.tiny().replace(n_heads=4, n_kv_heads=4, dtype=jnp.float32)
TCFG = ModelConfig.tiny().replace(n_heads=4, n_kv_heads=4, dtype=torch.float32)
JPARAMS = jl.init_params(JCFG, jax.random.PRNGKey(0))
NP_PARAMS = jax.tree_util.tree_map(np.asarray, JPARAMS)
GREEDY = dict(temperature=0.0, max_new_tokens=5)
KW = dict(num_slots=512, page_size=4, max_batch=4)
CASES = "tests._torch_tier_cases:"
PLANS = {"tp2": (1, 1, 2, 1), "pp2": (1, 1, 1, 2), "pp2tp2": (1, 1, 2, 2)}
PROMPT = np.random.default_rng(3).integers(1, JCFG.vocab_size, 45).tolist()


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(4, str(tmp_path_factory.mktemp("ranks")))
    yield g
    g.close()


def _jmesh(plan):
    _, _, tp, pp = plan
    return j_make_mesh(JPlan(tp=tp)) if pp == 1 else j_pp_mesh(pp=pp, tp=tp)


def _leader(results):
    live = [r for r in results if r is not None]
    packets = [r for r in live if r.get("packet") is not None or r.get("chunks")]
    return live, packets


@pytest.mark.parametrize("name", list(PLANS))
def test_prefill_packet_matches_jax_mesh_packet(group, name):
    """The leader's packet equals the JAX ``PrefillWorker``'s on the same
    mesh: the header fields, the first token and every head and layer of
    the K/V; the other ranks ship nothing but took part in the gather."""
    plan = PLANS[name]
    jpkt = JPrefillWorker(JCFG, JPARAMS, device_mesh=_jmesh(plan), **KW).prefill_handoff(
        PROMPT, JSampling(**GREEDY))
    want = unpack_handoff(j_pack(jpkt))
    live, packets = _leader(group.run(CASES + "prefill_packet", NP_PARAMS, TCFG, plan, PROMPT, GREEDY, KW))
    assert len(live) == plan[2] * plan[3] and len(packets) == 1
    assert all(r["gather_bytes"] == live[0]["gather_bytes"] > 0 for r in live)
    got = unpack_handoff(packets[0]["packet"])
    assert got.first_token == want.first_token
    assert got.prompt.tolist() == want.prompt.tolist() and got.kv_start == want.kv_start
    assert tuple(got.kv.shape) == tuple(want.kv.shape) == (2, TCFG.n_layers, len(PROMPT), 4, TCFG.head_dim)
    np.testing.assert_allclose(got.kv.numpy(), want.kv.numpy(), rtol=0, atol=1e-4)
    # The single device's packet is the mesh's, to the header's length.
    single = group.run(CASES + "prefill_packet", NP_PARAMS, TCFG, None, PROMPT, GREEDY, KW)[0]["packet"]
    one = unpack_handoff(single)
    assert one.first_token == got.first_token
    np.testing.assert_allclose(one.kv.numpy(), got.kv.numpy(), rtol=0, atol=1e-4)


def test_streamed_prefill_on_a_mesh(group):
    """``prefill_handoff_stream`` on pp = 2 × tp = 2: the leader sends every
    chunk, whose K/V, joined, is the whole packet's; a tp = 2
    ``DecodeWorker`` reassembles them to the single device's tokens."""
    plan = PLANS["pp2tp2"]
    live, packets = _leader(group.run(CASES + "prefill_packet", NP_PARAMS, TCFG, plan, PROMPT, GREEDY, KW,
                                      stream=16))
    assert len(packets) == 1 and all(r["n"] == 3 for r in live)
    chunks = [unpack_handoff(c) for c in packets[0]["chunks"]]
    assert [c.chunk_seq for c in chunks] == [0, 1, 2] and all(c.chunk_of == 3 for c in chunks)
    whole = unpack_handoff(group.run(CASES + "prefill_packet", NP_PARAMS, TCFG, plan, PROMPT, GREEDY,
                                     KW)[0]["packet"])
    np.testing.assert_array_equal(torch.cat([c.kv for c in chunks], dim=2).numpy(), whole.kv.numpy())
    want = JEngine(JCFG, JPARAMS, **KW).generate([PROMPT], JSampling(**GREEDY))
    res = [r for r in group.run(CASES + "decode_packets", NP_PARAMS, TCFG, PLANS["tp2"],
                                packets[0]["chunks"], KW) if r]
    assert len(res) == 2 and all(r["tokens"] == want for r in res)


@pytest.mark.parametrize("name,stage_layers", [("tp2", 0), ("pp2tp2", 1)])
def test_jax_packet_decodes_on_a_mesh(group, name, stage_layers):
    """A JAX single-device packet, handed to the leader of a port
    ``DecodeWorker`` on a mesh, decodes on every rank to the JAX decode
    worker's tokens; every rank's pool ends alike."""
    jpw = JPrefillWorker(JCFG, JPARAMS, **KW)
    data = j_pack(jpw.prefill_handoff(PROMPT, JSampling(**GREEDY)))
    jdw = JDecodeWorker(JEngine(JCFG, JPARAMS, **KW))
    jreq = jdw.submit(jpw.prefill_handoff(PROMPT, JSampling(**GREEDY)))
    jdw.run_until_drained()
    res = [r for r in group.run(CASES + "decode_packets", NP_PARAMS, TCFG, PLANS[name], [data], KW,
                                stage_layers) if r]
    assert len(res) == PLANS[name][2] * PLANS[name][3]
    for r in res:
        assert r["tokens"] == [jreq.generated]
        assert r["free_slots"] == res[0]["free_slots"] and r["stats"] == res[0]["stats"]
        assert r["collectives"]["agree"]["calls"] > 0 and r["collectives"]["agree_broadcast"]["calls"] == 1


@pytest.mark.parametrize("name", ["tp2", "pp2"])
def test_pool_bound_mesh_replica(group, name):
    """The leader's replica is bound to its pool through the proxy; the
    engine and a single-device node of the same ring serve the prompt to
    the JAX tokens; a free through the replica lands on every rank's
    allocator at the next pass, and every rank's slots balance."""
    plan = PLANS[name]
    want = JEngine(JCFG, JPARAMS, **KW).generate([PROMPT], JSampling(**GREEDY))
    addrs = [f"sharded-{name}-p0", f"sharded-{name}-d0"]
    res = [r for r in group.run(CASES + "mesh_pool", NP_PARAMS, TCFG, plan, PROMPT, GREEDY, KW, addrs) if r]
    assert len(res) == plan[2] * plan[3]
    assert res[0]["proxy"] == "MeshPoolProxy" and all(r["bound"] for r in res)
    assert res[0]["other_tokens"] == want
    for r in res:
        assert r["tokens"] == want
        assert r["freed"] == 2 * KW["page_size"]
        assert r["free_slots"] == res[0]["free_slots"] and r["balance"]


def test_mesh_pool_proxy_under_thread_pressure():
    """The proxy's queue is written by a replica's threads while the engine
    thread takes it: with more writers than cores and a short switch
    interval, every queued slot is applied to the pool exactly once."""
    import sys
    import threading

    from radixmesh_tpu_torch.parallel.step_sync import MeshPoolProxy

    class Pool:
        def __init__(self):
            self.freed = []
            self.allocator = "local allocator"

        def free(self, slots):
            self.freed.extend(int(s) for s in slots)

    pool = Pool()
    proxy = MeshPoolProxy(pool)
    assert proxy.allocator == "local allocator"
    writers, per = 16, 400
    done = threading.Event()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def write(w):
            for i in range(per):
                proxy.free(np.asarray([w * per + i], np.int32))

        threads = [threading.Thread(target=write, args=(w,)) for w in range(writers)]
        for t in threads:
            t.start()

        def drain():
            while not done.is_set() or proxy.pending():
                proxy.apply(proxy.take())

        taker = threading.Thread(target=drain)
        taker.start()
        for t in threads:
            t.join(timeout=60)
        done.set()
        taker.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not taker.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert sorted(pool.freed) == list(range(writers * per))
