"""One serving script through both packages' mesh-wired stacks.

The JAX package's ``ServingCluster`` of ``tests/test_mesh_serving.py``
(one prefill and one decode engine, each with an advertisement-only
``MeshCache`` replica, and a router replica with ``CacheAwareRouter``, on
an in-process ring) and its port twin run the same script on
``ModelConfig.tiny()`` in float32, with the JAX ``init_params`` carried
across by ``models/convert.py``: serve on each engine, wait for the
router, route shared-prefix requests, serve them where they were routed.
Both give the same advertised keys and slot values on every replica, the
same router attributions and routing decisions, the same
``cached_tokens`` and the same greedy tokens."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu_torch.models.convert import params_from_jax

torch.set_num_threads(1)  # the suite runs in parallel worker processes

PAGE = 4
NODES = {"prefill": ["p0"], "decode": ["d0"], "router": ["r0"]}


def _wait(pred, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def _build(pkg: str, jparams):
    """(meshes by address, engines by address, router, package modules)."""
    if pkg == "jax":
        from radixmesh_tpu.cache.kv_pool import PagedKVPool
        from radixmesh_tpu.cache.mesh_cache import MeshCache
        from radixmesh_tpu.comm.inproc import InprocHub
        from radixmesh_tpu.config import MeshConfig, NodeRole
        from radixmesh_tpu.engine.engine import Engine
        from radixmesh_tpu.engine.request import SamplingParams
        from radixmesh_tpu.models.llama import ModelConfig
        from radixmesh_tpu.router.cache_aware_router import CacheAwareRouter

        cfg = ModelConfig.tiny().replace(dtype=jnp.float32)
        params = jparams

        def engine(mesh, name):
            pool = PagedKVPool(num_slots=512, num_layers=cfg.n_layers, num_kv_heads=cfg.n_kv_heads,
                               head_dim=cfg.head_dim, page_size=PAGE, dtype=cfg.dtype)
            return Engine(cfg, params, pool=pool, page_size=PAGE, max_batch=4, mesh=mesh, name=name)
    else:
        from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
        from radixmesh_tpu_torch.comm.inproc import InprocHub
        from radixmesh_tpu_torch.config import MeshConfig, NodeRole
        from radixmesh_tpu_torch.engine.engine import Engine
        from radixmesh_tpu_torch.engine.request import SamplingParams
        from radixmesh_tpu_torch.models.llama import ModelConfig
        from radixmesh_tpu_torch.router.cache_aware_router import CacheAwareRouter

        cfg = ModelConfig.tiny().replace(dtype=torch.float32)
        params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")

        def engine(mesh, name):
            return Engine(cfg, params, num_slots=512, page_size=PAGE, max_batch=4, mesh=mesh,
                          name=name, device="cpu")

    InprocHub.reset_default()
    meshes, engines = {}, {}
    for addr in NODES["prefill"] + NODES["decode"] + NODES["router"]:
        mcfg = MeshConfig(prefill_nodes=NODES["prefill"], decode_nodes=NODES["decode"],
                          router_nodes=NODES["router"], local_addr=addr, protocol="inproc",
                          tick_interval_s=0.05, gc_interval_s=30.0)
        meshes[addr] = MeshCache(mcfg, pool=None).start()
        if mcfg.local_role is not NodeRole.ROUTER:
            engines[addr] = engine(meshes[addr], addr)
    for m in meshes.values():
        assert m.wait_ready(timeout=10)
    router = CacheAwareRouter(meshes["r0"], meshes["r0"].cfg)
    router.finish_warm_up()
    return meshes, engines, router, SamplingParams


def _entries(tree):
    """(full key, origin rank, slot values) of every node of a replica (a
    router's rank-only values carry their length instead)."""
    out = []
    stack = [(tree.root, ())]
    while stack:
        node, path = stack.pop()
        for child in node.children.values():
            key = path + tuple(int(t) for t in child.key)
            v = child.value
            slots = tuple(int(i) for i in v.indices) if hasattr(v, "indices") else v.length
            out.append((key, int(v.rank), slots))
            stack.append((child, key))
    return sorted(out)


def _script(pkg: str, jparams) -> dict:
    meshes, engines, router, SamplingParams = _build(pkg, jparams)
    greedy = SamplingParams(temperature=0.0, max_new_tokens=5)
    rng = np.random.default_rng(0)
    a = rng.integers(1, 500, 22).tolist()  # served on p0
    b = rng.integers(1, 500, 17).tolist()  # served on d0
    try:
        out = {"tokens": {}, "cached": {}}
        out["tokens"]["a"] = engines["p0"].generate([a], greedy)[0]
        out["tokens"]["b"] = engines["d0"].generate([b], greedy)[0]
        full_a = a + out["tokens"]["a"][:-1]
        full_b = b + out["tokens"]["b"][:-1]
        adv_a, adv_b = len(full_a) - len(full_a) % PAGE, len(full_b) - len(full_b) % PAGE
        assert _wait(lambda: meshes["r0"].match_prefix(full_a).match_len == adv_a
                     and meshes["r0"].match_prefix(full_b).match_len == adv_b), pkg
        assert _wait(lambda: all(m.match_prefix(full_a).length == adv_a
                                 and m.match_prefix(full_b).length == adv_b
                                 for a_, m in meshes.items() if a_ != "r0")), pkg
        out["attribution"] = [
            (r.prefill_rank, r.decode_rank, r.match_len)
            for r in (meshes["r0"].match_prefix(k) for k in (a, b, full_a, full_b, a[:5]))
        ]
        routed = {}
        for name, req in (("a", full_a + [7, 8, 9]), ("b", full_b + [11]), ("cold", [3] * 9)):
            r = router.cache_aware_route(req)
            routed[name] = (r.prefill_addr, r.decode_addr, r.prefill_cache_hit,
                            r.decode_cache_hit, r.match_len)
            # Serve where routed: the prefill node for a prefill hit, the
            # decode node for a decode hit.
            target = r.prefill_addr if r.prefill_cache_hit or not r.decode_cache_hit else r.decode_addr
            eng = engines[target]
            before = eng.stats.cached_tokens
            out["tokens"][name + "_routed"] = eng.generate([req], greedy)[0]
            out["cached"][name] = eng.stats.cached_tokens - before
        out["routes"] = routed
        assert _wait(lambda: all(
            _entries(m.tree) == _entries(meshes["p0"].tree) for a_, m in meshes.items() if a_ != "r0"
        )), pkg
        out["replicas"] = {addr: _entries(m.tree) for addr, m in meshes.items() if addr != "r0"}
        # The router's replica is fed by the master's fan-out after the
        # ring: let it catch up with the last inserts before reading it.
        assert _wait(lambda: [e[:2] for e in _entries(meshes["r0"].tree)]
                     == [e[:2] for e in out["replicas"]["p0"]]), pkg
        out["router_keys"] = _entries(meshes["r0"].tree)
        return out
    finally:
        for m in meshes.values():
            m.close()


@pytest.fixture(scope="module")
def jparams():
    from radixmesh_tpu.models import llama as jl

    return jl.init_params(jl.ModelConfig.tiny().replace(dtype=jnp.float32), jax.random.PRNGKey(0))


def test_one_script_gives_the_same_mesh_state_routes_and_tokens(jparams):
    want = _script("jax", jparams)
    got = _script("torch", jparams)
    assert got["replicas"] == want["replicas"]
    assert got["router_keys"] == want["router_keys"]
    assert got["attribution"] == want["attribution"]
    assert got["routes"] == want["routes"]
    assert got["cached"] == want["cached"]
    assert got["tokens"] == want["tokens"]
    # The script exercised what it compares: a routed prefill hit and a
    # decode hit, each served from the cache.
    assert want["routes"]["a"][0] == "p0" and want["routes"]["a"][2]
    assert want["routes"]["b"][1] == "d0" and want["routes"]["b"][3]
    assert want["cached"]["a"] >= 20 and want["cached"]["b"] >= 16
