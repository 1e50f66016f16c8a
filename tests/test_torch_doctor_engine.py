"""The mesh doctor over the port's own objects, held against the JAX
package's doctor over the JAX ones.

The doctor reads its seams by duck typing (``_restoring``, ``kv_transfer``,
``_kv_tier``, ``timeline``, ``spec_ledger``, ``spec_report``): a name the
port spelled differently would read as a silent "healthy" or a low-ranked
"rule crashed" finding, so these cases drive the real engines, not fakes.

- Parity: one seeded float32 script through the JAX ``Engine`` and the
  port's ``Engine`` on the CPU, on the same weights (a speculative run at
  γ 4, a token timeline, two restores parked behind a host tier), each
  wrapped in a ``MeshDoctor`` with the same small ``DoctorConfig``: equal
  ``rules_checked`` and ``inputs``, the same fired rules, exactly equal
  count evidence, and no "rule crashed" finding on either side.
- ``tier_thrash`` reads the port's ``DiskKVTier.recent_moves`` as the JAX
  rule reads the JAX tier's: real spills and restores through each
  engine's disk tier record the same moves.
- ``/cluster/health`` and ``/cluster/telemetry`` on both port frontends:
  twins of ``tests/test_http_frontend.py``'s ``TestClusterEndpoints``."""

import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.engine.engine import Engine as JEngine
from radixmesh_tpu.engine.request import RequestState as JState
from radixmesh_tpu.engine.request import SamplingParams as JSampling
from radixmesh_tpu.models import llama as jl
from radixmesh_tpu.obs import doctor as jdoctor
from radixmesh_tpu_torch.engine.engine import Engine as TEngine
from radixmesh_tpu_torch.engine.request import RequestState as TState
from radixmesh_tpu_torch.engine.request import SamplingParams as TSampling
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import ModelConfig
from radixmesh_tpu_torch.obs import doctor as tdoctor

torch.set_num_threads(1)  # the suite runs in parallel worker processes

# Small enough that the speculative run's counts reach the spec rules and
# two parked restores reach restore_park_stall.
DOCTOR = dict(park_min_parked=2, spec_min_proposed=4, spec_misconfig_min_proposed=4,
              spec_accept_floor=0.99)
# Stalls are judged on wall-clock gaps: a threshold no CPU step reaches
# keeps decode_stall's verdict off the clock (the rule still runs).
ENGINE_KW = dict(num_slots=512, page_size=4, max_batch=4, max_seq_len=128, spec_decode_tokens=4,
                 host_cache_slots=1024, kv_transfer_async=True, kv_transfer_chunk_tokens=16,
                 token_stall_threshold_s=60.0)
PKGS = {"jax": (JEngine, JSampling, JState, jdoctor), "torch": (TEngine, TSampling, TState, tdoctor)}


@pytest.fixture(scope="module")
def weights():
    jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(5))
    tcfg = ModelConfig.tiny().replace(dtype=torch.float32)
    return {"jax": (jcfg, jparams),
            "torch": (tcfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu"))}


def _engine(weights, pkg, **kw):
    cfg, params = weights[pkg]
    extra = {"device": "cpu"} if pkg == "torch" else {}
    return PKGS[pkg][0](cfg, params, **{**ENGINE_KW, **kw}, **extra)


def _drive(eng, reqs, max_steps=5000):
    for _ in range(max_steps):
        if not eng.has_work():
            break
        eng.step()
    assert all(r.generated for r in reqs)


def _script(eng, pkg) -> tuple[dict, list]:
    """The seeded script; returns the doctor's report while two restores
    are parked, and every request's tokens."""
    _, sampling, state, doctor_mod = PKGS[pkg]
    doc = doctor_mod.MeshDoctor(engine=eng, cfg=doctor_mod.DoctorConfig(**DOCTOR))
    rng = np.random.default_rng(11)
    rep = rng.integers(1, 512, 6).tolist() * 4  # n-gram and tree drafts
    out = [eng.generate([rep], sampling(max_new_tokens=16))[0],
           eng.generate([rep + rep[:8]], sampling(max_new_tokens=16))[0]]
    parked_prompts = [rng.integers(1, 512, 100).tolist() for _ in range(2)]
    out += eng.generate(parked_prompts, sampling(max_new_tokens=4))
    assert eng.tree.evict(100_000) > 0
    assert eng.kv_transfer.wait_host_ready()
    # The plane's worker takes the first restore and waits at the barrier
    # before staging it; the second stays queued behind it.
    barrier = threading.Event()
    eng.kv_transfer.stage_barrier = barrier
    reqs = [eng.add_request(p, sampling(max_new_tokens=4)) for p in parked_prompts]
    try:
        for _ in range(8):
            eng.step()
            if all(r.state is state.RESTORING for r in reqs):
                break
        assert [r.state for r in reqs] == [state.RESTORING] * 2
        deadline = time.monotonic() + 5
        while eng.kv_transfer.stats()["restores_queued"] != 1:
            assert time.monotonic() < deadline, eng.kv_transfer.stats()
            time.sleep(0.005)
        report = doc.diagnose()
    finally:
        barrier.set()
        eng.kv_transfer.stage_barrier = None
    _drive(eng, reqs)
    return report, out + [list(r.generated) for r in reqs]


def test_doctor_parity_over_both_engines(weights):
    reports, tokens, spec = {}, {}, {}
    for pkg in PKGS:
        eng = _engine(weights, pkg)
        try:
            reports[pkg], tokens[pkg] = _script(eng, pkg)
            spec[pkg] = eng.spec_report()
        finally:
            eng.kv_transfer.close()
    j, t = reports["jax"], reports["torch"]
    assert tokens["torch"] == tokens["jax"]
    assert spec["torch"] == spec["jax"] and sum(c["proposed"] for c in spec["jax"].values()) >= 4
    assert t["rules_checked"] == j["rules_checked"] == [
        "restore_park_stall", "spec_efficiency", "tier_thrash", "decode_stall", "spec_misconfigured"]
    assert t["inputs"] == j["inputs"] == {"mesh": False, "engine": True, "slo": False,
                                          "attribution": False, "history": False, "aggregator": False}
    for r in (j, t):
        assert not [f for f in r["findings"] if "crashed" in f["summary"]], r["findings"]
    fired = {k: {f["rule"]: f for f in r["findings"]} for k, r in reports.items()}
    assert sorted(fired["torch"]) == sorted(fired["jax"])
    assert {"restore_park_stall", "spec_efficiency"} <= set(fired["jax"])
    park = {k: fired[k]["restore_park_stall"]["evidence"] for k in fired}
    assert park["torch"] == park["jax"] and (park["jax"]["parked"], park["jax"]["restores_queued"]) == (2, 1)
    assert fired["torch"]["spec_efficiency"]["evidence"] == fired["jax"]["spec_efficiency"]["evidence"]
    if "spec_misconfigured" in fired["jax"]:
        assert fired["torch"]["spec_misconfigured"]["evidence"] == fired["jax"]["spec_misconfigured"]["evidence"]


def test_tier_thrash_reads_the_ports_disk_tier(weights, tmp_path):
    """Spills to each engine's disk tier and a restore from it: both tiers'
    ``recent_moves`` hold the same shards and directions, and the doctor's
    ``tier_thrash`` rule reads the port's ring without crashing."""
    moves = {}
    for pkg in PKGS:
        eng = _engine(weights, pkg, spec_decode_tokens=0, host_cache_slots=512, kv_tier_dir=str(tmp_path / pkg),
                      kv_tier_watermark=0.0, kv_tier_destage_budget=64, kv_tier_destage_interval_s=0.0,
                      kv_transfer_chunk_tokens=32)
        _, sampling, _, doctor_mod = PKGS[pkg]
        try:
            prompt = np.random.default_rng(3).integers(1, 512, 64).tolist()
            first = eng.generate([prompt], sampling(max_new_tokens=4))
            eng.tree.evict(1 << 20)
            eng.kv_transfer.wait_host_ready()
            eng.tree.destage_cold(force=True, budget=1 << 20)
            plane = eng.kv_transfer
            deadline = time.monotonic() + 15
            while not plane.spills_idle():
                assert time.monotonic() < deadline, "spills never settled"
                eng.step()
                plane.wait_progress(0.01)
            eng.tree._evict_host(1 << 20)  # disk-only residency: the repeat restores from disk
            again = eng.generate([prompt], sampling(max_new_tokens=4))
            assert again == first
            moves[pkg] = [(s, d) for _, s, d in eng._kv_tier.recent_moves]
            report = doctor_mod.MeshDoctor(engine=eng).diagnose()
            assert "tier_thrash" in report["rules_checked"]
            assert not [f for f in report["findings"] if "crashed" in f["summary"]], report["findings"]
        finally:
            eng.kv_transfer.close()
    assert moves["torch"] == moves["jax"] and any(d == "demote" for _, d in moves["jax"])


class TestClusterEndpoints:
    def test_serving_frontend_without_mesh(self, weights):
        from radixmesh_tpu_torch.server.http_frontend import ServingFrontend

        cfg, params = weights["torch"]
        eng = TEngine(cfg, params, device="cpu", num_slots=256, page_size=4, max_batch=2)
        fe = ServingFrontend(eng, port=0, history_interval_s=0)
        try:
            for path in ("/cluster/health", "/cluster/telemetry"):
                with urllib.request.urlopen(f"http://127.0.0.1:{fe.port}{path}", timeout=10) as r:
                    assert r.status == 200
                    out = json.loads(r.read())
                assert out["nodes"] == {} and "note" in out
        finally:
            fe.close(drain_s=0.0)

    def test_router_frontend_serves_fleet_view(self):
        from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
        from radixmesh_tpu_torch.comm.inproc import InprocHub
        from radixmesh_tpu_torch.config import MeshConfig, NodeRole
        from radixmesh_tpu_torch.obs.fleet_plane import FleetPlane
        from radixmesh_tpu_torch.router.cache_aware_router import CacheAwareRouter
        from radixmesh_tpu_torch.server.http_frontend import RouterFrontend

        InprocHub.reset_default()
        prefill, decode, router = ["p0"], ["d0"], ["r0"]
        nodes = []
        try:
            for addr in prefill + decode + router:
                cfg = MeshConfig(prefill_nodes=prefill, decode_nodes=decode, router_nodes=router,
                                 local_addr=addr, protocol="inproc", tick_interval_s=0.05,
                                 gc_interval_s=30.0)
                nodes.append(MeshCache(cfg, pool=None).start())
            for n in nodes:
                assert n.wait_ready(timeout=10)
            for p in [FleetPlane(n, interval_s=0.1) for n in nodes if n.role is not NodeRole.ROUTER]:
                p.publish_once()
            rnode = nodes[2]
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and len(rnode.fleet.digests()) != 2:
                time.sleep(0.01)
            car = CacheAwareRouter(rnode, rnode.cfg, health_aware=True)
            car.finish_warm_up()
            f = RouterFrontend(car, port=0)
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{f.port}/cluster/telemetry", timeout=10) as r:
                    tel = json.loads(r.read())
                assert set(tel["nodes"]) == {"0", "1"}
                assert tel["convergence"]["converged"] is True
                assert tel["nodes"]["0"]["role"] == "prefill"
                assert len(tel["nodes"]["0"]["fingerprint"]) == 16  # hex-encoded 64-bit
                assert tel["self"]["role"] == "router"
                with urllib.request.urlopen(f"http://127.0.0.1:{f.port}/cluster/health", timeout=10) as r:
                    health = json.loads(r.read())
                assert health["min_score"] == 1.0
                assert set(health["nodes"]) == {"0", "1"}
                assert health["nodes"]["0"]["score"] == 1.0
                assert health["convergence"]["max_convergence_age_s"] == 0.0
            finally:
                f.close()
        finally:
            for n in nodes:
                n.close()
            InprocHub.reset_default()
