"""``scripts/meshtop.py`` (which imports neither package: it reads a router's
``/cluster/slo`` and ``/cluster/timeseries``) against the port: a port
``RouterFrontend`` hosting a ``FleetAggregator`` over two tiny float32
``ServingFrontend``s on the CPU, each having served requests. One shot
renders the aggregator line, the peer table and the tenant SLO table and
exits 0; a router hosting no aggregator answers 404 there, and meshtop
exits 2."""

import json
import pathlib
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

from radixmesh_tpu_torch.comm.inproc import InprocHub
from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.models.llama import ModelConfig, init_params
from radixmesh_tpu_torch.server.http_frontend import RouterFrontend, ServingFrontend

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _meshtop(url: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, str(ROOT / "scripts" / "meshtop.py"), "--url", url],
                          capture_output=True, text=True, timeout=60)


def _post(port: int, prompt: list[int]) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps({"input_ids": prompt, "max_tokens": 4}).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_meshtop_renders_a_port_router_and_refuses_one_without_an_aggregator():
    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
    from radixmesh_tpu_torch.config import MeshConfig
    from radixmesh_tpu_torch.router.cache_aware_router import CacheAwareRouter

    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    serving, meshes, routers = [], [], []
    InprocHub.reset_default()
    try:
        for name in ("prefill0", "decode1"):
            eng = Engine(cfg, params, device="cpu", num_slots=512, page_size=4, max_batch=2, name=name)
            serving.append(ServingFrontend(eng, port=0, history_interval_s=0.1))
        for fe in serving:
            for _ in range(3):
                _post(fe.port, rng.integers(1, cfg.vocab_size, size=24).tolist())
        meshes = [MeshCache(MeshConfig(prefill_nodes=["p0"], decode_nodes=["d0"], router_nodes=["r0"],
                                       local_addr=a, protocol="inproc", tick_interval_s=0.05),
                            pool=None).start() for a in ("p0", "d0", "r0")]
        assert all(m.wait_ready(timeout=30) for m in meshes)
        car = CacheAwareRouter(meshes[2], meshes[2].cfg)
        car.finish_warm_up()
        peers = [(fe.runner.engine.name, f"http://127.0.0.1:{fe.port}", rank) for rank, fe in enumerate(serving)]
        routers.append(RouterFrontend(car, port=0, history_interval_s=0, aggregator_peers=peers,
                                      aggregator_interval_s=0.2))
        routers.append(RouterFrontend(car, port=0, history_interval_s=0))
        base = f"http://127.0.0.1:{routers[0].port}"
        deadline = time.monotonic() + 30
        while True:
            with urllib.request.urlopen(base + "/cluster/slo", timeout=10) as r:
                slo = json.loads(r.read())
            if slo.get("tenants") or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        assert slo.get("tenants"), slo
        shot = _meshtop(base)
        assert shot.returncode == 0, shot.stdout + shot.stderr
        assert "PEER" in shot.stdout and "TENANT" in shot.stdout, shot.stdout
        assert "prefill0" in shot.stdout and "decode1" in shot.stdout, shot.stdout
        bare = _meshtop(f"http://127.0.0.1:{routers[1].port}")
        assert bare.returncode == 2, bare.stdout + bare.stderr
    finally:
        for f in routers + serving:
            f.close()
        for m in meshes:
            m.close()
        InprocHub.reset_default()
