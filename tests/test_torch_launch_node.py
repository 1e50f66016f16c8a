"""``python -m radixmesh_tpu_torch.launch node``: the JAX launcher's
``node`` subcommand in the port.

No ``node`` flag is refused since fleet diagnosis was ported:
``--agg-interval`` and the config key ``agg_interval_s`` give a router a
fleet aggregator whose peers carry the topology's names, addresses and
ranks, a serving node with the key starts and answers ``/cluster/doctor``,
a cache node without a model writes a black box with a ``doctor``
section, and a router answers ``/cluster/{health,doctor,timeseries,slo}``
with the JAX package's keys. Two node
processes, a prefill and a decode node of the tiny model on the CPU over
the native transport, from JSON configs with a ``model:`` section and
``--fleet-digest-interval 0.5``, run ``chip_smoke.py``'s launcher leg:
``POST /generate`` to the prefill node, then the decode node counts the
replicated oplogs and its fleet view holds the prefill node's digest with
the prefill node's own fingerprint. Four node processes (two routers, a
prefill and a decode node of the tiny model) run ``chip_smoke.py``'s fleet
leg: route and route back over ``POST /route``, a router's and a serving
node's ``kill -9`` with the requests resumed on the survivor, a warm
rejoin and a graceful drain, and the router r1's fleet diagnosis over
them: the fleet store and fleet SLO, ``telemetry_gap`` naming the killed
p0 and clearing after its rejoin, d0's engine rules, and the post-mortem
of r1's black box."""

import json
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

import chip_smoke
from radixmesh_tpu_torch.launch import _NOT_PORTED_NODE, main, parse_args


def test_only_fleet_aggregation_is_left_unported():
    """Fleet aggregation was the last piece: nothing is left."""
    assert _NOT_PORTED_NODE == {}


class _Reached(Exception):
    pass


class _FakeMesh:
    """A router's mesh replica that is ready at once (no ring to join)."""

    def __init__(self, cfg, pool=None):
        self.cfg, self.rank = cfg, cfg.local_identity()[1]
        self.view = type("View", (), {"epoch": 1})()

    def start(self):
        return self

    def wait_ready(self, timeout=None):
        return True


class _FakeRouter:
    def __init__(self, mesh, cfg, **kw):
        self.mesh_cache = mesh

    def watch_topology(self):
        pass

    def finish_warm_up(self):
        pass


def _router_node(monkeypatch, tmp_path, extra: dict, flags: list, frontend):
    """``main(["node", ...])`` for a router of a tcp topology of three
    ring nodes, its mesh and router faked, ``frontend`` standing in for
    ``RouterFrontend``."""
    import radixmesh_tpu_torch.cache.mesh_cache as mc
    import radixmesh_tpu_torch.router.cache_aware_router as car
    import radixmesh_tpu_torch.server.http_frontend as hf

    monkeypatch.setattr(mc, "MeshCache", _FakeMesh)
    monkeypatch.setattr(car, "CacheAwareRouter", _FakeRouter)
    monkeypatch.setattr(hf, "RouterFrontend", frontend)
    path = tmp_path / "router.json"
    path.write_text(json.dumps({
        "prefill_nodes": ["127.0.0.1:51710", "127.0.0.1:51711"], "decode_nodes": ["127.0.0.1:51713"],
        "router_nodes": ["127.0.0.1:51712"], "local_addr": "127.0.0.1:51712", "protocol": "tcp",
        **extra}))
    with pytest.raises(_Reached):
        main(["node", "--config-file", str(path), "--http-port", "0", "--telemetry-history-interval", "0",
              *flags])


@pytest.mark.parametrize("flag", ["--agg-interval"])
def test_unported_node_flags_are_refused_by_name(flag, monkeypatch, tmp_path):
    """``--agg-interval 0.5`` parses and reaches ``RouterFrontend``'s
    ``aggregator_interval_s``, over the config's ``agg_interval_s``."""
    assert parse_args(["node", "--config-file", "x.json", flag, "0.5"]).agg_interval == 0.5
    assert parse_args(["node", "--config-file", "x.json"]).agg_interval is None
    seen = {}

    def frontend(router, **kw):
        seen.update(kw)
        raise _Reached

    _router_node(monkeypatch, tmp_path, {"agg_interval_s": 3.0}, [flag, "0.5"], frontend)
    assert seen["aggregator_interval_s"] == 0.5 and len(seen["aggregator_peers"]) == 3


def test_node_parses_the_ported_flags():
    args = parse_args([
        "node", "--config-file", "n.json", "--ready-timeout", "9", "--tokenizer", "byte",
        "--fleet-digest-interval", "0.5", "--replication-factor", "2", "--router-nodes", "a:1,b:2",
        "--rebalance-interval", "1", "--chaos-plan", "plan.json", "--kv-transfer-async",
        "--trace-sample", "0.5", "--telemetry-history-interval", "0", "--device", "cpu",
    ])
    assert (args.cmd, args.config_file, args.ready_timeout, args.tokenizer, args.fleet_digest_interval,
            args.replication_factor, args.router_nodes, args.rebalance_interval, args.chaos_plan,
            args.kv_transfer_async, args.trace_sample, args.telemetry_history_interval, args.device) == (
        "node", "n.json", 9.0, "byte", 0.5, 2, "a:1,b:2", 1.0, "plan.json", True, 0.5, 0.0, "cpu")
    # ``serve`` keeps its flags and refuses none of the node-only ones'
    # features by the node table.
    assert parse_args(["serve", "--device", "cpu", "--kv-transfer-async"]).kv_transfer_async


@pytest.mark.parametrize("flags,want", [
    (["--warm-up"], {"warm_up": True}),
    (["--health-aware-routing"], {"health_aware_routing": True}),
    (["--kv-prefetch-hints"], {"kv_prefetch_hints": True}),
    (["--repair-interval", "1.5"], {"repair_interval": 1.5}),
    (["--drain-timeout", "12"], {"drain_timeout": 12.0}),
])
def test_router_repair_and_drain_flags_parse(flags, want):
    args = parse_args(["node", "--config-file", "n.json", *flags])
    assert {k: getattr(args, k) for k in want} == want
    defaults = parse_args(["node", "--config-file", "n.json"])
    assert (defaults.drain_timeout, defaults.repair_interval, defaults.warm_up) == (30.0, None, False)


@pytest.mark.parametrize("flag", ["--slo", "--slo-ttft-ms", "--slo-tenant"])
def test_node_has_no_slo_flags(flag):
    """As in the JAX launcher, the overload control plane is ``serve``'s:
    a serving node runs the plain runner."""
    with pytest.raises(SystemExit) as e:
        parse_args(["node", "--config-file", "n.json", flag, "1"])
    assert e.value.code == 2


def _router_aggregation(monkeypatch, tmp_path):
    """A router's ``agg_interval_s`` gives an aggregator whose peers carry
    the topology's names, serving addresses and ranks."""
    from radixmesh_tpu_torch.server.http_frontend import RouterFrontend

    built = []

    class Frontend(RouterFrontend):
        def __init__(self, router, **kw):
            super().__init__(router, **kw)
            built.append(self)
            raise _Reached

    try:
        _router_node(monkeypatch, tmp_path, {"agg_interval_s": 1.0}, [], Frontend)
        (fe,) = built
        assert fe.aggregator is not None and fe.aggregator.interval_s == 1.0
        assert [(p.name, p.base_url, p.rank) for p in fe.aggregator.peers()] == [
            ("prefill0", "http://127.0.0.1:52710", 0), ("prefill1", "http://127.0.0.1:52711", 1),
            ("decode2", "http://127.0.0.1:52713", 2)]
        assert fe.doctor.aggregator is fe.aggregator
        base = f"http://127.0.0.1:{fe.port}"
        with urllib.request.urlopen(base + "/cluster/timeseries?limit=10", timeout=10) as r:
            body = json.loads(r.read())
        assert body["aggregator"]["peers"] == 3 and "series" in body
        with urllib.request.urlopen(base + "/cluster/slo", timeout=10) as r:
            assert set(json.loads(r.read())["peers"]) == {"prefill0", "prefill1", "decode2"}
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/cluster/timeseries?since=junk", timeout=10)
        assert e.value.code == 400
    finally:
        for fe in built:
            fe.close()


def _two_nodes(tmp_path, model: dict | None, flags: tuple[list, list]):
    """A prefill node (with ``model`` as its ``model:`` section, if any) and
    a cache-only decode node over ``tcp-py``, as ``launch.py node``
    processes, each with its own ``flags``; returns the processes, their
    logs and the prefill node's serving port once both are armed."""
    base = chip_smoke._port_block(2)
    addrs = [f"127.0.0.1:{base}", f"127.0.0.1:{base + 1}"]
    procs, logs = [], []
    for i, name in enumerate(("p0", "d1")):
        cfg = {"prefill_nodes": addrs[:1], "decode_nodes": addrs[1:], "router_nodes": [],
               "local_addr": addrs[i], "protocol": "tcp-py", "tick_interval_s": 0.2, "agg_interval_s": 1.0,
               "num_kv_slots": 256, "page_size": 4}
        if i == 0 and model:
            cfg["model"] = model
        (tmp_path / f"{name}.json").write_text(json.dumps(cfg))
        logs.append(tmp_path / f"{name}.log")
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "radixmesh_tpu_torch.launch", "node", "--config-file",
                 str(tmp_path / f"{name}.json"), "--device", "cpu", "--drain-timeout", "5", *flags[i]],
                cwd=chip_smoke.ROOT, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + 180
    # The signal handlers are installed just after this line.
    while not all("lifecycle plane armed" in log.read_text() for log in logs):
        assert all(p.poll() is None for p in procs) and time.monotonic() < deadline, \
            "\n".join(log.read_text() for log in logs)
        time.sleep(0.2)
    time.sleep(0.5)
    return procs, logs, base + 1000


def _stop(procs, logs) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    try:
        rcs = [p.wait(timeout=60) for p in procs]
        assert rcs == [0, 0], "\n".join(log.read_text() for log in logs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _serving_aggregation(monkeypatch, tmp_path):
    """A serving node with ``agg_interval_s`` in its config starts (the key
    is a router's; the JAX node ignores it on a serving node too) and
    answers ``/cluster/doctor`` over its engine and mesh."""
    procs, logs, port = _two_nodes(
        tmp_path, {"preset": "llama3-tiny", "kv_slots": 256, "page_size": 4, "max_batch": 2}, ([], []))
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/cluster/doctor", timeout=30) as r:
            report = json.loads(r.read())
    finally:
        _stop(procs, logs)
    assert report["inputs"]["engine"] and report["inputs"]["mesh"] and report["inputs"]["history"]
    assert "decode_stall" in report["rules_checked"] and "replication_lag" in report["rules_checked"]
    assert not [f for f in report["findings"] if "crashed" in f["summary"]]


def _modelless_blackbox(monkeypatch, tmp_path):
    """A cache node without a model and ``--blackbox-dir`` samples a history
    of its mesh and, on SIGTERM, writes a final dump with a ``doctor``
    section (a mesh-only doctor)."""
    from radixmesh_tpu_torch.obs.blackbox import load_blackbox

    bb = tmp_path / "bb"
    procs, logs, _ = _two_nodes(tmp_path, None, (
        [], ["--blackbox-dir", str(bb), "--telemetry-history-interval", "0.1"]))
    try:
        deadline = time.monotonic() + 60
        while not list(bb.glob("*/segment-*.json")):
            assert time.monotonic() < deadline, logs[1].read_text()
            time.sleep(0.1)
    finally:
        _stop(procs, logs)
    (node_dir,) = bb.iterdir()
    finals = sorted(node_dir.glob("final-*.json"))
    assert finals, sorted(p.name for p in node_dir.iterdir())
    final = json.loads(finals[-1].read_text())
    assert final["node"] == "decode@1" and final["doctor"]["inputs"]["mesh"]
    assert not final["doctor"]["inputs"]["engine"] and "replication_lag" in final["doctor"]["rules_checked"]
    dump = load_blackbox(str(node_dir))
    assert not dump["unclean"] and dump["series"]


_FEATURES = {"aggregation": _serving_aggregation, "router aggregation": _router_aggregation,
             "model-less black box": _modelless_blackbox}


@pytest.mark.parametrize("case", list(_FEATURES))
def test_unported_roles_and_keys_are_refused_by_name(case, monkeypatch, tmp_path):
    """Each role and key that was refused until fleet diagnosis was ported
    now runs its feature."""
    _FEATURES[case](monkeypatch, tmp_path)


def test_router_frontend_refuses_the_fleet_endpoints_by_name():
    """A router answers ``POST /route`` with the JAX reply keys and
    ``/cluster/{health,doctor,timeseries,slo}`` with the JAX bodies: health
    over the gossiped digests, the doctor's report over the router's
    seams, and a 404 pointer from the two aggregator pages where no
    aggregator is hosted."""
    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
    from radixmesh_tpu_torch.comm.inproc import InprocHub
    from radixmesh_tpu_torch.config import MeshConfig
    from radixmesh_tpu_torch.router.cache_aware_router import CacheAwareRouter
    from radixmesh_tpu_torch.server.http_frontend import RouterFrontend

    InprocHub.reset_default()
    meshes = [MeshCache(MeshConfig(prefill_nodes=["p0"], decode_nodes=["d0"], router_nodes=["r0"],
                                   local_addr=a, protocol="inproc", tick_interval_s=0.05),
                        pool=None).start() for a in ("p0", "d0", "r0")]
    mesh, cfg = meshes[2], meshes[2].cfg
    fe = None
    try:
        assert all(m.wait_ready(timeout=30) for m in meshes)
        router = CacheAwareRouter(mesh, cfg)
        router.finish_warm_up()
        fe = RouterFrontend(router, port=0, history_interval_s=0)
        base = f"http://127.0.0.1:{fe.port}"
        with urllib.request.urlopen(base + "/cluster/health", timeout=10) as r:
            health = json.loads(r.read())
        assert set(health) == {"nodes", "min_score", "convergence", "autoscale", "self"}
        assert health["self"]["role"] == "router" and "action" in health["autoscale"]
        with urllib.request.urlopen(base + "/cluster/doctor", timeout=10) as r:
            report = json.loads(r.read())
        assert {"healthy", "findings", "rules_checked", "inputs"} <= set(report)
        assert report["inputs"]["mesh"] and not report["inputs"]["engine"]
        assert report["inputs"]["aggregator"] is False
        for path in ("/cluster/timeseries", "/cluster/slo"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + path, timeout=10)
            body = json.loads(e.value.read())
            assert e.value.code == 404 and "no fleet aggregator hosted here" in body["error"]
        req = urllib.request.Request(base + "/route", data=json.dumps({"input_ids": [1, 2, 3]}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            reply = json.loads(r.read())
        assert set(reply) == {"prefill_addr", "decode_addr", "prefill_serve_addr", "decode_serve_addr",
                              "prefill_cache_hit", "decode_cache_hit", "match_len"}
        with urllib.request.urlopen(base + "/debug/state", timeout=10) as r:
            assert json.loads(r.read())["router"]["warm_up"] is False
    finally:
        if fe is not None:
            fe.close()
        for m in meshes:
            m.close()


def test_two_node_processes_replicate_and_gossip_digests(tmp_path):
    out = chip_smoke.mesh_node_leg("llama3-tiny", 1024, device="cpu", out_dir=tmp_path)
    assert len(out["output_ids"]) == 8
    before, after = out["oplogs_received"]
    assert after > before
    pre, seen = out["prefill_digest"], out["decode_view_of_prefill"]
    assert pre["tree_tokens"] > 0 and seen["fingerprint"] == pre["fingerprint"]
    assert seen["role"] == "prefill" and seen["lifecycle"] == "active"


def test_fleet_routes_fails_over_resumes_rejoins_and_drains(tmp_path):
    out = chip_smoke.fleet_leg(device="cpu", out_dir=tmp_path, sizes=dict(
        model="llama3-tiny", slots=4096, prompt_len=96, extra=16, new_tokens=4, resume_len=48,
        resume_tokens=200, drain_len=48, drain_tokens=200, wall_tokens=24))
    a, b, c, d, e = out["a"], out["b"], out["c"], out["d"], out["e"]
    assert a["cached_tokens"] == [96] * 8 and min(a["match_len"]) >= 96
    assert b["frontdoor"]["failovers"] >= 1 and b["routes"] == 8
    # Each request resumed once on d0 from its own k, nothing re-emitted.
    assert all(k >= 8 for k in c["k"]) and c["resurrections"] == [1] * 4
    assert all(n > 0 for n in c["reference_cached_tokens"])
    assert d["states"][-1] == "active" and d["rounds"] >= 1
    assert d["withheld_hits"][1] > d["withheld_hits"][0]
    assert d["route_after_join"]["prefill_cache_hit"]
    assert e["arrivals"] == [503] * 4 and e["decode_addr_after_left"] is None
    assert e["retry_after"] == [None] * 4
    assert e["drain"]["completed_in_flight"] and e["exit_s"] < 30
    f = out["f"]
    assert f["series_per_node"]["prefill0"] > 0 and f["series_per_node"]["decode1"] > 0
    assert f["fleet_ttft_a"]["n"] == 16 and f["slo_ttft"]["count"] == 20
    assert f["gap"]["evidence"]["peer"] == "prefill0" and f["gap"]["evidence"]["rank"] == "0"
    assert f["gap"]["evidence"]["verdict"] == "node_dead" and f["gap"]["cleared_after_active_s"] < 5
    assert set(chip_smoke.ENGINE_RULES) <= set(f["d0_rules_checked"])
    assert f["postmortem"]["rc"] in (0, 1) and f["postmortem"]["samples"] > 0
