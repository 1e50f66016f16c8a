"""``python -m radixmesh_tpu_torch.launch node``: the JAX launcher's
``node`` subcommand in the port.

The one ``node`` flag whose feature is not ported yet (``--agg-interval``)
is refused by name with its ROADMAP.md queue item, and so are the config
key ``agg_interval_s``, ``--blackbox-dir`` on a node without a model, and
the router's ``/cluster/{health,doctor,timeseries,slo}``. Two node
processes, a prefill and a decode node of the tiny model on the CPU over
the native transport, from JSON configs with a ``model:`` section and
``--fleet-digest-interval 0.5``, run ``chip_smoke.py``'s launcher leg:
``POST /generate`` to the prefill node, then the decode node counts the
replicated oplogs and its fleet view holds the prefill node's digest with
the prefill node's own fingerprint. Four node processes (two routers, a
prefill and a decode node of the tiny model) run ``chip_smoke.py``'s fleet
leg: route and route back over ``POST /route``, a router's and a serving
node's ``kill -9`` with the requests resumed on the survivor, a warm
rejoin and a graceful drain."""

import json
import urllib.error
import urllib.request

import pytest

import chip_smoke
from radixmesh_tpu_torch.launch import _NOT_PORTED_NODE, main, parse_args


def test_only_fleet_aggregation_is_left_unported():
    assert _NOT_PORTED_NODE == {"--agg-interval": "A4, fleet aggregation"}


@pytest.mark.parametrize("flag", sorted(_NOT_PORTED_NODE))
def test_unported_node_flags_are_refused_by_name(flag, capsys):
    assert flag == "--agg-interval"
    with pytest.raises(SystemExit) as e:
        parse_args(["node", "--config-file", "x.json", flag, "1"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and f"queue {_NOT_PORTED_NODE[flag]}" in err


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


_BASE = {"prefill_nodes": ["127.0.0.1:51710"], "decode_nodes": ["127.0.0.1:51711"],
         "router_nodes": ["127.0.0.1:51712"], "protocol": "tcp"}


@pytest.mark.parametrize("case,extra,flags,match", [
    ("aggregation", {"local_addr": "127.0.0.1:51710", "agg_interval_s": 1.0}, [],
     "agg_interval_s.*queue A4"),
    ("router aggregation", {"local_addr": "127.0.0.1:51712", "agg_interval_s": 1.0}, [],
     "agg_interval_s.*queue A4"),
    ("model-less black box", {"local_addr": "127.0.0.1:51712"}, ["--blackbox-dir", "bb"],
     "--blackbox-dir.*queue A4"),
])
def test_unported_roles_and_keys_are_refused_by_name(case, extra, flags, match, tmp_path):
    path = tmp_path / "node.json"
    path.write_text(json.dumps({**_BASE, **extra}))
    with pytest.raises(SystemExit, match=match):
        main(["node", "--config-file", str(path), "--device", "cpu", *flags])


def test_router_frontend_refuses_the_fleet_endpoints_by_name():
    """A router answers ``POST /route`` with the JAX reply keys and names
    queue A4 for the fleet endpoints, never a bare 404."""
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
        for path in ("/cluster/health", "/cluster/doctor", "/cluster/timeseries", "/cluster/slo"):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + path, timeout=10)
            body = json.loads(e.value.read())
            assert e.value.code == 501 and path in body["error"] and "queue A4" in body["error"]
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
