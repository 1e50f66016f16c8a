"""A mixed fleet: each package's ``FleetAggregator`` pulls one JAX and one
port ``ServingFrontend`` over ``HttpPeer`` (tiny float32 engines on the CPU,
the same weights and the same 4 requests each): both fleet stores hold the
same series, each node's TTFT buckets under the same names, and both
aggregators' ``fleet_slo()`` merge the same bucket counts. Then the doctor's
command lines across packages: the untouched ``scripts/doctor.py --url``
against the port's frontend, ``python -m radixmesh_tpu_torch.doctor --url``
against the JAX one, and the port's post-mortem reader over a flushed dump,
a hard kill's segments and a missing directory (exit codes 0 or 1, 1 with
``node_crash``, 2), and the port's ``--workload`` artifact, read by both
packages' validators."""

import json
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.engine.engine import Engine as JEngine
from radixmesh_tpu.models import llama as jl
from radixmesh_tpu.obs import aggregator as jagg
from radixmesh_tpu.obs import metrics as jmetrics
from radixmesh_tpu.server.http_frontend import ServingFrontend as JFrontend
from radixmesh_tpu_torch import doctor as cli
from radixmesh_tpu_torch.engine.engine import Engine as TEngine
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import ModelConfig
from radixmesh_tpu_torch.obs import aggregator as tagg
from radixmesh_tpu_torch.obs import metrics as tmetrics
from radixmesh_tpu_torch.server.http_frontend import ServingFrontend as TFrontend

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
ENGINE_KW = dict(num_slots=512, page_size=4, max_batch=4, max_seq_len=128)
INTERVAL = 0.1


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """A JAX and a port serving frontend on the same weights, each having
    served the same 4 requests; the port's with a black box. Each package's
    registry is a fresh one for the module: an earlier test file in the same
    worker process leaves its engines' series (TTFT observations among them)
    in the process-wide registry, which the frontends' histories would sample
    and the fleet's merged TTFT count would include."""
    old_regs = (jmetrics.set_registry(jmetrics.Registry()), tmetrics.set_registry(tmetrics.Registry()))
    try:
        yield from _fleet(tmp_path_factory)
    finally:
        jmetrics.set_registry(old_regs[0])
        tmetrics.set_registry(old_regs[1])


def _fleet(tmp_path_factory):
    jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(9))
    tcfg = ModelConfig.tiny().replace(dtype=torch.float32)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    bb = tmp_path_factory.mktemp("bb")
    fes = {"jax": JFrontend(JEngine(jcfg, jparams, name="jax0", **ENGINE_KW), port=0,
                            history_interval_s=INTERVAL),
           "torch": TFrontend(TEngine(tcfg, tparams, device="cpu", name="torch0", **ENGINE_KW), port=0,
                              history_interval_s=INTERVAL, blackbox_dir=str(bb))}
    try:
        rng = np.random.default_rng(4)
        prompts = [rng.integers(1, 512, n).tolist() for n in (9, 17, 24, 33)]
        outs = {k: [_post(fe.port, {"input_ids": p, "max_tokens": 6})["output_ids"] for p in prompts]
                for k, fe in fes.items()}
        assert outs["torch"] == outs["jax"]
        # Two samples past the finished requests, then the samplers stop:
        # every pull below reads the same frozen rings.
        for fe in fes.values():
            seq0, deadline = fe.history.query(limit=1)["seq"], time.monotonic() + 60
            while fe.history.query(limit=1)["seq"] < seq0 + 2:
                assert time.monotonic() < deadline
                time.sleep(INTERVAL)
            fe.history.close()
        yield fes, bb
    finally:
        for fe in fes.values():
            fe.close(drain_s=0.0)


def _bucket_counts(agg) -> dict:
    q = agg.store.query(family="radixmesh_request_ttft_seconds_bucket", limit=100000)
    return {name: s["last"][1] for name, s in q["series"].items()}


def test_each_packages_aggregator_reads_both_packages_frontends(fleet):
    fes, _ = fleet
    urls = {k: f"http://127.0.0.1:{fe.port}" for k, fe in fes.items()}
    # Each aggregator counts itself on a registry of its own: on the
    # frontends' registries its series would land in the rings it pulls.
    aggs = {name: mod.FleetAggregator(peers=[mod.HttpPeer(k, u) for k, u in sorted(urls.items())],
                                      interval_s=INTERVAL, node=f"fleet-{name}", registry=reg.Registry())
            for name, mod, reg in (("jax", jagg, jmetrics), ("torch", tagg, tmetrics))}
    for _ in range(2):
        for agg in aggs.values():
            sweep = agg.pull_once()
            assert sweep["errors"] == 0 and sweep["peers"] == 2
    names = {k: set(a.store.query(limit=100000)["series"]) for k, a in aggs.items()}
    assert names["torch"] == names["jax"]
    counts = {k: _bucket_counts(a) for k, a in aggs.items()}
    assert counts["torch"] == counts["jax"]
    # Each node's TTFT buckets under the same names: the wire and the
    # metric families agree across packages.
    by_node = {n: {k.replace(f'node="{n}"', "") for k in counts["jax"] if f'node="{n}"' in k}
               for n in ("jax", "torch")}
    assert by_node["jax"] == by_node["torch"] and by_node["jax"]
    slo = {k: a.fleet_slo()["tenants"] for k, a in aggs.items()}
    assert slo["torch"] == slo["jax"]
    ttft = slo["jax"]["default"]["ttft"]
    assert ttft["count"] == 8 and ttft["nodes"] == ["jax", "torch"]
    assert ttft["p50"] <= ttft["p99"]


def test_the_jax_doctor_script_reads_the_ports_frontend(fleet):
    fes, _ = fleet
    r = subprocess.run([sys.executable, "scripts/doctor.py", "--url", f"http://127.0.0.1:{fes['torch'].port}"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode in (0, 1), r.stdout + r.stderr
    assert "HEALTHY" in r.stdout or "finding(s)" in r.stdout


def test_the_ports_doctor_reads_the_jax_frontend(fleet, capsys):
    fes, _ = fleet
    rc = cli.main(["--url", f"http://127.0.0.1:{fes['jax'].port}"])
    assert rc in (0, 1)
    out = capsys.readouterr().out
    assert "HEALTHY" in out or "finding(s)" in out


def test_the_ports_postmortem_reader_over_a_flushed_dump(fleet):
    fes, bb = fleet
    with urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{fes['torch'].port}/admin/blackbox", data=b"{}"), timeout=30) as r:
        assert json.loads(r.read())["flushed"]
    r = subprocess.run([sys.executable, "-m", "radixmesh_tpu_torch.doctor", "--blackbox", str(bb / "torch0"),
                        "--json"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode in (0, 1), r.stdout + r.stderr
    report = json.loads(r.stdout)
    assert report["rules_checked"][0] == "node_crash" and report["samples"] > 0
    assert not [f for f in report["findings"] if f["rule"] == "node_crash"]


def test_the_ports_postmortem_reader_names_a_hard_kill(tmp_path, capsys):
    """A dump of committed segments alone (a kill -9) is unclean: exit 1,
    with a ``node_crash`` finding; a missing directory is exit 2."""
    from radixmesh_tpu_torch.obs.blackbox import BlackBox
    from radixmesh_tpu_torch.obs.metrics import Registry, get_registry, set_registry
    from radixmesh_tpu_torch.obs.timeseries import TelemetryHistory

    old = set_registry(Registry())
    try:
        c = get_registry().counter("radixmesh_test_total", "t")
        h = TelemetryHistory(interval_s=1.0, capacity=64)
        bb = BlackBox(str(tmp_path), history=h, node="n0", segment_every=2)
        for t in range(6):
            c.inc()
            h.sample(t=float(t))
        bb.close()  # no flush: the kill -9 simulation
    finally:
        set_registry(old)
    assert cli.main(["--blackbox", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "UNCLEAN" in out and "[node_crash]" in out
    assert cli.main(["--blackbox", str(tmp_path / "absent")]) == 2
    assert "cannot load black box" in capsys.readouterr().err


def test_the_ports_doctor_workload_writes_the_doctor_artifact(tmp_path, capsys):
    """``python -m radixmesh_tpu_torch.doctor --workload --device cpu --model
    toy --out FILE``: the seeded acceptance scenario on the toy model names
    all three pathologies, and the DOCTOR report it writes passes the port's
    validator and the JAX package's and carries a proven benchdiff
    self-check. An ``--out`` naming a JAX artifact is refused (exit 2)
    before anything runs."""
    import bench

    from radixmesh_tpu_torch import reports

    assert cli.main(["--workload", "--out", str(tmp_path / "DOCTOR_r12.json")]) == 2
    assert "JAX package's DOCTOR artifact" in capsys.readouterr().err
    out = tmp_path / "DOCTOR_torch_r22.json"
    assert cli.main(["--workload", "--device", "cpu", "--model", "toy", "--out", str(out)]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    report = json.loads(out.read_text())
    assert line["artifact"] == out.name and line["value"] == report["value"] == 3
    assert reports.validate_doctor(report) == [] == bench.validate_doctor(report)
    assert "schema_violation" not in report
    bd = report["benchdiff"]
    assert bd["identical_clean"] and bd["regression_flagged"] and bd["mismatch_detected"]
