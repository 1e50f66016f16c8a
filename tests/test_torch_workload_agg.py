"""The port's control-room scenario (``workload.run_agg_workload``) against the
JAX package's, on the CPU at the same seed and the scenario's defaults, the
port's engine on the JAX scenario's toy model: over the router-hosted
aggregator's merged store the fleet doctor names the seeded straggler by
rank, the merged p99 bucket's exemplar joins by trace id a stitched trace
holding the straggler's span, a killed node surfaces as a ``telemetry_gap``
with a dead-vs-sampler verdict, and the simulated fan-in sweep reads every
peer. Every port report carries the fields of the JAX package's artifact
schema (``bench.AGG_*_FIELDS``). The JAX report is computed once per module.
Not asserted: ``within_one_bucket`` (the TTFTs are wall-clock readings), the
overhead budget and ``within_cadence``."""

import pytest
import torch
from _torch_cli import hold_report, run_cli
from _torch_twin import fresh_jax_globals, fresh_port_globals, missing_artifact_fields

from radixmesh_tpu_torch import workload as pw

torch.set_num_threads(1)  # the suite runs in parallel worker processes


@pytest.fixture(scope="module")
def agg():
    from radixmesh_tpu import workload as jw

    with fresh_jax_globals():
        ref = jw.run_agg_workload(seed=0)
    with fresh_port_globals():
        return {"jax": ref, "port": pw.run_agg_workload(seed=0, device="cpu")}


def test_agg_merges_every_node_and_request(agg):
    port, ref = agg["port"], agg["jax"]
    for key in ("nodes", "replication_factor"):
        assert port[key] == ref[key], key
    pc, rpc = port["percentiles"], ref["percentiles"]
    for key in ("performed", "tenant", "count", "nodes", "raw_requests"):
        assert pc[key] == rpc[key], key
    assert pc["fleet_p99_s"] is not None and pc["truth_p99_s"] > 0.0


def test_agg_names_the_straggler_by_rank(agg):
    st, rst = agg["port"]["straggler"], agg["jax"]["straggler"]
    assert st == rst
    assert st["detected"] is True and str(st["named_rank"]) == str(st["seeded_rank"])


def test_agg_p99_exemplar_stitches_to_the_straggler(agg):
    ex, rex = agg["port"]["exemplar"], agg["jax"]["exemplar"]
    assert ex["node"] == rex["node"]
    assert ex["trace_id"] and ex["stitched"] is True and ex["has_straggler_span"] is True


def test_agg_killed_node_surfaces_as_a_gap(agg):
    gap, rgap = agg["port"]["gap"], agg["jax"]["gap"]
    for key in ("performed", "killed_peer", "detected", "verdict"):
        assert gap[key] == rgap[key], key
    assert gap["detected"] is True and gap["verdict"] in ("node_dead", "sampler_dead")


def test_agg_fan_in_sweep_reads_every_peer(agg):
    fan, rfan = agg["port"]["fan_in"], agg["jax"]["fan_in"]
    for key in ("performed", "peers", "points", "errors"):
        assert fan[key] == rfan[key], key
    assert fan["errors"] == 0 and fan["peers"] == 200


def test_agg_report_has_the_artifact_fields(agg):
    sections = {"percentiles": "PERCENTILE", "straggler": "STRAGGLER", "exemplar": "EXEMPLAR", "gap": "GAP",
                "overhead": "OVERHEAD", "fan_in": "FANIN"}
    assert not missing_artifact_fields(agg["port"], "AGG", sections, agg["jax"])


def test_aggbench_builds_and_validates_the_agg_report(agg, monkeypatch, tmp_path, capsys):
    """``radixmesh_tpu_torch.scripts.aggbench`` over the fixture's run: both
    validators read the AGG report alike (its pull-overhead budget is the
    run's own wall-clock verdict)."""
    from radixmesh_tpu_torch.scripts import aggbench

    rc, report, kw = run_cli(monkeypatch, tmp_path, capsys, aggbench, "run_agg_workload", agg["port"],
                             ["--device", "cpu", "--model", "toy"])
    assert kw == dict(seed=0, replication_factor=3, history_interval_s=0.2, agg_interval_s=0.25, sim_peers=200,
                      cfg=None, device="cpu")
    assert report["metric"] == "agg_fleet_verdicts_named"
    hold_report("agg", rc, report)
