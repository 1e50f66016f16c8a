"""The port's fleet-churn and chaos scenarios (``workload.run_fleet_churn_workload``,
``workload.run_chaos_workload``) against the JAX package's, on the CPU at the
same seed: the chaos run at the reduced arguments of
``tests/test_repair_plane.py``'s acceptance test, the churn run at its
defaults. Both are host code over the in-process mesh and touch no tensor.
The verdicts that do not depend on the wall clock hold and equal the JAX
report's; every port report carries the fields the JAX package's artifact
schema (``bench.CHAOS_*_FIELDS``, ``bench.FLEET_*_FIELDS``) names. The JAX
reports are computed once per module. Not asserted: the round budgets,
``within_one_backoff``, the quiescence window and the timings. The crash
phase's ``resurrection_hit_ratio`` is held on the port only: the JAX
scenario kills the victim before the ring has carried its last inserts to the
survivor, and then reads 0.0 now and then; the port waits for that delivery
(ROADMAP.md, C, deliberate differences)."""

import pytest
from _torch_cli import hold_report, run_cli
from _torch_twin import fresh_jax_globals, fresh_port_globals, missing_artifact_fields

from radixmesh_tpu_torch import workload as pw

# tests/test_repair_plane.py's TestChaosAcceptance arguments.
CHAOS_KW = dict(partition_s=1.2, partition_delay_s=0.3, n_requests=60, quiesce_window_s=0.8, timeout_s=45.0,
                join_partition_s=1.0, drain_requests=25, crash_streams=8, crash_tokens=16)


@pytest.fixture(scope="module")
def chaos():
    from radixmesh_tpu import workload as jw

    with fresh_jax_globals():
        ref = jw.run_chaos_workload(**CHAOS_KW)
    with fresh_port_globals():
        return {"jax": ref, "port": pw.run_chaos_workload(**CHAOS_KW)}


@pytest.fixture(scope="module")
def churn():
    from radixmesh_tpu import workload as jw

    with fresh_jax_globals():
        ref = jw.run_fleet_churn_workload()
    with fresh_port_globals():
        return {"jax": ref, "port": pw.run_fleet_churn_workload()}


def test_chaos_serves_diverges_and_repairs(chaos):
    port, ref = chaos["port"], chaos["jax"]
    for key in ("nodes", "topology", "replication_factor", "round_budget"):
        assert port[key] == ref[key], key
    fp, rfp = port["fault_plan"], ref["fault_plan"]
    for key in ("seed", "drop_p", "drop_window_s", "partition_s", "partitioned_node"):
        assert fp[key] == rfp[key], key
    assert port["served"]["attempted"] == ref["served"]["attempted"] == CHAOS_KW["n_requests"]
    assert port["served"]["ok_rate_during_fault"] >= 0.9
    assert port["divergence"]["detected"] is ref["divergence"]["detected"] is True
    assert port["repair"]["converged"] is ref["repair"]["converged"] is True


def test_chaos_drain_and_join_lose_nothing(chaos):
    """The JAX run's ``left_without_failure_detection`` is read, not held:
    its drain races its failure detector under a loaded host (a starved
    node reads as dead now and then); the port's must be True."""
    port, ref = chaos["port"], chaos["jax"]
    drain, rdrain = port["drain"], ref["drain"]
    for key in ("performed", "node", "zero_failed", "writeback_flushed"):
        assert drain[key] == rdrain[key], key
    assert drain["zero_failed"] is True and drain["writeback_flushed"] is True
    assert drain["left_without_failure_detection"] is True, rdrain["left_without_failure_detection"]
    assert drain["requeued_served"] == drain["requeued"] == rdrain["requeued"]
    assert drain["attempted_during_drain"] == drain["ok_during_drain"] == CHAOS_KW["drain_requests"]
    join, rjoin = port["join"], ref["join"]
    for key in ("performed", "joiner", "partition_active_at_join", "partitioned_node", "converged_with_donor",
                "fleet_converged_after_join", "hits_to_bootstrapping"):
        assert join[key] == rjoin[key], key
    assert join["converged_with_donor"] is True and join["fleet_converged_after_join"] is True
    assert join["hits_to_bootstrapping"] == 0
    assert join["withheld_hits"] > 0


def test_chaos_crash_resumes_every_stream_from_the_replicated_cache(chaos):
    port, ref = chaos["port"], chaos["jax"]
    crash, rcrash = port["crash"], ref["crash"]
    for key in ("performed", "streams", "tokens_per_stream", "killed_at_token", "failed", "prefix_identical"):
        assert crash[key] == rcrash[key], key
    assert crash["failed"] == 0 and crash["prefix_identical"] is True
    assert crash["interrupted"] > 0 and crash["resumed"] == crash["interrupted"]
    assert rcrash["resumed"] == rcrash["interrupted"]
    # The port waits until a survivor holds the interrupted streams before
    # the kill: a resurrection is then a cache hit.
    assert crash["copies_before_kill"] is True
    assert crash["resurrection_hit_ratio"] >= 0.8
    assert crash["detection"]["trigger"] == rcrash["detection"]["trigger"] == "hop_timeout"
    assert crash["hedge"] == rcrash["hedge"]
    assert crash["hedge"]["first_writer_wins"] is True and crash["hedge"]["loser_cancelled"] is True


def test_chaos_rebalance_and_router_kill_sections(chaos):
    port, ref = chaos["port"], chaos["jax"]
    # A full replica has no ownership to move: the phase does not run.
    assert port["rebalance"] == ref["rebalance"] == {"performed": False}
    rk, rrk = port["router_kill"], ref["router_kill"]
    for key in ("performed", "routers", "killed", "survivor", "streams", "inflight_at_kill", "completed", "failed",
                "survivor_served"):
        assert rk[key] == rrk[key], key
    assert rk["failed"] == 0 and rk["completed"] == rk["streams"] and rk["survivor_served"] is True


def test_chaos_report_has_the_artifact_fields(chaos):
    sections = {"fault_plan": "FAULT", "served": "SERVED", "divergence": "DIVERGENCE", "repair": "REPAIR",
                "quiescence": "QUIESCENCE", "drain": "DRAIN", "join": "JOIN", "crash": "CRASH",
                "router_kill": "ROUTER_KILL"}
    assert not missing_artifact_fields(chaos["port"], "CHAOS", sections, chaos["jax"])


def test_fleet_churn_converges_heals_and_demotes_the_stall(churn):
    port, ref = churn["port"], churn["jax"]
    for key in ("nodes", "topology", "digest_interval_s", "digest_bytes", "health_aware_demotion"):
        assert port[key] == ref[key], key
    conv, rconv = port["convergence"], ref["convergence"]
    for key in ("inserts", "writers", "converged", "injected_divergence_detected", "healed"):
        assert conv[key] == rconv[key], key
    assert conv["converged"] and conv["injected_divergence_detected"] and conv["healed"]
    stall, rstall = port["stall_reaction"], ref["stall_reaction"]
    for key in ("injected", "detected", "threshold"):
        assert stall[key] == rstall[key], key
    assert stall["detected"] is True and stall["score_after"] < stall["threshold"]
    assert port["health_aware_demotion"] is True
    assert port["fan_in"]["rounds"] == ref["fan_in"]["rounds"]


def test_fleet_churn_report_has_the_artifact_fields(churn):
    sections = {"fan_in": "FAN_IN", "convergence": "CONVERGENCE", "stall_reaction": "STALL"}
    assert not missing_artifact_fields(churn["port"], "FLEET", sections, churn["jax"])


def test_chaosbench_builds_and_validates_the_chaos_report(chaos, monkeypatch, tmp_path, capsys):
    """``radixmesh_tpu_torch.scripts.chaosbench`` over the fixture's run: the
    JAX script's flags reach the scenario; the CHAOS report is valid for
    both validators."""
    from radixmesh_tpu_torch.scripts import chaosbench

    rc, report, kw = run_cli(monkeypatch, tmp_path, capsys, chaosbench, "run_chaos_workload", chaos["port"],
                             ["--partition", "1.2", "--requests", "60", "--join-partition", "1.0",
                              "--crash-streams", "8"])
    assert kw == dict(drop_p=0.2, partition_s=1.2, n_requests=60, round_budget=8, seed=0, join_drain=True,
                      join_partition_s=1.0, crash=True, crash_streams=8, replication_factor=0, rebalance=True,
                      router_kill=True)
    assert report["metric"] == "chaos_heal_converge_s"
    hold_report("chaos", rc, report)


def test_fleetbench_builds_and_validates_the_fleet_report(churn, monkeypatch, tmp_path, capsys):
    """``radixmesh_tpu_torch.scripts.fleetbench`` over the fixture's run:
    the FLEET report is valid for both validators."""
    from radixmesh_tpu_torch.scripts import fleetbench

    rc, report, kw = run_cli(monkeypatch, tmp_path, capsys, fleetbench, "run_fleet_churn_workload", churn["port"],
                             [])
    assert kw == dict(n_inserts=120, digest_interval_s=0.1, fan_in_rounds=5, seed=0)
    assert report["metric"] == "fleet_digest_fan_in_p50_s"
    hold_report("fleet", rc, report)
