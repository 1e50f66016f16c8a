"""The port's mesh-doctor acceptance scenario (``workload.run_doctor_workload``:
a 4 prefill + 2 decode + 1 router inproc mesh beside a traced engine, a
healthy phase and three seeded pathologies) against the JAX package's, on
the CPU at the same seed and reduced arguments: the same rules run, the
healthy phase has no findings, the hot shard named is the one the numpy-
seeded zipf storm made hottest (shard and owner set, equal to the JAX run's
ground truth), the restore lane's parked count is named, the attributor's
sums are exact, and the report carries the fields of the JAX package's
artifact schema (``bench.DOCTOR_*_FIELDS``). The JAX report is computed once
per module. ``prefill_convoy`` is not asserted: whether a long prompt's
prefill dominates its e2e is a wall-clock reading (the JAX run at these
sizes does not fire it)."""

import json

import pytest
import torch
from _torch_twin import fresh_port_globals, missing_artifact_fields

import bench
from radixmesh_tpu_torch import reports
from radixmesh_tpu_torch import workload as pw

torch.set_num_threads(1)  # the suite runs in parallel worker processes

DOCTOR_KW = dict(seed=0, zipf_inserts=200, long_prompt=512, restore_prompt=256)


@pytest.fixture(scope="module")
def doctor():
    from radixmesh_tpu import workload as jw

    ref = jw.run_doctor_workload(**DOCTOR_KW)
    with fresh_port_globals():
        port = pw.run_doctor_workload(**DOCTOR_KW, device="cpu")
    return {"jax": ref, "port": port}


def test_doctor_runs_every_rule_and_stays_quiet_when_healthy(doctor):
    port, ref = doctor["port"], doctor["jax"]
    assert port["healthy"]["rules_checked"] == ref["healthy"]["rules_checked"]
    assert port["healthy"]["findings"] == []
    assert port["healthy"]["inputs"] == ref["healthy"]["inputs"]
    assert port["healthy"]["balanced_shards"] == ref["healthy"]["balanced_shards"]
    assert (port["nodes"], port["replication_factor"]) == (ref["nodes"], ref["replication_factor"])


def test_doctor_names_the_seeded_hot_shard_and_its_owners(doctor):
    hot, ref = doctor["port"]["pathologies"]["hot_shard"], doctor["jax"]["pathologies"]["hot_shard"]
    assert hot["expected"] == ref["expected"]
    assert hot["detected"] is True and hot["evidence_correct"] is True, hot
    assert hot["evidence"]["shard"] == ref["expected"]["shard"]
    assert sorted(hot["evidence"]["owners"]) == ref["expected"]["owners"]


def test_doctor_names_the_parked_restore_lane(doctor):
    stall = doctor["port"]["pathologies"]["restore_park_stall"]
    assert stall["expected"] == doctor["jax"]["pathologies"]["restore_park_stall"]["expected"]
    assert stall["detected"] is True and stall["evidence_correct"] is True, stall
    assert stall["evidence"]["parked"] == stall["expected"]["parked"] == 3


def test_doctor_attribution_sums_are_exact(doctor):
    att = doctor["port"]["attribution"]
    assert att["sums_ok"] is True and att["refused"] == 0
    assert att["audited"] == doctor["jax"]["attribution"]["audited"]


def test_doctor_report_has_the_artifact_fields(doctor):
    sections = {"healthy": "HEALTHY", "attribution": "ATTRIBUTION",
                **{f"pathologies.{name}": "PATHOLOGY" for name in bench.DOCTOR_PATHOLOGIES}}
    missing = missing_artifact_fields(doctor["port"], "DOCTOR", sections, doctor["jax"])
    assert not missing, missing


def test_doctor_workload_command_line_builds_the_doctor_report(doctor, monkeypatch, tmp_path, capsys):
    """``python -m radixmesh_tpu_torch.doctor --workload`` over the fixture's
    run: the default model (Llama-3-8B's widths, 2 layers) brings the card's
    scenario sizes (``scripts._cli.DOCTOR_KW``), the report carries a proven
    benchdiff self-check, and both validators read it alike (the reduced
    run's prefill convoy is its own wall-clock verdict)."""
    from _torch_cli import hold_report

    from radixmesh_tpu_torch import doctor as doctor_cli
    from radixmesh_tpu_torch import workload
    from radixmesh_tpu_torch.scripts._cli import DOCTOR_KW

    seen = {}

    def scenario(**kw):
        seen.update(kw)
        return dict(doctor["port"])

    monkeypatch.setattr(workload, "run_doctor_workload", scenario)
    out = tmp_path / "DOCTOR_torch_r99.json"
    rc = doctor_cli.main(["--workload", "--device", "cpu", "--seed", "0", "--out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = seen.pop("cfg")
    assert (cfg.n_layers, cfg.hidden, cfg.head_dim) == (2, 4096, 128)
    assert seen == dict(DOCTOR_KW, seed=0, device="cpu")
    report = json.loads(out.read_text())
    assert line["artifact"] == out.name and line["value"] == report["value"]
    bd = report["benchdiff"]
    assert bd["identical_clean"] and bd["regression_flagged"] and bd["mismatch_detected"]
    problems = hold_report("doctor", rc, report)
    assert rc == (0 if report["value"] == len(reports.DOCTOR_PATHOLOGIES) and not problems else 1)
