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

import pytest
import torch
from _torch_twin import fresh_port_globals, missing_artifact_fields

import bench
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
