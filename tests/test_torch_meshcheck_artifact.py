"""The port's ANALYSIS artifact: ``python -m radixmesh_tpu_torch.meshcheck
--write-artifact --out PATH`` over the port's tree, on the CPU, validated by
the port's schema (``analysis.report``) and by the JAX package's
``bench.validate_analysis``: one schema, two packages."""

import json

import bench
from radixmesh_tpu_torch.analysis import report as port_report
from radixmesh_tpu_torch.meshcheck import main


def test_artifact_passes_both_validators(tmp_path, capsys):
    out = tmp_path / "ANALYSIS_torch_r99.json"
    assert main(["--write-artifact", "--out", str(out)]) == 0, capsys.readouterr()
    assert "wrote ANALYSIS_torch_r99.json" in capsys.readouterr().out
    report = json.loads(out.read_text())
    assert port_report.validate_analysis(report) == []
    assert bench.validate_analysis(report) == []
    assert report["package"] == "radixmesh_tpu_torch"
    assert report["clean"] is True and report["findings"] == [] and report["value"] == 0
    assert report["schema_version"] == bench.ANALYSIS_SCHEMA_VERSION
    assert {c["id"] for c in report["checkers"]} == set(bench.ANALYSIS_CHECKER_IDS)
    fixtures = {c["fixture"] for c in report["positive_controls"]}
    assert {"torch_device_sync", "plain_import_edge", "hotpath_sleep", "guarded_race"} <= fixtures
    assert all(c["tripped"] for c in report["positive_controls"])
    assert "schema_violation" not in report
    names = {r["name"] for r in report["thread_roots"]["roots"]}
    assert {"kv-transfer", "engine-loop", "mesh-pool-free", "kv-handoff-lane"} <= names
    # Every justification in the ledger carries its reason and excuses a finding.
    assert report["suppressions"] and all(s["justification"].strip() and s["used"]
                                          for s in report["suppressions"])
