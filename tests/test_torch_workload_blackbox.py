"""The port's black-box scenario (``workload.run_blackbox_workload``) against
the JAX package's, on the CPU at the same seed and the arguments of
``tests/test_blackbox_workload.py``, the port's engine on the JAX scenario's
toy model: the live doctor stays silent on the healthy phase, the hot shard's
primary owner is killed hard after the zipf storm, and the post-mortem over
the dumps alone names the seeded hot shard, a crash window of the victim's
that holds the kill, and the victim's truncation; the victim's directory
holds segments only. Every port report carries the fields of the JAX
package's artifact schema (``bench.BLACKBOX_*_FIELDS``). The JAX report is
computed once per module. The storm's live ``hot_shard``, ``owner_set_correct``
and the crash window are held on the port only: the JAX heat phase reads the
router's view before every owner's post-storm summary is folded, and names
another shard now and then; the JAX scenario arms its 0.6 s staleness verdict
from the start, so a process starved of the CPU that long before the kill
records a drop of every rank, and the post-mortem names that earlier drop
(ROADMAP.md, C). Not asserted, as it reads the wall clock: the sampler's
overhead budget."""

import os

import pytest
import torch
from _torch_cli import hold_report, run_cli
from _torch_twin import fresh_jax_globals, fresh_port_globals, missing_artifact_fields

from radixmesh_tpu_torch import workload as pw

torch.set_num_threads(1)  # the suite runs in parallel worker processes


@pytest.fixture(scope="module")
def bb(tmp_path_factory):
    from radixmesh_tpu import workload as jw

    with fresh_jax_globals():
        ref = jw.run_blackbox_workload(seed=0, blackbox_dir=str(tmp_path_factory.mktemp("jax-bb")), timeout_s=45.0)
    out = str(tmp_path_factory.mktemp("port-bb"))
    with fresh_port_globals():
        port = pw.run_blackbox_workload(seed=0, blackbox_dir=out, timeout_s=45.0, device="cpu")
    return {"jax": ref, "port": port, "dir": out}


def test_blackbox_healthy_phase_is_silent(bb):
    port, ref = bb["port"]["healthy"], bb["jax"]["healthy"]
    assert port["findings"] == ref["findings"] == []
    assert port["rules_checked"] == ref["rules_checked"]
    assert port["balanced_shards"] == ref["balanced_shards"]
    assert bb["port"]["topology"].endswith("CPU engine")


def test_blackbox_kills_the_hot_owner(bb):
    port, ref = bb["port"], bb["jax"]
    storm, rstorm = port["storm"], ref["storm"]
    for key in ("inserts", "distinct_keys", "expected_hot_shard", "expected_hot_owners"):
        assert storm[key] == rstorm[key], key
    assert storm["hot_shard"] == storm["expected_hot_shard"] and storm["owner_set_correct"] is True
    crash, rcrash = port["crash"], ref["crash"]
    for key in ("victim_rank", "victim_is_hot_owner", "observer_detected_live"):
        assert crash[key] == rcrash[key], key
    assert crash["victim_is_hot_owner"] is True and crash["observer_detected_live"] is True
    assert crash["digests_fresh_at_kill"] is True


def test_blackbox_postmortem_names_everything_from_the_dumps(bb):
    port, ref = bb["port"], bb["jax"]
    pm, rpm = port["postmortem"], ref["postmortem"]
    assert pm["expected"]["hot_shard"] == rpm["expected"]["hot_shard"]
    assert pm["expected"]["hot_owners"] == rpm["expected"]["hot_owners"]
    assert pm["observer"]["hot_shard_named"] is True
    assert pm["observer"]["hot_shard_evidence"]["shard"] == pm["expected"]["hot_shard"]
    # The victim's own drop is named, and its window holds the kill.
    crash = pm["observer"]["crash_evidence"]
    assert crash["detector"] == "health_drop" and crash["rank"] == str(port["crash"]["victim_rank"])
    lo, hi = crash["window"]
    assert lo - 0.05 <= pm["expected"]["t_kill"] <= hi
    assert pm["observer"]["crash_window_named"] is True and port["named"] == 3
    assert pm["victim"]["unclean"] is rpm["victim"]["unclean"] is True
    assert pm["victim"]["truncation_named"] is True
    assert pm["observer"]["rules_checked"] == rpm["observer"]["rules_checked"]
    box, rbox = port["blackbox"], ref["blackbox"]
    assert box["schema_version"] == rbox["schema_version"]
    assert box["victim"]["unclean"] is True and box["victim"]["finals"] == rbox["victim"]["finals"] == 0
    assert box["observer"]["finals"] >= 1 and "sigterm" in box["observer"]["causes"]


def test_blackbox_victim_dir_holds_segments_only(bb):
    victim_dir = os.path.join(bb["dir"], "victim")
    node_dir = os.path.join(victim_dir, os.listdir(victim_dir)[0])
    names = sorted(os.listdir(node_dir))
    assert any(n.startswith("segment-") for n in names)
    assert not any(n.startswith("final-") for n in names)


def test_blackbox_report_has_the_artifact_fields(bb):
    sections = {"healthy": "HEALTHY", "crash": "CRASH", "history.self_overhead": "OVERHEAD"}
    assert not missing_artifact_fields(bb["port"], "BLACKBOX", sections, bb["jax"])


def test_blackboxbench_builds_and_validates_the_blackbox_report(bb, monkeypatch, tmp_path, capsys):
    """``radixmesh_tpu_torch.scripts.blackboxbench`` over the fixture's run:
    ``--keep-dumps`` reaches the scenario's ``blackbox_dir``; both
    validators read the report alike (the sampler's overhead budget is
    the run's own wall-clock verdict)."""
    from radixmesh_tpu_torch.scripts import blackboxbench

    keep = str(tmp_path / "dumps")
    rc, report, kw = run_cli(monkeypatch, tmp_path, capsys, blackboxbench, "run_blackbox_workload", bb["port"],
                             ["--device", "cpu", "--model", "toy", "--keep-dumps", keep])
    assert kw == dict(seed=0, replication_factor=3, history_interval_s=0.25, blackbox_dir=keep, cfg=None,
                      device="cpu")
    assert report["metric"] == "blackbox_postmortem_named"
    hold_report("blackbox", rc, report)
