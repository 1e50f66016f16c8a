"""The port's KV-movement and disk-tier acceptance scenarios
(``workload.run_kvflow_workload``, ``workload.run_tier_workload``) against
the JAX package's, on the CPU at the same seed and reduced arguments: the
counts that depend on neither the wall clock nor the weights' random
numbers (restored and written-back tokens, parked requests, gathers per
write-back sweep, prefetch hints; the cold cell's byte-identical resume and
its corrupt extents detected and never served) hold and equal the JAX
report's, and every port report carries the fields of the JAX package's
artifact schema (``bench.KVFLOW_*_FIELDS``, ``bench.TIER_*_FIELDS``). The
JAX reports are computed once per module. TTFT ratios, decode gaps and
``decode_steps_during_restore`` (which rides the plane's worker thread) are
not asserted."""

import pytest
import torch
from _torch_cli import hold_report, run_cli
from _torch_twin import fresh_port_globals, missing_artifact_fields

from radixmesh_tpu_torch import workload as pw

torch.set_num_threads(1)  # the suite runs in parallel worker processes

KVFLOW_KW = dict(n_restore_requests=2, prompt_tokens=256, chunk_tokens=128, repeats=1, seed=0)
TIER_KW = dict(n_prefixes=14, prefix_tokens=192, host_slots=256, n_streams=3, seed=1)


@pytest.fixture(scope="module")
def kvflow():
    from radixmesh_tpu import workload as jw

    ref = jw.run_kvflow_workload(**KVFLOW_KW)
    with fresh_port_globals():
        return {"jax": ref, "port": pw.run_kvflow_workload(**KVFLOW_KW, device="cpu")}


@pytest.fixture(scope="module")
def tier():
    from radixmesh_tpu import workload as jw

    ref = jw.run_tier_workload(**TIER_KW)
    with fresh_port_globals():
        return {"jax": ref, "port": pw.run_tier_workload(**TIER_KW, device="cpu")}


def test_kvflow_counts_equal_the_jax_report(kvflow):
    port, ref = kvflow["port"], kvflow["jax"]
    for section, key in (("restore", "restored_tokens"), ("restore", "parked_requests"),
                         ("restore", "requests"), ("writeback", "tokens_written_back"),
                         ("writeback", "gathers_per_sweep"), ("writeback", "sync_gathers_per_sweep"),
                         ("prefetch", "hints_sent")):
        assert port[section][key] == ref[section][key], (section, key)
    n = KVFLOW_KW["n_restore_requests"]
    assert port["restore"]["restored_tokens"] == port["writeback"]["tokens_written_back"] == n * 256
    assert port["restore"]["parked_requests"] == n
    assert port["restore"]["sync_decode_steps_during_restore"] == 0
    assert port["writeback"]["gathers_per_sweep"] == 1.0
    assert port["prefetch"]["hints_sent"] == 2 * n
    assert (port["chunk_tokens"], port["ttft_chunk_tokens"], port["page_size"]) == \
        (ref["chunk_tokens"], ref["ttft_chunk_tokens"], ref["page_size"])


def test_kvflow_report_has_the_artifact_fields(kvflow):
    sections = {"restore": "RESTORE", "writeback": "WRITEBACK", "prefetch": "PREFETCH"}
    assert not missing_artifact_fields(kvflow["port"], "KVFLOW", sections, kvflow["jax"])


def test_tier_cold_cell_resumes_byte_identical_and_drops_corrupt_extents(tier):
    port, ref = tier["port"], tier["jax"]
    cs, rcs = port["cold_start"], ref["cold_start"]
    assert cs["byte_identical"] is True and rcs["byte_identical"] is True
    assert cs["resumed"] == cs["interrupted"] == rcs["resumed"] == TIER_KW["n_streams"]
    assert cs["failed"] == rcs["failed"] == 0
    cor, rcor = port["corruption"], ref["corruption"]
    assert cor["extents_attacked"] == cor["detected"] == rcor["detected"] == 2
    assert cor["served_corrupt"] == rcor["served_corrupt"] == 0
    assert cs["corrupt_served"] == 0 and cs["corrupt_detected"] >= 2
    assert port["capacity"] == {**port["capacity"], **{k: ref["capacity"][k] for k in (
        "working_set_tokens", "host_slots", "working_set_ratio", "requests", "distinct_prefixes")}}
    assert port["spill"]["spilled_tokens"] == ref["spill"]["spilled_tokens"]
    assert port["spill"]["extents"] == ref["spill"]["extents"]


def test_tier_report_has_the_artifact_fields(tier):
    sections = {"capacity": "CAPACITY", "spill": "SPILL", "restore_overlap": "RESTORE",
                "cold_start": "COLD_START", "corruption": "CORRUPTION"}
    assert not missing_artifact_fields(tier["port"], "TIER", sections, tier["jax"])


def test_kvflowbench_builds_and_validates_the_kvflow_report(kvflow, monkeypatch, tmp_path, capsys):
    """``radixmesh_tpu_torch.scripts.kvflowbench`` over the fixture's run:
    the toy model on the CPU, the JAX script's flags mapped to the
    scenario's arguments, the KVFLOW report valid for both validators."""
    from radixmesh_tpu_torch.scripts import kvflowbench

    rc, report, kw = run_cli(monkeypatch, tmp_path, capsys, kvflowbench, "run_kvflow_workload", kvflow["port"],
                             ["--device", "cpu", "--model", "toy", "--requests", "2", "--prompt-tokens", "256",
                              "--chunk-tokens", "128", "--repeats", "1"])
    assert kw == dict(KVFLOW_KW, cfg=None, device="cpu")
    assert report["metric"] == "kv_restore_overlapped_ttft_ratio"
    hold_report("kvflow", rc, report)


def test_tierbench_embeds_the_ports_meshcheck_and_validates(tier, monkeypatch, tmp_path, capsys):
    """``radixmesh_tpu_torch.scripts.tierbench`` over the fixture's run: the
    TIER report embeds the port's meshcheck over the tier plane (0
    findings, the ``hotpath-file-io`` controls tripped) and is valid for
    both validators."""
    from radixmesh_tpu_torch.scripts import tierbench

    rc, report, kw = run_cli(monkeypatch, tmp_path, capsys, tierbench, "run_tier_workload", tier["port"],
                             ["--device", "cpu", "--model", "toy", "--seed", "1"])
    assert kw == dict(seed=1, cfg=None, device="cpu")
    mc = report["meshcheck"]
    assert mc["clean"] is True and mc["findings"] == 0, mc
    assert mc["file_io_controls"] == mc["file_io_controls_tripped"] > 0
    assert hold_report("tier", rc, report) == [] and rc == 0
