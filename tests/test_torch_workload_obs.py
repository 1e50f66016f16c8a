"""The port's mesh-wide observability scenario (``workload.run_obs_workload``)
against the JAX package's, on the CPU at the same seed and the reduced
arguments of ``tests/test_obs_workload.py``, plus one run of each with the
step-attribution leg on the toy model: the stitched trace of a crash and
resurrection spans at least three node tracks under one trace id, the zipf
storm's hot shard and owner set are named from gossip alone, traceless frames
are the untraced wire bit for bit, and both engines account the same waves
and tokens. Every port report carries the fields of the JAX package's
artifact schema (``bench.OBS_*_FIELDS``). The JAX reports are computed once
per module. ``replication_edges`` is held on the port only: the JAX scenario
kills the victim before the ring has carried its inserts, and then counts no
replication edge now and then; the port waits for that delivery (ROADMAP.md,
C, deliberate differences). Wall-clock readings (``mfu``, the timings) are
not compared."""

import json

import bench
import pytest
import torch
from _torch_cli import hold_report, run_cli
from _torch_twin import fresh_jax_globals, fresh_port_globals, missing_artifact_fields

from radixmesh_tpu_torch import workload as pw

torch.set_num_threads(1)  # the suite runs in parallel worker processes

# tests/test_obs_workload.py's arguments.
OBS_KW = dict(streams=6, tokens_per_stream=16, zipf_inserts=250, timeout_s=45.0)


@pytest.fixture(scope="module")
def obs(tmp_path_factory):
    from radixmesh_tpu import workload as jw

    trace = str(tmp_path_factory.mktemp("obs") / "stitched.json")
    with fresh_jax_globals():
        ref = jw.run_obs_workload(**OBS_KW, engine_steps=False)
    with fresh_port_globals():
        port = pw.run_obs_workload(**OBS_KW, engine_steps=False, stitched_trace_path=trace)
    with open(trace) as fh:
        doc = json.load(fh)
    return {"jax": ref, "port": port, "doc": doc}


@pytest.fixture(scope="module")
def steps():
    from radixmesh_tpu import workload as jw

    with fresh_jax_globals():
        ref = jw.run_obs_workload(**OBS_KW, engine_steps=True)
    with fresh_port_globals():
        return {"jax": ref, "port": pw.run_obs_workload(**OBS_KW, engine_steps=True, device="cpu")}


def test_obs_stitches_the_resurrected_stream_across_nodes(obs):
    port, ref = obs["port"], obs["jax"]
    st, rst = port["stitch"], ref["stitch"]
    for key in ("performed", "node", "streams", "tokens_per_stream", "interrupted", "resumed", "failed"):
        assert st[key] == rst[key], key
    assert st["failed"] == 0 and st["interrupted"] > 0 and st["resumed"] == st["interrupted"]
    assert st["node_tracks"] >= bench.OBS_MIN_NODE_TRACKS and rst["node_tracks"] >= bench.OBS_MIN_NODE_TRACKS
    assert st["publish_edges"] > 0 and rst["publish_edges"] > 0
    assert st["copies_before_kill"] is True and st["replication_edges"] > 0
    assert port["nodes"] == ref["nodes"] and port["topology"] == ref["topology"]


def test_obs_stitched_artifact_is_one_perfetto_document(obs):
    st, doc = obs["port"]["stitch"], obs["doc"]
    assert bench.validate_trace(doc) == []
    assert doc["otherData"]["stitched"] is True
    procs = {ev["args"]["name"] for ev in doc["traceEvents"]
             if ev.get("ph") == "M" and ev["name"] == "process_name"}
    assert set(st["nodes_on_track"]) <= procs
    pids = {ev["pid"] for ev in doc["traceEvents"]
            if ev.get("ph") == "X" and (ev.get("args") or {}).get("trace_id") == st["trace_id"]}
    assert len(pids) >= bench.OBS_MIN_NODE_TRACKS


def test_obs_heat_names_the_hot_shard_and_its_owners(obs):
    heat, rheat = obs["port"]["heat"], obs["jax"]["heat"]
    for key in ("performed", "inserts", "distinct_keys", "zipf_alpha", "expected_hot_shard", "expected_hot_owners",
                "hot_shard", "hot_owners", "owner_set_correct"):
        assert heat[key] == rheat[key], key
    assert heat["hot_shard"] == heat["expected_hot_shard"]
    assert heat["owner_set_correct"] is True
    assert heat["skew_score"] >= bench.OBS_MIN_SKEW_SCORE


def test_obs_wire_gate(obs):
    wire = obs["port"]["wire"]
    assert wire == obs["jax"]["wire"]
    assert wire["rf0_traceless_unchanged"] and wire["trace_trailer_roundtrip"] and wire["trailer_bytes"] == 8


def test_obs_steps_account_the_same_waves(steps):
    port, ref = steps["port"]["steps"], steps["jax"]["steps"]
    assert port["performed"] is ref["performed"] is True
    assert port["n_params"] == ref["n_params"]
    for phase in ("prefill", "decode"):
        for key in ("waves", "real_tokens", "padded_tokens", "pad_fraction"):
            assert port[phase][key] == ref[phase][key], (phase, key)
        assert port[phase]["waves"] > 0 and port[phase]["mfu"] > 0.0, phase


@pytest.mark.parametrize("which", ["obs", "steps"])
def test_obs_report_has_the_artifact_fields(which, obs, steps):
    run = {"obs": obs, "steps": steps}[which]
    sections = {"stitch": "STITCH", "heat": "HEAT", "wire": "WIRE"}
    if which == "steps":
        sections.update({"steps": "STEP", "steps.prefill": "WAVE", "steps.decode": "WAVE"})
    assert not missing_artifact_fields(run["port"], "OBS", sections, run["jax"])


def test_obsbench_builds_and_validates_the_obs_report(steps, monkeypatch, tmp_path, capsys):
    """``radixmesh_tpu_torch.scripts.obsbench`` over the fixture's run with
    the step leg: the OBS report valid for both validators."""
    from radixmesh_tpu_torch.scripts import obsbench

    rc, report, kw = run_cli(monkeypatch, tmp_path, capsys, obsbench, "run_obs_workload", steps["port"],
                             ["--device", "cpu", "--model", "toy", "--streams", "6", "--zipf-inserts", "250"])
    assert kw == dict(seed=0, replication_factor=3, streams=6, zipf_inserts=250, engine_steps=True,
                      stitched_trace_path=None, cfg=None, device="cpu")
    assert report["metric"] == "obs_stitched_node_tracks"
    hold_report("obs", rc, report)
