"""The port's request-flight tracing plane
(``radixmesh_tpu_torch/obs/trace_plane.py``) and step accounting
(``obs/step_plane.py``): twins of ``tests/test_trace_plane.py`` —
flight-recorder semantics (bounded, drop-oldest, one-branch no-op when
off), the span instrumentation of the port's engine, the launcher's trace
flags, cross-node stitching, step accounting and the workload harness
(``workload.run_engine_workload`` over a mesh-bound engine, and its trace
artifact) — without its SLO and disaggregated-handoff legs. The port's
Chrome trace passes the JAX package's artifact contract
(``bench.validate_trace``); the step plane's card rows and FLOPs model are
checked too."""

import json
import time

import numpy as np
import pytest
import torch

import bench
from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.models.llama import ModelConfig, init_params
from radixmesh_tpu_torch.obs.trace_plane import (
    FlightRecorder,
    get_recorder,
    set_recorder,
    write_trace,
)

torch.set_num_threads(1)  # the suite runs in parallel worker processes


@pytest.fixture(autouse=True)
def _restore_recorder():
    """Tests swap the port's process-wide recorder; put it back."""
    old = get_recorder()
    yield
    set_recorder(old)


def _tiny_engine(name: str, **kw) -> Engine:
    cfg = ModelConfig.tiny()
    return Engine(
        cfg,
        init_params(cfg, seed=0, device="cpu"),
        num_slots=512,
        page_size=4,
        max_batch=2,
        name=name,
        device="cpu",
        **kw,
    )


class TestFlightRecorder:
    def test_capacity_bound_and_drop_oldest(self):
        rec = FlightRecorder(capacity=16, sample=1.0)
        for i in range(100):
            rec.event("lane", f"e{i}", float(i), 0.5)
        assert len(rec) == 16
        assert rec.dropped == 84
        assert rec.recorded == 100
        # Drop-OLDEST: the survivors are the freshest spans.
        names = [s.name for s in rec.snapshot()]
        assert names == [f"e{i}" for i in range(84, 100)]
        assert len(rec.drain()) == 16
        assert len(rec) == 0

    def test_disabled_recorder_returns_none_and_records_nothing(self):
        rec = FlightRecorder(capacity=16, sample=0.0)
        assert rec.trace("req:1") is None
        rec.event("lane", "e", 0.0, 1.0)
        assert len(rec) == 0 and rec.recorded == 0

    def test_partial_sampling_mixes_traced_and_untraced(self):
        rec = FlightRecorder(capacity=1024, sample=0.5)
        got = [rec.trace("req") is not None for _ in range(200)]
        assert any(got) and not all(got)

    def test_span_context_manager_measures(self):
        rec = FlightRecorder(capacity=8, sample=1.0)
        ctx = rec.trace("req:1")
        with ctx.span("work", x=1):
            time.sleep(0.01)
        (span,) = rec.snapshot()
        assert span.name == "work" and span.dur >= 0.01
        assert span.trace_id == ctx.trace_id and span.args == {"x": 1}

    def test_chrome_trace_schema_validates(self):
        rec = FlightRecorder(capacity=64, sample=1.0)
        for i in range(10):
            rec.event(f"lane{i % 3}", "e", float(10 - i), 0.25, k=i)
        obj = rec.chrome_trace()
        assert bench.validate_trace(obj) == []
        # Round-trips through JSON (the /debug/trace body).
        assert bench.validate_trace(json.loads(json.dumps(obj))) == []
        names = {
            ev["args"]["name"]
            for ev in obj["traceEvents"]
            if ev["ph"] == "M"
        }
        assert names == {"lane0", "lane1", "lane2"}


class TestNoOpGuard:
    def test_disabled_tracing_allocates_no_spans(self, monkeypatch):
        """Acceptance: with sampling off, the per-step hot path takes the
        no-op branch — zero Span allocations, zero recorder writes — for
        a full serve (admission, prefill, decode, publish)."""
        calls = {"record": 0}
        orig = FlightRecorder._record

        def spy(self, span):
            calls["record"] += 1
            return orig(self, span)

        monkeypatch.setattr(FlightRecorder, "_record", spy)
        eng = _tiny_engine("trace-off")
        reqs = [eng.add_request(list(range(1, 16))) for _ in range(3)]
        for _ in range(200):
            if not eng.has_work():
                break
            eng.step()
        assert all(r.trace is None for r in reqs)
        assert calls["record"] == 0

    def test_enabled_tracing_attaches_context(self):
        set_recorder(FlightRecorder(capacity=4096, sample=1.0))
        eng = _tiny_engine("trace-on")
        req = eng.add_request(list(range(1, 16)))
        assert req.trace is not None
        for _ in range(200):
            if not eng.has_work():
                break
            eng.step()
        names = {s.name for s in get_recorder().snapshot()}
        assert {"prefix_match", "admission_wait", "prefill_wave",
                "decode_chunk", "publish", "first_token"} <= names


class TestLaunchTraceFlags:
    def _args(self, **kw):
        import argparse

        base = dict(trace_capacity=64, trace_sample=None, trace_dir=None)
        base.update(kw)
        return argparse.Namespace(**base)

    def test_trace_dir_alone_implies_full_sampling(self, tmp_path):
        from radixmesh_tpu_torch.launch import _configure_tracing

        _configure_tracing(self._args(trace_dir=str(tmp_path / "x")))
        assert get_recorder().sample == 1.0

    def test_explicit_zero_sample_wins_over_trace_dir(self, tmp_path):
        from radixmesh_tpu_torch.launch import _configure_tracing

        before = get_recorder()
        _configure_tracing(self._args(trace_dir=str(tmp_path / "x"), trace_sample=0.0))
        # Recorder untouched: the operator said off, so off.
        assert get_recorder() is before and not get_recorder().enabled

    def test_unset_everything_stays_disabled(self):
        from radixmesh_tpu_torch.launch import _configure_tracing

        before = get_recorder()
        _configure_tracing(self._args())
        assert get_recorder() is before and not get_recorder().enabled

    def test_dump_skipped_when_tracing_explicitly_off(self, tmp_path):
        import logging
        import os

        from radixmesh_tpu_torch.launch import _configure_tracing, _dump_trace

        args = self._args(trace_dir=str(tmp_path / "t"), trace_sample=0.0)
        _configure_tracing(args)
        _dump_trace(args, logging.getLogger("t"))
        # No empty junk artifact that reads as "a trace was captured".
        assert not os.path.exists(args.trace_dir)


class TestCrossNodeStitching:
    """64-bit globally-unique trace ids that cross the wire, per-
    span node attribution, and the merge path that folds many nodes'
    exports into ONE Perfetto document with one process-track per node
    and clock-offset correction."""

    def test_new_trace_ids_are_unique_and_nonzero(self):
        from radixmesh_tpu_torch.obs.trace_plane import new_trace_id

        ids = {new_trace_id() for _ in range(2000)}
        assert len(ids) == 2000
        assert all(0 < i < (1 << 64) for i in ids)

    def test_trace_id_adoption_implies_force(self):
        """A receiver handed an upstream id must keep it (the stitch
        contract) and must not re-flip the sampling coin — the id's
        existence IS the upstream decision."""
        rec = FlightRecorder(capacity=8, sample=1e-9, node="n1")
        ctx = rec.trace("req:7", trace_id=0xABCDE)
        assert ctx is not None and ctx.trace_id == 0xABCDE
        # The off switch still wins (tracing disabled = no spans, ever).
        assert FlightRecorder(capacity=8, sample=0.0).trace(
            "req:7", trace_id=0xABCDE
        ) is None

    def test_spans_carry_node_labels(self):
        rec = FlightRecorder(capacity=8, sample=1.0, node="default-node")
        rec.trace("req:1").add("a", 0.0, 0.1)
        rec.trace("req:2", node="other-node").add("b", 0.0, 0.1)
        rec.event("lane", "c", 0.0, 0.1)
        nodes = [s.node for s in rec.snapshot()]
        assert nodes == ["default-node", "other-node", "default-node"]

    def test_event_with_trace_id_skips_coin_flip(self):
        rec = FlightRecorder(capacity=64, sample=1e-9)
        for _ in range(20):
            rec.event("lane", "lag", 0.0, 0.1, trace_id=0x77)
        assert len(rec) == 20
        assert all(s.trace_id == 0x77 for s in rec.snapshot())

    def test_merge_one_pid_per_node_with_clock_offsets(self):
        """Two exports with different wall offsets (two processes) plus
        a per-node skew estimate: the merged doc carries one process
        track per node, process_name metadata, and validates against
        the trace artifact contract."""
        from radixmesh_tpu_torch.obs.trace_plane import stitch_traces

        a = FlightRecorder(capacity=8, sample=1.0, node="prefill@0")
        b = FlightRecorder(capacity=8, sample=1.0, node="decode@1")
        a.trace("req:1", trace_id=5).add("publish", 1.0, 0.2)
        b.event("ring:decode@1", "replication_lag", 1.1, 0.1, trace_id=5)
        ea, eb = a.export_spans(), b.export_spans()
        eb["wall_offset"] += 3.0  # a second process's clock base
        doc = stitch_traces([ea, eb], clock_offsets={"decode@1": 3.0})
        assert bench.validate_trace(doc) == []
        procs = {
            ev["args"]["name"]
            for ev in doc["traceEvents"]
            if ev["ph"] == "M" and ev["name"] == "process_name"
        }
        assert procs == {"prefill@0", "decode@1"}
        pids = {
            ev["pid"] for ev in doc["traceEvents"] if ev.get("ph") == "X"
        }
        assert len(pids) == 2
        # Both spans stitch under the SAME trace id.
        tids = {
            ev["args"]["trace_id"]
            for ev in doc["traceEvents"]
            if ev.get("ph") == "X"
        }
        assert len(tids) == 1
        # The offset correction cancelled decode@1's +3s base: the two
        # spans sit ~0.1s apart, not ~3s.
        xs = sorted(
            ev["ts"] for ev in doc["traceEvents"] if ev.get("ph") == "X"
        )
        assert xs[1] - xs[0] < 1e6  # microseconds

    def test_single_inproc_export_groups_by_span_node(self):
        """In-process multi-node harnesses share ONE recorder: the
        stitcher must split tracks by each SPAN's node label."""
        from radixmesh_tpu_torch.obs.trace_plane import stitch_traces

        rec = FlightRecorder(capacity=16, sample=1.0, node="edge")
        for node in ("edge", "prefill@0", "decode@1"):
            rec.event("lane", "e", 1.0, 0.1, trace_id=9, node=node)
        doc = stitch_traces([rec.export_spans()])
        procs = {
            ev["args"]["name"]
            for ev in doc["traceEvents"]
            if ev["ph"] == "M" and ev["name"] == "process_name"
        }
        assert procs == {"edge", "prefill@0", "decode@1"}


class TestNoOpGuardNewCallSites:
    """The no-op invariant — sampling off means zero span allocations and
    zero recorder writes — at the engine wave paths (step accounting's
    seam)."""

    def test_wave_paths_with_accounting_off_touch_no_recorder(
        self, monkeypatch
    ):
        """Default engines (step_accounting off) keep the wave hot paths
        at one `is not None` branch: a full serve with sampling off
        makes zero recorder writes and allocates no StepAccounting."""
        calls = {"record": 0}
        orig = FlightRecorder._record
        monkeypatch.setattr(
            FlightRecorder,
            "_record",
            lambda self, span: (calls.__setitem__(
                "record", calls["record"] + 1
            ), orig(self, span))[1],
        )
        set_recorder(FlightRecorder(capacity=64, sample=0.0))
        eng = _tiny_engine("waves-off")
        assert eng.step_acct is None
        eng.add_request(list(range(1, 16)))
        for _ in range(200):
            if not eng.has_work():
                break
            eng.step()
        assert calls["record"] == 0

class TestStepAccounting:
    """obs/step_plane.py unit math + the engine seam (leg (c) of the
    observability tentpole)."""

    def test_note_wave_math(self):
        from radixmesh_tpu_torch.obs.step_plane import StepAccounting

        acct = StepAccounting("unit", n_params=1_000_000, peak_tflops=1.0)
        # 500 real of 1000 launched tokens in 1 ms on a 1 TFLOP/s peak:
        # 2e6 FLOPs/token * 500 / (1e12 * 1e-3) = 1e9/1e9 = 1.0e0... no:
        # 2*1e6*500 = 1e9 FLOPs over 1e9 peak-FLOP budget -> MFU 1.0.
        mfu = acct.note_wave("prefill", 500, 1000, 1e-3)
        assert mfu == pytest.approx(1.0)
        rep = acct.report()
        assert rep["prefill"]["waves"] == 1
        assert rep["prefill"]["pad_fraction"] == pytest.approx(0.5)
        assert rep["prefill"]["mfu"] == pytest.approx(1.0)
        assert rep["decode"]["waves"] == 0
        with pytest.raises(ValueError):
            acct.note_wave("warp", 1, 1, 1.0)

    def test_engine_reports_prefill_and_decode_waves(self):
        set_recorder(FlightRecorder(capacity=4096, sample=1.0))
        eng = _tiny_engine("steps-on", step_accounting=True, peak_tflops=1.0)
        eng.generate([list(range(1, 14)), list(range(1, 10))])
        rep = eng.step_acct.report()
        for kind in ("prefill", "decode"):
            assert rep[kind]["waves"] > 0, rep
            assert rep[kind]["mfu"] > 0
            assert 0.0 <= rep[kind]["pad_fraction"] < 1.0
        # The step_wave spans landed on the engine's step lane.
        lanes = {s.lane for s in get_recorder().snapshot()}
        assert "step:steps-on" in lanes


class TestEngineTrace:
    def test_multi_turn_trace_has_request_span_tree(self, tmp_path):
        """A two-turn conversation served with tracing on: the dumped
        Chrome trace validates, and each request carries the span tree
        from admission to finish under its trace id."""
        set_recorder(FlightRecorder(capacity=1 << 15, sample=1.0, node="serve"))
        eng = _tiny_engine("trace-turns")
        rng = np.random.default_rng(0)
        system = rng.integers(1, 256, 8).tolist()
        turn1 = system + rng.integers(1, 256, 4).tolist()
        (out1,) = eng.generate([turn1])
        turn2 = turn1 + out1 + rng.integers(1, 256, 4).tolist()
        eng.generate([turn2])
        path = str(tmp_path / "trace.json")
        assert write_trace(path) > 0
        with open(path) as fh:
            obj = json.load(fh)
        assert bench.validate_trace(obj) == []
        by_trace: dict[int, set] = {}
        for ev in obj["traceEvents"]:
            tid = (ev.get("args") or {}).get("trace_id")
            if ev.get("ph") == "X" and tid:
                by_trace.setdefault(tid, set()).add(ev["name"])
        want = {"prefix_match", "admission_wait", "prefill_wave", "first_token",
                "decode_chunk", "publish", "request_done"}
        assert len(by_trace) == 2 and all(want <= names for names in by_trace.values()), by_trace

    def test_adopted_trace_id_and_restore_span(self):
        """``make_request(trace_id=...)`` adopts the upstream id; a request
        parked for a staged host restore records a ``kv_restore`` span."""
        set_recorder(FlightRecorder(capacity=4096, sample=1e-9))
        eng = _tiny_engine("trace-restore", host_cache_slots=1024, kv_transfer_async=True,
                           kv_transfer_chunk_tokens=16)
        try:
            prompt = list(range(1, 60))
            eng.generate([prompt])
            assert eng.tree.evict(100_000) > 0
            assert eng.kv_transfer.wait_host_ready()
            req = eng.add_request(prompt, trace_id=0xABC)
            assert req.trace is not None and req.trace.trace_id == 0xABC
            while eng.has_work():
                eng.step()
            names = {s.name for s in get_recorder().spans_for_trace(0xABC)}
            assert {"kv_restore", "prefix_match", "request_done"} <= names
        finally:
            eng.close()


class TestEngineWorkloadTrace:
    def test_workload_trace_has_request_span_tree_and_ring_lag(self, tmp_path):
        """A traced multi-turn workload through an engine bound to an
        inproc mesh node: the Chrome trace validates, at least one request
        carries admission, prefill, decode and publish spans, and the ring
        recorded replication-lag spans."""
        import time

        from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
        from radixmesh_tpu_torch.comm.inproc import InprocHub
        from radixmesh_tpu_torch.config import MeshConfig
        from radixmesh_tpu_torch.workload import MultiTurnWorkload, run_engine_workload

        set_recorder(FlightRecorder(capacity=1 << 15, sample=1.0))
        InprocHub.reset_default()
        prefill, decode = ["p0"], ["d0"]
        nodes = []
        try:
            for addr in prefill + decode:
                cfg = MeshConfig(prefill_nodes=prefill, decode_nodes=decode, router_nodes=[],
                                 local_addr=addr, protocol="inproc", tick_interval_s=0.05,
                                 gc_interval_s=30.0)
                nodes.append(MeshCache(cfg, pool=None).start())
            for n in nodes:
                assert n.wait_ready(timeout=10)
            eng = _tiny_engine("trace-mesh", mesh=nodes[0])
            wl = MultiTurnWorkload(n_conversations=2, n_turns=2, system_len=8, user_len=4, gen_len=4,
                                   vocab_size=256)
            report = run_engine_workload(eng, wl)
            assert report["requests"] == 4
            # Replication lag is recorded on d0's receive path: give the
            # ring a moment to lap.
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                if any(s.name == "replication_lag" for s in get_recorder().snapshot()):
                    break
                time.sleep(0.02)
            path = str(tmp_path / "trace.json")
            assert write_trace(path) > 0
        finally:
            for n in nodes:
                n.close()
            InprocHub.reset_default()
        with open(path) as fh:
            obj = json.load(fh)
        assert bench.validate_trace(obj) == []
        by_trace: dict[int, set] = {}
        lag_spans = []
        for ev in obj["traceEvents"]:
            if ev.get("ph") != "X":
                continue
            tid = (ev.get("args") or {}).get("trace_id")
            if tid:
                by_trace.setdefault(tid, set()).add(ev["name"])
            if ev["name"] == "replication_lag":
                lag_spans.append(ev)
        want = {"admission_wait", "prefill_wave", "decode_chunk", "publish"}
        assert any(want <= names for names in by_trace.values()), by_trace
        assert lag_spans, "no ring replication-lag spans recorded"
        assert all(ev["dur"] >= 0 for ev in lag_spans)

    def test_workload_emits_trace_artifact_inline(self, tmp_path):
        from radixmesh_tpu_torch.workload import MultiTurnWorkload, run_engine_workload

        set_recorder(FlightRecorder(capacity=4096, sample=1.0))
        eng = _tiny_engine("trace-artifact")
        wl = MultiTurnWorkload(n_conversations=1, n_turns=2, system_len=8, user_len=4, gen_len=4,
                               vocab_size=256)
        path = str(tmp_path / "wl_trace.json")
        report = run_engine_workload(eng, wl, trace_path=path)
        assert report["trace_artifact"] == path
        assert report["trace_spans"] > 0
        with open(path) as fh:
            assert bench.validate_trace(json.load(fh)) == []


class TestStepPlaneCards:
    def test_flops_model_equals_jax(self):
        from radixmesh_tpu.obs import step_plane as js
        from radixmesh_tpu_torch.obs import step_plane as ts

        for n in (1, 1_000_000, 8_030_261_248):
            assert ts.analytic_flops_per_token(n) == js.analytic_flops_per_token(n)
        # The port's table names the card's rows only.
        assert not any("tpu" in k for k in ts.PEAK_TFLOPS_BY_DEVICE)

    @pytest.mark.parametrize("name, peak", [
        ("NVIDIA H100 80GB HBM3", 989.0),
        ("NVIDIA H100 PCIe", 756.0),
        ("NVIDIA H100 SXM5 80GB", 989.0),
        ("NVIDIA A100-SXM4-80GB", 1.0),
    ])
    def test_h100_rows(self, monkeypatch, name, peak):
        from radixmesh_tpu_torch.obs import step_plane as ts

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)
        assert ts.detect_peak_tflops() == peak
        assert ts.detect_peak_tflops("cuda:0") == peak
        # A CPU engine reads the nominal figure even beside a card.
        assert ts.detect_peak_tflops("cpu") == ts.DEFAULT_PEAK_TFLOPS
        acct = ts.StepAccounting("card", n_params=10**9)
        assert acct.report()["peak_tflops"] == peak

    def test_no_cuda_reads_the_nominal_peak(self, monkeypatch):
        from radixmesh_tpu_torch.obs import step_plane as ts

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert ts.detect_peak_tflops() == ts.DEFAULT_PEAK_TFLOPS == 1.0

    def test_engine_counts_its_parameters(self):
        eng = _tiny_engine("steps-params", step_accounting=True)
        assert eng.step_acct.n_params == sum(p.numel() for p in eng.model.parameters())
        assert eng.step_acct.report()["peak_tflops"] == 1.0  # a CPU engine
