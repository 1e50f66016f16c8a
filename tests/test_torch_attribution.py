"""The port's phase attributor (``radixmesh_tpu_torch/obs/attribution.py``)
held against the JAX package's: ``tests/test_attribution.py``'s cases on
both packages (exclusive decomposition summing to e2e, priority, clipping,
the resurrection and restore-park shapes, the retire hook and histograms,
holed-trace refusal, the vocabulary); the same spans give the same
waterfalls on both (seeded span soups); the same retired traces give the
same ``report()``, per-shape aggregates included; and a traced port engine
behind ``SLORunner`` retires its requests into waterfalls whose phases sum
to e2e, with the ``slo_queue`` leg attributed."""

import numpy as np
import pytest
import torch

from radixmesh_tpu.obs import attribution as jattr
from radixmesh_tpu.obs import metrics as jmetrics
from radixmesh_tpu.obs import trace_plane as jtp
from radixmesh_tpu_torch.obs import attribution as tattr
from radixmesh_tpu_torch.obs import metrics as tmetrics
from radixmesh_tpu_torch.obs import trace_plane as ttp

torch.set_num_threads(1)  # the suite runs in parallel worker processes

PKGS = {"jax": (jattr, jmetrics, jtp), "torch": (tattr, tmetrics, ttp)}
EPS = 1e-9


@pytest.fixture
def planes(request):
    """``planes(pkg) -> (recorder, attributor)``: an isolated registry and a
    traced recorder with an installed attributor, for either package."""
    saved = []

    def make(pkg, capacity=256):
        attr, metrics, tp = PKGS[pkg]
        saved.append((metrics, metrics.set_registry(metrics.Registry()), tp, tp.get_recorder()))
        rec = tp.FlightRecorder(capacity=capacity, sample=1.0, node="t0")
        tp.set_recorder(rec)
        return rec, attr.ensure_attributor(rec)

    yield make
    for metrics, reg, tp, rec in reversed(saved):
        tp.set_recorder(rec)
        metrics.set_registry(reg)


def _span(pkg, name, t0, dur, tid=7, **args):
    return PKGS[pkg][2].Span(name, "req:1", t0, dur, tid, args=args or None, node="t0")


def _retire(pkg, t0, dur, tid=7, **args):
    return _span(pkg, "request_done", t0, dur, tid, **args)


@pytest.mark.parametrize("pkg", sorted(PKGS))
class TestAttributionCases:
    def test_sums_to_e2e_on_gapped_overlapping_spans(self, pkg):
        a = PKGS[pkg][0]
        spans = [_span(pkg, "slo_queue", 0.0, 0.1), _span(pkg, "admission_wait", 0.0, 0.5),
                 _span(pkg, "prefill_wave", 0.2, 0.2), _span(pkg, "decode_chunk", 0.6, 0.3)]
        wf = a.waterfall_from_spans(spans, _retire(pkg, 0.0, 1.0))
        assert abs(sum(wf.phases.values()) - wf.e2e_s) < EPS
        assert wf.phases["slo_queue"] == pytest.approx(0.1)
        assert wf.phases["admission"] == pytest.approx(0.2)
        assert wf.phases[a.RESIDUAL_PHASE] == pytest.approx(0.2)

    def test_priority_and_clipping(self, pkg):
        a = PKGS[pkg][0]
        wf = a.waterfall_from_spans([_span(pkg, "prefill_wave", 0.0, 1.0),
                                     _span(pkg, "decode_chunk", 0.4, 0.2)], _retire(pkg, 0.0, 1.0))
        assert wf.phases["decode"] == pytest.approx(0.2) and wf.phases["prefill"] == pytest.approx(0.8)
        wf = a.waterfall_from_spans([_span(pkg, "decode_chunk", 0.0, 0.5),
                                     _span(pkg, "replication_lag", 0.9, 0.8),
                                     _span(pkg, "mesh_publish", -0.3, 0.4)], _retire(pkg, 0.0, 1.0))
        assert wf.phases["replication"] == pytest.approx(0.1)

    def test_restore_park_and_resurrection_shapes(self, pkg):
        a = PKGS[pkg][0]
        wf = a.waterfall_from_spans(
            [_span(pkg, "admission_wait", 0.0, 0.40), _span(pkg, "kv_restore", 0.05, 0.30),
             _span(pkg, "prefill_wave", 0.40, 0.10), _span(pkg, "decode_chunk", 0.55, 0.40)],
            _retire(pkg, 0.0, 1.0))
        assert wf.phases["restore_park"] == pytest.approx(0.30)
        assert wf.phases[a.RESIDUAL_PHASE] == pytest.approx(0.1)
        wf = a.waterfall_from_spans(
            [_span(pkg, "resurrect", 0.35, 0.20), _span(pkg, "hedge", 0.45, 0.05),
             _span(pkg, "decode_chunk", 0.70, 0.25)], _retire(pkg, 0.0, 1.0))
        assert wf.phases["resurrection"] == pytest.approx(0.20)

    def test_zero_window_and_retire_args(self, pkg):
        a = PKGS[pkg][0]
        wf = a.waterfall_from_spans([_span(pkg, "decode_chunk", 0.0, 1.0)], _retire(pkg, 0.5, 0.0))
        assert wf.e2e_s == 0.0 and sum(wf.phases.values()) == 0.0
        wf = a.waterfall_from_spans([], _retire(pkg, 0.0, 1.0, prompt_tokens=100, output_tokens=7))
        assert (wf.shape, wf.prompt_tokens, wf.output_tokens) == ("p128", 100, 7)
        assert a.shape_bucket(33) == "p64" and a.shape_bucket(1536) == "p2048"
        d = a.Waterfall(trace_id=0xAB, t0=0.0, e2e_s=1.0, phases={p: 0.0 for p in a.PHASES},
                        retire="request_done").as_dict()
        assert d["trace_id"] == f"{0xAB:#018x}" and set(d["phases"]) == set(a.PHASES)

    def test_retire_feeds_histograms_once(self, pkg, planes):
        a, metrics, _ = PKGS[pkg]
        rec, attr = planes(pkg)
        snap = metrics.get_registry().snapshot()
        for phase in a.PHASES:  # every phase series exists from install
            assert f'radixmesh_request_phase_seconds{{phase="{phase}"}}_count' in snap
        ctx = rec.trace("req:1", node="t0")
        ctx.add("admission_wait", 100.0, 0.2, cat="queue")
        ctx.add("decode_chunk", 100.2, 0.8, cat="decode")
        ctx.add("request_done", 100.0, 1.0, cat="scheduler", prompt_tokens=50, output_tokens=9)
        ctx.add("http_request", 99.9, 1.2, cat="http")  # the wider envelope
        st = attr.stats()
        assert (st["audited"], st["refused"]) == (1, 0) and st["max_sum_error_s"] < EPS
        rep = attr.report()
        assert rep["phases"]["decode"]["sum_s"] == pytest.approx(0.8)
        assert rep["by_shape"]["p64"]["count"] == 1
        assert [w["retire"] for w in rep["recent"]] == ["http_request"]
        assert a.ensure_attributor(rec) is attr

    def test_holed_trace_refused(self, pkg, planes):
        metrics = PKGS[pkg][1]
        rec, attr = planes(pkg, capacity=4)
        ctx = rec.trace("req:1", node="t0")
        for i in range(8):
            ctx.add("decode_chunk", float(i), 0.5, cat="decode")
        assert rec.trace_has_drops(ctx.trace_id)
        ctx.add("request_done", 0.0, 8.0)
        assert (attr.stats()["audited"], attr.stats()["refused"]) == (0, 1)
        snap = metrics.get_registry().snapshot()
        assert snap['radixmesh_trace_waterfall_refusals_total{node="t0"}'] == 1

    def test_vocabulary(self, pkg):
        a = PKGS[pkg][0]
        assert all(p in a.PHASE_PRIORITY for p in a.PHASE_OF_SPAN.values())
        assert a.RESIDUAL_PHASE not in a.PHASE_PRIORITY and a.RESIDUAL_PHASE in a.PHASES


def test_vocabularies_are_the_jax_packages():
    assert tattr.PHASES == jattr.PHASES
    assert tattr.PHASE_OF_SPAN == jattr.PHASE_OF_SPAN
    assert tattr.RETIRE_SPANS == jattr.RETIRE_SPANS


def _soup(rng, names, pkg):
    n = int(rng.integers(0, 14))
    spans = [_span(pkg, names[int(rng.integers(len(names)))], float(rng.uniform(-0.2, 1.2)),
                   float(rng.uniform(0.0, 0.6)), prompt_tokens=int(rng.integers(1, 3000)))
             for _ in range(n)]
    return spans, float(rng.uniform(0.01, 2.0))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_spans_give_the_same_waterfalls(seed):
    names = list(jattr.PHASE_OF_SPAN) + ["prefix_match", "first_token"]
    out = {}
    for pkg in ("jax", "torch"):
        rng = np.random.default_rng(seed)
        wfs = []
        for _ in range(150):
            spans, e2e = _soup(rng, names, pkg)
            wf = PKGS[pkg][0].waterfall_from_spans(spans, _retire(pkg, 0.0, e2e, output_tokens=3))
            assert abs(sum(wf.phases.values()) - e2e) < 1e-7
            wfs.append((wf.as_dict(), wf.phases, wf.t0))
        out[pkg] = wfs
    assert out["torch"] == out["jax"]


def test_same_traces_give_the_same_report(planes):
    """Retired traces of several shapes through each package's recorder and
    attributor: the same report, per-shape aggregates included."""
    reports = {}
    for pkg in ("jax", "torch"):
        rec, attr = planes(pkg)
        rng = np.random.default_rng(11)
        names = list(jattr.PHASE_OF_SPAN)
        for i in range(40):
            ctx = rec.trace(f"req:{i}", node="t0")
            t0 = float(i)
            for _ in range(int(rng.integers(1, 8))):
                ctx.add(names[int(rng.integers(len(names)))], t0 + float(rng.uniform(0, 0.8)),
                        float(rng.uniform(0, 0.4)))
            ctx.add("request_done", t0, float(rng.uniform(0.2, 1.0)),
                    prompt_tokens=int(rng.integers(1, 5000)), output_tokens=int(rng.integers(1, 64)))
        rep = attr.report(recent=64)
        for w in rep["recent"]:
            w.pop("trace_id")  # drawn from each recorder's own generator
        reports[pkg] = rep
    assert reports["torch"]["audited"] == 40
    assert reports["torch"] == reports["jax"]


def test_served_requests_retire_into_waterfalls(planes):
    from radixmesh_tpu_torch.engine.engine import Engine
    from radixmesh_tpu_torch.engine.request import SamplingParams
    from radixmesh_tpu_torch.models.llama import ModelConfig, init_params
    from radixmesh_tpu_torch.slo.runner import SLORunner

    rec, attr = planes("torch", capacity=4096)
    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    eng = Engine(cfg, init_params(cfg, seed=2, device="cpu"), num_slots=256, page_size=4, max_batch=2,
                 device="cpu")
    runner = SLORunner(eng).start()
    try:
        reqs = [runner.submit(list(range(1 + i, 40 + i)), SamplingParams(max_new_tokens=5), tenant="a")
                for i in range(3)]
        for r in reqs:
            runner.wait(r, timeout=60)
    finally:
        runner.close()
    st = attr.stats()
    assert st["audited"] == 3 and st["refused"] == 0 and st["max_sum_error_s"] < 1e-6
    rep = attr.report()
    assert rep["phases"]["slo_queue"]["count"] == 3
    assert rep["phases"]["decode"]["sum_s"] > 0 and rep["phases"]["prefill"]["sum_s"] > 0
    assert set(rep["by_shape"]) == {"p64"}
