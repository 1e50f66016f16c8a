"""The port's telemetry history (``radixmesh_tpu_torch/obs/timeseries.py``)
held against the JAX package's: ``tests/test_timeseries.py``'s cases on
both packages (change compression, ring bounds, pruning, the series cap,
the derived seams, the burn feed, cursor pagination on a sample boundary,
self-accounting, the thread); the same registry operations under virtual
time give the same ``query()`` pages on both, page by page; the
``/debug/timeseries`` handlers answer the same cursor errors; and a sample
over a port engine that has served reads no CUDA tensor (``.item()``,
``.cpu()``, ``float()`` of a tensor and ``torch.cuda.synchronize`` all
raise inside ``sample()``)."""

import io
import threading

import numpy as np
import pytest
import torch

from radixmesh_tpu.obs import metrics as jmetrics
from radixmesh_tpu.obs import timeseries as jts
from radixmesh_tpu.server import http_frontend as jfront
from radixmesh_tpu_torch.obs import metrics as tmetrics
from radixmesh_tpu_torch.obs import timeseries as tts
from radixmesh_tpu_torch.server import http_frontend as tfront

torch.set_num_threads(1)  # the suite runs in parallel worker processes

PKGS = {"jax": (jts, jmetrics), "torch": (tts, tmetrics)}


@pytest.fixture(autouse=True)
def fresh_registries():
    old = (jmetrics.set_registry(jmetrics.Registry()), tmetrics.set_registry(tmetrics.Registry()))
    yield
    jmetrics.set_registry(old[0])
    tmetrics.set_registry(old[1])


class FakeFleet:
    def __init__(self):
        self.scores = {0: 1.0, 1: 1.0}
        self.heat = {"7": 50.0, "9": 5.0}

    def health(self):
        return {r: {"score": s, "age_s": 0.1, "reasons": []} for r, s in self.scores.items()}

    def digests(self):
        class D:
            replication_lag_s = 0.05

        return {r: D() for r in self.scores}

    def shard_heat(self):
        mean = sum(self.heat.values()) / len(self.heat)
        return {"shards": dict(self.heat), "skew_score": max(self.heat.values()) / mean,
                "reporters": 2}


class FakeMesh:
    sharded = True

    def __init__(self):
        self.fleet = FakeFleet()


class FakeAcct:
    def report(self):
        return {"prefill": {"mfu": 0.1, "pad_fraction": 0.2, "waves": 3},
                "decode": {"mfu": 0.05, "pad_fraction": 0.0, "waves": 9}}


class FakeEngine:
    step_acct = FakeAcct()


class FakeSLO:
    def __init__(self):
        self.counts = {"t0": {"admitted": 0, "shed": 0}}

    def burn_counts(self):
        return {t: dict(c) for t, c in self.counts.items()}


def _hist(pkg, **kw):
    kw.setdefault("interval_s", 1.0)
    kw.setdefault("capacity", 16)
    return PKGS[pkg][0].TelemetryHistory(**kw)


def _reg(pkg):
    return PKGS[pkg][1].get_registry()


@pytest.mark.parametrize("pkg", sorted(PKGS))
class TestHistoryCases:
    def test_change_compression_flat_series_is_one_point(self, pkg):
        g = _reg(pkg).gauge("radixmesh_test_flag", "t")
        g.set(1.0)
        h = _hist(pkg)
        for t in range(8):
            h.sample(t=float(t))
        pts = h.query(family="radixmesh_test_flag")["series"]["radixmesh_test_flag"]["points"]
        assert len(pts) == 1
        g.set(2.0)
        h.sample(t=8.0)
        pts = h.query(family="radixmesh_test_flag")["series"]["radixmesh_test_flag"]["points"]
        assert [p[2] for p in pts] == [1.0, 2.0]

    def test_capacity_bounds_points(self, pkg):
        c = _reg(pkg).counter("radixmesh_test_total", "t")
        h = _hist(pkg, capacity=8)
        for t in range(50):
            c.inc()
            h.sample(t=float(t))
        pts = h.query(family="radixmesh_test_total")["series"]["radixmesh_test_total"]["points"]
        assert len(pts) == 8 and pts[-1][0] == 49

    def test_vanished_series_pruned_after_a_window(self, pkg):
        h = _hist(pkg, capacity=4, mesh=FakeMesh())
        h.sample(t=0.0)
        assert any(n.startswith("shard:heat") for n in h.query()["series"])
        h.mesh.fleet.heat = {}
        h.mesh.fleet.scores = {}
        for t in range(1, 10):
            h.sample(t=float(t))
        assert not any(n.startswith("shard:heat") for n in h.query()["series"])

    def test_max_series_cap_drops_and_counts_once(self, pkg):
        h = _hist(pkg, max_series=3, capacity=64)
        h.sample(t=0.0)
        first = h.stats()["dropped_series"]
        assert h.stats()["series"] == 3 and first > 0
        for t in range(1, 20):
            h.sample(t=float(t))
        assert h.stats()["dropped_series"] == first

    def test_derived_seams_and_broken_seam(self, pkg):
        slo = FakeSLO()
        slo.counts = {"t0": {"admitted": 10, "shed": 2}}
        h = _hist(pkg, mesh=FakeMesh(), engine=FakeEngine(), slo=slo)
        h.sample(t=0.0)
        s = h.query()["series"]
        assert s['fleet:health_score{rank="0"}']["points"][0][2] == 1.0
        assert s["shard:skew_ratio"]["points"][0][2] == pytest.approx(50.0 / 27.5)
        assert s['step:mfu{kind="prefill"}']["points"][0][2] == 0.1
        assert s['slo:shed{tenant="t0"}']["points"][0][2] == 2.0

        class BrokenMesh:
            sharded = True

            @property
            def fleet(self):
                raise RuntimeError("boom")

        _reg(pkg).counter("radixmesh_test_total", "t").inc()
        h2 = _hist(pkg, mesh=BrokenMesh())
        assert h2.sample(t=0.0) == 0
        assert "radixmesh_test_total" in h2.query()["series"]

    def test_burn_tracker_fed_per_sample(self, pkg):
        slo = FakeSLO()
        h = _hist(pkg, slo=slo)
        calls = []

        class Sink:
            def sample(self, counts, t=None):
                calls.append((dict(counts), t))

        sink = Sink()
        h.bind_burn_tracker(sink)
        h.bind_burn_tracker(sink)  # idempotent
        slo.counts = {"t0": {"admitted": 5, "shed": 1}}
        h.sample(t=42.0)
        assert calls == [({"t0": {"admitted": 5, "shed": 1}}, 42.0)]

    def test_pagination_loop_covers_everything(self, pkg):
        c = _reg(pkg).counter("radixmesh_test_total", "t")
        g = _reg(pkg).gauge("radixmesh_test_flag", "t")
        h = _hist(pkg, capacity=64)
        for t in range(10):
            c.inc()
            g.set(float(t % 2))
            h.sample(t=float(t))
        all_pts = {n: [tuple(p) for p in b["points"]] for n, b in h.query(limit=1 << 62)["series"].items()}
        got: dict[str, list] = {}
        since, pages = -1, 0
        while True:
            page = h.query(since=since, limit=7)
            for n, b in page["series"].items():
                assert all(p[0] <= page["next_since"] for p in b["points"])
                got.setdefault(n, []).extend(tuple(p) for p in b["points"])
            pages += 1
            assert pages < 100
            if not page["has_more"]:
                break
            assert page["next_since"] > since
            since = page["next_since"]
        assert pages > 1
        for n, pts in all_pts.items():
            assert got[n] == pts
        page = h.query(family="radixmesh_test_total", since=h.query()["seq"])
        body = page["series"]["radixmesh_test_total"]
        assert body["points"] == [] and body["last"][1] == 10.0

    def test_self_accounting(self, pkg):
        h = _hist(pkg)
        h.sample(t=0.0)
        h.sample(t=1.0)
        snap = _reg(pkg).snapshot()
        assert snap["radixmesh_history_samples_total"] == 2.0
        assert snap["radixmesh_history_sample_seconds_count"] == 2.0
        assert snap["radixmesh_history_series"] > 0 and snap["radixmesh_history_points"] > 0
        assert "radixmesh_history_dropped_series_total" in snap
        assert h.stats()["sample_seconds_total"] > 0.0
        assert "radixmesh_history_samples_total" in h.query()["series"]

    def test_thread_samples_and_zero_interval_refuses(self, pkg):
        h = _hist(pkg, interval_s=0.01, capacity=32).start()
        try:
            wait = threading.Event()
            for _ in range(200):
                if h.stats()["seq"] >= 2:
                    break
                wait.wait(0.01)
            assert h.stats()["seq"] >= 2
        finally:
            h.close()
        assert h.last_sample_age_s() < 60.0
        with pytest.raises(ValueError):
            _hist(pkg, interval_s=0.0).start()


# The sampler's own cost differs run to run; every other series is a pure
# function of the registry operations.
_OWN_COST = "radixmesh_history_sample_seconds"


def _drive(pkg: str, seed: int) -> list[dict]:
    """Seeded registry operations under virtual time; the pages a client
    paginating with ``limit=9`` reads, and the full query at the end."""
    rng = np.random.default_rng(seed)
    reg = _reg(pkg)
    counters = [reg.counter(f"radixmesh_test_c{i}_total", "t", ("tenant",)) for i in range(3)]
    gauges = [reg.gauge(f"radixmesh_test_g{i}", "t") for i in range(3)]
    hist = reg.histogram("radixmesh_request_ttft_seconds", "t", ("tenant",))
    slo = FakeSLO()
    h = _hist(pkg, capacity=12, slo=slo, engine=FakeEngine(), max_series=40)
    pages, since = [], -1
    for t in range(40):
        for _ in range(int(rng.integers(0, 4))):
            k = int(rng.integers(3))
            counters[k].labels(tenant=f"t{int(rng.integers(3))}").inc(float(rng.integers(1, 5)))
            gauges[k].set(float(rng.integers(0, 3)))
            hist.labels(tenant="t0").observe(float(rng.uniform(0, 2)))
        slo.counts["t0"]["admitted"] += int(rng.integers(0, 2))
        h.sample(t=float(t) * 0.5)
        if t % 5 == 4:
            while True:
                page = h.query(since=since, limit=9)
                pages.append(page)
                if not page["has_more"]:
                    break
                since = page["next_since"]
    pages.append(h.query())
    pages.append(h.query(family="radixmesh_test_c1", since=5, limit=3))
    for page in pages:
        page.pop("wall_offset")
        page["series"] = {n: b for n, b in page["series"].items() if not n.startswith(_OWN_COST)}
        page.pop("points")  # counts the sampler-cost series' points too
    return pages


@pytest.mark.parametrize("seed", [0, 1])
def test_same_operations_give_the_same_pages(seed):
    want, got = _drive("jax", seed), _drive("torch", seed)
    assert len(want) > 10
    assert got == want


class _FakeHandler:
    """Enough of ``BaseHTTPRequestHandler`` for the JAX response helper."""

    def __init__(self, path):
        self.path = path
        self.code = None
        self.wfile = io.BytesIO()

    def send_response(self, code):
        self.code = code

    def send_header(self, *a):
        pass

    def end_headers(self):
        pass


@pytest.mark.parametrize("query", ["?since=banana", "?limit=x", "?since=1.5", "?family=radixmesh&limit=3",
                                   "", "?since=-1&limit=1"])
def test_debug_timeseries_answers_alike(query):
    import json
    from urllib.parse import parse_qs, urlsplit

    answers = {}
    for pkg in ("jax", "torch"):
        _reg(pkg).counter("radixmesh_test_total", "t").inc()
        h = _hist(pkg)
        for t in range(3):
            h.sample(t=float(t))
        if pkg == "jax":
            fake = _FakeHandler("/debug/timeseries" + query)
            jfront._debug_timeseries_response(fake, h)
            code, body = fake.code, json.loads(fake.wfile.getvalue())
        else:
            code, body = tfront._debug_timeseries(h, parse_qs(urlsplit("/d" + query).query))
        if code == 200:
            body.pop("wall_offset")
            body.pop("points")
            body["series"] = {n: b for n, b in body["series"].items() if not n.startswith(_OWN_COST)}
        answers[pkg] = (code, body)
    assert answers["torch"] == answers["jax"]
    fake = _FakeHandler("/debug/timeseries")
    jfront._debug_timeseries_response(fake, None)
    assert (fake.code, tfront._debug_timeseries(None, {})[0]) == (404, 404)


def test_sample_reads_no_cuda_tensor(monkeypatch):
    """The sampler thread must never synchronize the card: with an engine
    that has served (step accounting, the goodput ledger, the spec ledger,
    the SLO controller), a sample touches no tensor value."""
    from radixmesh_tpu_torch.engine.engine import Engine
    from radixmesh_tpu_torch.engine.request import SamplingParams
    from radixmesh_tpu_torch.models.llama import ModelConfig, init_params
    from radixmesh_tpu_torch.slo.runner import SLORunner

    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    eng = Engine(cfg, init_params(cfg, seed=2, device="cpu"), num_slots=256, page_size=4, max_batch=2,
                 device="cpu", step_accounting=True, spec_decode_tokens=2)
    runner = SLORunner(eng).start()
    try:
        req = runner.submit(list(range(1, 30)) * 2, SamplingParams(max_new_tokens=6), tenant="a")
        runner.wait(req, timeout=60)
    finally:
        runner.close()
    h = tts.TelemetryHistory(interval_s=1.0, capacity=8, engine=eng, slo=runner.ctl)

    def refuse(*a, **k):
        raise AssertionError("the sampler read a tensor value")

    for name in ("item", "cpu", "tolist", "numpy", "__float__", "__int__", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    with pytest.raises(AssertionError, match="tensor value"):
        float(torch.ones(1))  # the guard is live
    seq = h.sample(t=0.0)
    monkeypatch.undo()
    series = h.query()["series"]
    assert seq == 0
    assert {'step:mfu{kind="decode"}', "goodput:tokens_per_second", 'slo:admitted{tenant="a"}',
            'radixmesh_slo_admitted_requests_total{tenant="a"}'} <= set(series)
    assert any(n.startswith("radixmesh_engine_") for n in series)
