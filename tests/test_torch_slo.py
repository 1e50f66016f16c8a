"""The port's SLO control plane (``radixmesh_tpu_torch/slo/``) held against
the JAX package's (``radixmesh_tpu/slo/``).

Controller: each case of ``tests/test_slo.py`` runs on both packages'
``OverloadController`` under a virtual clock, and a seeded random script
of offers, dispatches, first tokens, retirements, cancels, tier updates
and clock advances drives both side by side: the same decisions, reasons,
``retry_after_s``, weighted-fair dispatch order, tier trajectory,
``snapshot()`` and ``radixmesh_slo_*`` series.

Runner (tiny config, float32, CPU, the same weights): ``SLORunner`` on both
engines gives the same greedy tokens at light load (exact); the tier knobs
apply and restore; an end-to-end deadline cancels a running request; close
flushes the queue (QUEUED → FINISHED, shed "shutdown"); a cancel retires
the dispatched backlog and one still in the queue; a rate-limited tenant
sheds with 429 and ``Retry-After``; a submit landing during a long engine
step returns before the step ends; and a request mid inline prefill past
its deadline is not swept on either engine until it is installed in a row.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.engine.engine import Engine as JEngine
from radixmesh_tpu.engine.request import Request as JRequest
from radixmesh_tpu.engine.request import SamplingParams as JSampling
from radixmesh_tpu.models import llama as jl
from radixmesh_tpu.obs import metrics as jmetrics
from radixmesh_tpu.slo import control as jctl
from radixmesh_tpu.slo.runner import SLORunner as JRunner
from radixmesh_tpu_torch.engine.engine import Engine as TEngine
from radixmesh_tpu_torch.engine.request import VALID_TRANSITIONS, RequestState
from radixmesh_tpu_torch.engine.request import Request as TRequest
from radixmesh_tpu_torch.engine.request import SamplingParams as TSampling
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import ModelConfig
from radixmesh_tpu_torch.obs import metrics as tmetrics
from radixmesh_tpu_torch.slo import control as tctl
from radixmesh_tpu_torch.slo.runner import SLORunner as TRunner

torch.set_num_threads(1)  # the suite runs in parallel worker processes

ENGINE_KW = dict(num_slots=512, page_size=4, max_batch=4, max_seq_len=128)
PKGS = {
    "jax": (jctl, JRequest, JSampling, jmetrics),
    "torch": (tctl, TRequest, TSampling, tmetrics),
}


@pytest.fixture(autouse=True)
def fresh_port_registry():
    old = tmetrics.set_registry(tmetrics.Registry())
    yield
    tmetrics.set_registry(old)


class Clock:
    """Manually advanced monotonic clock."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def _req(pkg, tenant, n_tokens, submit_time, ttft_deadline_s=None, max_new_tokens=8):
    _, Request, Sampling, _ = PKGS[pkg]
    req = Request(prompt=np.arange(1, n_tokens + 1, dtype=np.int32),
                  sampling=Sampling(max_new_tokens=max_new_tokens), tenant=tenant,
                  ttft_deadline_s=ttft_deadline_s)
    req.submit_time = submit_time
    return req


def _offer_enqueue(pkg, ctl, clock, tenant, n_tokens, ttft_deadline_s=None):
    dec = ctl.offer(tenant, n_tokens, ttft_deadline_s, now=clock())
    if not dec.admitted:
        return None
    req = _req(pkg, tenant, n_tokens, clock(), ttft_deadline_s)
    ctl.enqueue(req, now=clock())
    return req


# ---------------------------------------------------------------------------
# The controller, case by case on both packages (tests/test_slo.py's cases)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", sorted(PKGS))
class TestControllerCases:
    def test_burst_then_rate_limits(self, pkg):
        c = PKGS[pkg][0]
        clock = Clock()
        ctl = c.OverloadController(
            c.SLOConfig(tenants={"t": c.TenantConfig(rate_tokens_per_s=100, burst_tokens=250)}),
            clock=clock)
        assert ctl.offer("t", 100, now=clock()).admitted
        assert ctl.offer("t", 100, now=clock()).admitted
        dec = ctl.offer("t", 100, now=clock())
        assert not dec.admitted and dec.reason == c.SHED_RATE_LIMITED
        assert dec.retry_after_s == pytest.approx(0.5)
        clock.advance(0.6)
        assert ctl.offer("t", 100, now=clock()).admitted

    def test_over_burst_prompt_is_nonretriable_413(self, pkg):
        c = PKGS[pkg][0]
        clock = Clock()
        ctl = c.OverloadController(c.SLOConfig(tenants={"t": c.TenantConfig(rate_tokens_per_s=100)}),
                                   clock=clock)
        dec = ctl.offer("t", 150, now=clock())
        assert not dec.admitted and dec.reason == c.SHED_OVER_BURST and dec.retry_after_s is None
        assert c.RequestShed(dec.reason, None, "t").http_status == 413
        assert ctl.offer("t", 100, now=clock()).admitted

    def test_queue_full_sheds(self, pkg):
        c = PKGS[pkg][0]
        clock = Clock()
        ctl = c.OverloadController(c.SLOConfig(max_queue_requests=2), clock=clock)
        assert _offer_enqueue(pkg, ctl, clock, "a", 8) is not None
        assert _offer_enqueue(pkg, ctl, clock, "a", 8) is not None
        dec = ctl.offer("a", 8, now=clock())
        assert not dec.admitted and dec.reason == c.SHED_QUEUE_FULL

    def test_dispatch_order_tracks_weights(self, pkg):
        c = PKGS[pkg][0]
        clock = Clock()
        ctl = c.OverloadController(c.SLOConfig(tenants={"heavy": c.TenantConfig(weight=3.0),
                                                        "light": c.TenantConfig(weight=1.0)}),
                                   clock=clock)
        for _ in range(40):
            _offer_enqueue(pkg, ctl, clock, "heavy", 10)
            _offer_enqueue(pkg, ctl, clock, "light", 10)
        served = {"heavy": 0, "light": 0}
        for _ in range(20):
            req = ctl.pop_ready(now=clock())
            served[req.tenant] += len(req.prompt)
        assert served["heavy"] + served["light"] == 200
        assert abs(served["heavy"] - 150) <= 10

    def test_bursty_tenant_cannot_convoy_steady_one(self, pkg):
        c = PKGS[pkg][0]
        clock = Clock()
        ctl = c.OverloadController(c.SLOConfig(), clock=clock)
        for _ in range(100):
            _offer_enqueue(pkg, ctl, clock, "bursty", 10)
        late = _offer_enqueue(pkg, ctl, clock, "steady", 10)
        order = [ctl.pop_ready(now=clock()) for _ in range(3)]
        assert any(r is late for r in order)

    def test_deadline_admission_and_dispatch_recheck(self, pkg):
        c = PKGS[pkg][0]
        clock = Clock()
        ctl = c.OverloadController(c.SLOConfig(), clock=clock)
        assert ctl.offer("a", 10_000, ttft_deadline_s=0.001, now=clock()).admitted  # uncalibrated
        ctl.observe_service(1000, 1.0)
        stale = _offer_enqueue(pkg, ctl, clock, "a", 100, ttft_deadline_s=0.5)
        fresh = _offer_enqueue(pkg, ctl, clock, "a", 100)
        for _ in range(18):
            _offer_enqueue(pkg, ctl, clock, "a", 100)
        dec = ctl.offer("a", 100, ttft_deadline_s=0.5, now=clock())
        assert not dec.admitted and dec.reason == c.SHED_DEADLINE and dec.retry_after_s > 0
        clock.advance(1.0)
        assert ctl.pop_ready(now=clock()) is fresh
        assert stale.shed and stale.shed_reason == c.SHED_DISPATCH_DEADLINE
        assert ctl.drain_shed() == [stale]

    def test_cancel_before_first_token_retires_backlog(self, pkg):
        c = PKGS[pkg][0]
        clock = Clock()
        ctl = c.OverloadController(c.SLOConfig(), clock=clock)
        ctl.observe_service(1000, 1.0)
        req = _offer_enqueue(pkg, ctl, clock, "a", 500)
        assert ctl.pop_ready(now=clock()) is req
        assert ctl.est_wait_s() == pytest.approx(0.5)
        req.admit_time = clock()
        ctl.note_retired(req, now=clock())
        assert ctl.est_wait_s() == 0.0
        ctl.note_first_token(req, now=clock.advance(0.1))
        assert ctl._dispatched_tokens == 0 and req.slo_retired

    def test_tier_ladder_up_and_down_with_hysteresis(self, pkg):
        c = PKGS[pkg][0]
        clock = Clock()
        ctl = c.OverloadController(c.SLOConfig(tier_backlog_s=(0.5, 1.5, 3.0), tier_up_hold_s=0.1,
                                               tier_down_hold_s=1.0), clock=clock)
        ctl.observe_service(1000, 1.0)
        for _ in range(40):
            _offer_enqueue(pkg, ctl, clock, "a", 100)
        assert ctl.update_tier(now=clock()) == 0
        clock.advance(0.2)
        assert ctl.update_tier(now=clock()) == 3
        while ctl.pop_ready(now=clock()) is not None:
            pass
        for _ in range(40):
            req = _req(pkg, "a", 100, clock())
            req.admit_time = clock()
            ctl.note_first_token(req, now=clock.advance(0.001))
        assert ctl.update_tier(now=clock()) == 3
        clock.advance(1.1)
        assert ctl.update_tier(now=clock()) == 0
        assert [(old, new) for _, old, new, _ in ctl.tier_events] == [(0, 3), (3, 0)]

    def test_metrics_and_snapshot(self, pkg):
        c, _, _, metrics = PKGS[pkg]
        old = metrics.set_registry(metrics.Registry())
        try:
            clock = Clock()
            ctl = c.OverloadController(
                c.SLOConfig(tenants={"t": c.TenantConfig(rate_tokens_per_s=10, burst_tokens=10)}),
                clock=clock)
            assert _offer_enqueue(pkg, ctl, clock, "t", 8) is not None
            assert not ctl.offer("t", 8, now=clock()).admitted
            ctl.pop_ready(now=clock())
            snap = metrics.get_registry().snapshot()
            assert snap['radixmesh_slo_admitted_requests_total{tenant="t"}'] == 1
            assert snap['radixmesh_slo_shed_requests_total{reason="rate_limited",tenant="t"}'] == 1
            assert "radixmesh_slo_admission_wait_seconds_bucket" in metrics.get_registry().render()
            assert {"tier", "backlog_tokens", "est_wait_s", "tenants", "total_admitted",
                    "total_shed"} <= set(ctl.snapshot())
        finally:
            metrics.set_registry(old)

    def test_config_validation_and_http_mapping(self, pkg):
        c = PKGS[pkg][0]
        with pytest.raises(ValueError):
            c.TenantConfig(weight=0)
        with pytest.raises(ValueError):
            c.SLOConfig(tier_backlog_s=(3.0, 1.0, 2.0))
        assert c.RequestShed(c.SHED_RATE_LIMITED).http_status == 429
        assert c.RequestShed(c.SHED_DEADLINE).http_status == 503
        assert c.OVERFLOW_TENANT == "__overflow__"


def _script(pkg: str, seed: int) -> dict:
    """A seeded random run of every controller operation under a virtual
    clock; returns what each step answered, in package-neutral terms
    (requests by their index of creation)."""
    c, _, _, metrics = PKGS[pkg]
    old = metrics.set_registry(metrics.Registry())
    try:
        rng = np.random.default_rng(seed)
        clock = Clock(100.0)
        cfg = c.SLOConfig(
            tenants={"heavy": c.TenantConfig(weight=3.0), "light": c.TenantConfig(weight=1.0),
                     "capped": c.TenantConfig(rate_tokens_per_s=400, burst_tokens=600)},
            max_queue_requests=48, max_tenants=5, tier_backlog_s=(0.3, 0.8, 1.6),
            tier_up_hold_s=0.05, tier_down_hold_s=0.3,
        )
        ctl = c.OverloadController(cfg, clock=clock)
        reqs, queued, dispatched, trace = [], [], [], []
        index = {}

        def drop(lst, req):  # by identity: dataclass equality compares prompt arrays
            for i, r in enumerate(lst):
                if r is req:
                    del lst[i]
                    return
        names = ["heavy", "light", "capped", "dyn0", "dyn1", "dyn2", "dyn3"]
        for step in range(600):
            op = rng.choice(["offer", "offer", "offer", "pop", "pop", "first", "retire", "tier",
                             "advance", "cancel", "shed"])
            if op == "offer":
                tenant = names[int(rng.integers(len(names)))]
                n = int(rng.integers(1, 400))
                deadline = [None, 0.2, 1.0, 4.0][int(rng.integers(4))]
                e2e = [None, None, 0.5][int(rng.integers(3))]
                dec = ctl.offer(tenant, n, deadline, now=clock())
                trace.append(("offer", dec.admitted, dec.reason,
                              None if dec.retry_after_s is None else round(dec.retry_after_s, 9),
                              round(dec.est_wait_s, 9)))
                if dec.admitted:
                    req = _req(pkg, tenant, n, clock(), deadline)
                    req.e2e_deadline_s = e2e
                    index[id(req)] = len(reqs)
                    reqs.append(req)
                    queued.append(req)
                    ctl.enqueue(req, now=clock())
            elif op == "pop":
                req = ctl.pop_ready(now=clock())
                trace.append(("pop", None if req is None else index[id(req)]))
                if req is not None:
                    drop(queued, req)
                    req.admit_time = clock()
                    dispatched.append(req)
            elif op in ("first", "retire") and dispatched:
                req = dispatched.pop(int(rng.integers(len(dispatched))))
                if op == "first":
                    req.prefix_len = int(rng.integers(0, len(req.prompt)))
                    ctl.note_first_token(req, now=clock())
                else:
                    ctl.note_retired(req, now=clock())
                trace.append((op, index[id(req)], ctl.snapshot()["prefill_tok_s_ewma"]))
            elif op == "tier":
                trace.append(("tier", ctl.update_tier(now=clock())))
            elif op == "advance":
                clock.advance(float(rng.uniform(0.0, 0.15)))
            elif op == "cancel" and queued:
                req = queued[int(rng.integers(len(queued)))]
                got = ctl.cancel_queued(req.rid)
                trace.append(("cancel", None if got is None else index[id(got)]))
                drop(queued, req)
            elif op == "shed":
                shed = ctl.drain_shed()
                for r in shed:
                    drop(queued, r)
                trace.append(("shed", [(index[id(r)], r.shed_reason) for r in shed]))
            if step == 300:
                ctl.observe_service(2000, 1.0)  # calibrate half way through
        flushed = ctl.flush()
        trace.append(("flush", [(index[id(r)], r.shed_reason) for r in flushed]))
        slo = {k: v for k, v in metrics.get_registry().snapshot().items()
               if k.startswith("radixmesh_slo_") and "wait_seconds" not in k}
        return {"trace": trace, "snapshot": ctl.snapshot(), "tier_events": ctl.tier_events,
                "admitted_tokens": ctl.admitted_tokens_by_tenant(), "burn": ctl.burn_counts(),
                "series": slo}
    finally:
        metrics.set_registry(old)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controllers_decide_alike_under_one_clock(seed):
    want, got = _script("jax", seed), _script("torch", seed)
    kinds = {t[0] for t in want["trace"]}
    assert {"offer", "pop", "first", "tier"} <= kinds
    assert any(t[0] == "offer" and not t[1] for t in want["trace"]), "no shed in the script"
    assert got["trace"] == want["trace"]
    assert got["tier_events"] == want["tier_events"]
    assert got["snapshot"] == want["snapshot"]
    assert got["admitted_tokens"] == want["admitted_tokens"]
    assert got["burn"] == want["burn"]
    assert got["series"] == want["series"]


# ---------------------------------------------------------------------------
# SLORunner over both engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """``make(**kw) -> (jax_engine, port_engine)`` on the same weights."""
    jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(7))
    tcfg = ModelConfig.tiny().replace(dtype=torch.float32)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")

    def make(**kw):
        kw = {**ENGINE_KW, **kw}
        return JEngine(jcfg, jparams, **kw), TEngine(tcfg, tparams, device="cpu", **kw)

    return make


def _port(pair, **kw):
    return pair(**kw)[1]


def test_light_load_matches_jax_and_sheds_nothing(pair):
    jeng, teng = pair()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 512, n).tolist() for n in (7, 13, 19)]
    outs = {}
    for name, eng, Runner, Sampling in (("jax", jeng, JRunner, JSampling),
                                        ("torch", teng, TRunner, TSampling)):
        runner = Runner(eng, PKGS[name][0].SLOConfig()).start()
        try:
            reqs = [runner.submit(p, Sampling(max_new_tokens=5), tenant=t)
                    for p, t in zip(prompts, ("a", "b", "a"))]
            outs[name] = [runner.wait(r, timeout=120) for r in reqs]
            snap = runner.ctl.snapshot()
            assert (snap["total_shed"], snap["tier"], snap["total_admitted"]) == (0, 0, 3)
            assert snap["prefill_tok_s_ewma"] is not None  # first tokens fed the EWMA
        finally:
            runner.close()
    assert outs["torch"] == outs["jax"]


def test_rate_limited_tenant_sheds_with_retry_after(pair):
    eng = _port(pair)
    runner = TRunner(eng, tctl.SLOConfig(
        tenants={"free": tctl.TenantConfig(rate_tokens_per_s=0.1, burst_tokens=24)})).start()
    try:
        rng = np.random.default_rng(6)
        ok = runner.submit(rng.integers(1, 512, 20).tolist(), TSampling(max_new_tokens=3), tenant="free")
        runner.wait(ok, timeout=120)
        with pytest.raises(tctl.RequestShed) as exc:
            runner.submit(rng.integers(1, 512, 20).tolist(), TSampling(max_new_tokens=3), tenant="free")
        assert exc.value.http_status == 429 and exc.value.retry_after_s > 0
    finally:
        runner.close()


def test_tier_knobs_apply_and_restore(pair):
    """Force the ladder to tier 3 on both runners: spec decode off, the
    wave width shrunk, dispatched requests capped; back to tier 0 after
    the hold, every knob restored. The two runners step alike."""
    jeng, teng = pair(spec_decode_tokens=3)
    seen = {}
    for name, eng, Runner in (("jax", jeng, JRunner), ("torch", teng, TRunner)):
        c = PKGS[name][0]
        base_wave = eng.prefill_wave_tokens
        clock = Clock()
        runner = Runner(eng, c.SLOConfig(tier_backlog_s=(0.5, 1.5, 3.0), tier_up_hold_s=0.0,
                                         tier_down_hold_s=0.5, tier2_max_new_tokens=2), clock=clock)
        ctl = runner.ctl
        ctl.observe_service(1000, 1.0)
        queued = []
        for _ in range(40):
            req = _req(name, "a", 100, clock(), max_new_tokens=50)
            ctl.enqueue(req, now=clock())
            queued.append(req)
        runner._pump()
        assert runner._applied_tier == 3
        assert eng.spec_decode_tokens == 0 and eng.prefill_wave_tokens < base_wave
        assert eng.spec_ledger.last_tier == 3
        dispatched = [r for r in queued if any(r is w for w in eng.waiting)]
        assert dispatched and all(r.sampling.max_new_tokens == 2 and r.degradation_tier == 3
                                  for r in dispatched)
        while ctl.pop_ready(now=clock()) is not None:
            pass
        for r in queued:
            r.admit_time = clock()
            ctl.note_first_token(r, now=clock())
        runner._pump()
        assert runner._applied_tier == 3
        clock.advance(0.6)
        runner._pump()
        assert runner._applied_tier == 0
        assert eng.spec_decode_tokens == 3 and eng.prefill_wave_tokens == base_wave
        seen[name] = (len(dispatched), eng.prefill_wave_tokens, ctl.tier_events)
        eng.waiting.clear()  # never stepped; drop the fabricated requests
    assert seen["torch"] == seen["jax"]


def test_e2e_deadline_cancels_running_request(pair):
    eng = _port(pair)
    runner = TRunner(eng, tctl.SLOConfig()).start()
    try:
        req = runner.submit(np.arange(1, 11).tolist(), TSampling(max_new_tokens=120), tenant="a",
                            e2e_deadline_s=0.05)
        out = runner.wait(req, timeout=120)
        assert req.cancelled and req.shed and req.shed_reason == "e2e_deadline"
        assert len(out) < 120
    finally:
        runner.close()


def test_close_flushes_queued_requests(pair):
    eng = _port(pair)
    runner = TRunner(eng, tctl.SLOConfig())  # not started: nothing drains
    req = runner.submit(np.arange(1, 11).tolist(), TSampling(max_new_tokens=4))
    assert req.state is RequestState.QUEUED
    runner.close()
    assert req.state is RequestState.FINISHED
    assert (RequestState.QUEUED, RequestState.FINISHED) in VALID_TRANSITIONS
    assert req.shed and req.shed_reason == "shutdown" and req.cancelled
    with pytest.raises(RuntimeError, match="shut down"):
        runner.submit([1, 2, 3], TSampling(max_new_tokens=1))


def test_cancel_retires_dispatched_backlog_and_queued_requests(pair):
    eng = _port(pair)
    runner = TRunner(eng, tctl.SLOConfig())  # not started: manual pump
    runner.ctl.observe_service(1000, 1.0)
    req = runner.submit(np.arange(1, 11).tolist(), TSampling(max_new_tokens=4))
    with runner._lock:
        runner._pump()  # dispatch into engine.waiting, admit_time set
    assert req.admit_time > 0 and runner.ctl.snapshot()["backlog_tokens"] == 10
    assert runner.cancel(req.rid) and req.cancelled
    assert runner.ctl.snapshot()["backlog_tokens"] == 0
    # Still in the WFQ: the controller's lock alone retires it.
    queued = runner.submit(np.arange(1, 8).tolist(), TSampling(max_new_tokens=4))
    assert runner.ctl.snapshot()["queued_requests"] == 1
    assert runner.cancel(queued.rid)
    assert queued.state is RequestState.FINISHED and queued.cancelled
    assert runner.ctl.snapshot()["queued_requests"] == 0
    assert not runner.cancel(10**9)
    runner.close()


def test_submit_does_not_wait_for_a_running_step(pair):
    """A submit that lands while the runner holds the step lock returns
    before the step ends: it takes only the controller's lock."""
    eng = _port(pair)
    runner = TRunner(eng, tctl.SLOConfig()).start()
    entered, release = threading.Event(), threading.Event()
    step = eng.step

    def slow_step():
        entered.set()
        release.wait(timeout=30)
        step()

    eng.step = slow_step
    try:
        first = runner.submit(np.arange(1, 11).tolist(), TSampling(max_new_tokens=2))
        assert entered.wait(timeout=30), "the runner never stepped"
        t0 = time.monotonic()
        second = runner.submit(np.arange(5, 15).tolist(), TSampling(max_new_tokens=2), tenant="b")
        took = time.monotonic() - t0
        assert not release.is_set()
        assert took < 5.0, f"submit waited {took:.2f}s for the step"
        assert runner.ctl.snapshot()["queued_requests"] == 1  # queued while the step runs
        release.set()
        assert len(runner.wait(first, timeout=60)) == 2
        assert len(runner.wait(second, timeout=60)) == 2
    finally:
        release.set()
        eng.step = step
        runner.close()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_inline_prefill_is_not_swept_until_installed(pair, pkg):
    """Both runners sweep ``waiting``, ``_restoring`` and ``_rows`` only: a
    request in the mixed-wave inline backlog past its end-to-end deadline
    is cancelled at the first sweep after its install, not before."""
    engines = dict(zip(("jax", "torch"), pair(prefill_inline_budget=8)))
    eng = engines[pkg]
    Runner, Sampling = (JRunner, JSampling) if pkg == "jax" else (TRunner, TSampling)
    clock = Clock(10.0)
    runner = Runner(eng, PKGS[pkg][0].SLOConfig(), clock=clock)
    long = runner.submit(np.arange(1, 9).tolist(), Sampling(max_new_tokens=60))
    with runner._lock:
        runner._pump()
    eng.step()  # the long request prefills and decodes
    late = runner.submit(np.arange(20, 60).tolist(), Sampling(max_new_tokens=4), e2e_deadline_s=1.0)
    with runner._lock:
        runner._pump()
    eng.step()  # admission parks it in the inline backlog; one budgeted slice
    assert [j.req for j in eng._inline] == [late]
    clock.advance(5.0)  # far past its deadline
    with runner._lock:
        runner._pump()
    assert not late.cancelled and late.state is not RequestState.FINISHED
    for _ in range(20):
        if not eng._inline:
            break
        eng.step()
    assert any(r is late for r in eng._rows), "the inline prefill never installed"
    with runner._lock:
        runner._pump()
    assert late.cancelled and late.shed_reason == "e2e_deadline"
    assert not long.cancelled  # no deadline: never swept
    runner.close()


@pytest.mark.parametrize("spacing_s", [0.0, 20e-6])
def test_one_finalize_of_first_tokens_folds_alike(spacing_s):
    """Reference behaviour both controllers share: when a wave's first
    tokens are recorded in one finalize (callbacks microseconds apart), the
    window closes at the first callback with one request's tokens over the
    wave's wall, and the drained branch folds the rest over the spacing
    between callbacks; with no spacing it does not fold them at all."""
    ewmas = {}
    for pkg in ("jax", "torch"):
        c = PKGS[pkg][0]
        clock = Clock()
        ctl = c.OverloadController(c.SLOConfig(), clock=clock)
        reqs = [_offer_enqueue(pkg, ctl, clock, "a", 2000) for _ in range(8)]
        for r in reqs:
            assert ctl.pop_ready(now=clock()) is r
            r.admit_time = clock()
        seen = []
        for i, r in enumerate(reqs):
            ctl.note_first_token(r, now=0.7 + i * spacing_s)
            seen.append(ctl.snapshot()["prefill_tok_s_ewma"])
        ewmas[pkg] = seen
    assert ewmas["torch"] == ewmas["jax"]
    first = ewmas["torch"][0]
    assert first == pytest.approx(2000 / 0.7, abs=0.1)
    if spacing_s:
        assert ewmas["torch"][-1] > 1e7  # 14000 tokens over 140 µs, at alpha 0.3
    else:
        assert ewmas["torch"][-1] == first
