"""The port's token-level speed plane
(``radixmesh_tpu_torch/obs/token_timeline.py`` and ``obs/spec_ledger.py``):
twins of ``tests/test_token_timeline.py`` — the bounded change-compressed
ITL ring with stall-cause attribution, the speculation ledger with its
adaptive-γ controller, the goodput decomposition, and the engine wiring
(draft-token conservation on every verify path, one-branch no-op when
off) and the SLO tier seam (``note_tier``, which the port's
``slo/runner.py`` calls). Plus the
stall taxonomy and bucket bounds equal to the JAX module's, the
registry series of the ledger, and the engine's stall attribution."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.models import llama as jl
from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.engine.request import SamplingParams
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import ModelConfig
from radixmesh_tpu_torch.obs.token_timeline import (
    DRAFT_SOURCES,
    STALL_CAUSES,
    GoodputLedger,
    SpecLedger,
    TokenTimeline,
)

torch.set_num_threads(1)  # the suite runs in parallel worker processes

PAGE = 4


@pytest.fixture(scope="module")
def model():
    """``tests/test_engine.py``'s model (tiny, float32, PRNGKey(7)),
    converted from the JAX init."""
    jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(7))
    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    return cfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")


def make_engine(model, **kw):
    cfg, params = model
    kw.setdefault("num_slots", 512)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq_len", 128)
    return Engine(cfg, params, device="cpu", **kw)


def prompts_rng():
    return np.random.default_rng(3)


class TestTokenTimelineRing:
    def test_bounded_drop_oldest(self):
        tl = TokenTimeline(capacity=8, node="t")
        for i in range(20):
            # Distinct rids: compression never kicks in.
            tl.note_token(i, "default", 0.001 * (i + 1), now=float(i))
        snap = tl.snapshot(limit=100)
        assert snap["points"] == 20
        assert snap["dropped"] == 12
        assert len(snap["recent"]) == 8
        # Oldest entries fell off; the tail survives in order.
        assert [e["rid"] for e in snap["recent"]] == list(range(12, 20))

    def test_change_compression_bumps_repeats(self):
        tl = TokenTimeline(capacity=64, node="t")
        # Same rid, steady cadence: one slot, repeats climbing.
        for i in range(10):
            tl.note_token(7, "default", 0.002, now=float(i))
        snap = tl.snapshot(limit=64)
        assert snap["appends"] == 10
        assert snap["points"] == 1
        assert snap["compressed"] == 9
        assert snap["recent"][0]["repeats"] == 10

    def test_cadence_change_breaks_compression(self):
        tl = TokenTimeline(capacity=64, node="t")
        tl.note_token(7, "default", 0.002, now=0.0)
        tl.note_token(7, "default", 0.002, now=1.0)
        tl.note_token(7, "default", 0.050, now=2.0)  # 25x: a new regime
        assert tl.snapshot(limit=64)["points"] == 2

    def test_stall_attribution_counts(self):
        tl = TokenTimeline(capacity=64, stall_threshold_s=0.05, node="t")
        for cause in STALL_CAUSES:
            tl.note_token(1, "default", 0.2, cause=cause, now=0.0)
        snap = tl.snapshot(limit=64)
        assert snap["stalls"] == {c: 1 for c in STALL_CAUSES}
        for c in STALL_CAUSES:
            assert snap["stall_seconds"][c] == pytest.approx(0.2)

    def test_per_tenant_percentiles(self):
        tl = TokenTimeline(capacity=256, node="t")
        for i in range(100):
            tl.note_token(i, "acme", 0.004, now=float(i))
        itl = tl.snapshot(limit=0)["itl"]["acme"]
        assert itl["count"] == 100
        assert 0.001 <= itl["p50_s"] <= 0.01
        assert itl["p99_s"] >= itl["p50_s"]

    def test_append_overhead_under_budget_at_1k_tps(self):
        # The tentpole's hot-path bound: the marginal append cost must
        # stay under 1% of wall at a 1k tok/s decode cadence (1 ms per
        # token → < 10 us per append), measured against the same loop
        # paying only the disabled plane's one branch.
        n = 1000
        tl = TokenTimeline(capacity=4096, node="t")
        gaps = np.random.default_rng(0).uniform(0.001, 0.02, size=n)
        t0 = time.perf_counter()
        for i in range(n):
            tl.note_token(i % 8, "default", float(gaps[i]), now=float(i))
        on_s = time.perf_counter() - t0
        off_tl = None
        t0 = time.perf_counter()
        for i in range(n):
            if off_tl is not None:  # the one-branch no-op the engine pays
                off_tl.note_token(i % 8, "default", float(gaps[i]))
        off_s = time.perf_counter() - t0
        fraction = max(0.0, on_s - off_s) / (n * 1e-3)
        assert fraction < 0.01, (
            f"token append costs {fraction:.2%} of wall at 1k tok/s "
            f"(on={on_s:.4f}s off={off_s:.4f}s for {n} appends)"
        )


class TestSpecLedger:
    def test_cold_start_seeds_ewma_at_first_rate(self):
        led = SpecLedger(alpha=0.25, node="t")
        led.note_wave("default", "p32", "ngram", proposed=4, accepted=3,
                      gamma=4)
        c = led.report()["default/p32/ngram"]
        # First wave SEEDS the EWMA at its rate — not alpha-blended
        # from an imaginary zero history.
        assert c["accept_ewma"] == pytest.approx(0.75)
        led.note_wave("default", "p32", "ngram", proposed=4, accepted=0,
                      gamma=4)
        c = led.report()["default/p32/ngram"]
        assert c["accept_ewma"] == pytest.approx(0.75 * 0.75)

    def test_zero_proposed_wave_is_ignored(self):
        led = SpecLedger(node="t")
        led.note_wave("default", "p32", "none", proposed=0, accepted=0,
                      gamma=4)
        assert led.report() == {}

    def test_class_eviction_at_capacity(self):
        led = SpecLedger(max_classes=4, node="t")
        for i in range(4):
            led.note_wave(f"t{i}", "p32", "ngram", 4, 2, 4)
        led.note_wave("fresh", "p32", "ngram", 4, 2, 4)
        rep = led.report()
        assert len(rep) == 4
        # The least-recently-active class (t0) was evicted.
        assert "t0/p32/ngram" not in rep
        assert "fresh/p32/ngram" in rep

    def test_totals_conserve(self):
        led = SpecLedger(node="t")
        led.note_wave("a", "p32", "tree", 5, 5, 5)
        led.note_wave("a", "p32", "ngram", 3, 1, 3)
        t = led.totals()
        assert t["proposed"] == t["accepted"] + t["rejected"] == 8

    def test_draft_sources_vocabulary(self):
        assert set(DRAFT_SOURCES) == {"tree", "ngram", "none"}


class TestAdaptiveGamma:
    def test_off_by_default(self):
        led = SpecLedger(node="t")  # adaptive=False
        for _ in range(20):
            led.note_wave("default", "p32", "ngram", 4, 0, 4)
        # Acceptance is zero, but without --spec-adaptive the base γ is
        # returned untouched.
        assert led.gamma_for("default", "p32", 4) == 4

    def test_shrinks_on_misses_clamped_at_one(self):
        led = SpecLedger(adaptive=True, accept_floor=0.5, node="t")
        for _ in range(20):
            led.note_wave("default", "p32", "ngram", 4, 0, 4)
        assert led.gamma_for("default", "p32", 4) == 1  # never below 1

    def test_grows_on_hits_clamped_at_base(self):
        led = SpecLedger(adaptive=True, accept_ceil=0.8, node="t")
        for _ in range(20):
            led.note_wave("default", "p32", "tree", 4, 4, 4)
        # Every draft lands: γ wants to grow, but the BASE is the cap.
        assert led.gamma_for("default", "p32", 4) == 4

    def test_base_zero_stays_zero(self):
        # SLO tier 1 zeroes the engine's base γ; the controller must
        # never resurrect speculation the ladder turned off.
        led = SpecLedger(adaptive=True, node="t")
        led.note_wave("default", "p32", "tree", 4, 4, 4)
        assert led.gamma_for("default", "p32", 0) == 0

    def test_note_tier_recorded(self):
        led = SpecLedger(node="t")
        assert led.last_tier == 0
        led.note_tier(2)
        assert led.last_tier == 2


class TestGoodputLedger:
    class _Acct:
        def report(self):
            return {
                "prefill": {"real_tokens": 80, "padded_tokens": 100},
                "decode": {"real_tokens": 40, "padded_tokens": 50},
            }

    def test_waste_decomposition(self):
        gp = GoodputLedger(node="t", now=lambda: 10.0)
        spec = SpecLedger(node="t")
        spec.note_wave("default", "p32", "ngram", 10, 4, 4)
        for _ in range(94):
            gp.note_token("default")
        gp.note_stall("default", 2.0)
        rep = gp.report(step_acct=self._Acct(), spec=spec)
        assert rep["useful_tokens"] == 94
        assert rep["padding_tokens"] == 30  # (100-80) + (50-40)
        assert rep["rejected_draft_tokens"] == 6
        # Fractions over processed = useful + padding + rejected = 130.
        assert rep["waste"]["padding"] == pytest.approx(30 / 130, abs=1e-5)
        assert rep["waste"]["rejected_draft"] == pytest.approx(
            6 / 130, abs=1e-5
        )
        assert rep["tenants"]["default"]["stall_seconds"] == pytest.approx(2.0)

    def test_report_without_seams(self):
        gp = GoodputLedger(node="t")
        gp.note_token("default")
        rep = gp.report()
        assert rep["useful_tokens"] == 1
        assert rep["padding_tokens"] == 0
        assert rep["rejected_draft_tokens"] == 0


class TestEngineTokenPlane:
    def test_conservation_on_every_verify_path(self, model):
        # Repetitive prompts generated then REPLAYED: n-gram drafts on
        # pass one, tree-peek drafts on pass two, misses throughout —
        # and proposed == accepted + rejected must hold exactly, on the
        # engine counters AND the per-class ledger, per class and in
        # total.
        cfg, params = model
        eng = make_engine(model, spec_decode_tokens=4)
        base = prompts_rng().integers(1, cfg.vocab_size, 4).tolist()
        prompts = [base * 4, (base * 5)[:18]]
        sp = SamplingParams(temperature=0.0, max_new_tokens=12)
        eng.generate(prompts, sp)
        eng.generate(prompts, sp)
        st = eng.stats
        assert st.spec_proposed > 0
        assert st.spec_proposed == st.spec_accepted + st.spec_rejected
        tot = eng.spec_ledger.totals()
        assert tot["proposed"] == st.spec_proposed
        assert tot["accepted"] == st.spec_accepted
        assert tot["rejected"] == st.spec_rejected
        for c in eng.spec_ledger.report().values():
            assert c["proposed"] == c["accepted"] + c["rejected"]

    def test_timeline_records_tokens(self, model):
        eng = make_engine(model)
        prompt = prompts_rng().integers(1, 64, 8).tolist()
        eng.generate([prompt], SamplingParams(max_new_tokens=8))
        snap = eng.timeline.snapshot(limit=16)
        # The first token's latency is TTFT, not ITL — the other 7
        # inter-token gaps land, and all 8 tokens count as useful.
        assert snap["appends"] == 7
        assert eng.goodput.report()["useful_tokens"] == 8

    def test_timeline_off_is_none(self, model):
        eng = make_engine(model, token_timeline_capacity=0)
        assert eng.timeline is None
        assert eng.goodput is None
        prompt = prompts_rng().integers(1, 64, 8).tolist()
        out = eng.generate([prompt], SamplingParams(max_new_tokens=6))[0]
        assert len(out) == 6  # the disabled plane is a pure no-op

    def test_hint_stall_validates_cause(self, model):
        eng = make_engine(model)
        eng.hint_stall("rebalance_handoff")
        with pytest.raises(ValueError):
            eng.hint_stall("bogus_cause")

    def test_adaptive_flag_threads_to_ledger(self, model):
        assert make_engine(model, spec_adaptive=True).spec_ledger.adaptive
        assert not make_engine(model).spec_ledger.adaptive


class TestAgainstJax:
    def test_taxonomy_and_buckets_equal_jax(self):
        from radixmesh_tpu.obs import token_timeline as jt
        from radixmesh_tpu_torch.obs import token_timeline as tt

        assert tt.STALL_CAUSES == jt.STALL_CAUSES
        assert tt.DRAFT_SOURCES == jt.DRAFT_SOURCES
        assert tt.ITL_SECONDS_BUCKETS == jt.ITL_SECONDS_BUCKETS

    def test_same_tokens_same_snapshot_as_jax(self):
        """The same token sequence gives the same snapshot (ring, stalls,
        per-tenant ITL quantiles) from the JAX timeline and the port's,
        each on a fresh registry of its own package."""
        from radixmesh_tpu.obs import metrics as jm
        from radixmesh_tpu.obs import token_timeline as jt
        from radixmesh_tpu_torch.obs import metrics as tm

        rng = np.random.default_rng(1)
        gaps = rng.uniform(0.0005, 0.2, 300)
        snaps = []
        for cls, mod in ((jt.TokenTimeline, jm), (TokenTimeline, tm)):
            old = mod.get_registry()
            mod.set_registry(mod.Registry())
            try:
                tl = cls(capacity=64, stall_threshold_s=0.05, node="t")
                for i, g in enumerate(gaps):
                    cause = STALL_CAUSES[i % len(STALL_CAUSES)] if g >= 0.05 else None
                    tl.note_token(i % 5, "acme" if i % 2 else "default", float(g), cause,
                                  now=float(i))
                snaps.append(tl.snapshot(limit=64))
            finally:
                mod.set_registry(old)
        assert snaps[0] == snaps[1]


class TestLedgerSeries:
    def test_spec_ledger_lands_on_the_registry(self):
        from radixmesh_tpu_torch.obs.metrics import Registry, get_registry, set_registry

        old = get_registry()
        reg = set_registry(Registry())
        try:
            led = SpecLedger(node="t")
            led.note_wave("a", "p32", "tree", 5, 3, 5)
            led.note_wave("a", "p32", "tree", 2, 2, 2)
            snap = reg.snapshot()
            k = '{shape="p32",source="tree",tenant="a"}'
            assert snap[f"radixmesh_spec_proposed_tokens_total{k}"] == 7
            assert snap[f"radixmesh_spec_accepted_tokens_total{k}"] == 5
            assert snap[f"radixmesh_spec_rejected_tokens_total{k}"] == 2
            assert snap[f"radixmesh_spec_gamma_used_tokens{k}"] == 2
        finally:
            set_registry(old)


class TestStallAttribution:
    def test_causes_in_priority_order(self, model):
        eng = make_engine(model)
        from radixmesh_tpu_torch.engine.request import Request

        req = Request(prompt=np.arange(1, 5, dtype=np.int32))
        now = 100.0
        eng._last_prefill_t = eng._last_inline_prefill_t = 0.0
        assert eng._stall_cause(req, now, 0.1) == "scheduler_wait"
        req.spec_miss = 2
        assert eng._stall_cause(req, now, 0.1) == "spec_verify_miss"
        assert req.spec_miss == 0  # consumed
        eng._last_inline_prefill_t = now - 0.05
        assert eng._stall_cause(req, now, 0.1) == "prefill_inline"
        eng._last_prefill_t = now - 0.05
        assert eng._stall_cause(req, now, 0.1) == "prefill_convoy"
        eng.hint_stall("rebalance_handoff")
        assert eng._stall_cause(req, now, 0.1) == "rebalance_handoff"
        assert eng._stall_cause(req, now, 0.1) == "prefill_convoy"  # the latch is one-shot

    def test_prefill_convoy_attributed_on_a_live_engine(self, model):
        """A long prompt admitted while a row decodes (legacy schedule: the
        whole prefill runs between two decode steps) stretches that row's
        gap past a zero threshold: the gap reads as a prefill convoy."""
        eng = make_engine(model, token_stall_threshold_s=0.0)
        cfg, _ = model
        rng = prompts_rng()
        a = eng.add_request(rng.integers(1, cfg.vocab_size, 8).tolist(),
                            SamplingParams(max_new_tokens=12))
        for _ in range(3):
            eng.step()
        eng.add_request(rng.integers(1, cfg.vocab_size, 90).tolist(),
                        SamplingParams(max_new_tokens=2))
        while eng.has_work():
            eng.step()
        snap = eng.timeline.snapshot(limit=256)
        assert snap["stalls"].get("prefill_convoy", 0) >= 1
        assert len(a.generated) == 12
