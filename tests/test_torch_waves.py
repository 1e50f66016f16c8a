"""Mixed prefill+decode waves in the port: the wave scheduler's invariants
on the port's copy (budget, starvation bound, shortest-remaining-first
allotment, accounting), the same plans as the JAX package's scheduler on
the same backlog sequences, and the engine under
``prefill_inline_budget`` held against the JAX ``Engine`` under the same
flags (tiny config, float32, CPU, the same weights): greedy outputs
token-exact, equal to the legacy schedule's, composed with speculative
decode, exact chunk resume offsets, a cancel mid-inline that releases
everything, the starvation bound in virtual time, and the paged-vs-dense
crossover's recorded decision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from radixmesh_tpu.engine.engine import Engine as JEngine
from radixmesh_tpu.engine.request import SamplingParams as JSampling
from radixmesh_tpu.engine.waves import WaveScheduler as JWaveScheduler
from radixmesh_tpu.models import llama as jl
from radixmesh_tpu_torch.engine.engine import Engine as TEngine
from radixmesh_tpu_torch.engine.request import RequestState, SamplingParams as TSampling
from radixmesh_tpu_torch.engine.waves import WAVE_KINDS, WavePlan, WaveScheduler
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import ModelConfig
from radixmesh_tpu_torch.ops.attention import batch_bucket, last_dispatch, select_paged

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)  # the suite runs in parallel worker processes

ENGINE_KW = dict(num_slots=512, page_size=4, max_batch=4, max_seq_len=128)


def make(budget=32, max_defer=2, chunk=512, boost=128):
    return WaveScheduler(inline_budget=budget, max_defer=max_defer, chunk=chunk, boost_tokens=boost)


class TestBudgetInvariant:
    def test_mixed_wave_never_exceeds_budget(self):
        rng = np.random.default_rng(0)
        ws = make(budget=32, boost=10_000)  # boost unreachable
        for _ in range(200):
            backlog = rng.integers(0, 400, size=rng.integers(1, 6)).tolist()
            plan = ws.plan(decode_rows=2, backlog=backlog)
            assert plan.kind in WAVE_KINDS
            assert sum(plan.allot) <= ws.inline_budget
            for a, r in zip(plan.allot, backlog):
                assert 0 <= a <= min(r, ws.chunk)

    def test_boost_wave_bounded_by_boost_tokens(self):
        ws = make(budget=32, boost=128)
        plan = ws.plan(decode_rows=1, backlog=[500, 500])
        assert plan.kind == "boost" and not plan.decode
        assert sum(plan.allot) <= ws.boost_tokens

    def test_chunk_caps_single_job_share(self):
        ws = make(budget=4096, chunk=512, boost=100_000)
        assert ws.plan(decode_rows=1, backlog=[10_000]).allot == [512]

    def test_zero_budget_rejected(self):
        with pytest.raises(ValueError):
            WaveScheduler(inline_budget=0)


class TestStarvationBound:
    def test_defer_never_exceeds_bound_under_adversarial_backlog(self):
        ws = make(budget=32, max_defer=2, boost=128)
        consecutive = 0
        for _ in range(100):
            plan = ws.plan(decode_rows=3, backlog=[10_000, 10_000])
            ws.note(plan)
            consecutive = 0 if plan.decode else consecutive + 1
            assert consecutive <= ws.max_defer
        assert ws.max_defer_observed <= ws.max_defer
        assert ws.counts["boost"] > 0

    def test_mixed_wave_always_carries_decode(self):
        plan = make(budget=32, boost=10_000).plan(decode_rows=2, backlog=[40])
        assert plan.kind == "mixed" and plan.decode

    def test_pure_prefill_waves_do_not_charge_the_bound(self):
        ws = make(budget=32, max_defer=1, boost=128)
        for _ in range(5):
            plan = ws.plan(decode_rows=0, backlog=[10_000])
            assert plan.kind == "prefill"
            ws.note(plan)
        assert ws.max_defer_observed == 0

    def test_max_defer_zero_disables_boost(self):
        plan = make(budget=32, max_defer=0, boost=128).plan(decode_rows=1, backlog=[10_000])
        assert plan.kind == "mixed" and plan.decode


class TestAllotmentPolicy:
    def test_shortest_remaining_first(self):
        assert make(budget=32, boost=10_000).plan(1, [100, 16, 20]).allot == [0, 16, 16]

    def test_fifo_tiebreak_on_equal_remaining(self):
        assert make(budget=16).plan(1, [16, 16]).allot == [16, 0]

    def test_empty_backlog_plans_pure_decode(self):
        plan = make().plan(decode_rows=2, backlog=[])
        assert plan.kind == "decode" and plan.decode and plan.allot == []

    def test_drained_jobs_get_zero(self):
        assert make(budget=32).plan(1, [0, 10]).allot == [0, 10]


class TestAccounting:
    def test_note_and_snapshot_roundtrip(self):
        ws = make(budget=32, boost=128)
        ws.note(WavePlan("mixed", [16, 8], True))
        ws.note(WavePlan("boost", [128], False))
        ws.note(WavePlan("mixed", [4], True))
        snap = ws.snapshot()
        assert snap["counts"]["mixed"] == 2 and snap["counts"]["boost"] == 1
        assert snap["inline_tokens"] == 16 + 8 + 128 + 4
        assert snap["decode_defer"] == 0
        assert snap["max_defer_observed"] == 1
        assert snap["budget"] == 32 and snap["max_defer"] == 2

    def test_boost_floor_is_inline_budget(self):
        assert WaveScheduler(inline_budget=256, boost_tokens=64).boost_tokens == 256


@settings(max_examples=150, deadline=None)
@given(
    budget=st.integers(1, 600),
    max_defer=st.integers(0, 4),
    chunk=st.integers(1, 700),
    boost=st.integers(1, 2000),
    waves=st.lists(
        st.tuples(st.integers(0, 8), st.lists(st.integers(0, 3000), max_size=6)),
        min_size=1, max_size=12,
    ),
)
def test_same_plans_as_jax(budget, max_defer, chunk, boost, waves):
    """Both packages' schedulers, fed the same backlog sequences, plan the
    same waves and keep the same accounting."""
    kw = dict(inline_budget=budget, max_defer=max_defer, chunk=chunk, boost_tokens=boost)
    t, j = WaveScheduler(**kw), JWaveScheduler(**kw)
    for decode_rows, backlog in waves:
        tp, jp = t.plan(decode_rows, backlog), j.plan(decode_rows, backlog)
        assert (tp.kind, tp.allot, tp.decode) == (jp.kind, jp.allot, jp.decode)
        t.note(tp)
        j.note(jp)
        assert t.snapshot() == j.snapshot()


# ---------------------------------------------------------------------------
# the engine under mixed waves, against the JAX engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """``make(**kw) -> (jax_engine, port_engine)`` on the same weights."""
    jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(7))
    tcfg = ModelConfig.tiny().replace(dtype=torch.float32)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")

    def make_pair(**kw):
        kw = {**ENGINE_KW, **kw}
        return JEngine(jcfg, jparams, **kw), TEngine(tcfg, tparams, device="cpu", **kw)

    return make_pair


def repetitive_prompt(n_tokens: int, seed: int, vocab: int = 512) -> list[int]:
    head = np.random.default_rng(seed).integers(1, vocab - 1, size=4)
    return (list(map(int, head)) * ((n_tokens // 4) + 1))[:n_tokens]


def staggered_run(eng, sampling_cls, prompts, lead_steps=3, cap=600, **sampling):
    """The first prompt admitted and decoding, the rest arriving mid-decode
    (the arrival pattern that exposes the convoy). Returns the outputs and
    each request's ``prefix_len``."""
    samp = sampling_cls(**sampling)
    reqs = [eng.add_request(prompts[0], samp)]
    for _ in range(lead_steps):
        eng.step()
    reqs += [eng.add_request(p, samp) for p in prompts[1:]]
    steps = 0
    while eng.has_work() and steps < cap:
        eng.step()
        steps += 1
    assert not eng.has_work(), "engine failed to drain"
    return [(list(map(int, r.output_tokens)), r.prefix_len) for r in reqs]


def _both(pair, prompts, run_kw=None, **engine_kw):
    jeng, teng = pair(**engine_kw)
    run_kw = run_kw or {}
    want = staggered_run(jeng, JSampling, prompts, **run_kw)
    got = staggered_run(teng, TSampling, prompts, **run_kw)
    assert got == want
    assert teng.waves.snapshot() == jeng.waves.snapshot()
    assert teng.stats.cached_tokens == jeng.stats.cached_tokens
    return jeng, teng, got


class TestMixedWaveEquivalence:
    def test_outputs_match_legacy_schedule_and_jax(self, pair):
        prompts = [repetitive_prompt(n, i) for i, n in enumerate((12, 90, 9))]
        _, teng, mixed = _both(pair, prompts, dict(max_new_tokens=10), prefill_inline_budget=16)
        _, legacy = pair()
        base = staggered_run(legacy, TSampling, prompts, max_new_tokens=10)
        assert [o for o, _ in base] == [o for o, _ in mixed]
        snap = teng.waves.snapshot()
        assert snap["inline_tokens"] > 0 and snap["counts"]["mixed"] > 0
        assert teng.stats.mixed_launches > 0

    def test_spec_decode_composes_with_inline_prefill(self, pair):
        prompts = [repetitive_prompt(n, 20 + i) for i, n in enumerate((16, 80, 12))]
        jeng, teng, mixed = _both(
            pair, prompts, dict(max_new_tokens=12), spec_decode_tokens=2, prefill_inline_budget=16
        )
        st_ = teng.stats
        assert st_.spec_proposed > 0, "speculation never engaged"
        assert st_.spec_proposed == st_.spec_accepted + st_.spec_rejected
        assert (st_.spec_proposed, st_.spec_accepted) == (
            jeng.stats.spec_proposed, jeng.stats.spec_accepted)
        assert teng.waves.snapshot()["inline_tokens"] > 0
        _, spec_only = pair(spec_decode_tokens=2)
        base = staggered_run(spec_only, TSampling, prompts, max_new_tokens=12)
        assert [o for o, _ in base] == [o for o, _ in mixed]

    def test_chunk_resume_offsets_exact(self, pair):
        budget = 8
        runs = {}
        for name, eng, samp in zip(("jax", "port"), pair(prefill_inline_budget=budget),
                                   (JSampling, TSampling)):
            sp = samp(max_new_tokens=6)
            eng.add_request(repetitive_prompt(10, 30), sp)
            for _ in range(3):
                eng.step()
            long_prompt = repetitive_prompt(50, 31)
            long_req = eng.add_request(long_prompt, sp)
            positions, steps = [], 0
            while eng.has_work() and steps < 400:
                job = next((j for j in eng._inline if j.req.rid == long_req.rid), None)
                if job is not None:
                    positions.append(job.pos)
                eng.step()
                steps += 1
            runs[name] = (positions, list(long_req.output_tokens))
            assert positions, "the long prompt never entered the inline backlog"
            for a, b in zip(positions, positions[1:]):
                assert a <= b <= a + budget
            assert long_req.kv_len >= len(long_prompt)
            assert len(long_req.output_tokens) == 6
        assert runs["port"] == runs["jax"]

    def test_cancel_mid_inline_releases_everything(self, pair):
        _, eng = pair(prefill_inline_budget=8)
        samp = TSampling(max_new_tokens=8)
        free0 = eng.pool.free_slots
        carrier = eng.add_request(repetitive_prompt(12, 40), samp)
        for _ in range(3):
            eng.step()
        victim = eng.add_request(repetitive_prompt(60, 41), samp)
        eng.step()  # the victim enters the backlog and advances one chunk
        assert any(j.req.rid == victim.rid for j in eng._inline)
        assert eng.cancel(victim.rid)
        assert not eng._inline and not eng._inline_rows
        assert victim.cancelled and victim.state == RequestState.FINISHED
        assert victim.lock_node is None
        steps = 0
        while eng.has_work() and steps < 200:
            eng.step()
            steps += 1
        assert len(carrier.output_tokens) == 8
        late = eng.add_request(repetitive_prompt(9, 42), samp)
        while eng.has_work():
            eng.step()
        assert len(late.output_tokens) == 8
        # Only tree-published pages stay out of the free list.
        assert eng.pool.free_slots + eng.tree.evictable_size_ == free0


class TestStarvationVirtualTime:
    def test_decode_never_deferred_past_bound(self, pair):
        max_defer = 1
        outs = {}
        for name, eng, samp in zip(
            ("jax", "port"),
            pair(prefill_inline_budget=8, prefill_inline_max_defer=max_defer, prefill_wave_tokens=16),
            (JSampling, TSampling),
        ):
            carrier = eng.add_request(repetitive_prompt(8, 60), samp(max_new_tokens=24))
            for _ in range(3):
                eng.step()
            late = eng.add_request(repetitive_prompt(96, 61), samp(max_new_tokens=4))
            gap = max_gap = steps = 0
            last = len(carrier.output_tokens)
            while eng.has_work() and steps < 400:
                pending = bool(eng._inline)
                eng.step()
                steps += 1
                n = len(carrier.output_tokens)
                if n > last or not pending or n >= 24:
                    gap = 0
                else:
                    gap += 1
                    max_gap = max(max_gap, gap)
                last = n
            snap = eng.waves.snapshot()
            assert snap["counts"]["boost"] >= 1, "skew never exercised deferral"
            assert max_gap <= max_defer
            assert snap["max_defer_observed"] <= max_defer
            outs[name] = (list(carrier.output_tokens), list(late.output_tokens), snap)
        assert outs["port"] == outs["jax"]


class TestPagedDispatch:
    def test_batch_bucket_powers_of_two(self):
        assert [batch_bucket(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 16]
        assert batch_bucket(3, floor=8) == 8

    def test_select_paged_records_decision(self):
        # The CPU has no decode kernel: dense always.
        assert select_paged(2, 128, "cpu", min_batch=8, max_len=64) is False
        assert last_dispatch() == {"path": "dense", "batch": 2, "bucket": 2, "max_len": 64}
        # The policy on a CUDA device (no card needed to decide it).
        assert select_paged(4, 128, "cuda", min_batch=2, max_len=9) is True
        assert last_dispatch()["path"] == "paged"
        assert select_paged(1, 128, "cuda", min_batch=2) is False
        assert select_paged(8, 64, "cuda") is False  # head_dim not a multiple of 128

    def test_engine_exposes_dispatch_and_wave_snapshot(self, pair):
        _, eng = pair(prefill_inline_budget=8)
        staggered_run(eng, TSampling, [repetitive_prompt(10, 70), repetitive_prompt(40, 71)],
                      max_new_tokens=6)
        assert eng._last_dispatch is not None
        assert eng._last_dispatch["path"] in ("dense", "paged")
        assert set(eng.waves.snapshot()) >= {
            "budget", "max_defer", "counts", "inline_tokens", "decode_defer", "max_defer_observed",
        }
