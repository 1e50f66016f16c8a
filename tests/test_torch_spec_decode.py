"""Speculative decode in the port held against the JAX package (tiny
config, float32, CPU, the same weights): the n-gram drafter of both
packages on the same histories; greedy outputs token-exact against the JAX
``Engine`` under the same ``spec_decode_tokens`` (random, repetitive and
cyclic prompts, a stop token mid-accept, a follow-up served from what a
speculative run published, a replay that accepts tree drafts), with the
draft counts equal too and conserved (``proposed == accepted +
rejected``); ``spec_verify_sample`` against the JAX function on fixed
logits for greedy rows, and by a chi-square test of the emitted token's
distribution for stochastic rows; the adaptive-γ ledger steering as the
JAX one does, and an adaptive engine token-exact against the JAX one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.engine.engine import Engine as JEngine
from radixmesh_tpu.engine.request import SamplingParams as JSampling
from radixmesh_tpu.models import llama as jl
from radixmesh_tpu.ops import sampling as jsamp
from radixmesh_tpu_torch.engine.engine import Engine as TEngine
from radixmesh_tpu_torch.engine.request import SamplingParams as TSampling
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import ModelConfig
from radixmesh_tpu_torch.ops import sampling as tsamp

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)  # the suite runs in parallel worker processes

ENGINE_KW = dict(num_slots=512, page_size=4, max_batch=4, max_seq_len=128)


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


def _generate_both(jeng, teng, prompts, **sampling):
    want = jeng.generate(prompts, JSampling(**sampling))
    got = teng.generate(prompts, TSampling(**sampling))
    return want, got


def _spec_counts(stats):
    return stats.spec_proposed, stats.spec_accepted, stats.spec_rejected


def _assert_same_run(jeng, teng):
    """Token-exact runs must agree on every count the host derives from the
    tokens, and the port's draft counts must be conserved."""
    assert _spec_counts(teng.stats) == _spec_counts(jeng.stats)
    assert teng.stats.cached_tokens == jeng.stats.cached_tokens
    assert teng.stats.decode_steps == jeng.stats.decode_steps
    p, a, r = _spec_counts(teng.stats)
    assert p == a + r
    assert teng.spec_report() == jeng.spec_report()
    ledger = teng.spec_ledger.totals()
    assert ledger["proposed"] == ledger["accepted"] + ledger["rejected"]


def _rng():
    return np.random.default_rng(3)


NGRAM_CASES = [
    ([1, 2, 3, 9, 1, 2, 3, 7, 5, 1, 2, 3], 2, 3, [7, 5]),  # latest continuation
    ([4, 5, 8, 0, 4, 5], 3, 3, [8, 0, 4]),  # trigram misses, bigram hits
    (list(range(10)), 4, 3, []),  # no repeat, no draft
    ([1, 2, 6, 1, 2], 4, 2, [6, 1, 2]),  # continuation runs off the end
]


class TestNgramDraft:
    @pytest.mark.parametrize("engine_cls", [JEngine, TEngine], ids=["jax", "port"])
    @pytest.mark.parametrize("hist,gamma,n,want", NGRAM_CASES)
    def test_cases(self, engine_cls, hist, gamma, n, want):
        d = engine_cls._ngram_draft(np.asarray(hist, np.int32), gamma=gamma, n=n)
        assert d.tolist() == want

    def test_packages_agree_on_random_histories(self):
        rng = np.random.default_rng(0)
        for _ in range(200):
            hist = rng.integers(0, 6, size=rng.integers(1, 40)).astype(np.int32)
            g, n = int(rng.integers(1, 6)), int(rng.integers(2, 5))
            assert (TEngine._ngram_draft(hist, g, n).tolist()
                    == JEngine._ngram_draft(hist, g, n).tolist())


class TestSpecExactness:
    @pytest.mark.parametrize("gamma", [2, 4])
    def test_random_prompts(self, pair, gamma):
        jeng, teng = pair(spec_decode_tokens=gamma)
        rng = _rng()
        prompts = [rng.integers(1, 512, n).tolist() for n in (11, 7, 15)]
        want, got = _generate_both(jeng, teng, prompts, max_new_tokens=14)
        assert got == want
        _assert_same_run(jeng, teng)

    @pytest.mark.parametrize("gamma", [2, 4])
    def test_repetitive_prompt_proposes(self, pair, gamma):
        jeng, teng = pair(spec_decode_tokens=gamma)
        prompt = _rng().integers(1, 512, 6).tolist() * 4  # heavy n-gram repetition
        want, got = _generate_both(jeng, teng, [prompt], max_new_tokens=16)
        assert got == want
        assert teng.stats.spec_proposed > 0
        assert teng.stats.verify_launches > 0
        _assert_same_run(jeng, teng)

    def test_cyclic_generation_accepts(self, pair):
        # A tiny random model falls into output cycles under greedy decode;
        # once the cycle is in the history the n-gram drafter predicts it.
        jeng, teng = pair(spec_decode_tokens=4)
        prompt = [12, 12, 12, 12, 12]
        want, got = _generate_both(jeng, teng, [prompt], max_new_tokens=60)
        assert got == want
        assert teng.stats.spec_accepted > 0
        _assert_same_run(jeng, teng)

    def test_stop_token_mid_accept(self, pair):
        jeng, teng = pair(spec_decode_tokens=4)
        prompt = [12, 12, 12, 12, 12]
        ref = teng.generate([prompt], TSampling(max_new_tokens=30))[0]
        jeng.generate([prompt], JSampling(max_new_tokens=30))
        stop = ref[20]
        want, got = _generate_both(jeng, teng, [prompt], max_new_tokens=30, stop_token_ids=(stop,))
        assert got == want
        assert got[0] == ref[: ref.index(stop)]
        _assert_same_run(jeng, teng)

    def test_publish_after_spec_serves_followup(self, pair):
        jeng, teng = pair(spec_decode_tokens=4)
        prompt = _rng().integers(1, 512, 6).tolist() * 3
        want, got = _generate_both(jeng, teng, [prompt], max_new_tokens=10)
        assert got == want
        follow = prompt + got[0]
        want2, got2 = _generate_both(jeng, teng, [follow], max_new_tokens=10)
        assert got2 == want2
        assert teng.stats.cached_tokens > 0
        _assert_same_run(jeng, teng)


class TestTreeDrafts:
    def test_replay_accepts_heavily_and_matches(self, pair):
        jeng, teng = pair(spec_decode_tokens=4)
        prompt = _rng().integers(1, 512, 13).tolist()
        first_j, first = _generate_both(jeng, teng, [prompt], max_new_tokens=16)
        assert first == first_j
        steps_first = teng.stats.decode_steps
        second_j, second = _generate_both(jeng, teng, [prompt], max_new_tokens=16)
        assert second == second_j == first
        assert teng.stats.spec_accepted >= 8
        assert teng.stats.decode_steps - steps_first < steps_first
        sources = {c["source"] for c in teng.spec_ledger.report().values()}
        assert "tree" in sources
        _assert_same_run(jeng, teng)


class TestVerifySample:
    def test_greedy_rows_match_jax(self):
        rng = np.random.default_rng(0)
        B, C, V = 6, 5, 40
        logits = rng.normal(size=(B, C, V)).astype(np.float32)
        greedy = logits.argmax(-1)
        # Drafts that agree with the argmax for a row-specific prefix.
        drafts = rng.integers(0, V, size=(B, C - 1)).astype(np.int32)
        for b in range(B):
            drafts[b, :b % C] = greedy[b, : b % C]
        dlen = np.array([4, 4, 3, 0, 4, 2], np.int32)
        temps = np.zeros(B, np.float32)
        tops = np.ones(B, np.float32)
        ja, jb = jsamp.spec_verify_sample(
            jnp.asarray(logits), jnp.asarray(drafts), jnp.asarray(dlen),
            jax.random.PRNGKey(0), jnp.asarray(temps), jnp.asarray(tops),
        )
        ta, tb = tsamp.spec_verify_sample(
            torch.as_tensor(logits), torch.as_tensor(drafts), torch.as_tensor(dlen),
            torch.Generator().manual_seed(0), torch.as_tensor(temps), torch.as_tensor(tops),
        )
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))

    @pytest.mark.parametrize("which", ["likely", "unlikely"])
    def test_emitted_distribution_chi_square(self, which):
        """The first emitted token of a stochastic row is distributed as
        plain sampling from the filtered target, whatever the draft (the
        speculative-sampling identity), judged by a chi-square test."""
        from scipy.stats import chi2

        V, N = 12, 30_000
        rng = np.random.default_rng(1)
        row = rng.normal(size=(V,)).astype(np.float32) * 2.0
        temperature, top_p = 0.8, 0.85
        target = torch.softmax(tsamp._filtered_logits(
            torch.as_tensor(row)[None], torch.tensor([temperature]), torch.tensor([top_p]),
            torch.tensor([0]),
        ), dim=-1)[0].numpy()
        d = int(np.argmax(target) if which == "likely" else np.argmin(target))
        accept, bonus = tsamp.spec_verify_sample(
            torch.as_tensor(row).expand(N, 2, V), torch.full((N, 1), d, dtype=torch.int32),
            torch.ones(N, dtype=torch.int32), torch.Generator().manual_seed(7),
            torch.full((N,), temperature), torch.full((N,), top_p),
        )
        emitted = torch.where(accept > 0, d, bonus).numpy()
        counts = np.bincount(emitted, minlength=V)
        support = target > 0
        assert counts[~support].sum() == 0, "a token outside the nucleus was emitted"
        expected = N * target[support]
        stat = float(((counts[support] - expected) ** 2 / expected).sum())
        dof = int(support.sum()) - 1
        assert stat < chi2.ppf(0.999, dof), (stat, dof, counts, target)


class TestAdaptiveGamma:
    def test_ledger_steers_like_jax(self):
        from radixmesh_tpu.obs.token_timeline import SpecLedger as JLedger
        from radixmesh_tpu_torch.obs.spec_ledger import SpecLedger

        t, j = SpecLedger(adaptive=True, max_classes=6), JLedger(adaptive=True, max_classes=6)
        rng = np.random.default_rng(0)
        for _ in range(400):
            cls = (f"t{rng.integers(2)}", f"p{32 << int(rng.integers(3))}", ["tree", "ngram"][rng.integers(2)])
            proposed = int(rng.integers(0, 5))
            accepted = int(rng.integers(0, proposed + 1))
            t.note_wave(*cls, proposed, accepted, proposed)
            j.note_wave(*cls, proposed, accepted, proposed)
            assert t.gamma_for(cls[0], cls[1], 4) == j.gamma_for(cls[0], cls[1], 4)
        assert t.report() == j.report()
        assert t.totals() == j.totals()

    def test_adaptive_engine_token_exact(self, pair):
        jeng, teng = pair(spec_decode_tokens=4, spec_adaptive=True)
        prompts = [_rng().integers(1, 512, 6).tolist() * 4, [12, 12, 12, 12, 12]]
        want, got = _generate_both(jeng, teng, prompts, max_new_tokens=40)
        assert got == want
        _assert_same_run(jeng, teng)
        gammas = {c["gamma_used"] for c in teng.spec_ledger.report().values()}
        assert gammas and min(gammas) < 4, "the controller never shrank γ"
