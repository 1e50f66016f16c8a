"""Seeded replay and resume admission in the port's engine
(``radixmesh_tpu_torch/engine/engine.py``): twins of
``tests/test_recovery.py::TestEngineResume`` on ``ModelConfig.tiny()`` with
params converted from the JAX init, and the checks that tie the port to
the JAX engine:

- the key material (``_mix64`` and the per-(seed, position) value) is the
  JAX engine's, bit for bit;
- greedy seeded rows give the JAX ``Engine``'s tokens in float32;
- an all-seeded batch takes no speculative, multi-step or compact launch,
  and its mixed waves run as two launches (``EngineStats``).

The stochastic draws come from a ``torch.Generator``, not threefry, so the
sampled tokens themselves are compared only within the port."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.engine import engine as jeng
from radixmesh_tpu.engine.request import Request as JRequest
from radixmesh_tpu.engine.request import SamplingParams as JSampling
from radixmesh_tpu.models import llama as jl
from radixmesh_tpu_torch.engine import engine as teng
from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.engine.request import Request, RequestState, SamplingParams
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import ModelConfig

torch.set_num_threads(1)  # the suite runs in parallel worker processes


def _pair(dtype_j, dtype_t):
    jcfg = jl.ModelConfig.tiny().replace(dtype=dtype_j)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = ModelConfig.tiny().replace(dtype=dtype_t)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    return (jcfg, jparams), (tcfg, tparams)


@pytest.fixture(scope="module")
def tiny():
    """The JAX test's model: ``ModelConfig.tiny()`` (bf16) from PRNGKey(0)."""
    return _pair(jnp.bfloat16, torch.bfloat16)[1]


@pytest.fixture(scope="module")
def tiny_f32():
    return _pair(jnp.float32, torch.float32)


def _engine(tiny, **kw):
    cfg, params = tiny
    kw.setdefault("num_slots", 512)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_batch", 2)
    return Engine(cfg, params, device="cpu", **kw)


def _drain(eng):
    while eng.has_work():
        eng.step()


class TestEngineResume:
    def test_resume_admission_suppresses_reemission(self, tiny):
        eng = _engine(tiny, name="resume-basic")
        prompt = list(range(1, 30))
        samp = SamplingParams(max_new_tokens=10)
        first = eng.add_request(prompt, samp)
        _drain(eng)
        full = first.generated
        assert len(full) == 10
        k = 4
        resumed = eng.add_request(prompt, samp, resume_tokens=full[:k])
        _drain(eng)
        # Only post-resume tokens emitted; the output budget is conserved.
        assert resumed.resume_offset == k
        assert len(resumed.generated) == 10 - k
        # Greedy, same engine: the continuation replays exactly.
        assert resumed.generated == full[k:]
        assert eng.stats.resurrections == 1
        # The first life published prompt + output: the replay is a hit.
        assert eng.stats.replayed_tokens == len(prompt) + k
        assert eng.stats.replayed_cached_tokens > 0

    @pytest.mark.parametrize("k", [1, 5])
    def test_seeded_resume_replay_determinism(self, tiny, k):
        """Same seed: the same continuation at each crash point, on another
        engine (the resumed life runs elsewhere)."""
        prompt = list(range(1, 36))
        samp = SamplingParams(max_new_tokens=10, temperature=0.9, top_p=0.95, seed=4242)
        e1 = _engine(tiny, name="replay-a")
        first = e1.add_request(prompt, samp)
        _drain(e1)
        full = first.generated
        assert len(full) == 10
        e2 = _engine(tiny, name=f"replay-b{k}")
        resumed = e2.add_request(prompt, samp, resume_tokens=full[:k])
        _drain(e2)
        assert resumed.generated == full[k:], f"seeded continuation diverged at crash point {k}"

    def test_resume_covering_full_budget_is_refused(self, tiny):
        eng = _engine(tiny, name="resume-full")
        with pytest.raises(ValueError, match="already complete"):
            eng.make_request(list(range(1, 10)), SamplingParams(max_new_tokens=4),
                             resume_tokens=[5, 6, 7, 8])
        assert eng.stats.resurrections == 0

    @pytest.mark.parametrize("seeds", [(0, 1 << 44), (5, 5 | (1 << 63))])
    def test_high_seed_bits_matter(self, tiny, seeds):
        """Seeds that differ only above bit 43, or only in bit 63, must not
        collide: the key mixes the full 64-bit seed before the position,
        and the generator takes the whole uint64 range."""
        prompt = list(range(10, 40))
        outs = []
        for seed in seeds:
            e = _engine(tiny, name=f"hiseed-{seed}")
            r = e.add_request(prompt, SamplingParams(max_new_tokens=12, temperature=1.0, seed=seed))
            _drain(e)
            outs.append(r.generated)
        assert outs[0] != outs[1]

    def test_different_seed_diverges(self, tiny):
        prompt = list(range(50, 90))
        outs = []
        for seed in (1, 2):
            e = _engine(tiny, name=f"seed-{seed}")
            r = e.add_request(prompt, SamplingParams(max_new_tokens=12, temperature=1.0, seed=seed))
            _drain(e)
            outs.append(r.generated)
        assert outs[0] != outs[1]

    def test_stream_publish_grows_prefix_mid_decode(self, tiny):
        eng = _engine(tiny, name="stream-pub", stream_publish_tokens=2)
        prompt = list(range(1, 21))
        req = eng.add_request(prompt, SamplingParams(max_new_tokens=8))
        while len(req.output_tokens) < 5 and eng.has_work():
            eng.step()
        grown = np.concatenate([req.prompt, np.asarray(req.output_tokens[:2], np.int32)])
        # The grown prefix is matchable mid-stream (page alignment may
        # truncate the tail token, never the prompt).
        assert eng.tree.match_prefix(grown).length >= len(prompt)
        _drain(eng)
        # Without the cadence only the prompt is in the tree mid-stream.
        off = _engine(tiny, name="stream-pub-off")
        req = off.add_request(prompt, SamplingParams(max_new_tokens=8))
        while len(req.output_tokens) < 5 and off.has_work():
            off.step()
        assert off.tree.match_prefix(grown).length < len(prompt) + 2 - 1
        _drain(off)

    def test_crash_while_restoring_releases_ticket(self, tiny):
        """A crash (the teardown sweep) while a request is parked in
        RESTORING: its restore ticket releases its eviction shields, and the
        request (no token delivered) runs again on another engine as a
        plain retry. The JAX test drives the retry through the recovery
        coordinator, which the port does not have; here the retry is a
        plain submission."""
        eng = _engine(tiny, name="restoring-crash", host_cache_slots=1024,
                      kv_transfer_async=True, kv_transfer_chunk_tokens=16)
        try:
            prompt = list(range(1, 120))
            samp = SamplingParams(max_new_tokens=4)
            eng.generate([prompt], samp)
            assert eng.tree.evict(100_000) > 0
            assert eng.kv_transfer.wait_host_ready()
            barrier = threading.Event()
            eng.kv_transfer.stage_barrier = barrier
            parked = eng.add_request(prompt, samp)
            for _ in range(3):
                eng.step()
            assert parked.state is RequestState.RESTORING
            assert eng.cancel_all() == 1
            assert parked.state is RequestState.FINISHED
            assert parked.generated == []  # nothing delivered: a retry, not a resume
            barrier.set()
            eng.kv_transfer.stage_barrier = None
            deadline = time.monotonic() + 10
            while eng.has_work() and time.monotonic() < deadline:
                eng.step()
            assert eng.tree.protected_size_ == 0
            e2 = _engine(tiny, name="restoring-rescue")
            assert len(e2.generate([prompt], samp)[0]) == 4
            assert e2.stats.resurrections == 0
        finally:
            eng.close()


class TestAgainstJax:
    SEEDS = [0, 1, 4242, 1 << 44, (1 << 63) | 5, (1 << 64) - 1, 1 << 64, (1 << 70) + 3]
    POSITIONS = [0, 1, 35, 36, 4095, 1 << 20]

    def test_mix64_and_key_material_equal_jax(self):
        rng = np.random.default_rng(0)
        for x in [0, 1, (1 << 64) - 1] + [int(v) for v in rng.integers(0, 1 << 63, 50)]:
            assert teng._mix64(x) == jeng._mix64(x)
        assert teng._M64 == jeng._M64
        for seed in self.SEEDS:
            for pos in self.POSITIONS:
                prompt = np.ones(pos, np.int32)  # the next token's position is pos
                treq = Request(prompt=prompt, sampling=SamplingParams(seed=seed))
                jreq = JRequest(prompt=prompt, sampling=JSampling(seed=seed))
                assert treq.num_tokens == jreq.num_tokens
                acc = Engine._seed_key(treq)
                # The JAX engine's key is the uint32 pair [acc >> 32, acc].
                jkey = np.asarray(jeng.Engine._seed_key(None, jreq))
                assert [int(jkey[0]), int(jkey[1])] == [acc >> 32, acc & 0xFFFFFFFF], (seed, pos)
                # The generator takes the whole uint64 range.
                torch.Generator().manual_seed(acc)

    def test_greedy_seeded_rows_match_jax_engine(self, tiny_f32):
        (jcfg, jparams), (tcfg, tparams) = tiny_f32
        kw = dict(num_slots=512, page_size=4, max_batch=4)
        rng = np.random.default_rng(3)
        prompts = [rng.integers(1, 500, n).tolist() for n in (13, 29, 40)]
        resume = rng.integers(1, 500, 3).tolist()
        outs = {}
        for name, eng, samp in (
            ("jax", jeng.Engine(jcfg, jparams, name="greedy-seeded-j", **kw), JSampling),
            ("torch", Engine(tcfg, tparams, device="cpu", name="greedy-seeded-t", **kw),
             SamplingParams),
        ):
            sp = samp(max_new_tokens=10, temperature=0.0, seed=77)
            reqs = [eng.add_request(p, sp) for p in prompts]
            # A resumed seeded row rides the same batch.
            reqs.append(eng.add_request(prompts[0], sp, resume_tokens=resume))
            _drain(eng)
            outs[name] = [r.generated for r in reqs]
        assert outs["torch"] == outs["jax"]
        assert all(len(o) == 10 for o in outs["torch"][:3]) and len(outs["torch"][3]) == 7

    def test_all_seeded_batch_takes_no_fast_schedule(self, tiny_f32):
        """With speculation, multi-step decode and mixed waves on (and, on
        the CPU, every unseeded decode wave on the compact leg), an
        all-seeded batch decodes through ``decode_step`` only and its mixed
        waves take two launches; the same script unseeded takes each fast
        schedule. Greedy seeded tokens equal the unseeded ones."""
        _, tiny = tiny_f32
        kw = dict(spec_decode_tokens=2, decode_steps_per_launch=4, prefill_inline_budget=16,
                  max_batch=3, num_slots=1024)
        rng = np.random.default_rng(5)
        first = (rng.integers(1, 500, 6).tolist() * 5)[:30]
        late = rng.integers(1, 500, 60).tolist()
        runs = {}
        for seeded in (True, False):
            eng = _engine(tiny, name=f"seeded-schedules-{seeded}", **kw)
            sp = SamplingParams(max_new_tokens=24, seed=9 if seeded else None)
            reqs = [eng.add_request(first, sp)]
            for _ in range(2):
                eng.step()
            reqs.append(eng.add_request(late, sp))  # arrives while a row decodes
            _drain(eng)
            reqs.append(eng.add_request(first, sp))  # a replay: tree drafts
            _drain(eng)
            runs[seeded] = (eng.stats, eng.waves.snapshot(), [r.generated for r in reqs])
        st, waves, toks = runs[True]
        assert st.verify_launches == st.multi_step_launches == st.compact_launches == 0
        assert st.spec_proposed == 0 and st.mixed_launches == 0
        assert waves["counts"]["mixed"] > 0
        assert st.inline_launches >= waves["counts"]["mixed"]
        assert st.decode_forwards == st.decode_steps > 0
        st_u, waves_u, toks_u = runs[False]
        # Unseeded, on the CPU every decode launch takes the compact leg,
        # k > 1 steps at a time where it can fuse.
        assert st_u.verify_launches > 0 and st_u.mixed_launches > 0
        assert st_u.compact_launches > 0 and st_u.decode_forwards > st_u.compact_launches
        assert toks == toks_u
