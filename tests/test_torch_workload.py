"""The port's workload generators and engine runners
(``radixmesh_tpu_torch/workload.py``): the cases of ``tests/test_workload.py``
twinned against the port, the generators held to the JAX package's prompts
and arrivals at three seeds, ``run_engine_workload`` on both packages' engines
with the same tiny float32 weights (the same replies, token for token, and
the same counters), and ``run_overload_workload`` through the port's
``SLORunner`` at a low offered rate (the accounting closes, nothing times
out). No verdict that depends on the wall clock is asserted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_twin import load_twin

from radixmesh_tpu_torch import workload as pw
from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import ModelConfig

torch.set_num_threads(1)  # the suite runs in parallel worker processes

load_twin("test_workload", globals(), subs=(
    ("init_params(cfg, jax.random.PRNGKey(0))", "init_params(cfg, 0, \"cpu\")"),
    ("num_slots=4096, page_size=4, max_batch=4)", "num_slots=4096, page_size=4, max_batch=4, device=\"cpu\")"),
))

SEEDS = (0, 7, 123)


def _prompts(wl, turns):
    return [[list(p) for _, p in wl.round_prompts(t)] for t in range(turns)]


@pytest.mark.parametrize("seed", SEEDS)
def test_multi_turn_prompts_equal_the_jax_generator(seed):
    from radixmesh_tpu import workload as jw

    kw = dict(n_conversations=5, n_turns=3, system_len=40, user_len=12, gen_len=6, vocab_size=1000,
              seed=seed)
    a, b = pw.MultiTurnWorkload(**kw), jw.MultiTurnWorkload(**kw)
    assert a.system == b.system
    assert _prompts(a, 3) == _prompts(b, 3)
    assert a.max_context_len == b.max_context_len
    # Replies recorded alike grow the contexts alike.
    for (ca, pa), (cb, pb) in zip(a.round_prompts(0), b.round_prompts(0)):
        a.record_reply(ca, pa, [9, 8])
        b.record_reply(cb, pb, [9, 8])
    assert _prompts(a, 3) == _prompts(b, 3)


@pytest.mark.parametrize("seed", SEEDS)
def test_text_multi_turn_prompts_equal_the_jax_generator(seed):
    """Through each package's own ``ByteTokenizer``: the same text, the same
    token ids."""
    from radixmesh_tpu import workload as jw
    from radixmesh_tpu.server.tokenizer import ByteTokenizer as JByteTokenizer
    from radixmesh_tpu_torch.server.tokenizer import ByteTokenizer

    kw = dict(n_conversations=4, n_turns=3, system_sentences=5, user_sentences=2, gen_len=4, seed=seed)
    a = pw.TextMultiTurnWorkload(ByteTokenizer(), **kw)
    b = jw.TextMultiTurnWorkload(JByteTokenizer(), **kw)
    assert a.system_text == b.system_text
    assert a.system == b.system
    assert _prompts(a, 3) == _prompts(b, 3)
    assert pw.synth_text(np.random.default_rng(seed), 6) == jw.synth_text(np.random.default_rng(seed), 6)


@pytest.mark.parametrize("seed", SEEDS)
def test_overload_arrivals_equal_the_jax_generator(seed):
    from radixmesh_tpu import workload as jw

    kw = dict(tenants={"free": 1.0, "pro": 2.0, "ent": 0.5}, duration_s=3.0, offered_tokens_per_s=4000.0,
              prompt_len=64, shared_frac=0.5, gen_len=4, vocab_size=2000, seed=seed)
    a, b = pw.OverloadWorkload(**kw), jw.OverloadWorkload(**kw)
    assert a.offered_requests == b.offered_requests > 0
    assert [(t, n, list(p)) for t, n, p in a.arrivals] == [(t, n, list(p)) for t, n, p in b.arrivals]


def test_run_engine_workload_equals_the_jax_engine():
    """Tiny float32 weights drawn by the JAX package and carried across:
    both engines reply token for token alike, and the reports' counters and
    ceilings are equal (TTFTs are wall-clock and not compared)."""
    from radixmesh_tpu import workload as jw
    from radixmesh_tpu.engine.engine import Engine as JEngine
    from radixmesh_tpu.models import llama as jl

    jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(3))
    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    kw = dict(n_conversations=3, n_turns=3, system_len=32, user_len=12, gen_len=6, vocab_size=512, seed=4)
    wl_p, wl_j = pw.MultiTurnWorkload(**kw), jw.MultiTurnWorkload(**kw)
    ekw = dict(num_slots=2048, page_size=4, max_batch=4)
    rep_p = pw.run_engine_workload(Engine(cfg, params, device="cpu", **ekw), wl_p)
    rep_j = jw.run_engine_workload(JEngine(jcfg, jparams, **ekw), wl_j)
    assert [c.context for c in wl_p.conversations] == [c.context for c in wl_j.conversations]
    for key in ("requests", "prompt_tokens", "cached_tokens", "hit_rate", "ceiling_hit_rate",
                "reuse_efficiency"):
        assert rep_p[key] == rep_j[key], key
    assert set(rep_p) == set(rep_j)
    assert len(rep_p["ttft_s"]) == rep_p["requests"]
    assert rep_p["cached_tokens"] > 0


def test_run_overload_workload_accounting_closes():
    """A low offered rate through the port's ``SLORunner``: every arrival is
    offered, admitted or shed (none here), none times out, and the report
    has the JAX report's keys."""
    from radixmesh_tpu_torch.slo.control import SLOConfig, TenantConfig
    from radixmesh_tpu_torch.slo.runner import SLORunner

    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    from radixmesh_tpu_torch.models.llama import init_params

    eng = Engine(cfg, init_params(cfg, 0, "cpu"), device="cpu", num_slots=2048, page_size=4, max_batch=4)
    wl = pw.OverloadWorkload(tenants={"free": 1.0, "pro": 2.0}, duration_s=1.0, offered_tokens_per_s=600.0,
                             prompt_len=48, gen_len=4, vocab_size=cfg.vocab_size, seed=2)
    runner = SLORunner(eng, SLOConfig(tenants={k: TenantConfig(weight=w) for k, w in wl.tenants.items()}))
    runner.start()
    try:
        rep = pw.run_overload_workload(runner, wl, wait_timeout_s=60.0)
    finally:
        runner.close()
    assert rep["offered_requests"] == len(wl.arrivals) > 0
    assert rep["admitted_requests"] + rep["shed_requests"] + rep["timed_out_requests"] == rep["offered_requests"]
    assert rep["timed_out_requests"] == 0
    assert rep["served_requests"] == rep["admitted_requests"]
    assert sum(rep["admitted_tokens_by_tenant"].values()) == 48 * rep["admitted_requests"]
    assert rep["served_tok_s"] > 0
    assert set(rep) == {
        "offered_requests", "admitted_requests", "served_requests", "shed_requests", "shed_by_reason",
        "timed_out_requests", "deadline_met", "deadline_met_frac", "goodput_tok_s", "served_tok_s",
        "admitted_tokens_by_tenant", "p50_ttft_s", "p99_ttft_s", "elapsed_s",
    }
