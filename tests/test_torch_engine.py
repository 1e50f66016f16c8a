"""The port's Engine held against the JAX Engine on the same weights (tiny
config, float32, CPU): a shared-prefix multi-request workload with a
concurrent group (one member deferred behind its groupmate's prefix), a
prompt above a lowered ``long_prefill_threshold`` (chunked prefill with
prior > 0), a follow-up that hits the cache, and a pool small enough that
admission evicts. Greedy outputs must be token-exact and every request's
``cached_tokens`` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.engine.engine import Engine as JEngine
from radixmesh_tpu.engine.request import SamplingParams as JSampling
from radixmesh_tpu.models import llama as jl
from radixmesh_tpu_torch.engine.engine import Engine as TEngine
from radixmesh_tpu_torch.engine.request import SamplingParams as TSampling
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import ModelConfig

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)  # the suite runs in parallel worker processes

ENGINE_KW = dict(
    num_slots=128, page_size=4, max_batch=4, long_prefill_threshold=24,
    prefill_chunk=16,
)
MAX_NEW = 8


def _run(engine, sampling_cls, waves):
    """Each wave is submitted at once and stepped to completion; returns
    ``[(output_ids, cached_tokens)]`` in submission order."""
    out = []
    for prompts in waves:
        reqs = [engine.add_request(p, sampling_cls(max_new_tokens=MAX_NEW)) for p in prompts]
        for _ in range(10_000):
            if not engine.has_work():
                break
            engine.step()
        out.extend((r.generated, r.prefix_len) for r in reqs)
    return out


@pytest.fixture(scope="module")
def engines():
    jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = ModelConfig.tiny().replace(dtype=torch.float32)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    return (
        lambda: JEngine(jcfg, jparams, **ENGINE_KW),
        lambda: TEngine(tcfg, tparams, device="cpu", **ENGINE_KW),
    )


def test_shared_prefix_workload_token_exact(engines):
    make_j, make_t = engines
    rng = np.random.default_rng(0)

    def toks(n):
        return rng.integers(0, 512, size=n).tolist()

    a = toks(20)
    b = a[:12] + toks(10)  # shares 3 pages with a: deferred a wave
    c = toks(18)
    d = toks(60)  # > long_prefill_threshold: chunked, chunks 2+ have prior
    e = toks(30)
    waves = [[a, b, c], [d], [e]]

    jeng, teng = make_j(), make_t()
    j1 = _run(jeng, JSampling, waves)
    t1 = _run(teng, TSampling, waves)
    assert t1 == j1
    # The follow-up extends a's published sequence (prompt + output).
    follow = a + t1[0][0] + toks(5)
    j2 = _run(jeng, JSampling, [[follow]])
    t2 = _run(teng, TSampling, [[follow]])
    assert t2 == j2
    assert t2[0][1] > 0, "follow-up should hit the cache"
    assert t1[1][1] > 0, "deferred groupmate should hit its peer's prefix"
    assert teng.stats.evicted_tokens > 0, "pool pressure should force eviction"
    assert teng.stats.prefill_chunks_with_prior > 0
    assert teng.stats.cached_tokens == jeng.stats.cached_tokens
    assert teng.stats.prompt_tokens == jeng.stats.prompt_tokens


def test_cancel_releases_row_and_pages(engines):
    _, make_t = engines
    eng = make_t()
    free0 = eng.pool.free_slots
    req = eng.add_request(list(range(1, 15)), TSampling(max_new_tokens=50))
    eng.step()
    assert req.state.value == "running"
    assert eng.cancel(req.rid)
    assert req.cancelled and not eng.has_work()
    # Only tree-published pages stay out of the free list.
    assert eng.pool.free_slots + eng.tree.evictable_size_ == free0
