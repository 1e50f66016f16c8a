"""The port's Qwen2 family held against the JAX package on the CPU: the five
presets field for field, ``init_params`` shapes with zero QKV biases, the
three forwards with non-zero biases planted through ``params_from_jax``
(``qwen2-tiny``, and a tiny variant with GQA group 7, Qwen2-7B's), and the
port's ``Engine`` against the JAX ``Engine`` greedy token for token.
Tolerances as ``test_torch_models.py``: float32 logits atol 1e-4, pool
contents atol 1e-5, greedy tokens exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.engine.engine import Engine as JEngine
from radixmesh_tpu.engine.request import SamplingParams as JSampling
from radixmesh_tpu.models import get_config as j_get_config
from radixmesh_tpu.models import llama as jl
from radixmesh_tpu_torch.engine.engine import Engine as TEngine
from radixmesh_tpu_torch.engine.request import SamplingParams as TSampling
from radixmesh_tpu_torch.models import get_config
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import Llama, init_params, param_shapes

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)  # the suite runs in parallel worker processes
LOGIT_ATOL = 1e-4
POOL_ATOL = 1e-5
PAGE = 4
PRESETS = ("qwen2-72b", "qwen2-7b", "qwen2.5-14b", "qwen2.5-32b", "qwen2-tiny")
# A tiny Qwen2 with Qwen2-7B's GQA group: 14 query heads over 2 kv heads.
G7 = dict(n_heads=14, n_kv_heads=2, head_dim=16)


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_jax_field_for_field(name):
    got, want = get_config(name), j_get_config(name)
    for f in dataclasses.fields(want):
        if f.name == "dtype":
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        else:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.qkv_bias


def test_qwen25_rms_eps():
    assert get_config("qwen2.5-14b").rms_eps == get_config("qwen2.5-32b").rms_eps == 1e-5
    assert get_config("qwen2-7b").rms_eps == get_config("qwen2-72b").rms_eps == 1e-6


def test_init_params_shapes_and_zero_biases():
    cfg = get_config("qwen2-tiny")
    params = init_params(cfg, seed=0, device="cpu")
    jparams = jl.init_params(j_get_config("qwen2-tiny"), jax.random.PRNGKey(0))
    shapes = param_shapes(cfg)
    assert set(params["layers"]) == set(jparams["layers"]) == set(shapes["layers"])
    assert set(params) == set(jparams)
    for name in ("bq", "bk", "bv"):
        assert tuple(params["layers"][name].shape) == jparams["layers"][name].shape
        assert params["layers"][name].dtype == torch.bfloat16
        assert torch.count_nonzero(params["layers"][name]) == 0
    assert shapes["layers"]["bq"] == (2, 4 * 32) and shapes["layers"]["bk"] == (2, 2 * 32)


def _planted(jcfg, seed):
    """JAX ``init_params`` with the QKV biases planted non-zero (JAX
    initialises them to zero, which would leave the bias path untested)."""
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        shape = jparams["layers"][name].shape
        jparams["layers"][name] = jnp.asarray(rng.normal(size=shape) * 0.5, jcfg.dtype)
    return jparams


@pytest.fixture(scope="module", params=["qwen2-tiny", "qwen2-tiny-g7"])
def models(request):
    extra = G7 if request.param.endswith("g7") else {}
    jcfg = j_get_config("qwen2-tiny", dtype=jnp.float32, **extra)
    jparams = _planted(jcfg, 0)
    tcfg = get_config("qwen2-tiny", dtype=torch.float32, **extra)
    model = Llama(tcfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu"))
    assert torch.count_nonzero(model.layers["bk"]) > 0
    return jcfg, jparams, tcfg, model


def _close(got, want, atol):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=0, atol=atol
    )


def _pool(cfg, num_slots=256):
    return np.zeros((2, cfg.n_layers, cfg.n_kv_heads, num_slots, cfg.head_dim), np.float32)


def test_prefill_forward(models):
    jcfg, jparams, tcfg, model = models
    rng = np.random.default_rng(0)
    L, Hkv, D = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim
    B, S, P = 2, 6, 8
    tokens = rng.integers(0, tcfg.vocab_size, size=(B, S)).astype(np.int32)
    prefix = np.array([3, 8], np.int32)
    positions = (prefix[:, None] + np.arange(S)[None]).astype(np.int32)
    ck = rng.normal(size=(L, B, P, Hkv, D)).astype(np.float32)
    cv = rng.normal(size=(L, B, P, Hkv, D)).astype(np.float32)
    want = jl.prefill_forward(
        jparams, jcfg, *(jnp.asarray(a) for a in (tokens, positions, ck, cv, prefix))
    )
    got = model.prefill_forward(*(torch.from_numpy(a) for a in (tokens, positions, ck, cv, prefix)))
    _close(got[0], want[0], LOGIT_ATOL)
    _close(got[1], want[1], POOL_ATOL)
    _close(got[2], want[2], POOL_ATOL)


def test_prefill_chunk_paged_then_decode(models):
    """Two chunks (the second against the first's pages), then four greedy
    decode steps: logits and pool against JAX at each launch."""
    jcfg, jparams, tcfg, model = models
    rng = np.random.default_rng(1)
    C, maxp, num_slots = 8, 32, 256
    total = 13
    pt = np.zeros((1, maxp), np.int32)  # the JAX chunk path scans 32-page blocks
    pt[0, :8] = 1 + rng.permutation(num_slots // PAGE - 1)[:8]
    prompt = rng.integers(0, tcfg.vocab_size, size=total).astype(np.int32)
    jpool, tpool = jnp.asarray(_pool(tcfg, num_slots)), torch.from_numpy(_pool(tcfg, num_slots))
    for ci in range(2):
        start = ci * C
        nv = min(total - start, C)
        poss = (start + np.arange(C))[None].astype(np.int32)
        toks = np.zeros((1, C), np.int32)
        toks[0, :nv] = prompt[start : start + nv]
        sl = (pt[0, poss // PAGE] * PAGE + poss % PAGE).astype(np.int32)
        sl[0, nv:] = 0
        kvlen = np.array([start + nv], np.int32)
        jlog, jpool = jl.prefill_chunk_paged(
            jparams, jcfg, *(jnp.asarray(a) for a in (toks, poss)), jpool,
            *(jnp.asarray(a) for a in (sl, pt, kvlen)), page_size=PAGE,
        )
        tlog = model.prefill_chunk_paged(
            *(torch.from_numpy(a) for a in (toks, poss)), tpool,
            *(torch.from_numpy(a) for a in (sl, pt, kvlen)), page_size=PAGE,
        )
        _close(tlog.numpy()[0, :nv], np.asarray(jlog)[0, :nv], LOGIT_ATOL)
        _close(tpool.numpy()[:, :, :, PAGE:], np.asarray(jpool)[:, :, :, PAGE:], POOL_ATOL)
    cur = np.array([int(tlog[0, nv - 1].argmax())], np.int32)
    length = total
    for _ in range(4):
        length += 1
        pos = length - 1
        slots = np.array([pt[0, pos // PAGE] * PAGE + pos % PAGE], np.int32)
        lengths = np.array([length], np.int32)
        jlog, jpool = jl.decode_step(
            jparams, jcfg, jnp.asarray(cur), jpool, jnp.asarray(slots), jnp.asarray(pt),
            jnp.asarray(lengths), PAGE,
        )
        tlog = model.decode_step(
            torch.from_numpy(cur), tpool, torch.from_numpy(slots), torch.from_numpy(pt),
            torch.from_numpy(lengths), page_size=PAGE,
        )
        _close(tlog, jlog, LOGIT_ATOL)
        _close(tpool.numpy()[:, :, :, PAGE:], np.asarray(jpool)[:, :, :, PAGE:], POOL_ATOL)
        assert int(tlog.argmax()) == int(jnp.argmax(jlog))
        cur = tlog.argmax(-1).numpy().astype(np.int32)


ENGINE_KW = dict(num_slots=256, page_size=4, max_batch=4, long_prefill_threshold=24,
                 prefill_chunk=16)


def _run(engine, sampling_cls, waves):
    out = []
    for prompts in waves:
        reqs = [engine.add_request(p, sampling_cls(max_new_tokens=8)) for p in prompts]
        for _ in range(10_000):
            if not engine.has_work():
                break
            engine.step()
        out.extend((r.generated, r.prefix_len) for r in reqs)
    return out


def test_engine_greedy_token_exact(models):
    """A concurrent pair, a 40-token prompt (chunked prefill with prior >
    0) and a follow-up that hits the cache: the same tokens and cached
    counts as the JAX ``Engine`` on the same planted weights."""
    jcfg, jparams, tcfg, model = models
    rng = np.random.default_rng(3)
    a = rng.integers(0, tcfg.vocab_size, size=10).tolist()
    waves = [[a, rng.integers(0, tcfg.vocab_size, size=7).tolist()],
             [rng.integers(0, tcfg.vocab_size, size=40).tolist()],
             [a + rng.integers(0, tcfg.vocab_size, size=5).tolist()]]
    tparams = {"embed": model.embed, "final_norm": model.final_norm, "lm_head": model.lm_head,
               "layers": dict(model.layers)}
    want = _run(JEngine(jcfg, jparams, **ENGINE_KW), JSampling, waves)
    got = _run(TEngine(tcfg, tparams, device="cpu", **ENGINE_KW), TSampling, waves)
    assert got == want
    assert got[-1][1] > 0
