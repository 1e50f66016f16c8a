"""The port's Llama held against the JAX model on the CPU, on the tiny config
in float32 with the same weights (``params_from_jax`` on the JAX
``init_params`` tree). Tolerances: logits atol 1e-4 (float32 through two
layers, different summation order), pool contents atol 1e-5; greedy tokens
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.models import llama as jl
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import Llama, ModelConfig

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(1)  # the suite runs in parallel worker processes
LOGIT_ATOL = 1e-4
POOL_ATOL = 1e-5
PAGE = 4


@pytest.fixture(scope="module")
def models():
    jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree_util.tree_map(np.asarray, jparams)
    tcfg = ModelConfig.tiny().replace(dtype=torch.float32)
    model = Llama(tcfg, params_from_jax(np_tree, tcfg, "cpu"))
    return jcfg, jparams, tcfg, model


def _close(got, want, atol):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), rtol=0, atol=atol
    )


def _pool(cfg, num_slots=256):
    return np.zeros((2, cfg.n_layers, cfg.n_kv_heads, num_slots, cfg.head_dim), np.float32)


def test_params_from_jax_bf16_is_exact():
    jcfg = jl.ModelConfig.tiny()
    np_tree = jax.tree_util.tree_map(np.asarray, jl.init_params(jcfg, jax.random.PRNGKey(1)))
    tcfg = ModelConfig.tiny()
    params = params_from_jax(np_tree, tcfg, "cpu")
    assert params["layers"]["wq"].dtype == torch.bfloat16
    for got, want in (
        (params["embed"], np_tree["embed"]),
        (params["layers"]["w_down"], np_tree["layers"]["w_down"]),
        (params["lm_head"], np_tree["lm_head"]),
    ):
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_prefill_forward_with_cached_prefix(models):
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


def test_prefill_chunk_paged_two_chunks(models):
    """Chunk 1 cold, chunk 2 against chunk 1's pool pages (prior > 0), one
    row ragged and partial; logits and the whole pool against JAX."""
    jcfg, jparams, tcfg, model = models
    rng = np.random.default_rng(1)
    C, maxp, num_slots = 8, 32, 256
    totals = [16, 11]
    pages = rng.permutation(num_slots // PAGE)[: 2 * 4].reshape(2, 4)
    pt = np.zeros((2, maxp), np.int32)
    pt[:, :4] = pages
    prompts = [rng.integers(0, tcfg.vocab_size, size=t).astype(np.int32) for t in totals]
    jpool, tpool = jnp.asarray(_pool(tcfg, num_slots)), torch.from_numpy(_pool(tcfg, num_slots))
    for ci in range(2):
        toks = np.zeros((2, C), np.int32)
        sl = np.zeros((2, C), np.int32)
        poss = np.zeros((2, C), np.int32)
        kvlen = np.zeros(2, np.int32)
        for i, t in enumerate(totals):
            start = ci * C
            nv = min(max(t - start, 0), C)
            poss[i] = start + np.arange(C)
            toks[i, :nv] = prompts[i][start : start + nv]
            p = start + np.arange(C)
            sl[i] = pt[i, p // PAGE] * PAGE + p % PAGE
            sl[i, nv:] = 0  # pad → slot 0 (scratch in the engine)
            kvlen[i] = start + nv
        jlog, jpool = jl.prefill_chunk_paged(
            jparams, jcfg, *(jnp.asarray(a) for a in (toks, poss)), jpool,
            *(jnp.asarray(a) for a in (sl, pt, kvlen)), page_size=PAGE,
        )
        tlog = model.prefill_chunk_paged(
            *(torch.from_numpy(a) for a in (toks, poss)), tpool,
            *(torch.from_numpy(a) for a in (sl, pt, kvlen)), page_size=PAGE,
        )
        valid = np.arange(C)[None, :] < (kvlen - ci * C)[:, None]
        _close(tlog.numpy()[valid], np.asarray(jlog)[valid], LOGIT_ATOL)
        # Slot 0 is the shared pad target (last write wins in both): skip it.
        _close(tpool.numpy()[:, :, :, 1:], np.asarray(jpool)[:, :, :, 1:], POOL_ATOL)


def test_decode_steps_greedy_token_exact(models):
    """Prefill two rows, then 8 greedy decode steps through decode_step:
    logits and pool against JAX at every step, tokens exact."""
    jcfg, jparams, tcfg, model = models
    rng = np.random.default_rng(2)
    num_slots, maxp = 256, 8
    B = 3  # row 2 is inactive (length 1 on the scratch slot 0)
    lens = np.array([9, 5, 0])
    pt = np.zeros((B, maxp), np.int32)
    pt[0, :] = 1 + np.arange(maxp)
    pt[1, :] = 1 + maxp + rng.permutation(maxp)
    jpool = jnp.asarray(_pool(tcfg, num_slots))
    tpool = torch.from_numpy(_pool(tcfg, num_slots))
    cur = rng.integers(0, tcfg.vocab_size, size=B).astype(np.int32)
    t_toks, j_toks = [], []
    for step in range(8 + 9):
        active = lens > 0
        lengths = np.where(active, lens + 1, 1).astype(np.int32)
        pos = lengths - 1
        slots = np.where(active, pt[np.arange(B), pos // PAGE] * PAGE + pos % PAGE, 0)
        slots = slots.astype(np.int32)
        jlog, jpool = jl.decode_step(
            jparams, jcfg, jnp.asarray(cur), jpool, jnp.asarray(slots), jnp.asarray(pt),
            jnp.asarray(lengths), PAGE,
        )
        tlog = model.decode_step(
            torch.from_numpy(cur), tpool, torch.from_numpy(slots), torch.from_numpy(pt),
            torch.from_numpy(lengths), page_size=PAGE,
        )
        _close(tlog.numpy()[active], np.asarray(jlog)[active], LOGIT_ATOL)
        _close(tpool.numpy()[:, :, :, PAGE:], np.asarray(jpool)[:, :, :, PAGE:], POOL_ATOL)
        nxt_t = tlog.argmax(-1).numpy().astype(np.int32)
        nxt_j = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
        t_toks.append(nxt_t[active])
        j_toks.append(nxt_j[active])
        cur = nxt_t
        lens = np.where(active, lens + 1, 0)
    np.testing.assert_array_equal(np.stack(t_toks), np.stack(j_toks))
