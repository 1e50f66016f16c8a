"""W8A16 weights in the port (``radixmesh_tpu_torch/ops/wquant.py`` and
the ``_proj`` / ``_embed`` / ``_logits`` seams of ``models/llama.py``):
twins of ``tests/test_wquant.py`` on the CPU (its pipeline-parallel case
waits for the port's parallelism), held against the JAX package: the
quantized leaves exactly and the scales to rtol 1e-6, ``random_w8_params``
leaf for leaf, W8A16 prefill logits within atol 1e-4 in float32, and the
W8A16 engines' greedy tokens. Also ``PagedKVPool.write_block`` (the
handoff's write) against the JAX pool's, for each dtype dispatch, with a
block of a few layers and a full-layer one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu_torch.engine import Engine, SamplingParams
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import Llama, ModelConfig, w8_scale_shapes
from radixmesh_tpu_torch.ops.wquant import LAYER_QUANT_WEIGHTS, quantize_params, quantize_weight, random_w8_params

torch.set_num_threads(1)  # the suite runs in parallel worker processes


@pytest.fixture(scope="module")
def model():
    """The tiny float32 config with the JAX package's weights, as the JAX
    tree and as the port's."""
    from radixmesh_tpu.models import llama as jl

    jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(11))
    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")
    return cfg, params, jcfg, jparams


def _np(t):
    return np.asarray(t)


class TestQuantizeWeight:
    def test_round_trip_error_bounded(self):
        rng = np.random.default_rng(0)
        w = torch.as_tensor(rng.normal(size=(64, 96)), dtype=torch.float32)
        q, s = quantize_weight(w, axis=0)
        assert q.dtype == torch.int8
        assert s.shape == (96,)
        deq = q.float() * s[None, :]
        # Symmetric int8 per channel: error <= scale / 2 per element.
        assert torch.all((deq - w).abs() <= s[None, :] * 0.5 + 1e-7)

    def test_outlier_channel_isolated(self):
        """One huge output channel must not inflate the others' scales."""
        w = torch.ones(8, 4)
        w[:, 2] = 1000.0
        _, s = quantize_weight(w, axis=0)
        assert s[2] > 5.0 and torch.all(s[[0, 1, 3]] < 0.01)


class TestQuantizeParams:
    def test_leaves_and_scales(self, model):
        cfg, params, _, _ = model
        qp = quantize_params(params)
        for name in LAYER_QUANT_WEIGHTS:
            w = qp["layers"][name]
            assert w.dtype == torch.int8, name
            assert qp["layers"][name + "_s"].shape == w.shape[:1] + w.shape[2:], name
        assert qp["embed"].dtype == torch.int8
        assert qp["embed_s"].shape == (cfg.vocab_size,)
        assert qp["lm_head"].dtype == torch.int8
        assert qp["lm_head_s"].shape == (cfg.vocab_size,)
        # Norms stay full precision; the input tree is untouched.
        assert qp["final_norm"].dtype == params["final_norm"].dtype
        assert params["layers"]["wq"].dtype == torch.float32
        # Idempotent.
        qp2 = quantize_params(qp)
        assert qp2["layers"]["wq"] is qp["layers"]["wq"]

    def test_scale_shapes_cover_scales(self, model):
        """The port's twin of the JAX sharding-axes check: every scale leaf
        of a quantized tree has the shape ``w8_scale_shapes`` names for its
        weight, and ``Llama`` loads the tree with every leaf accounted for."""
        cfg, params, _, _ = model
        qp = quantize_params(params)
        shapes = w8_scale_shapes(cfg)
        for name in LAYER_QUANT_WEIGHTS:
            assert tuple(qp["layers"][name + "_s"].shape) == shapes[name], name
        assert tuple(qp["embed_s"].shape) == shapes["embed"]
        assert tuple(qp["lm_head_s"].shape) == shapes["lm_head"]
        m = Llama(cfg, qp)
        n_leaves = len(qp["layers"]) + sum(1 for k in qp if k != "layers")
        assert len(list(m.parameters())) == n_leaves
        assert m.weight_quant == "int8" and m.layers["wq"].dtype == torch.int8
        bad = dict(qp, embed_s=qp["embed_s"][:-1])
        with pytest.raises(ValueError, match="embed_s"):
            Llama(cfg, bad)

    def test_matches_the_jax_quantize_params(self, model):
        """int8 leaves equal exactly, scales to rtol 1e-6 (eager jnp and
        torch divide alike)."""
        from radixmesh_tpu.ops import wquant as jw

        _, params, _, jparams = model
        qp, jq = quantize_params(params), jw.quantize_params(jparams)
        for name in LAYER_QUANT_WEIGHTS:
            np.testing.assert_array_equal(qp["layers"][name].numpy(), _np(jq["layers"][name]), name)
            np.testing.assert_allclose(qp["layers"][name + "_s"].numpy(), _np(jq["layers"][name + "_s"]),
                                       rtol=1e-6)
        for name in ("embed", "lm_head"):
            np.testing.assert_array_equal(qp[name].numpy(), _np(jq[name]), name)
            np.testing.assert_allclose(qp[name + "_s"].numpy(), _np(jq[name + "_s"]), rtol=1e-6)

    def test_logits_close_to_full_precision(self, model):
        cfg, params, _, _ = model
        ref, w8 = Llama(cfg, params), Llama(cfg, quantize_params(params))
        tokens, positions, ck, pl = _prefill_inputs(cfg)
        want = ref.prefill_forward(tokens, positions, ck, ck, pl)[0].numpy()
        got = w8.prefill_forward(tokens, positions, ck, ck, pl)[0].numpy()
        # Per-channel int8 weights: logits track within a small fraction of
        # the logit range.
        assert np.abs(got - want).max() < 0.05 * np.abs(want).max()
        assert (want.argmax(-1) == got.argmax(-1)).mean() >= 0.9

    def test_prefill_logits_match_jax(self, model):
        """W8A16 prefill logits, port against JAX, float32: atol 1e-4."""
        from radixmesh_tpu.models import llama as jl
        from radixmesh_tpu.ops import wquant as jw

        cfg, params, jcfg, jparams = model
        w8 = Llama(cfg, quantize_params(params))
        tokens, positions, ck, pl = _prefill_inputs(cfg)
        got = w8.prefill_forward(tokens, positions, ck, ck, pl)[0].numpy()
        jck = jnp.zeros(ck.shape, jnp.float32)
        want, _, _ = jl.prefill_forward(
            jw.quantize_params(jparams), jcfg, jnp.asarray(tokens.numpy(), jnp.int32),
            jnp.asarray(positions.numpy(), jnp.int32), jck, jck, jnp.zeros((2,), jnp.int32),
        )
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4)


def _prefill_inputs(cfg):
    rng = np.random.default_rng(5)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 12)))
    positions = torch.arange(12).expand(2, 12).contiguous()
    ck = torch.zeros(cfg.n_layers, 2, 0, cfg.n_kv_heads, cfg.head_dim)
    return tokens, positions, ck, torch.zeros(2, dtype=torch.long)


def _engine(cfg, params, **kw):
    kw = dict(num_slots=256, page_size=4, max_batch=2, max_seq_len=64, device="cpu") | kw
    return Engine(cfg, params, **kw)


class TestEngineWeightQuant:
    def test_generate_runs_and_tracks_bf16(self, model):
        cfg, params, _, _ = model
        prompts = [np.random.default_rng(7).integers(0, cfg.vocab_size, 10).tolist() for _ in range(2)]
        eng = _engine(cfg, params, weight_quant="int8")
        assert eng.weight_quant == "int8" and eng.model.layers["w_up"].dtype == torch.int8
        out = eng.generate(prompts, SamplingParams(max_new_tokens=6))
        assert all(len(o) == 6 for o in out)
        assert all(0 <= t < cfg.vocab_size for o in out for t in o)

    def test_greedy_tokens_match_the_jax_engine(self, model):
        from radixmesh_tpu.engine import Engine as JEngine
        from radixmesh_tpu.engine import SamplingParams as JSampling

        cfg, params, jcfg, jparams = model
        rng = np.random.default_rng(8)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (10, 23)]
        want = JEngine(jcfg, jparams, num_slots=256, page_size=4, max_batch=2, max_seq_len=64,
                       weight_quant="int8").generate(prompts, JSampling(max_new_tokens=6))
        got = _engine(cfg, params, weight_quant="int8").generate(prompts, SamplingParams(max_new_tokens=6))
        assert got == want

    def test_weight_quant_values_and_models(self, model):
        cfg, params, _, _ = model
        with pytest.raises(ValueError, match="unknown weight quantization"):
            _engine(cfg, params, weight_quant="int4")
        # A W8A16 Llama is taken as it is; a full-precision one is quantized.
        w8 = Llama(cfg, quantize_params(params))
        assert _engine(cfg, w8, weight_quant="int8").model is w8
        assert _engine(cfg, w8).weight_quant == "int8"
        eng = _engine(cfg, Llama(cfg, params), weight_quant="int8")
        assert eng.model.embed.dtype == torch.int8
        torch.testing.assert_close(eng.model.layers["wq_s"], w8.layers["wq_s"], rtol=0, atol=0)


class TestRandomW8Params:
    def test_decodes_through_engine(self, model):
        cfg = model[0]
        params = random_w8_params(cfg, seed=3)
        assert params["layers"]["wq"].dtype == np.int8
        assert params["embed"].dtype == np.int8
        eng = _engine(cfg, params_from_jax(params, cfg, "cpu"))
        prompts = [np.random.default_rng(4).integers(0, cfg.vocab_size, 9).tolist()]
        assert len(eng.generate(prompts, SamplingParams(max_new_tokens=5))[0]) == 5

    def test_matches_quantize_params_scheme(self, model):
        cfg = model[0]
        p = random_w8_params(cfg, seed=0)
        L = cfg.n_layers
        assert p["layers"]["wq_s"].shape == (L, cfg.n_heads * cfg.head_dim)
        assert p["layers"]["w_down_s"].shape == (L, cfg.hidden)
        assert p["embed_s"].shape == (cfg.vocab_size,)
        deq = p["layers"]["wq"][0].astype(np.float32) * p["layers"]["wq_s"][0]
        assert np.abs(deq).std() > 0
        assert p["layers"]["wq"].max() == 127 or p["layers"]["wq"].min() == -127

    @pytest.mark.parametrize("preset", ["llama3-tiny", "qwen2-tiny"])
    def test_equals_the_jax_function(self, preset):
        """The same ``default_rng`` draws: every leaf equal for the same
        config and seed (norms and biases as float32 values)."""
        from radixmesh_tpu.models import get_config as jget
        from radixmesh_tpu.ops.wquant import random_w8_params as jrandom
        from radixmesh_tpu_torch.models import get_config

        want = jrandom(jget(preset, dtype=jnp.float32), seed=5, dtype=jnp.float32)
        got = random_w8_params(get_config(preset), seed=5)
        flat_w, tree_w = jax.tree_util.tree_flatten(want)
        flat_g, tree_g = jax.tree_util.tree_flatten(got)
        assert tree_w == tree_g
        for w, g in zip(flat_w, flat_g):
            assert w.dtype == g.dtype and w.shape == g.shape
            np.testing.assert_array_equal(g, w)


class TestW8Compositions:
    def test_spec_decode_compose(self, model):
        """Speculative decode over W8A16 weights: greedy output equal to the
        non-speculative W8A16 engine's."""
        cfg, params, _, _ = model
        prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 12).tolist()
        prompt = prompt + prompt[:6]
        sampling = SamplingParams(max_new_tokens=8)
        kw = dict(max_batch=1, max_seq_len=96, weight_quant="int8")
        want = _engine(cfg, params, **kw).generate([prompt], sampling)[0]
        spec = _engine(cfg, params, spec_decode_tokens=3, **kw)
        assert spec.generate([prompt], sampling)[0] == want
        # A replay drafts from the tree's published continuation, so the
        # equality is not vacuous.
        assert spec.generate([prompt], sampling)[0] == want
        assert spec.stats.spec_accepted > 0

    def test_qwen2_bias_compose(self):
        """Qwen2's biases stay full precision and add after the scale."""
        from radixmesh_tpu_torch.models import get_config
        from radixmesh_tpu_torch.models.llama import init_params

        cfg = get_config("qwen2-tiny", dtype=torch.float32)
        assert cfg.qkv_bias
        params = init_params(cfg, seed=4, device="cpu")
        gen = torch.Generator().manual_seed(5)
        for name in ("bq", "bk", "bv"):
            params["layers"][name] = torch.randn(params["layers"][name].shape, generator=gen) * 0.1
        prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, 10).tolist()
        sampling = SamplingParams(max_new_tokens=6)
        base = _engine(cfg, params, max_batch=1).generate([prompt], sampling)[0]
        w8 = _engine(cfg, params, max_batch=1, weight_quant="int8").generate([prompt], sampling)[0]
        assert len(w8) == 6
        assert sum(a == b for a, b in zip(base, w8)) >= 4, (base, w8)


# ---------------------------------------------------------------------------
# PagedKVPool.write_block against the JAX pool's
# ---------------------------------------------------------------------------

L_POOL, H_POOL, D_POOL, S_POOL = 4, 2, 32, 64


def _pools(quant):
    from radixmesh_tpu.cache.kv_pool import PagedKVPool as JPool
    from radixmesh_tpu_torch.cache.kv_pool import PagedKVPool

    jp = JPool(S_POOL, L_POOL, H_POOL, D_POOL, page_size=4, dtype=jnp.float32, quant=quant)
    tp = PagedKVPool(S_POOL, L_POOL, H_POOL, D_POOL, page_size=4, dtype=torch.float32, device="cpu",
                     quant=quant)
    return jp, tp


def _state(jp, tp):
    j = [np.asarray(jp.kv)] + ([] if jp.kv_scale is None else [np.asarray(jp.kv_scale)])
    t = [tp.kv.numpy()] + ([] if tp.kv_scale is None else [tp.kv_scale.numpy()])
    return j, t


@pytest.mark.parametrize("layer0,n_layers", [(1, 2), (0, L_POOL)], ids=["layers 1-2", "all layers"])
@pytest.mark.parametrize("dispatch", ["plain cast", "int8 quantize on store", "int8 raw with scales"])
def test_write_block_matches_the_jax_pool(dispatch, layer0, n_layers):
    rng = np.random.default_rng(layer0 + n_layers)
    slots = np.array([5, 6, 7, 8, 20, 33], np.int32)
    block = rng.standard_normal((2, n_layers, len(slots), H_POOL, D_POOL)).astype(np.float32)
    quant = None if dispatch == "plain cast" else "int8"
    jp, tp = _pools(quant)
    if dispatch == "int8 raw with scales":
        q = rng.integers(-127, 128, block.shape).astype(np.int8)
        s = rng.random(block.shape[:-1]).astype(np.float32)
        jp.write_block(slots, jnp.asarray(q), layer0, scales=jnp.asarray(s))
        tp.write_block(slots, torch.as_tensor(q), layer0, scales=torch.as_tensor(s))
    else:
        jp.write_block(slots, jnp.asarray(block), layer0)
        tp.write_block(slots, torch.as_tensor(block), layer0)
    want, got = _state(jp, tp)
    np.testing.assert_array_equal(got[0], want[0])
    if len(want) > 1:
        # The JAX quantize-on-store scatter is jitted, where XLA multiplies
        # by 1/127 and the port divides (ROADMAP.md, expected divergences):
        # scales to rtol 1e-6, payloads exact.
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=0)
    if n_layers < L_POOL:
        untouched = [l for l in range(L_POOL) if not layer0 <= l < layer0 + n_layers]
        assert not tp.kv[:, untouched].any()


def test_write_block_refuses_scales_into_a_plain_pool():
    _, tp = _pools(None)
    kv = torch.zeros(2, 2, 3, H_POOL, D_POOL, dtype=torch.int8)
    with pytest.raises(ValueError, match="quantized pools"):
        tp.write_block(np.arange(3), kv, 1, scales=torch.ones(2, 2, 3, H_POOL))
