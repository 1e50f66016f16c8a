"""The port's pipelined forward (``radixmesh_tpu_torch/parallel/pipeline.py``)
against the JAX package: twins of ``tests/test_pipeline.py``'s forward cases
and of the PP-forward leg of ``dryrun_multichip``. The training step
through the pipeline waits for the training port (``ROADMAP.md`` A6) and is
refused by name.

The port's ranks are four processes over gloo (``tests/_torch_ranks.py``,
one group for the file): one process per stage, the stages handing
activations on by point-to-point and the last one broadcasting its hidden
state. The JAX references run here on conftest's virtual devices. float32
logits agree within rtol and atol 2e-4, the JAX test's tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.models import llama as jl
from radixmesh_tpu.parallel.pipeline import make_pp_mesh as j_pp_mesh
from radixmesh_tpu.parallel.pipeline import pipeline_forward as j_pipeline_forward
from radixmesh_tpu.parallel.pipeline import stage_params as j_stage_params
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import ModelConfig
from radixmesh_tpu_torch.parallel import make_pp_train_step, stage_params
from tests._torch_ranks import RankGroup

torch.set_num_threads(1)

JCFG = jl.ModelConfig.tiny().replace(n_layers=4, dtype=jnp.float32)
TCFG = ModelConfig.tiny().replace(n_layers=4, dtype=torch.float32)
JPARAMS = jl.init_params(JCFG, jax.random.PRNGKey(0))
NP_PARAMS = jax.tree_util.tree_map(np.asarray, JPARAMS)
PP = "tests._torch_pp_cases:"


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(4, str(tmp_path_factory.mktemp("ranks")))
    yield g
    g.close()


def reference_logits(tokens):
    B, S = tokens.shape
    positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    empty = jnp.zeros((JCFG.n_layers, B, 0, JCFG.n_kv_heads, JCFG.head_dim), dtype=JCFG.dtype)
    logits, _, _ = jl.prefill_forward(JPARAMS, JCFG, jnp.asarray(tokens), positions, empty, empty,
                                      jnp.zeros((B,), jnp.int32))
    return np.asarray(logits)


def _tokens(seed, shape=(4, 16)):
    return np.random.default_rng(seed).integers(1, JCFG.vocab_size, shape).astype(np.int64)


@pytest.mark.parametrize("pp,n_micro", [(2, 2), (2, 4), (4, 4)])
def test_pipeline_matches_reference(group, pp, n_micro):
    tokens = _tokens(0)
    want = reference_logits(tokens)
    jax_got = j_pipeline_forward(j_stage_params(JPARAMS, pp, j_pp_mesh(pp)), JCFG,
                                 jnp.asarray(tokens, jnp.int32), j_pp_mesh(pp), n_micro)
    res = [r for r in group.run(PP + "pipeline_logits", NP_PARAMS, TCFG, (1, 1, 1, pp), n_micro, tokens)
           if r is not None]
    assert len(res) == pp
    for stage, r in enumerate(res):
        np.testing.assert_allclose(r["logits"], want, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(r["logits"], np.asarray(jax_got), rtol=2e-4, atol=2e-4)
        # Per microbatch, every stage but the first received one activation
        # and every stage but the last sent one; the last one broadcast.
        assert r["collectives"]["p2p"]["calls"] == n_micro * ((stage > 0) + (stage < pp - 1))
        assert r["collectives"]["broadcast"]["calls"] == 1


def test_dryrun_pp_forward_leg(group):
    """``dryrun_multichip``'s PP-forward leg: a 2-stage pipeline with two
    microbatches gives finite logits of the batch's shape, equal on both
    stages."""
    tokens = _tokens(2)
    a, b = [r for r in group.run(PP + "pipeline_logits", NP_PARAMS, TCFG, (1, 1, 1, 2), 2, tokens)
            if r is not None]
    assert a["logits"].shape == (4, 16, JCFG.vocab_size)
    assert np.isfinite(a["logits"]).all()
    np.testing.assert_array_equal(a["logits"], b["logits"])


def test_stage_params_requires_divisibility():
    params = params_from_jax(NP_PARAMS, TCFG, "cpu")
    with pytest.raises(ValueError, match="not divisible"):
        stage_params(params, 3)
    with pytest.raises(ValueError, match="not divisible"):
        j_stage_params(JPARAMS, 3)
    staged = stage_params(params, 2)
    assert tuple(staged["layers"]["wq"].shape) == (2, 2, *params["layers"]["wq"].shape[1:])


def test_pp_train_step_is_refused_naming_a6():
    with pytest.raises(NotImplementedError, match="A6"):
        make_pp_train_step(TCFG, None, None, n_micro=2)
