"""The port's pipelined forward and train step
(``radixmesh_tpu_torch/parallel/pipeline.py``) against the JAX package:
twins of ``tests/test_pipeline.py`` (the forward cases and
``test_pp_train_step_matches_unpipelined_loss``, at pp = 2, pp = 2 x tp = 2
and pp = 4, with an untied head and with Qwen2's tied head and q/k/v
biases) and of the PP-forward leg of ``dryrun_multichip``.

The port's ranks are four processes over gloo (``tests/_torch_ranks.py``,
one group for the file): one process per stage, the stages handing
activations on by point-to-point and the last one broadcasting its hidden
state. The JAX references run here on conftest's virtual devices. float32
logits agree within rtol and atol 2e-4, the JAX test's tolerance; a train
step's loss within 1e-4 of the unpipelined loss (the JAX test's pin) and
within 1e-5 of the JAX pipeline's, every updated leaf within 1e-5 of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.models import llama as jl
import optax

from radixmesh_tpu.parallel.pipeline import make_pp_mesh as j_pp_mesh
from radixmesh_tpu.parallel.pipeline import make_pp_train_step as j_make_pp_train_step
from radixmesh_tpu.parallel.pipeline import pipeline_forward as j_pipeline_forward
from radixmesh_tpu.parallel.pipeline import stage_params as j_stage_params
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import ModelConfig
from radixmesh_tpu_torch.parallel import stage_params
from tests._torch_ranks import RankGroup

torch.set_num_threads(1)

JCFG = jl.ModelConfig.tiny().replace(n_layers=4, dtype=jnp.float32)
TCFG = ModelConfig.tiny().replace(n_layers=4, dtype=torch.float32)
JPARAMS = jl.init_params(JCFG, jax.random.PRNGKey(0))
NP_PARAMS = jax.tree_util.tree_map(np.asarray, JPARAMS)
PP = "tests._torch_pp_cases:"

# The Qwen2 shape: the LM head is the embedding (its gradient is the lookup's
# plus the head's) and q/k/v carry biases, planted non-zero.
TIED_JCFG = JCFG.replace(tie_embeddings=True, qkv_bias=True)
TIED_TCFG = TCFG.replace(tie_embeddings=True, qkv_bias=True)
TIED_NP = jax.tree_util.tree_map(np.asarray, jl.init_params(TIED_JCFG, jax.random.PRNGKey(3)))
for _i, _b in enumerate(("bq", "bk", "bv")):
    TIED_NP["layers"][_b] = np.random.default_rng(_i).normal(
        0, 0.1, TIED_NP["layers"][_b].shape).astype(np.float32)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(4, str(tmp_path_factory.mktemp("ranks")))
    yield g
    g.close()


def reference_logits(tokens, cfg=JCFG, np_params=None):
    B, S = tokens.shape
    params = JPARAMS if np_params is None else jax.tree_util.tree_map(jnp.asarray, np_params)
    positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    empty = jnp.zeros((cfg.n_layers, B, 0, cfg.n_kv_heads, cfg.head_dim), dtype=cfg.dtype)
    logits, _, _ = jl.prefill_forward(params, cfg, jnp.asarray(tokens), positions, empty, empty,
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


@pytest.mark.parametrize("plan,tied", [((1, 1, 1, 2), False), ((1, 1, 2, 2), False),
                                       ((1, 1, 1, 4), False), ((1, 1, 1, 2), True), ((1, 1, 2, 2), True)])
def test_pp_train_step_matches_unpipelined_loss(group, plan, tied):
    """Two SGD steps through a 2-stage pipeline (alone, and with tp = 2 in
    each stage) and a 4-stage one (its middle stages both receive and
    send), two microbatches, with an untied head and with the tied head
    and q/k/v biases of Qwen2: the loss equals the unpipelined loss and
    the JAX pipeline's, the trained leaves JAX's; the second step's loss is
    lower and the layers moved (the gradients flowed back through the
    stages, not only into the head); every rank holds the same tree."""
    jcfg, tcfg, np_params = (TIED_JCFG, TIED_TCFG, TIED_NP) if tied else (JCFG, TCFG, NP_PARAMS)
    pp = plan[3]
    mesh = j_pp_mesh(pp)
    jparams = j_stage_params(jax.tree_util.tree_map(jnp.asarray, np_params), pp, mesh)
    opt = optax.sgd(1e-2)
    step = j_make_pp_train_step(jcfg, mesh, opt, n_micro=2)
    tokens = np.random.default_rng(1).integers(1, jcfg.vocab_size, (4, 12))
    jtok = jnp.asarray(tokens, jnp.int32)
    logp = jax.nn.log_softmax(jnp.asarray(reference_logits(tokens[:, :-1], jcfg, np_params), jnp.float32),
                              axis=-1)
    want = float(-jnp.take_along_axis(logp, jtok[:, 1:, None], axis=-1).mean())
    state1, jloss1 = step((jparams, opt.init(jparams)), jtok)
    state2, jloss2 = step(state1, jtok)
    jtree = jax.tree_util.tree_map(np.asarray, state1[0])
    jtree["layers"] = {k: v.reshape(-1, *v.shape[2:]) for k, v in jtree["layers"].items()}
    res = [r for r in group.run("tests._torch_train_cases:train_steps", np_params, tcfg, plan, tokens, "sgd", 1,
                                n_micro=2) if r is not None]
    two = [r for r in group.run("tests._torch_train_cases:train_steps", np_params, tcfg, plan, tokens, "sgd", 2,
                                n_micro=2) if r is not None]
    assert len(res) == len(two) == plan[2] * plan[3]
    top = ("embed", "final_norm") + (() if tied else ("lm_head",))
    assert ("lm_head" in res[0]["whole"]) is not tied
    for r, r2 in zip(res, two):
        assert abs(r["losses"][0] - want) < 1e-4
        assert abs(r["losses"][0] - float(jloss1)) < 1e-5
        for k, v in jtree["layers"].items():
            np.testing.assert_allclose(r["whole"]["layers"][k], v, rtol=0, atol=1e-5, err_msg=k)
        for k in top:
            np.testing.assert_allclose(r["whole"][k], jtree[k], rtol=0, atol=1e-5, err_msg=k)
        assert abs(r2["losses"][1] - float(jloss2)) < 1e-5
        assert r2["losses"][1] < r2["losses"][0]
        assert np.abs(r["whole"]["layers"]["wq"] - np_params["layers"]["wq"]).max() > 0
        assert np.abs(r["whole"]["embed"] - np_params["embed"]).max() > 0
        for k, v in res[0]["whole"].items():
            for leaf, a in (v.items() if isinstance(v, dict) else [(k, v)]):
                np.testing.assert_array_equal(r["whole"][k][leaf] if isinstance(v, dict) else r["whole"][k], a)
