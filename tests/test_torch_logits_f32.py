"""The LM head's logits in a bf16 model are float32 products that were
never rounded to bf16, as the JAX ``_logits`` gives them
(``preferred_element_type=jnp.float32``): the port's ``Llama._logits`` on
``ModelConfig.tiny()`` in bf16, with the JAX ``init_params`` tree carried
across by ``models/convert.py``, matches the JAX ``_logits`` at atol 1e-5,
for a plain head, a tied one and a W8A16 one (the JAX quantized tree
carried across as it is)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import Llama, ModelConfig

torch.set_num_threads(1)  # the suite runs in parallel worker processes


@pytest.mark.parametrize("tied", [False, True], ids=["lm_head", "tied"])
@pytest.mark.parametrize("w8", [False, True], ids=["bf16", "w8a16"])
def test_bf16_logits_match_jax_in_float32(tied, w8):
    from radixmesh_tpu.models import llama as jl
    from radixmesh_tpu.ops import wquant as jw

    jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.bfloat16, tie_embeddings=tied)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(3))
    if w8:
        jparams = jw.quantize_params(jparams)
    cfg = ModelConfig.tiny().replace(dtype=torch.bfloat16, tie_embeddings=tied)
    model = Llama(cfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu"))
    assert (model.lm_head_s is not None or model.embed_s is not None) == w8

    x = np.random.default_rng(7).normal(0.0, 1.0, (3, 5, cfg.hidden)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jl._logits(jparams, jcfg, jx))
    got = model._logits(torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # A bf16-rounded product would sit on the bf16 grid; these do not.
    assert not torch.equal(got, got.to(torch.bfloat16).float())
