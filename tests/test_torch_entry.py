"""The port's ``entry()`` (``radixmesh_tpu_torch/entry.py``) held against
the JAX package's (``__graft_entry__.entry``) on the same params: the
prefill over a right-aligned cached prefix gives the same logits, within
2e-5 (atol, float32: both sides in float32 over the JAX entry's shapes and
inputs) and 0.1 (atol, bfloat16 end to end, logits of magnitude ~4: a few
bf16 roundings of the activations); the default device is CUDA, and the
entry raises where torch has none."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from radixmesh_tpu.models import llama as jl
from radixmesh_tpu_torch.entry import entry
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import ModelConfig

torch.set_num_threads(1)  # the suite runs in parallel worker processes


@pytest.fixture(scope="module")
def jax_entry():
    fn, args = __graft_entry__.entry()
    return fn, args, jax.tree_util.tree_map(np.asarray, args[0])


def _check_inputs(args):
    _, tokens, positions, cached_k, _, prefix_lengths = args
    assert tokens.shape == (2, 16) and cached_k.shape[2] == 32
    assert prefix_lengths.tolist() == [32, 16]
    assert positions[1].tolist() == list(range(16, 32))


def test_bf16_entry_matches_jax(jax_entry):
    jfn, jargs, np_params = jax_entry
    want = np.asarray(jax.jit(jfn)(*jargs).astype(jnp.float32))
    cfg = ModelConfig.tiny()
    fn, args = entry(device="cpu", params=params_from_jax(np_params, cfg, "cpu"))
    _check_inputs(args)
    got = fn(*args).float().numpy()
    assert got.shape == want.shape == (2, 16, cfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=0.1, rtol=0)
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.9


def test_f32_entry_matches_jax(jax_entry):
    _, jargs, np_params = jax_entry
    jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
    p32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jargs[0])
    inputs = [a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a for a in jargs[1:]]
    want, _, _ = jl.prefill_forward(p32, jcfg, *inputs)
    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, p32), cfg, "cpu")
    fn, args = entry(device="cpu", params=params)
    assert args[3].dtype == torch.float32  # the cached K region takes the params' dtype
    np.testing.assert_allclose(fn(*args).numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_entry_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        entry()
    fn, args = entry(device="cpu")  # its own init_params(seed=0) weights
    out = fn(*args)
    assert out.shape == (2, 16, 512) and torch.isfinite(out.float()).all()
