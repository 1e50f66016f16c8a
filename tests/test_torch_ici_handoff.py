"""The port's device handoff (``IciHandoff`` in
``radixmesh_tpu_torch/engine/disagg.py`` and ``parallel/kv_transfer.py``)
against the JAX package: twins of ``tests/test_disagg.py::TestIciHandoff``
and of the ICI leg of ``dryrun_multichip``, and of the page transfer and
the prefill→decode permutation it rests on.

The port's ranks are four processes over gloo (``tests/_torch_ranks.py``,
one group for the file) on a ``(dp=4)`` mesh: the source rank prefills with
``device_kv=True``, ``IciHandoff.move`` carries the packet to the
destination rank, which decodes it. The moved block must be bit-equal to
the source's, and the tokens equal the JAX collocated engine's (float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from radixmesh_tpu.engine import Engine as JEngine
from radixmesh_tpu.engine import SamplingParams as JSampling
from radixmesh_tpu.engine.disagg import IciHandoff as JIciHandoff
from radixmesh_tpu.models import llama as jl
from radixmesh_tpu.parallel.kv_transfer import make_kv_page_transfer as j_transfer
from radixmesh_tpu.parallel.kv_transfer import prefill_to_decode_perm as j_perm
from radixmesh_tpu_torch.engine.disagg import IciHandoff
from radixmesh_tpu_torch.models.llama import ModelConfig
from radixmesh_tpu_torch.parallel import prefill_to_decode_perm
from tests._torch_ranks import RankGroup

torch.set_num_threads(1)

JCFG = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
TCFG = ModelConfig.tiny().replace(dtype=torch.float32)
PLAN = (4, 1, 1)  # one dp axis of four ranks, as the JAX test's ("dp",) mesh
PP = "tests._torch_pp_cases:"


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(4, str(tmp_path_factory.mktemp("ranks")))
    yield g
    g.close()


@pytest.fixture(scope="module")
def jmesh():
    return Mesh(np.asarray(jax.devices()[:4]), axis_names=("dp",))


def _params(key):
    p = jl.init_params(JCFG, jax.random.PRNGKey(key))
    return p, jax.tree_util.tree_map(np.asarray, p)


def _collocated(params, prompt, n_new, page):
    eng = JEngine(JCFG, params, num_slots=512, page_size=page, max_batch=2)
    return eng.generate([prompt], JSampling(max_new_tokens=n_new))[0]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_ici_move_is_lossless(group, kv_quant):
    """The destination's KV (and int8 scales) is bit-equal to the source
    packet's; the other two ranks get nothing."""
    _, np_params = _params(7)
    res = group.run(PP + "ici_handoff", np_params, TCFG, PLAN, "dp", 0, 2, list(range(1, 23)), 6, 4,
                    kv_quant)
    src, other1, dst, other3 = res
    assert [r["moved"] for r in res] == [False, False, True, False]
    assert dst["kv"].dtype == src["kv"].dtype
    np.testing.assert_array_equal(dst["kv"], src["kv"])
    if kv_quant:
        np.testing.assert_array_equal(dst["scale"], src["scale"])
    assert dst["p2p"]["bytes"] == src["p2p"]["bytes"] > 0
    assert other1["p2p"] is None and other3["p2p"] is None


@pytest.mark.parametrize("key,src,dst,prompt,n_new,page", [
    (7, 1, 3, list(range(30, 55)), 6, 4),  # test_disagg.py's end-to-end case
    (5, 0, 2, np.random.default_rng(1).integers(1, 512, 20).tolist(), 4, 8),  # the dryrun's ICI leg
])
def test_ici_handoff_end_to_end_tokens(group, key, src, dst, prompt, n_new, page):
    params, np_params = _params(key)
    want = _collocated(params, prompt, n_new, page)
    res = group.run(PP + "ici_handoff", np_params, TCFG, PLAN, "dp", src, dst, prompt, n_new, page)
    assert [r["moved"] for r in res] == [i == dst for i in range(4)]
    assert res[dst]["tokens"] == want
    assert res[dst]["prompt"] == prompt


def test_ici_rank_validation(jmesh):
    with pytest.raises(ValueError, match="outside axis"):
        JIciHandoff(jmesh, "dp", src_rank=0, dst_rank=9)

    class Line:  # the axis sizes are all the check reads
        def size(self, axis):
            return 4

    with pytest.raises(ValueError, match="outside axis"):
        IciHandoff(Line(), "dp", src_rank=0, dst_rank=9, device="cpu")
    with pytest.raises(ValueError, match="outside axis"):
        IciHandoff(Line(), "dp", src_rank=-1, dst_rank=2, device="cpu")


def test_kv_page_transfer_matches_jax(group, jmesh):
    """Each prefill rank's page block lands on its decode rank; ranks that
    are no destination get zeros, as the JAX ``ppermute`` gives them."""
    perm = prefill_to_decode_perm(2, 2)
    assert perm == j_perm(2, 2) == [(0, 2), (1, 3)]
    blocks = np.random.default_rng(3).normal(size=(4, 3, 4, 2, 8)).astype(np.float32)
    want = j_transfer(jmesh, "dp", perm)(
        jax.device_put(jnp.asarray(blocks.reshape(12, 4, 2, 8)), NamedSharding(jmesh, PartitionSpec("dp"))))
    want = np.asarray(want).reshape(blocks.shape)
    got = group.run(PP + "page_transfer", PLAN, "dp", perm, blocks)
    for i in range(4):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_array_equal(got[2], blocks[0])
    assert not got[0].any() and not got[1].any()


@pytest.mark.parametrize("n_prefill,n_decode", [(0, 1), (1, 0), (3, 2)])
def test_prefill_to_decode_perm_refusals_match_jax(n_prefill, n_decode):
    with pytest.raises(ValueError) as want:
        j_perm(n_prefill, n_decode)
    with pytest.raises(ValueError) as got:
        prefill_to_decode_perm(n_prefill, n_decode)
    assert str(got.value) == str(want.value)
