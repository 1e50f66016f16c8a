"""The port's mesh, sharding rules, ring and Ulysses attention and
multi-process bootstrap, against the JAX package (twins of
``tests/test_parallel.py``'s ``TestMeshPlan`` and ``TestParamSharding``,
``tests/test_ring_attention.py``, ``tests/test_ulysses.py`` and the
``init_multihost`` + ``global_mesh`` half of ``tests/test_multihost.py``;
the training cases wait for the training port).

The port's ranks are four processes over gloo (``tests/_torch_ranks.py``,
one group for the file; the multi-host case starts two more); the JAX
references run here on conftest's eight virtual CPU devices. Attention
outputs agree with the JAX functions within atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.models import llama as jl
from radixmesh_tpu.parallel.ring_attention import ring_self_attention as j_ring
from radixmesh_tpu.parallel.sharding import LOGICAL_RULES as J_RULES
from radixmesh_tpu.parallel.sharding import MeshPlan as JPlan
from radixmesh_tpu.parallel.sharding import logical_to_spec as j_spec
from radixmesh_tpu.parallel.sharding import make_mesh as j_make_mesh
from radixmesh_tpu.parallel.sharding import shard_params as j_shard_params
from radixmesh_tpu.parallel.ulysses import ulysses_self_attention as j_ulysses
from radixmesh_tpu_torch.models.llama import ModelConfig, param_logical_axes
from radixmesh_tpu_torch.parallel import LOGICAL_RULES, MeshPlan, logical_to_spec
from tests._torch_ranks import RankGroup

torch.set_num_threads(1)

CASES = "tests._torch_parallel_cases:"
JCFG = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
TCFG = ModelConfig.tiny().replace(dtype=torch.float32)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(4, str(tmp_path_factory.mktemp("ranks")))
    yield g
    g.close()


def _live(results):
    return [r for r in results if r is not None]


class TestMeshPlan:
    def test_auto_factorizations(self):
        for n in (8, 4, 2, 1, 16, 6, 12):
            j = JPlan.auto(n)
            assert MeshPlan.auto(n) == MeshPlan(dp=j.dp, sp=j.sp, tp=j.tp)
        assert MeshPlan.auto(8) == MeshPlan(dp=1, sp=2, tp=4)
        assert MeshPlan.auto(16) == MeshPlan(dp=2, sp=2, tp=4)

    def test_make_mesh_shape(self, group):
        layouts = group.run(CASES + "mesh_layout", (2, 1, 2))
        for rank, lay in enumerate(layouts):
            assert lay["shape"] == {"dp": 2, "pp": 1, "sp": 1, "tp": 2}
            # tp innermost: rank = dp * 2 + tp; (dp, pp, sp, tp).
            assert lay["coords"] == (rank // 2, 0, 0, rank % 2)
            assert lay["lines"]["tp"] == [rank // 2 * 2, rank // 2 * 2 + 1]
            assert lay["lines"]["dp"] == [rank % 2, rank % 2 + 2]
            assert lay["backend"] == "gloo"
        # A plan over fewer ranks leaves the others out of it.
        part = group.run(CASES + "mesh_layout", (1, 2, 1))
        assert part[2] is None and part[3] is None
        assert part[0]["coords"] == (0, 0, 0, 0) and part[1]["coords"] == (0, 0, 1, 0)

    def test_batch_sharding_takes_this_ranks_block(self, group):
        """Token batches: batch over dp, sequence over sp (the JAX
        ``batch_sharding``'s ``P("dp", "sp")``), tp ranks holding the same
        block."""
        x = np.arange(4 * 8).reshape(4, 8)
        blocks = group.run(CASES + "batch_block", (2, 2, 1), x)
        for rank, blk in enumerate(blocks):
            dp, sp = rank // 2, rank % 2
            np.testing.assert_array_equal(blk, x[dp * 2:(dp + 1) * 2, sp * 4:(sp + 1) * 4])
        tp = group.run(CASES + "batch_block", (1, 1, 4), x)
        for blk in tp:
            np.testing.assert_array_equal(blk, x)

    def test_too_many_devices_raises(self, group):
        for msg in group.run(CASES + "mesh_refused", (4, 2, 4)):
            assert "needs 32 processes, have 4" in msg


class TestParamSharding:
    def test_rules_and_axes_match_the_jax_package(self):
        assert LOGICAL_RULES == J_RULES
        for cfg_j, cfg_t in ((JCFG, TCFG),
                             (JCFG.replace(qkv_bias=True, tie_embeddings=True),
                              TCFG.replace(qkv_bias=True, tie_embeddings=True))):
            axes_j = jl.param_logical_axes(cfg_j)
            axes_t = param_logical_axes(cfg_t)
            assert axes_t == axes_j
            flat = jax.tree_util.tree_leaves(axes_j, is_leaf=lambda x: isinstance(x, tuple))
            for a in flat:
                assert logical_to_spec(a) == tuple(j_spec(a))

    def test_w8a16_scale_axes_match(self):
        from radixmesh_tpu.ops.wquant import quantize_params as j_quant

        params = j_quant(jl.init_params(JCFG, jax.random.PRNGKey(0)))
        np_params = jax.tree_util.tree_map(np.asarray, params)
        assert param_logical_axes(TCFG, np_params) == jl.param_logical_axes(JCFG, params)

    def test_tp_shards_heads_and_ffn(self, group):
        """Each rank's shard shapes equal the JAX package's addressable
        shards on a tp=2 mesh, W8A16 scales included."""
        from radixmesh_tpu.ops.wquant import quantize_params as j_quant

        params = j_quant(jl.init_params(JCFG, jax.random.PRNGKey(0)))
        jm = j_make_mesh(JPlan(dp=1, sp=1, tp=2))
        sharded = j_shard_params(params, jl.param_logical_axes(JCFG, params), jm)
        want = jax.tree_util.tree_map(lambda a: a.addressable_shards[0].data.shape, sharded)
        np_params = jax.tree_util.tree_map(np.asarray, params)
        got = _live(group.run(CASES + "shard_shapes", np_params, TCFG, (1, 1, 2)))
        assert len(got) == 2
        for shapes in got:
            assert shapes == want
        assert got[0]["layers"]["wq"][-1] == JCFG.n_heads * JCFG.head_dim // 2
        assert got[0]["layers"]["attn_norm"] == (JCFG.n_layers, JCFG.hidden)

    @pytest.mark.parametrize("plan", [(1, 1, 2), (2, 1, 2), (1, 2, 2)])
    def test_sharded_forward_matches_single_device(self, group, plan):
        params = jl.init_params(JCFG, jax.random.PRNGKey(0))
        b, s = 4, 16
        tokens = np.random.default_rng(1).integers(0, JCFG.vocab_size, (b, s))
        positions = jnp.broadcast_to(jnp.arange(s)[None], (b, s)).astype(jnp.int32)
        ck = jnp.zeros((JCFG.n_layers, b, 0, JCFG.n_kv_heads, JCFG.head_dim), JCFG.dtype)
        ref, _, _ = jl.prefill_forward(params, JCFG, jnp.asarray(tokens, jnp.int32), positions,
                                       ck, ck, jnp.zeros((b,), jnp.int32))
        np_params = jax.tree_util.tree_map(np.asarray, params)
        out = _live(group.run(CASES + "tp_prefill_logits", np_params, TCFG, plan, tokens))
        assert len(out) == int(np.prod(plan))
        for o in out:
            np.testing.assert_allclose(o, np.asarray(ref), atol=2e-4)


def _inputs(b=2, s=64, hq=4, hkv=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return mk(b, s, hq, d), mk(b, s, hkv, d), mk(b, s, hkv, d)


def _j(fn, sp, q, k, v):
    mesh = j_make_mesh(JPlan(dp=1, sp=sp, tp=1))
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh))


class TestRingAttention:
    @pytest.mark.parametrize("sp", [2, 4])
    @pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4)], ids=["gqa", "mha"])
    def test_matches_jax(self, group, sp, hq, hkv):
        q, k, v = _inputs(hq=hq, hkv=hkv)
        want = _j(j_ring, sp, q, k, v)
        out = _live(group.run(CASES + "ring", (1, sp, 1), q, k, v))
        assert len(out) == sp
        for o in out:
            np.testing.assert_allclose(o, want, atol=1e-5)

    def test_score_blocks_of_one_kv_head(self, group):
        """Scores bounded to one kv head's block at a time: the same output."""
        q, k, v = _inputs(hq=8, hkv=4)
        want = _j(j_ring, 2, q, k, v)
        one_head = 4 * 2 * 2 * 32 * 32  # b * g * c * c float32 scores
        for o in _live(group.run(CASES + "ring", (1, 2, 1), q, k, v, one_head)):
            np.testing.assert_allclose(o, want, atol=1e-5)

    def test_long_sequence_blocks(self, group):
        q, k, v = _inputs(b=1, s=256, hq=2, hkv=1, d=8, seed=3)
        want = _j(j_ring, 4, q, k, v)
        for o in _live(group.run(CASES + "ring", (1, 4, 1), q, k, v)):
            np.testing.assert_allclose(o, want, atol=1e-5)


class TestUlyssesAttention:
    @pytest.mark.parametrize("sp", [2, 4])
    def test_matches_jax_mha(self, group, sp):
        q, k, v = _inputs(hq=8, hkv=8)
        want = _j(j_ulysses, sp, q, k, v)
        for o in _live(group.run(CASES + "ulysses", (1, sp, 1), q, k, v)):
            np.testing.assert_allclose(o, want, atol=1e-5)

    @pytest.mark.parametrize("sp,hq,hkv", [(2, 8, 4), (4, 8, 2), (4, 8, 1)])
    def test_gqa_kv_paths(self, group, sp, hq, hkv):
        """hkv >= sp splits K/V heads like Q; hkv < sp takes the all-gather
        branch with per-rank kv-head slicing."""
        q, k, v = _inputs(hq=hq, hkv=hkv)
        want = _j(j_ulysses, sp, q, k, v)
        for o in _live(group.run(CASES + "ulysses", (1, sp, 1), q, k, v)):
            np.testing.assert_allclose(o, want, atol=1e-5)

    def test_indivisible_heads_rejected(self, group):
        q, k, v = _inputs(hq=2, hkv=2)  # 2 heads over 4 ranks
        for o in _live(group.run(CASES + "ulysses", (1, 4, 1), q, k, v)):
            assert o.startswith("ValueError") and "divisible" in o

    def test_agrees_with_ring(self, group):
        q, k, v = _inputs(hq=8, hkv=4)
        a = _live(group.run(CASES + "ulysses", (1, 4, 1), q, k, v))
        b = _live(group.run(CASES + "ring", (1, 4, 1), q, k, v))
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, atol=1e-5)


def test_two_process_init_multihost_global_mesh(tmp_path):
    """Two processes, one rank per host: ``init_multihost`` over a
    FileStore and ``global_mesh()`` put the host boundary on dp."""
    g = RankGroup(2, str(tmp_path), local_device_count=1)
    try:
        out = g.run(CASES + "global_mesh_layout")
    finally:
        g.close()
    assert [o["shape"] for o in out] == [{"dp": 2, "pp": 1, "sp": 1, "tp": 1}] * 2
    assert [o["coords"] for o in out] == [(0, 0, 0, 0), (1, 0, 0, 0)]
