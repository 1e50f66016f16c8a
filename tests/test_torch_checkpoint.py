"""The port's checkpoint module (``radixmesh_tpu_torch/checkpoint.py``) against
the JAX package's: the twins of every case of ``tests/test_checkpoint.py``,
and tree snapshots crossing between the packages both ways.

Weights: the JAX package writes orbax, the port safetensors
(``models/hf_io.py``), so the weight twins round-trip the port's own format:
bit-equal leaves, and ``load_params(mesh=)`` equal to ``shard_params`` of the
whole tree on every coordinate of tp = 2, pp = 2 and pp = 2 x tp = 2 meshes
(the counterpart of JAX's restore onto a mesh). Tree snapshots are one
format: a snapshot either package writes loads in the other, the KV content
equal through the float32 container (bf16 pools bit-equal, int8 payloads
exact and scales within rtol 1e-6, as the JAX test holds its own).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.cache.kv_pool import PagedKVPool as JPool
from radixmesh_tpu.cache.radix_tree import RadixTree as JTree
from radixmesh_tpu.checkpoint import load_tree as j_load_tree
from radixmesh_tpu.checkpoint import save_tree as j_save_tree
from radixmesh_tpu_torch.cache.kv_pool import PagedKVPool, SlotAllocator
from radixmesh_tpu_torch.cache.radix_tree import RadixTree
from radixmesh_tpu_torch.checkpoint import (
    load_params,
    load_tree,
    save_params,
    save_tree,
    tree_restore,
    tree_snapshot,
)
from radixmesh_tpu_torch.models.llama import ModelConfig, init_params, param_logical_axes
from radixmesh_tpu_torch.parallel import MeshPlan, ProcessMesh, shard_params
from radixmesh_tpu_torch.parallel.sharding import AXES


def _leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _assert_trees_equal(a: dict, b: dict):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k], lb[k]), k


def _coords(plan: MeshPlan):
    """A ``ProcessMesh`` at every coordinate of ``plan`` (no process group:
    sharding reads only sizes and indices)."""
    sizes = tuple(getattr(plan, a) for a in AXES)
    for rank, coords in enumerate(np.ndindex(*sizes)):
        yield ProcessMesh(plan=plan, rank=rank, coords=tuple(int(c) for c in coords), backend=None,
                          groups={}, lines={})


class TestParamsCheckpoint:
    def test_round_trip(self, tmp_path):
        cfg = ModelConfig.tiny().replace(dtype=torch.float32)
        params = init_params(cfg, 0, "cpu")
        path = str(tmp_path / "ckpt")
        save_params(path, params)
        _assert_trees_equal(load_params(path, device="cpu"), params)
        # A second save replaces the first in place.
        params2 = init_params(cfg, 1, "cpu")
        save_params(path, params2)
        _assert_trees_equal(load_params(path, device="cpu"), params2)
        assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt"]

    def test_bf16_and_w8a16_trees_round_trip(self, tmp_path):
        from radixmesh_tpu_torch.ops.wquant import random_w8_params
        from radixmesh_tpu_torch.models.convert import params_from_jax

        cfg = ModelConfig.tiny().replace(qkv_bias=True, tie_embeddings=True)
        bf16 = init_params(cfg, 0, "cpu")
        save_params(str(tmp_path / "bf16"), bf16)
        _assert_trees_equal(load_params(str(tmp_path / "bf16"), device="cpu"), bf16)
        w8 = params_from_jax(random_w8_params(ModelConfig.tiny(), 0), ModelConfig.tiny(), "cpu")
        save_params(str(tmp_path / "w8"), w8)
        _assert_trees_equal(load_params(str(tmp_path / "w8"), device="cpu"), w8)

    @pytest.mark.parametrize("plan", [MeshPlan(tp=2), MeshPlan(pp=2), MeshPlan(tp=2, pp=2)],
                             ids=["tp2", "pp2", "pp2xtp2"])
    def test_restore_onto_mesh(self, tmp_path, plan):
        cfg = ModelConfig.tiny().replace(dtype=torch.float32)
        params = init_params(cfg, 0, "cpu")
        path = str(tmp_path / "ckpt")
        save_params(path, params)
        qd = cfg.n_heads * cfg.head_dim
        for mesh in _coords(plan):
            got = load_params(path, mesh=mesh, device="cpu")
            _assert_trees_equal(got, shard_params(params, param_logical_axes(cfg), mesh))
            assert got["layers"]["wq"].shape == (cfg.n_layers // plan.pp, cfg.hidden, qd // plan.tp)

    def test_entry_point_asks_for_cuda(self, tmp_path):
        cfg = ModelConfig.tiny().replace(dtype=torch.float32)
        save_params(str(tmp_path / "c"), init_params(cfg, 0, "cpu"))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                load_params(str(tmp_path / "c"))


def build_tree(page_size=1):
    tree = RadixTree(page_size=page_size)
    tree.insert([1, 2, 3, 4], np.arange(4, dtype=np.int32))
    tree.insert([1, 2, 9, 9], np.array([0, 1, 10, 11], dtype=np.int32))
    tree.insert([7, 7], np.array([20, 21], dtype=np.int32))
    return tree


def fresh_pool(num_layers=2, num_kv_heads=2, dtype=torch.float32, quant=None, page_size=4):
    return PagedKVPool(num_slots=64, num_layers=num_layers, num_kv_heads=num_kv_heads, head_dim=4,
                       page_size=page_size, dtype=dtype, device="cpu", quant=quant)


def _filled(pool, tree, seed, n=8):
    slots = pool.alloc(n)
    rng = np.random.default_rng(seed)
    shape = (pool.num_layers, n, pool.num_kv_heads, pool.head_dim)
    pool.write(slots, torch.as_tensor(rng.normal(size=shape), dtype=torch.float32),
               torch.as_tensor(rng.normal(size=shape), dtype=torch.float32))
    tree.insert(list(range(n)), slots)
    return slots


class TestTreeSnapshot:
    def test_round_trip_preserves_matches(self):
        tree = build_tree()
        snap, _ = tree_snapshot(tree)
        tree2 = RadixTree(page_size=1)
        n = tree_restore(snap, tree2)
        assert n >= 4
        for key in ([1, 2, 3, 4], [1, 2, 9, 9], [7, 7], [1, 2], [7, 7, 8]):
            a, b = tree.match_prefix(key), tree2.match_prefix(key)
            assert a.length == b.length
            np.testing.assert_array_equal(a.indices(), b.indices())
        assert tree2.total_size() == tree.total_size()
        assert tree2.evictable_size() == tree.evictable_size()

    def test_file_round_trip(self, tmp_path):
        tree = build_tree()
        path = str(tmp_path / "tree.json")
        save_tree(path, tree)
        tree2 = RadixTree(page_size=1)
        load_tree(path, tree2)
        assert tree2.match_prefix([1, 2, 3, 4]).length == 4

    def test_restore_does_not_free_pool_slots(self):
        freed = []
        tree = RadixTree(page_size=1, on_free=lambda s: freed.extend(s.tolist()))
        tree.insert([5, 6], np.array([0, 1], dtype=np.int32))
        snap, _ = tree_snapshot(tree)
        tree_restore(snap, tree)
        assert freed == []
        assert tree.match_prefix([5, 6]).length == 2

    def test_page_size_mismatch_rejected(self):
        snap, _ = tree_snapshot(build_tree())
        with pytest.raises(ValueError):
            tree_restore(snap, RadixTree(page_size=4))

    def test_kv_content_round_trip(self, tmp_path):
        pool = fresh_pool()
        tree = RadixTree(page_size=4, on_free=pool.free)
        slots = _filled(pool, tree, 0)
        path = str(tmp_path / "tree.json")
        save_tree(path, tree, pool=pool)
        pool2 = fresh_pool()
        tree2 = RadixTree(page_size=4, on_free=pool2.free)
        load_tree(path, tree2, pool=pool2)
        m = tree2.match_prefix(list(range(8)))
        assert m.length == 8
        np.testing.assert_array_equal(m.indices(), slots)
        assert torch.equal(pool2.gather(slots), pool.gather(slots))
        got = pool2.alloc(56)
        assert got is not None and not set(got.tolist()) & set(slots.tolist())
        assert pool2.alloc(8) is None

    def test_quantized_pool_round_trip_is_lossless(self, tmp_path):
        pool = fresh_pool(quant="int8")
        tree = RadixTree(page_size=4, on_free=pool.free)
        slots = _filled(pool, tree, 1)
        path = str(tmp_path / "tree.json")
        save_tree(path, tree, pool=pool)
        pool2 = fresh_pool(quant="int8")
        tree2 = RadixTree(page_size=4, on_free=pool2.free)
        load_tree(path, tree2, pool=pool2)
        assert tree2.match_prefix(list(range(8))).length == 8
        kv1, sc1 = pool.gather_raw(slots)
        kv2, sc2 = pool2.gather_raw(slots)
        assert torch.equal(kv1, kv2)
        np.testing.assert_allclose(sc1.numpy(), sc2.numpy(), rtol=1e-6)

    def test_restore_into_pool_without_kv_refused(self):
        snap, _ = tree_snapshot(build_tree())
        pool = PagedKVPool(num_slots=64, num_layers=1, num_kv_heads=1, head_dim=4, page_size=1,
                           dtype=torch.float32, device="cpu")
        with pytest.raises(ValueError, match="no KV content"):
            tree_restore(snap, RadixTree(page_size=1), pool=pool)

    def test_reserve_rejects_allocated_slots(self):
        a = SlotAllocator(16, page_size=4)
        got = a.alloc(4)
        with pytest.raises(ValueError, match="already allocated"):
            a.reserve(got)
        a.reserve(np.array([8, 9, 10, 11], dtype=np.int32))
        assert a.free_slots == 8
        a.free(np.array([8, 9, 10, 11], dtype=np.int32))
        assert a.free_slots == 12

    def test_restore_rebases_access_clock(self):
        tree = build_tree()
        for n in tree._all_nodes():
            if n is not tree.root:
                n.last_access_time += 1e6
        snap, _ = tree_snapshot(tree)
        snap["clock"] = snap["clock"] + 1e6
        tree2 = RadixTree(page_size=1)
        tree_restore(snap, tree2)
        now = time.monotonic()
        for n in tree2._all_nodes():
            if n is not tree2.root:
                assert n.last_access_time <= now

    def test_restore_emits_store_events(self):
        tree = build_tree()
        snap, _ = tree_snapshot(tree)
        tree2 = RadixTree(page_size=1, enable_events=True)
        n = tree_restore(snap, tree2)
        stored = [e for e in tree2.take_events() if type(e).__name__ == "BlockStored"]
        assert len(stored) == n
        for node in tree2._all_nodes():
            if node is not tree2.root:
                assert node.block_hashes

    def test_lru_order_survives(self):
        tree = RadixTree(page_size=1)
        t = [0.0]

        def clock():
            t[0] += 1
            return t[0]

        tree._time = clock
        tree.insert([1, 1], np.array([0, 1], dtype=np.int32))
        tree.insert([2, 2], np.array([2, 3], dtype=np.int32))
        tree.match_prefix([1, 1])
        snap, _ = tree_snapshot(tree)
        freed = []
        tree2 = RadixTree(page_size=1, on_free=lambda s: freed.extend(s.tolist()))
        tree_restore(snap, tree2)
        tree2.evict(2)
        assert sorted(freed) == [2, 3]


class TestTornSnapshot:
    def test_mismatched_kv_and_meta_rejected(self, tmp_path):
        pool = fresh_pool(num_layers=1, num_kv_heads=1)
        tree = RadixTree(page_size=4, on_free=pool.free)
        slots = pool.alloc(4)
        pool.write(slots, torch.zeros(1, 4, 1, 4), torch.zeros(1, 4, 1, 4))
        tree.insert([1, 2, 3, 4], slots)
        path = str(tmp_path / "tree.json")
        save_tree(path, tree, pool=pool)
        kv_bytes = (tmp_path / "tree.json.kv.npz").read_bytes()
        tree.insert([9, 9, 9, 9], pool.alloc(4))
        save_tree(path, tree, pool=pool)
        (tmp_path / "tree.json.kv.npz").write_bytes(kv_bytes)
        pool2 = fresh_pool(num_layers=1, num_kv_heads=1)
        with pytest.raises(ValueError, match="torn snapshot"):
            load_tree(path, RadixTree(page_size=4, on_free=pool2.free), pool=pool2)


# -- between the packages ----------------------------------------------------


def _jax_pool(quant=None):
    kw = dict(quant="int8") if quant else dict(dtype=jnp.bfloat16)
    return JPool(num_slots=64, num_layers=2, num_kv_heads=2, head_dim=4, page_size=4, **kw)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_jax_snapshot_loads_in_the_port(tmp_path, quant):
    jpool = _jax_pool(quant)
    jtree = JTree(page_size=4, on_free=jpool.free)
    rng = np.random.default_rng(3)
    slots = jpool.alloc(12)
    jpool.write(slots, jnp.asarray(rng.normal(size=(2, 12, 2, 4)), jnp.float32),
                jnp.asarray(rng.normal(size=(2, 12, 2, 4)), jnp.float32))
    jtree.insert(list(range(12)), slots)
    jtree.insert(list(range(8)) + [50, 51, 52, 53], np.concatenate([slots[:8], jpool.alloc(4)]))
    path = str(tmp_path / "jax-tree.json")
    j_save_tree(path, jtree, pool=jpool)
    pool = fresh_pool(dtype=torch.bfloat16, quant=quant)
    tree = RadixTree(page_size=4, on_free=pool.free)
    assert load_tree(path, tree, pool=pool) == 3
    for key in (list(range(12)), list(range(8)) + [50, 51, 52, 53]):
        m, jm = tree.match_prefix(key), jtree.match_prefix(key)
        assert m.length == jm.length == 12
        np.testing.assert_array_equal(m.indices(), jm.indices())
        want = np.asarray(jpool.gather(jm.indices()), np.float32)
        got = pool.gather(m.indices()).float().numpy()
        if quant is None:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("quant", [None, "int8"])
def test_port_snapshot_loads_in_jax(tmp_path, quant):
    pool = fresh_pool(dtype=torch.bfloat16, quant=quant)
    tree = RadixTree(page_size=4, on_free=pool.free)
    slots = _filled(pool, tree, 4, n=12)
    path = str(tmp_path / "port-tree.json")
    save_tree(path, tree, pool=pool)
    jpool = _jax_pool(quant)
    jtree = JTree(page_size=4, on_free=jpool.free)
    j_load_tree(path, jtree, pool=jpool)
    m = jtree.match_prefix(list(range(12)))
    assert m.length == 12
    np.testing.assert_array_equal(m.indices(), slots)
    want = pool.gather(slots).float().numpy()
    got = np.asarray(jpool.gather(slots), np.float32)
    if quant is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(np.asarray(jpool.gather_raw(slots)[0]), pool.gather_raw(slots)[0].numpy())


def test_sharded_pool_restore_writes_each_ranks_slice(tmp_path):
    """A whole snapshot restored with ``mesh=`` into each coordinate's shard
    pool (L/pp layers, Hkv/tp heads) writes exactly that slice; a pool that
    does not fit the file is refused."""
    pool = fresh_pool(num_layers=2, num_kv_heads=2)
    tree = RadixTree(page_size=4, on_free=pool.free)
    slots = _filled(pool, tree, 5)
    path = str(tmp_path / "tree.json")
    save_tree(path, tree, pool=pool)
    whole = pool.gather(slots)
    plan = MeshPlan(tp=2, pp=2)
    for mesh in _coords(plan):
        shard = fresh_pool(num_layers=1, num_kv_heads=1)
        load_tree(path, RadixTree(page_size=4, on_free=shard.free), pool=shard, mesh=mesh)
        lo, h = mesh.index("pp"), mesh.index("tp")
        assert torch.equal(shard.gather(slots), whole[:, lo:lo + 1, :, h:h + 1])
    with pytest.raises(ValueError, match="does not fit"):
        load_tree(path, RadixTree(page_size=4), pool=fresh_pool(num_layers=2, num_kv_heads=1),
                  mesh=next(_coords(plan)))
