"""The port's host KV tier (``radixmesh_tpu_torch/cache/host_cache.py``) held
against the JAX package's (``radixmesh_tpu/cache/host_cache.py``): twins of
``tests/test_host_cache.py``. Each scenario runs the same operation sequence
on a JAX ``HierarchicalCache`` and on the port's (float32 pools on the CPU,
the same K/V from a numpy seed) and returns what it observed: match lengths,
``host_value`` lengths and gathered pool contents, which must be equal —
exactly, but for int8 scales, held at rtol 1e-6 (the JAX package quantizes
under ``jit``, where XLA multiplies by the reciprocal of 127; ROADMAP §C).
Also: the raw interchange (``gather_raw``/``write_raw``, bit-exact for
float32, bf16 and int8), the pinned arena's refusal to fall back to
pageable memory, and the port's engine against the JAX engine with a host
tier under pool pressure."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.cache import host_cache as jhc
from radixmesh_tpu.cache import kv_pool as jpool
from radixmesh_tpu.cache.kv_transfer import KVTransferPlane as JPlane
from radixmesh_tpu_torch.cache import host_cache as thc
from radixmesh_tpu_torch.cache import kv_pool as tpool
from radixmesh_tpu_torch.cache.kv_transfer import KVTransferPlane as TPlane
from radixmesh_tpu_torch.cache.radix_tree import RadixTree

torch.set_num_threads(1)  # the suite runs in parallel worker processes

PAGE = 4
L, H, D = 2, 2, 4


class _J:
    """The JAX package's side of a scenario."""

    @staticmethod
    def plane():
        return JPlane(name="host-cache-twin")

    @staticmethod
    def pool(num_slots=32, quant=None):
        return jpool.PagedKVPool(num_slots=num_slots, num_layers=L, num_kv_heads=H, head_dim=D,
                                 page_size=PAGE, dtype=jnp.float32, quant=quant)

    @staticmethod
    def host(num_slots=64, quant=None):
        return jhc.HostKVStore(num_slots=num_slots, num_layers=L, num_kv_heads=H, head_dim=D,
                               page_size=PAGE, dtype=jnp.float32, quant=quant)

    tree = jhc.HierarchicalCache

    @staticmethod
    def write(pool, slots, k, v):
        pool.write(slots, jnp.asarray(k), jnp.asarray(v))

    @staticmethod
    def raw(pool, slots):
        kv, sc = pool.gather_raw(np.asarray(slots, np.int32))
        return np.asarray(kv), None if sc is None else np.asarray(sc)

    @staticmethod
    def host_read(host, slots):
        return np.asarray(host.read(slots)[0])

    @staticmethod
    def gathered(pool, slots):
        return np.asarray(jhc.gather_padded(pool, slots)[0])


class _T:
    """The port's side of a scenario."""

    plane = TPlane

    @staticmethod
    def pool(num_slots=32, quant=None):
        return tpool.PagedKVPool(num_slots=num_slots, num_layers=L, num_kv_heads=H, head_dim=D,
                                 page_size=PAGE, dtype=torch.float32, device="cpu", quant=quant)

    @staticmethod
    def host(num_slots=64, quant=None):
        return thc.HostKVStore(num_slots=num_slots, num_layers=L, num_kv_heads=H, head_dim=D,
                               page_size=PAGE, dtype=torch.float32, quant=quant)

    tree = thc.HierarchicalCache

    @staticmethod
    def write(pool, slots, k, v):
        pool.write(slots, torch.from_numpy(k), torch.from_numpy(v))

    @staticmethod
    def raw(pool, slots):
        kv, sc = pool.gather_raw(np.asarray(slots, np.int32))
        return kv.numpy(), None if sc is None else sc.numpy()

    @staticmethod
    def host_read(host, slots):
        return host.read(slots)[0].numpy()

    @staticmethod
    def gathered(pool, slots):
        return thc.gather_padded(pool, slots)[0].numpy()


def _fill(lib, pool, slots, seed):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(L, len(slots), H, D)).astype(np.float32)
    v = rng.normal(size=(L, len(slots), H, D)).astype(np.float32)
    lib.write(pool, slots, k, v)
    return np.stack([k, v])  # [2, L, n, H, D]


def _same(j, t, key=""):
    """JAX observation == port observation, recursively; arrays exactly, int8
    scales (keys ending in "scales") at rtol 1e-6."""
    if isinstance(j, dict):
        assert j.keys() == t.keys()
        for k in j:
            _same(j[k], t[k], k)
    elif isinstance(j, (list, tuple)):
        assert len(j) == len(t), key
        for a, b in zip(j, t):
            _same(a, b, key)
    elif isinstance(j, np.ndarray):
        assert j.shape == t.shape and j.dtype == t.dtype, (key, j.shape, t.shape, j.dtype, t.dtype)
        if key.endswith("scales"):
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(t, j, err_msg=key)
    else:
        assert j == t, (key, j, t)


def _twin(scenario, **kw):
    """Run ``scenario(lib, **kw)`` on both packages; their observations must
    agree."""
    _same(scenario(_J, **kw), scenario(_T, **kw))


def _host_lengths(tree):
    return sorted(len(n.host_value) for n in tree._all_nodes() if n.host_value is not None)


class TestHostKVStore:
    def test_write_read_round_trip(self):
        host = _T.host()
        slots = host.alloc(8)
        data = np.random.default_rng(0).normal(size=(2, L, 8, H, D)).astype(np.float32)
        host.write(slots[:8], torch.from_numpy(data))
        np.testing.assert_array_equal(host.read(slots[:8])[0].numpy(), data)

    def test_alloc_exhaustion(self):
        host = _T.host(num_slots=8)
        assert host.alloc(8) is not None
        assert host.alloc(1) is None

    def test_duplicate_slots_last_write_wins(self):
        """A sweep may name one arena slot twice (a node dropped mid-sweep
        and its slots re-reserved): the later write wins, as numpy's."""
        host = _T.host()
        slots = host.alloc(4)
        data = np.random.default_rng(1).normal(size=(2, L, 6, H, D)).astype(np.float32)
        ids = np.concatenate([slots, slots[:2]])
        host.write(ids, torch.from_numpy(data))
        want = data[:, :, :4].copy()
        want[:, :, :2] = data[:, :, 4:]
        np.testing.assert_array_equal(host.read(slots)[0].numpy(), want)

    def test_pinned_arena_raises_where_it_cannot_pin(self, monkeypatch):
        """Behind a CUDA pool the arena must be page-locked: where pinning is
        impossible the store raises instead of using pageable memory."""
        real_zeros = torch.zeros

        def zeros(*a, pin_memory=False, **kw):
            return real_zeros(*a, **kw)  # a pageable tensor: pinning "failed"

        monkeypatch.setattr(torch, "zeros", zeros)
        with pytest.raises(RuntimeError, match="could not be pinned"):
            thc.HostKVStore(num_slots=8, num_layers=L, num_kv_heads=H, head_dim=D,
                            page_size=PAGE, dtype=torch.float32, pin_memory=True)


def test_cuda_pool_refuses_a_pageable_host_tier():
    """Behind a CUDA pool the tier takes only a pinned arena: pageable
    memory would turn the plane's DMAs into blocking copies."""

    class CudaPool(tpool.PagedKVPool):
        device = torch.device("cuda", 0)  # only the device is read here

    pool = CudaPool(num_slots=32, num_layers=L, num_kv_heads=H, head_dim=D, page_size=PAGE,
                    dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="must be pinned"):
        thc.HierarchicalCache(pool, _T.host())


class TestRawInterchange:
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, None])
    def test_gather_raw_write_raw_bit_exact(self, dtype):
        """``write_raw(gather_raw(s))`` into other slots reproduces the stored
        representation bit for bit (bf16 and float32 pools; int8 payload
        and scales)."""
        quant = None if dtype is not None else "int8"
        pool = tpool.PagedKVPool(num_slots=64, num_layers=L, num_kv_heads=H, head_dim=D,
                                 page_size=PAGE, dtype=dtype or torch.float32, device="cpu",
                                 quant=quant)
        g = torch.Generator().manual_seed(3)
        src = pool.alloc(12)
        pool.write(src, torch.randn(L, 12, H, D, generator=g), torch.randn(L, 12, H, D, generator=g))
        kv, sc = pool.gather_raw(src)
        assert kv.shape == (2, L, 12, H, D) and kv.dtype == pool.dtype
        assert (sc is None) == (quant is None)
        dst = pool.alloc(12)
        pool.write_raw(dst, kv, sc)
        kv2, sc2 = pool.gather_raw(dst)
        assert torch.equal(kv2.view(torch.uint8), kv.view(torch.uint8))
        if quant is not None:
            assert torch.equal(sc2, sc)
        with pytest.raises(ValueError, match="pool dtype"):
            pool.write_raw(dst, kv.to(torch.float16), sc)

    @pytest.mark.parametrize("quant", [None, "int8"])
    def test_gather_raw_matches_jax(self, quant):
        def scenario(lib):
            pool = lib.pool(num_slots=32, quant=quant)
            slots = pool.alloc(10)
            _fill(lib, pool, slots, seed=4)
            kv, sc = lib.raw(pool, slots[::-1])
            return {"kv": kv, "kv_scales": sc} if quant else {"kv": kv}

        _twin(scenario)


def _evict_and_report(lib):
    pool, host = lib.pool(), lib.host()
    tree = lib.tree(pool, host)
    key = list(range(8))
    slots = pool.alloc(8)
    kv = _fill(lib, pool, slots, seed=1)
    tree.insert(key, slots)
    freed = tree.evict(8)
    assert freed == 8 and pool.free_slots >= 8
    res = tree.match_prefix(key)
    assert res.last_host_node is not None and res.last_host_node.backuped
    got = lib.host_read(host, res.host_indices())
    np.testing.assert_array_equal(got, kv)
    return {"length": res.length, "host_length": res.host_length, "host": got,
            "free": pool.free_slots}


def _restore_device_hit(lib):
    pool, host = lib.pool(), lib.host()
    tree = lib.tree(pool, host)
    key = list(range(8))
    slots = pool.alloc(8)
    kv = _fill(lib, pool, slots, seed=2)
    tree.insert(key, slots)
    tree.evict(8)
    res = tree.match_and_load(key)
    restored = lib.gathered(pool, res.indices())
    np.testing.assert_array_equal(restored, kv)
    assert res.last_node.backuped  # the host copy is kept
    return {"length": res.length, "host_length": res.host_length, "pool": restored,
            "indices": np.asarray(res.indices())}


def _second_eviction_free(lib):
    pool, host = lib.pool(), lib.host()
    tree = lib.tree(pool, host)
    key = list(range(8))
    tree.insert(key, pool.alloc(8))
    tree.evict(8)
    tree.match_and_load(key)
    host_before = host.free_slots
    freed = tree.evict(8)
    assert host.free_slots == host_before  # no new host allocation
    return {"freed": freed, "host_length": tree.match_prefix(key).host_length}


def _locked_not_written_back(lib):
    pool, host = lib.pool(), lib.host()
    tree = lib.tree(pool, host)
    key = list(range(8))
    tree.insert(key, pool.alloc(8))
    m = tree.match_prefix(key)
    tree.inc_lock_ref(m.last_node)
    locked = tree.evict(8)
    tree.dec_lock_ref(m.last_node)
    return {"locked": locked, "unlocked": tree.evict(8)}


def _deep_chain(lib):
    pool, host = lib.pool(num_slots=64), lib.host(num_slots=64)
    tree = lib.tree(pool, host)
    k1, k2 = list(range(8)), list(range(12))
    s1 = pool.alloc(8)
    kv1 = _fill(lib, pool, s1, 3)
    tree.insert(k1, s1)
    s2 = pool.alloc(4)
    kv2 = _fill(lib, pool, s2, 4)
    tree.insert(k2, np.concatenate([s1, s2]))
    tree.evict(12)
    host_len = tree.match_prefix(k2).host_length
    res = tree.match_and_load(k2)
    got = lib.gathered(pool, res.indices())
    np.testing.assert_array_equal(got[:, :, :8], kv1)
    np.testing.assert_array_equal(got[:, :, 8:], kv2)
    return {"host_length": host_len, "length": res.length, "pool": got,
            "host_nodes": _host_lengths(tree)}


class TestWriteback:
    @pytest.mark.parametrize("scenario", [
        _evict_and_report, _restore_device_hit, _second_eviction_free,
        _locked_not_written_back, _deep_chain,
    ], ids=lambda f: f.__name__.strip("_"))
    def test_same_as_jax(self, scenario):
        _twin(scenario)

    def test_expected_values(self):
        """The twins' shared observations are also the JAX tests' values."""
        assert _evict_and_report(_T)["host_length"] == 8
        assert _restore_device_hit(_T)["length"] == 8
        assert _second_eviction_free(_T) == {"freed": 8, "host_length": 8}
        assert _locked_not_written_back(_T) == {"locked": 0, "unlocked": 8}
        d = _deep_chain(_T)
        assert d["host_length"] == 12 and d["length"] == 12


def _arena_full(lib):
    pool, host = lib.pool(num_slots=32), lib.host(num_slots=8)
    tree = lib.tree(pool, host)
    tree.insert(list(range(8)), pool.alloc(8))
    tree.insert([99] * 4 + [98] * 4, pool.alloc(8))
    tree.evict(16)
    assert sum(_host_lengths(tree)) <= 8 and pool.free_slots >= 16
    return {"host_nodes": _host_lengths(tree), "free": pool.free_slots,
            "host_free": host.free_slots}


def _partial_restore(lib):
    pool, host = lib.pool(num_slots=16), lib.host(num_slots=32)
    tree = lib.tree(pool, host)
    key = list(range(16))
    slots = pool.alloc(16)
    kv = _fill(lib, pool, slots, seed=6)
    tree.insert(key, slots)
    tree.evict(16)
    assert pool.alloc(12) is not None  # a blocker: one page stays free
    res = tree.match_and_load(key)
    rest = tree.match_prefix(key).host_length
    np.testing.assert_array_equal(lib.gathered(pool, res.indices()), kv[:, :, : res.length])
    return {"length": res.length, "host_rest": rest}


class TestHostPressure:
    def test_host_arena_full_falls_back_to_plain_eviction(self):
        _twin(_arena_full)

    def test_partial_restore_when_device_pool_tight(self):
        _twin(_partial_restore)
        assert _partial_restore(_T) == {"length": 4, "host_rest": 12}


class TestPlainTreeUnaffected:
    def test_base_tree_eviction_still_removes(self):
        pool = _T.pool()
        tree = RadixTree(page_size=PAGE, on_free=pool.free)
        tree.insert(list(range(8)), pool.alloc(8))
        assert tree.evict(8) == 8
        m = tree.match_prefix(list(range(8)))
        assert m.length == 0 and m.host_length == 0


def _readopt(lib):
    pool, host = lib.pool(), lib.host()
    tree = lib.tree(pool, host)
    k8 = list(range(8))
    tree.insert(k8, pool.alloc(8))
    tree.evict(8)
    k12 = list(range(12))
    slots = pool.alloc(12)
    _fill(lib, pool, slots, seed=9)
    matched = tree.insert(k12, slots)
    res = tree.match_prefix(k12)
    assert matched == 0 and res.length == 12 and res.host_length == 0
    np.testing.assert_array_equal(res.indices(), slots)
    return {"matched": matched, "evictable": tree.evictable_size()}


def _skip_host_parent(lib):
    pool, host = lib.pool(num_slots=64), lib.host()
    tree = lib.tree(pool, host)
    sA = pool.alloc(4)
    tree.insert(list(range(4)), sA)
    sH = pool.alloc(4)
    tree.insert(list(range(8)), np.concatenate([sA, sH]))
    sC = pool.alloc(4)
    tree.insert(list(range(12)), np.concatenate([sA, sH, sC]))
    h_node = tree.match_prefix(list(range(8))).last_node
    hs = host.alloc(4)
    host.write(hs, *(jhc.gather_padded if lib is _J else thc.gather_padded)(
        pool, np.asarray(h_node.value)))
    pool.free(np.asarray(h_node.value))
    h_node.host_value = hs
    h_node.value = None
    tree.evictable_size_ -= 4
    freed = tree.evict(8)  # C then A, skipping H
    return {"freed": freed, "free": pool.free_slots}


class TestDeviceClosureInvariant:
    def test_insert_readopts_host_resident_span(self):
        _twin(_readopt)
        assert _readopt(_T) == {"matched": 0, "evictable": 12}

    def test_evict_skips_host_parent_to_device_ancestor(self):
        _twin(_skip_host_parent)
        assert _skip_host_parent(_T)["freed"] == 8


def _int8_round_trip(lib):
    pool, host = lib.pool(num_slots=64, quant="int8"), lib.host(num_slots=64, quant="int8")
    tree = lib.tree(pool, host)
    key = list(range(8))
    slots = pool.alloc(8)
    _fill(lib, pool, slots, seed=5)
    stored_kv, stored_sc = lib.raw(pool, slots)
    tree.insert(key, slots)
    tree.evict(8)
    host_len = tree.match_prefix(key).host_length
    res = tree.match_and_load(key)
    back_kv, back_sc = lib.raw(pool, res.indices())
    np.testing.assert_array_equal(back_kv, stored_kv)
    np.testing.assert_array_equal(back_sc, stored_sc)
    return {"host_length": host_len, "length": res.length, "kv": back_kv, "kv_scales": back_sc}


class TestQuantizedHostTier:
    def test_writeback_restore_round_trip_int8(self):
        host = _T.host(quant="int8")
        assert host._arena.dtype == torch.int8 and host._scale_arena is not None
        _twin(_int8_round_trip)


def _chains(lib, n_chains, chain_len=8, quant=None):
    pool, host = lib.pool(num_slots=256, quant=quant), lib.host(num_slots=256, quant=quant)
    tree = lib.tree(pool, host)
    keys, raws = [], []
    for i in range(n_chains):
        key = list(range(100 * i, 100 * i + chain_len))
        slots = pool.alloc(chain_len)
        _fill(lib, pool, slots, seed=10 + i)
        raws.append(lib.raw(pool, slots))
        tree.insert(key, slots)
        keys.append(key)
    return tree, keys, raws


def _sweep_round_trip(lib, quant, async_plane):
    tree, keys, raws = _chains(lib, 4, quant=quant)
    plane = lib.plane() if async_plane else None
    tree.plane = plane
    try:
        freed = tree.evict(1000)
        assert tree.wb_sweeps == 1 and tree.wb_gathers == 1  # fused: NOT one per node
        if plane is not None:
            assert plane.wait_host_ready()
        out = {"freed": freed, "host": [tree.match_prefix(k).host_length for k in keys]}
        for i, (key, (raw_kv, raw_sc)) in enumerate(zip(keys, raws)):
            res = tree.match_and_load(key)
            back_kv, back_sc = lib.raw(tree.pool, res.indices())
            np.testing.assert_array_equal(back_kv, raw_kv)
            if quant is not None:
                np.testing.assert_array_equal(back_sc, raw_sc)
            out[f"len{i}"] = res.length
            out[f"kv{i}"] = back_kv
            if quant is not None:
                out[f"kv{i}_scales"] = back_sc
        return out
    finally:
        if plane is not None:
            plane.close()


class TestBatchedWritebackSweep:
    """Eviction write-back is sweep-batched: one fused gather per sweep,
    however many nodes it absorbs, and the round trip is bit-exact."""

    def test_one_gather_per_sweep_many_nodes(self):
        tree, keys, _ = _chains(_T, 5)
        assert tree.evict(1000) == 5 * 8
        assert tree.wb_sweeps == 1 and tree.wb_gathers == 1
        for key in keys:
            assert tree.match_prefix(key).host_length == 8

    @pytest.mark.parametrize("quant", [None, "int8"])
    @pytest.mark.parametrize("async_plane", [False, True], ids=["sync", "plane"])
    def test_sweep_round_trip_bitwise_equivalence(self, quant, async_plane):
        """evict (one fused sweep) → host → restore: the pool holds the exact
        stored representation again, synchronously and with the write-back
        on the plane's worker (``wait_host_ready`` is the read barrier), the
        same as the JAX package."""
        _twin(_sweep_round_trip, quant=quant, async_plane=async_plane)

    def test_plane_writeback_and_restore_over_fragmented_arena(self):
        """The plane copies each run of consecutive arena slots as one
        block: with the arena fragmented (every other page taken), a sweep
        spans many runs, in both directions, and still lands bit-exact;
        a two-slot staging ring is reused across the restores' chunks."""
        from radixmesh_tpu_torch.cache.kv_transfer import _runs

        tree, keys, raws = _chains(_T, 5, chain_len=12)
        taken = [tree.host.alloc(PAGE) for _ in range(40)]
        for held in taken[::2]:
            tree.host.free(held)  # free pages alternate with taken ones
        plane = TPlane(chunk_tokens=8, stage_depth=2)
        tree.plane = plane
        try:
            assert tree.evict(1000) == 60
            assert plane.wait_host_ready()
            host_slots = np.concatenate([n.host_value for n in tree._all_nodes()
                                         if n.host_value is not None])
            assert len(_runs(host_slots)) > 5
            assert plane.stats()["lane_bytes"]["writeback"] == 60 * 2 * L * H * D * 4
            for key, (raw_kv, _) in zip(keys, raws):
                m = tree.match_prefix(key)
                ticket = plane.begin_restore(tree, m, alloc=tree.pool.alloc, auto_release=True)
                while not ticket.released:
                    plane.pump(tree)
                    plane.wait_progress(0.001)
                res = tree.match_prefix(key)
                assert res.length == 12
                np.testing.assert_array_equal(_T.raw(tree.pool, res.indices())[0], raw_kv)
            assert plane.stats()["stage_free"] == 2
        finally:
            plane.close()

    def test_runs(self):
        from radixmesh_tpu_torch.cache.kv_transfer import _runs

        assert _runs([]) == []
        assert _runs([4, 5, 6, 9, 10, 3, 3]) == [(0, 4, 3), (3, 9, 2), (5, 3, 1), (6, 3, 1)]


@pytest.fixture(scope="module")
def tiny_pair():
    from radixmesh_tpu.models import llama as jl
    from radixmesh_tpu_torch.models.convert import params_from_jax
    from radixmesh_tpu_torch.models.llama import ModelConfig

    jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = ModelConfig.tiny().replace(dtype=torch.float32)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    return (jcfg, jparams), (tcfg, tparams)


class TestEngineWithHostTier:
    def test_engine_serves_hits_after_hbm_pressure_same_as_jax(self, tiny_pair):
        """A prefix forced out of the (tiny) pool by a second request is a
        cache hit again on re-arrival, restored from host RAM: the port's
        engine gives the JAX engine's greedy tokens and cached tokens."""
        from radixmesh_tpu.engine.engine import Engine as JEngine
        from radixmesh_tpu.engine.request import SamplingParams as JSampling
        from radixmesh_tpu_torch.engine.engine import Engine as TEngine
        from radixmesh_tpu_torch.engine.request import SamplingParams as TSampling

        (jcfg, jparams), (tcfg, tparams) = tiny_pair
        kw = dict(num_slots=128, page_size=4, max_batch=1, max_seq_len=96, host_cache_slots=1024)
        a, b = list(range(1, 60)), list(range(100, 160))
        outs = {}
        for name, eng, samp in (
            ("jax", JEngine(jcfg, jparams, name="hicache-twin", **kw), JSampling),
            ("port", TEngine(tcfg, tparams, device="cpu", **kw), TSampling),
        ):
            seen = []
            for p in (a, b, a):
                req = eng.add_request(p, samp(max_new_tokens=16))
                while eng.has_work():
                    eng.step()
                seen.append((req.generated, req.prefix_len))
            outs[name] = seen
            if name == "port":
                st = eng.tree.stats()
                assert st["backup_tokens"] > 0 and st["restore_tokens"] > 0
        assert outs["port"] == outs["jax"]
        assert outs["port"][2][1] > 0, "the re-arrival should hit through the host tier"
