"""The port's host-side cache pieces held against the JAX package's on the
same operation sequences (CPU): the slot allocator hands out and takes back
the same slots, the pool's write/gather/pages/page_table keep the JAX
layouts and values, and the radix tree copy matches, inserts, locks and
evicts exactly as the original does. Values compare exactly (float32
stores are copies)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu.cache import kv_pool as jpool
from radixmesh_tpu.cache.radix_tree import RadixTree as JTree
from radixmesh_tpu_torch.cache import kv_pool as tpool
from radixmesh_tpu_torch.cache.radix_tree import RadixTree as TTree


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_same_slots_on_random_sequences(seed):
    rng = np.random.default_rng(seed)
    ja, ta = jpool.SlotAllocator(256, page_size=8), tpool.SlotAllocator(256, page_size=8)
    held = []
    for _ in range(200):
        if held and rng.random() < 0.45:
            s = held.pop(int(rng.integers(len(held))))
            cut = int(rng.integers(0, len(s) + 1))  # free in two parts
            for part in (s[:cut], s[cut:]):
                ja.free(part)
                ta.free(part)
        else:
            n = int(rng.integers(1, 40))
            js, ts = ja.alloc(n), ta.alloc(n)
            assert (js is None) == (ts is None)
            if js is not None:
                np.testing.assert_array_equal(ts, js)
                held.append(js)
        assert ta.free_slots == ja.free_slots
    probe = np.arange(-2, 260)
    np.testing.assert_array_equal(ta.is_allocated(probe), ja.is_allocated(probe))


def test_allocator_reserve_and_double_free():
    for a in (jpool.SlotAllocator(32, page_size=4), tpool.SlotAllocator(32, page_size=4)):
        a.reserve(np.array([5, 6, 13]))
        assert a.free_slots == 24
        with pytest.raises(ValueError):
            a.reserve(np.array([6]))
        a.free(np.array([5, 6]))
        with pytest.raises(ValueError):
            a.free(np.array([5]))
        assert a.free_slots == 28


def test_pool_write_gather_pages_match_jax():
    rng = np.random.default_rng(3)
    L, H, D, page, n_slots = 3, 2, 8, 4, 64
    jp = jpool.PagedKVPool(n_slots, L, H, D, page_size=page, dtype=jnp.float32)
    tp = tpool.PagedKVPool(n_slots, L, H, D, page_size=page, dtype=torch.float32, device="cpu")
    for n in (7, 12, 1):
        js, ts = jp.alloc(n), tp.alloc(n)
        np.testing.assert_array_equal(ts, js)
        k = rng.normal(size=(L, n, H, D)).astype(np.float32)
        v = rng.normal(size=(L, n, H, D)).astype(np.float32)
        jp.write(js, jnp.asarray(k), jnp.asarray(v))
        tp.write(ts, torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(tp.kv.numpy(), np.asarray(jp.kv))
    sl = np.array([3, 17, 0, 9])
    np.testing.assert_array_equal(tp.gather(sl).numpy(), np.asarray(jp.gather(sl)))
    for layer in (0, 2):
        for got, want in zip(tp.pages_for_layer(layer), jp.pages_for_layer(layer)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    run = np.arange(8, 20)
    np.testing.assert_array_equal(tp.page_table(run), jp.page_table(run))
    with pytest.raises(ValueError):
        tp.page_table(np.arange(2, 10))
    assert tp.pages().shape == (2, L, H, n_slots // page, page, D)
    assert tp.pages().data_ptr() == tp.kv.data_ptr()  # a view, not a copy


@pytest.mark.parametrize("seed", [0, 1])
def test_radix_tree_copy_matches_original(seed):
    """Random shared-prefix inserts, matches, locks and evictions: the
    same match lengths, slot values, evicted counts and freed slots."""
    rng = np.random.default_rng(seed)
    freed = {"j": [], "t": []}
    jt = JTree(page_size=4, on_free=lambda s: freed["j"].append(np.asarray(s).copy()))
    tt = TTree(page_size=4, on_free=lambda s: freed["t"].append(np.asarray(s).copy()))
    bases = [rng.integers(0, 50, size=32) for _ in range(4)]
    next_slot, locked = 0, []
    for step in range(120):
        key = np.concatenate([bases[int(rng.integers(4))][: int(rng.integers(4, 33))],
                              rng.integers(0, 50, size=int(rng.integers(0, 12)))])
        op = rng.random()
        if op < 0.5:
            vals = np.arange(next_slot, next_slot + len(key), dtype=np.int64)
            next_slot += len(key)
            assert tt.insert(key, vals) == jt.insert(key, vals)
        elif op < 0.8:
            jm, tm = jt.match_prefix(key), tt.match_prefix(key)
            assert tm.length == jm.length
            np.testing.assert_array_equal(tm.indices(), jm.indices())
            if rng.random() < 0.3:
                jt.inc_lock_ref(jm.last_node)
                tt.inc_lock_ref(tm.last_node)
                locked.append((jm.last_node, tm.last_node))
        elif locked and op < 0.9:
            jn, tn = locked.pop(0)
            jt.dec_lock_ref(jn)
            tt.dec_lock_ref(tn)
        else:
            n = int(rng.integers(1, 30))
            assert tt.evict(n) == jt.evict(n)
        assert tt.evictable_size_ == jt.evictable_size_
        assert tt.total_size() == jt.total_size()
    assert freed["t"] and len(freed["t"]) == len(freed["j"])
    for a, b in zip(freed["t"], freed["j"]):
        np.testing.assert_array_equal(a, b)
