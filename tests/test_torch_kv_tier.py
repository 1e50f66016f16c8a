"""The port's durable KV tier (``radixmesh_tpu_torch/cache/kv_tier.py``): twins
of ``tests/test_kv_tier.py``'s ``TestExtentFormat``, ``TestTierWalk`` and
``TestEngineTier`` (its cold-restart resume leg with seeded replay too).
Also the two properties that tie the packages together:

- the extent files are byte-identical: the JAX ``DiskKVTier`` and the
  port's encode the same bf16, float32 and int8 inputs to the same bytes,
  and each reads the other's files back exactly;
- the port's ``Engine`` gives the JAX ``Engine``'s greedy tokens and
  ``cached_tokens`` per request (float32 and int8 pools, the plane on and
  off) through pool pressure → eviction to the host tier → restore →
  drain; with a tier directory also → a whole-cell stop → a new engine on
  the same directory → resurrection → disk hits.

Every tier directory is a pytest ``tmp_path``."""

import glob
import os
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from radixmesh_tpu.cache.kv_tier import DiskKVTier as JTier
from radixmesh_tpu_torch.cache.kv_tier import (
    EXTENT_SCHEMA_VERSION,
    DiskKVTier,
    ExtentRef,
    node_heat,
)
from radixmesh_tpu_torch.cache.radix_tree import RadixTree, TreeNode
from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.engine.request import RequestState, SamplingParams
from radixmesh_tpu_torch.models.llama import ModelConfig, init_params

torch.set_num_threads(1)  # the suite runs in parallel worker processes

PAGE = 4


@pytest.fixture(scope="module")
def tiny():
    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    return cfg, init_params(cfg, seed=0, device="cpu")


def make_engine(tiny, tier_dir, **kw):
    cfg, params = tiny
    kw.setdefault("num_slots", 1024)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("max_batch", 3)
    kw.setdefault("host_cache_slots", 512)
    kw.setdefault("kv_tier_watermark", 0.0)
    kw.setdefault("kv_tier_destage_budget", 64)
    kw.setdefault("kv_tier_destage_interval_s", 0.0)
    kw.setdefault("kv_transfer_chunk_tokens", 32)
    return Engine(cfg, params, device="cpu", kv_tier_dir=str(tier_dir), **kw)


def settle(eng, timeout=15.0):
    """Pump until every spill committed (the destager's engine half)."""
    plane = eng.kv_transfer
    plane.wait_host_ready()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        eng.step()
        if plane.spills_idle():
            return
        plane.wait_progress(0.01)
    raise AssertionError("spills never settled")


def spill_everything(eng, prompts, sampling):
    """Serve, push device → host, destage host → disk, commit."""
    for p in prompts:
        eng.generate([list(p)], sampling)
    eng.tree.evict(1 << 20)
    eng.kv_transfer.wait_host_ready()
    eng.tree.destage_cold(force=True, budget=1 << 20)
    settle(eng)


def _prompts(cfg, n, tokens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size - 1, size=tokens).astype(np.int32) for _ in range(n)]


# ---------------------------------------------------------------------------
# extent format
# ---------------------------------------------------------------------------


class TestExtentFormat:
    def _tier(self, tmp_path, **kw):
        kw.setdefault("page_size", PAGE)
        return DiskKVTier(str(tmp_path / "tier"), **kw)

    def _payload(self, n=8, seed=0):
        rng = np.random.default_rng(seed)
        prefix = rng.integers(1, 100, size=12).astype(np.int32)
        seg = rng.integers(1, 100, size=n).astype(np.int32)
        kv = torch.from_numpy(rng.standard_normal((2, 2, n, 2, 4)).astype(np.float32))
        return prefix, seg, kv

    def test_write_read_roundtrip(self, tmp_path):
        tier = self._tier(tmp_path)
        prefix, seg, kv = self._payload()
        ref = tier.write_extent(prefix, seg, kv, None)
        assert ref is not None and len(ref) == len(seg)
        got, scales = tier.read_extent(ref)
        assert scales is None and got.dtype == torch.float32
        assert torch.equal(got, kv)

    def test_quant_scales_roundtrip(self, tmp_path):
        tier = self._tier(tmp_path)
        prefix, seg, _ = self._payload()
        rng = np.random.default_rng(1)
        kv = torch.from_numpy(rng.integers(-128, 127, size=(2, 2, 8, 2, 4)).astype(np.int8))
        scales = torch.from_numpy(rng.standard_normal((2, 2, 8, 2)).astype(np.float32))
        ref = tier.write_extent(prefix, seg, kv, scales)
        got, got_s = tier.read_extent(ref)
        assert got.dtype == torch.int8 and torch.equal(got, kv)
        assert torch.equal(got_s, scales)

    def test_bf16_roundtrip_through_bit_patterns(self, tmp_path):
        """bf16 goes to disk as its 16-bit patterns and comes back as a bf16
        tensor, NaN payloads and signed zeros included."""
        tier = self._tier(tmp_path)
        prefix, seg, kv = self._payload()
        kv = kv.to(torch.bfloat16)
        kv[0, 0, 0, 0, :3] = torch.tensor([float("nan"), -0.0, float("inf")])
        got, _ = tier.read_extent(tier.write_extent(prefix, seg, kv, None))
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), kv.view(torch.int16))

    def test_same_path_respill_replaces_not_duplicates(self, tmp_path):
        tier = self._tier(tmp_path)
        prefix, seg, kv = self._payload()
        tier.write_extent(prefix, seg, kv, None)
        tier.write_extent(prefix, seg, kv * 2, None)
        assert tier.extents == 1

    def test_truncation_anywhere_is_detected_never_served(self, tmp_path):
        rng = np.random.default_rng(2)
        for trial in range(12):
            tier = self._tier(tmp_path / f"t{trial}")
            prefix, seg, kv = self._payload(seed=trial)
            ref = tier.write_extent(prefix, seg, kv, None)
            cut = int(rng.integers(0, os.path.getsize(ref.path)))
            with open(ref.path, "r+b") as fh:
                fh.truncate(cut)
            assert tier.read_extent(ref) is None
            assert not os.path.exists(ref.path)
        assert tier.stats()["corrupt_extents"]["truncated"] + tier.stats()["corrupt_extents"][
            "checksum"] + tier.stats()["corrupt_extents"]["schema"] == 1

    def test_bitflip_anywhere_is_detected_never_served(self, tmp_path):
        rng = np.random.default_rng(3)
        for trial in range(16):
            tier = self._tier(tmp_path / f"b{trial}")
            prefix, seg, kv = self._payload(seed=100 + trial)
            ref = tier.write_extent(prefix, seg, kv, None)
            off = int(rng.integers(0, os.path.getsize(ref.path)))
            with open(ref.path, "r+b") as fh:
                fh.seek(off)
                b = fh.read(1)
                fh.seek(off)
                fh.write(bytes([b[0] ^ (1 << int(rng.integers(0, 8)))]))
            assert tier.read_extent(ref) is None

    def test_future_schema_refused(self, tmp_path):
        tier = self._tier(tmp_path)
        prefix, seg, kv = self._payload()
        ref = tier.write_extent(prefix, seg, kv, None)
        with open(ref.path, "r+b") as fh:
            raw = bytearray(fh.read())
            raw[4:6] = (EXTENT_SCHEMA_VERSION + 1).to_bytes(2, "little")
            fh.seek(0)
            fh.write(bytes(raw))
        assert tier.read_extent(ref) is None

    def test_crash_mid_spill_leaves_committed_extents_readable(self, tmp_path):
        tier = self._tier(tmp_path)
        prefix, seg, kv = self._payload()
        tier.write_extent(prefix, seg, kv, None)
        torn = os.path.join(tier.dir, "ext-dead.kv.tmp.12345")
        with open(torn, "wb") as fh:
            fh.write(b"half-written garbage")
        tier2 = DiskKVTier(tier.dir, page_size=PAGE)
        metas = tier2.scan()
        assert len(metas) == 1
        np.testing.assert_array_equal(metas[0].seg_tokens, seg)
        assert not os.path.exists(torn)
        got, _ = tier2.read_extent(metas[0].ref)
        assert torch.equal(got, kv)

    def test_capacity_drops_oldest_and_counts(self, tmp_path):
        tier = self._tier(tmp_path, capacity_bytes=1)
        tier.write_extent(*self._payload(seed=10), None)
        tier.write_extent(*self._payload(seed=11), None)
        assert tier.extents == 1
        assert tier.stats()["moves"]["drop"] == 1

    def test_retire_is_in_memory_until_drained(self, tmp_path):
        tier = self._tier(tmp_path)
        ref = tier.write_extent(*self._payload(), None)
        tier.retire(ref)
        assert os.path.exists(ref.path)
        assert tier.drain_retired() == 1
        assert not os.path.exists(ref.path)

    def test_node_heat_decays(self):
        n = TreeNode()
        n.hit_count = 8
        n.last_access_time = 100.0
        assert node_heat(n, 100.0, half_life_s=10.0) == pytest.approx(8.0)
        assert node_heat(n, 110.0, half_life_s=10.0) == pytest.approx(4.0)
        assert node_heat(n, 200.0, half_life_s=10.0) < 0.01


class TestCrossPackageExtents:
    """A node of either package resurrects the other's extents: the same
    inputs encode to the same file bytes, and each tier reads the other's
    file back exactly."""

    @pytest.mark.parametrize("kind", ["bfloat16", "float32", "int8"])
    def test_identical_bytes_and_read_both_ways(self, tmp_path, kind):
        rng = np.random.default_rng(7)
        prefix = rng.integers(1, 500, size=16).astype(np.int32)
        seg = rng.integers(1, 500, size=8).astype(np.int32)
        shape = (2, 2, 8, 2, 4)
        scales_np = None
        if kind == "int8":
            kv_np = rng.integers(-127, 128, size=shape).astype(np.int8)
            scales_np = rng.random((2, 2, 8, 2)).astype(np.float32)
            kv_t = torch.from_numpy(kv_np)
        elif kind == "float32":
            kv_np = rng.standard_normal(shape).astype(np.float32)
            kv_t = torch.from_numpy(kv_np)
        else:
            bits = rng.integers(-(1 << 15), 1 << 15, size=shape).astype(np.int16)
            bits[bits & 0x7F80 == 0x7F80] = 0  # no NaN/inf patterns: compared as numbers below
            kv_np = bits.view(ml_dtypes.bfloat16)
            kv_t = torch.from_numpy(bits).view(torch.bfloat16)
        scales_t = None if scales_np is None else torch.from_numpy(scales_np)
        jt = JTier(str(tmp_path / "jax"), page_size=PAGE, name=f"x-{kind}")
        tt = DiskKVTier(str(tmp_path / "port"), page_size=PAGE)
        jref = jt.write_extent(prefix, seg, kv_np, scales_np)
        tref = tt.write_extent(prefix, seg, kv_t, scales_t)
        assert os.path.basename(jref.path) == os.path.basename(tref.path)
        with open(jref.path, "rb") as a, open(tref.path, "rb") as b:
            assert a.read() == b.read()
        assert (jref.nbytes, jref.n_seg, jref.shard) == (tref.nbytes, tref.n_seg, tref.shard)
        # The port reads the JAX file; the JAX tier reads the port's.
        t_meta = DiskKVTier(str(tmp_path / "jax"), page_size=PAGE).scan()
        got_t, got_ts = DiskKVTier(str(tmp_path / "jax"), page_size=PAGE).read_extent(t_meta[0].ref)
        j_meta = JTier(str(tmp_path / "port"), page_size=PAGE, name=f"y-{kind}").scan()
        got_j, got_js = jt.read_extent(j_meta[0].ref)
        np.testing.assert_array_equal(t_meta[0].prefix_tokens, prefix)
        np.testing.assert_array_equal(j_meta[0].seg_tokens, seg)
        assert got_t.dtype == kv_t.dtype and torch.equal(got_t.view(torch.uint8), kv_t.view(torch.uint8))
        assert got_j.dtype == kv_np.dtype and got_j.tobytes() == kv_np.tobytes()
        if scales_np is not None:
            np.testing.assert_array_equal(got_ts.numpy(), scales_np)
            np.testing.assert_array_equal(got_js, scales_np)


# ---------------------------------------------------------------------------
# three-tier radix walk (the port's RadixTree)
# ---------------------------------------------------------------------------


def _ref(n):
    return ExtentRef(path=f"/fake/{n}", n_seg=n, nbytes=1, shard=0)


def _only_child(node):
    (k,) = node.children.keys()
    return node.children[k]


class TestTierWalk:
    def test_disk_extension_returned_in_order(self):
        t = RadixTree(page_size=1)
        t.insert([1, 2, 3, 4, 5, 6], np.arange(6, dtype=np.int32))
        a = t._split_node(t.root.children[1], 2)
        b = t._split_node(_only_child(a), 2)
        leaf = _only_child(b)
        b.host_value = np.asarray(b.value)
        b.value = None
        leaf.disk_value = _ref(2)
        leaf.value = None
        m = t.match_prefix([1, 2, 3, 4, 5, 6])
        assert (m.length, m.host_length, m.disk_length) == (2, 2, 2)
        assert [n is leaf for n in m.disk_nodes] == [True]
        assert m.restorable_nodes() == [b, leaf]

    def test_host_below_disk_breaks_the_walk(self):
        t = RadixTree(page_size=1)
        t.insert([1, 2, 3, 4], np.arange(4, dtype=np.int32))
        a = t._split_node(t.root.children[1], 2)
        deep = _only_child(a)
        a.value = None
        a.disk_value = _ref(2)
        deep.host_value = np.asarray(deep.value)
        deep.value = None
        m = t.match_prefix([1, 2, 3, 4])
        assert m.disk_length == 2 and m.host_length == 0

    def test_partial_disk_match_never_splits(self):
        t = RadixTree(page_size=1)
        t.insert([1, 2, 3, 4], np.arange(4, dtype=np.int32))
        node = t.root.children[1]
        node.disk_value = _ref(4)
        node.value = None
        n_before = sum(1 for _ in t._all_nodes())
        m = t.match_prefix([1, 2, 9, 9])
        assert m.disk_length == 0
        assert sum(1 for _ in t._all_nodes()) == n_before

    def test_split_detaches_extent_via_hook(self):
        t = RadixTree(page_size=1)
        retired = []
        t.on_disk_detach = retired.append
        t.insert([1, 2, 3, 4], np.arange(4, dtype=np.int32))
        node = t.root.children[1]
        ref = _ref(4)
        node.disk_value = ref
        t._split_node(node, 2)
        assert retired == [ref] and node.disk_value is None

    def test_remove_node_retires_extents(self):
        t = RadixTree(page_size=1)
        retired = []
        t.on_disk_detach = retired.append
        t.insert([1, 2, 3, 4], np.arange(4, dtype=np.int32))
        node = t.root.children[1]
        node.disk_value = _ref(4)
        node.value = None
        t._remove_node(node, [])
        assert len(retired) == 1

    def test_reset_retires_extents(self):
        t = RadixTree(page_size=1)
        retired = []
        t.on_disk_detach = retired.append
        t.insert([1, 2, 3, 4], np.arange(4, dtype=np.int32))
        t.root.children[1].disk_value = _ref(4)
        t.reset()
        assert len(retired) == 1


# ---------------------------------------------------------------------------
# engine integration: spill / demote / restore / resurrect
# ---------------------------------------------------------------------------


class TestEngineTier:
    def test_tier_requires_host_cache(self, tiny, tmp_path):
        cfg, params = tiny
        with pytest.raises(ValueError, match="host tier"):
            Engine(cfg, params, device="cpu", kv_tier_dir=str(tmp_path / "d"), host_cache_slots=0)

    def test_tier_auto_arms_the_plane(self, tiny, tmp_path):
        eng = make_engine(tiny, tmp_path / "arm", kv_transfer_async=False)
        assert eng.kv_transfer is not None and eng.tree.disk is not None
        eng.close()

    def test_spill_kill_resurrect_serves_from_disk(self, tiny, tmp_path):
        cfg, _ = tiny
        d = tmp_path / "cell"
        prompts = _prompts(cfg, 3, 96)
        samp = SamplingParams(max_new_tokens=2)
        eng = make_engine(tiny, d)
        spill_everything(eng, prompts, samp)
        assert eng._kv_tier.extents >= 3
        eng.close()  # the whole cell dies: no flush
        del eng
        eng2 = make_engine(tiny, d)
        assert eng2.resurrected["grafted_nodes"] >= 3
        m = eng2.tree.match_prefix(prompts[0])
        assert m.disk_length > 0 and m.length == 0 and m.host_length == 0
        c0 = eng2.stats.cached_tokens
        eng2.generate([list(prompts[0])], samp)
        assert eng2.stats.cached_tokens - c0 > 0  # served from disk
        assert eng2._kv_tier.stats()["restored_tokens"] > 0
        eng2.close()

    def test_corrupt_extent_degrades_to_shorter_verified_prefix(self, tiny, tmp_path):
        cfg, _ = tiny
        d = tmp_path / "corrupt"
        prompts = _prompts(cfg, 2, 96, seed=7)
        samp = SamplingParams(max_new_tokens=2)
        eng = make_engine(tiny, d)
        spill_everything(eng, prompts, samp)
        eng.close()
        del eng
        files = sorted(glob.glob(str(d / "ext-*.kv")))
        with open(files[0], "r+b") as fh:
            fh.seek(os.path.getsize(files[0]) // 2)
            b = fh.read(1)
            fh.seek(-1, 1)
            fh.write(bytes([b[0] ^ 0xFF]))
        eng2 = make_engine(tiny, d)
        assert sum(eng2._kv_tier.stats()["corrupt_extents"].values()) >= 1
        for p in prompts:  # one recomputes, one hits disk; nothing raises
            eng2.generate([list(p)], samp)
        eng2.close()

    def test_eviction_prefers_demote_over_drop(self, tiny, tmp_path):
        cfg, _ = tiny
        prompts = _prompts(cfg, 2, 64, seed=3)
        eng = make_engine(tiny, tmp_path / "demote")
        spill_everything(eng, prompts, SamplingParams(max_new_tokens=2))
        dropped0 = eng.tree.host_evicted_tokens
        assert eng.tree._evict_host(1 << 20) > 0
        assert eng.tree.host_evicted_tokens == dropped0  # demoted, none died
        for p in prompts:
            assert eng.tree.match_prefix(p).disk_length > 0
        eng.close()

    def test_destage_min_heat_lets_cold_nodes_die(self, tiny, tmp_path):
        cfg, _ = tiny
        eng = make_engine(tiny, tmp_path / "cold", kv_tier_min_heat=1e9)
        for p in _prompts(cfg, 2, 64, seed=4):
            eng.generate([list(p)], SamplingParams(max_new_tokens=2))
        eng.tree.evict(1 << 20)
        eng.kv_transfer.wait_host_ready()
        assert eng.tree.destage_cold(watermark=0.0, min_heat=1e9, budget=64) == 0
        assert eng.tree.destage_cold(force=True, budget=64) > 0
        eng.close()

    def test_parked_disk_restore_while_decode_steps(self, tiny, tmp_path):
        cfg, _ = tiny
        prompts = _prompts(cfg, 2, 96, seed=5)
        samp = SamplingParams(max_new_tokens=2)
        eng = make_engine(tiny, tmp_path / "park")
        spill_everything(eng, prompts, samp)
        eng.tree._evict_host(1 << 20)  # disk-only residency
        bg = eng.add_request(list(_prompts(cfg, 1, 32, seed=6)[0]), SamplingParams(max_new_tokens=32))
        eng.step()
        req = eng.add_request(list(prompts[0]), samp)
        parked, decode_during = False, 0
        for _ in range(5000):
            before = eng.stats.decode_steps
            eng.step()
            parked |= req.state is RequestState.RESTORING
            if eng._restoring:
                decode_during += eng.stats.decode_steps - before
            if req.state is RequestState.FINISHED:
                break
        assert req.state is RequestState.FINISHED and req.prefix_len > 0
        assert parked, "disk restores must park, never run inline"
        assert decode_during > 0, "decode blocked on a disk restore"
        if bg.state is not RequestState.FINISHED:
            eng.cancel(bg.rid)
        eng.close()

    def test_prefetch_hint_restores_from_disk_ahead_of_request(self, tiny, tmp_path):
        cfg, _ = tiny
        prompts = _prompts(cfg, 1, 64, seed=8)
        eng = make_engine(tiny, tmp_path / "hint")
        spill_everything(eng, prompts, SamplingParams(max_new_tokens=2))
        eng.tree._evict_host(1 << 20)
        assert eng.tree.match_prefix(prompts[0]).disk_length > 0
        eng.kv_transfer.note_hint(prompts[0])
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            eng.step()
            if eng.tree.match_prefix(prompts[0]).length > 0:
                break
            eng.kv_transfer.wait_progress(0.01)
        m = eng.tree.match_prefix(prompts[0])
        assert m.length > 0, "hint never promoted the disk prefix"
        assert m.last_node.disk_value is not None  # the disk copy is kept
        assert eng.kv_transfer.stats()["hint_outcomes"]["started"] == 1
        eng.close()

    def test_drain_flush_disk_commits_everything(self, tiny, tmp_path):
        cfg, _ = tiny
        d = tmp_path / "drain"
        eng = make_engine(tiny, d)
        for p in _prompts(cfg, 2, 64, seed=9):
            eng.generate([list(p)], SamplingParams(max_new_tokens=2))
        assert eng.drain_flush_hot() > 0
        eng.kv_transfer.wait_host_ready()
        spilled, committed = eng.drain_flush_disk()
        assert spilled > 0 and committed is True
        assert eng._kv_tier.extents >= 2
        eng.close()
        del eng
        eng2 = make_engine(tiny, d)
        assert eng2.resurrected["grafted_nodes"] >= 2
        eng2.close()

    def test_cold_restart_resume_byte_identical(self, tiny, tmp_path):
        """Seeded replay composed with the tier: a stream interrupted by a
        whole-cell kill resumes byte-identical on a cell rebuilt from the
        extent directory alone, its replay a disk hit."""
        cfg, _ = tiny
        rng = np.random.default_rng(11)
        prompt = list(rng.integers(1, cfg.vocab_size - 1, size=96).astype(np.int32))
        samp = SamplingParams(temperature=0.9, top_p=0.95, seed=4242, max_new_tokens=8)
        ref = make_engine(tiny, tmp_path / "ref")  # the expectation, on a pristine engine
        r = ref.add_request(prompt, samp)
        while ref.has_work():
            ref.step()
        expected = list(r.generated)
        ref.close()

        d = tmp_path / "resume"
        eng = make_engine(tiny, d)
        spill_everything(eng, [np.asarray(prompt)], samp)
        req = eng.add_request(prompt, samp)
        while len(req.generated) < 3:
            eng.step()
        delivered = list(req.generated)
        eng.close()  # mid-decode whole-cell kill
        del eng

        eng2 = make_engine(tiny, d)
        c0 = eng2.stats.cached_tokens
        resumed = eng2.add_request(prompt, samp, resume_tokens=delivered)
        while eng2.has_work():
            eng2.step()
        assert delivered + list(resumed.generated) == expected
        assert eng2.stats.cached_tokens - c0 > 0  # the replay hit disk KV
        assert eng2.stats.resurrections == 1
        eng2.close()


# ---------------------------------------------------------------------------
# engine parity with the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_pair():
    from radixmesh_tpu.models import llama as jl
    from radixmesh_tpu_torch.models.convert import params_from_jax

    jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = ModelConfig.tiny().replace(dtype=torch.float32)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg, "cpu")
    return (jcfg, jparams), (tcfg, tparams)


def _tier_script(make, tier_dir):
    """Pool pressure evicts A to the host tier and A comes back as a host
    hit; a drain writes the working set back to the host tier and C and A
    come back as host hits; with a tier directory the engine then flushes
    it to disk, the cell stops, and a new engine on the same directory
    resurrects it and serves A and C from disk. ``make()`` builds an engine
    and names its ``SamplingParams``. Returns per request ``(greedy tokens,
    cached tokens)``, and the resurrection's counts."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.integers(1, 500, size=60).tolist() for _ in range(3))
    out = []

    def serve(eng, prompt):
        req = eng.add_request(prompt, samp(max_new_tokens=8))
        for _ in range(10_000):
            if not eng.has_work():
                break
            eng.step()
        assert req.state.value == "finished"
        out.append((list(req.generated), int(req.prefix_len)))

    def drain(eng):
        assert eng.drain_flush_hot() > 0
        if eng.kv_transfer is not None:
            assert eng.kv_transfer.wait_host_ready()

    eng, samp = make()
    for p in (a, b, c, a):
        serve(eng, p)
    drain(eng)
    for p in (c, a):
        serve(eng, p)
    if tier_dir is None:
        return out, None
    drain(eng)
    spilled, committed = eng.drain_flush_disk()
    assert spilled > 0 and committed
    eng.kv_transfer.close()  # the whole cell stops
    eng2, _ = make()
    grafted = (eng2.resurrected["grafted_nodes"], eng2.resurrected["grafted_tokens"])
    for p in (a, c):
        serve(eng2, p)
    eng2.kv_transfer.close()
    return out, grafted


@pytest.mark.parametrize("quant", [None, "int8"], ids=["float32", "int8"])
@pytest.mark.parametrize("tier", [False, True], ids=["host+sync", "host+plane+disk"])
def test_engine_tiers_token_exact_with_jax(tiny_pair, tmp_path, quant, tier):
    from radixmesh_tpu.engine.engine import Engine as JEngine
    from radixmesh_tpu.engine.request import SamplingParams as JSampling

    (jcfg, jparams), (tcfg, tparams) = tiny_pair
    kw = dict(num_slots=160, page_size=PAGE, max_batch=2, max_seq_len=128, host_cache_slots=1024,
              kv_quant=quant, kv_transfer_chunk_tokens=16, kv_tier_watermark=2.0,
              kv_tier_destage_interval_s=0.0)
    results = {}
    for name in ("jax", "port"):
        d = str(tmp_path / name) if tier else None

        def make(name=name, d=d):
            if name == "jax":
                return JEngine(jcfg, jparams, name=f"tier-twin-{quant}-{tier}", kv_tier_dir=d,
                               **kw), JSampling
            return Engine(tcfg, tparams, device="cpu", kv_tier_dir=d, **kw), SamplingParams

        results[name] = _tier_script(make, d)
    assert results["port"] == results["jax"]
    out, grafted = results["port"]
    assert [n for _, n in out[3:6]] == [56, 56, 56], "A, C, A should come back as host hits"
    assert out[5] == out[3], "two host hits of A reuse the same prefix, bit-exact"
    if tier:
        assert grafted[0] > 0
        assert out[6] == out[3] and out[7] == out[4], "the disk hits should repeat the host hits"
