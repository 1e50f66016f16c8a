"""The port's async KV-movement plane (``radixmesh_tpu_torch/cache/
kv_transfer.py``): twins of ``tests/test_kv_transfer.py`` on the port's
engine (tiny float32 model on the CPU, the JAX package's weights), plus the
plane's own staging design: the pump applies only chunks whose copy has
completed, so decode keeps stepping while a restore's copies are in
flight; the staging ring is reused through restores longer than it; a
write-back that fails poisons its arena slots."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.engine.request import RequestState, SamplingParams

torch.set_num_threads(1)  # the suite runs in parallel worker processes

PAGE = 4
PROMPT = list(range(1, 120))
SAMP = SamplingParams(max_new_tokens=4)


@pytest.fixture(scope="module")
def tiny():
    """The port's tiny float32 model on the JAX package's weights, and the
    JAX engine's greedy tokens for ``PROMPT`` (no tier): every staged or
    synchronous restore below must reproduce them."""
    from radixmesh_tpu.engine.engine import Engine as JEngine
    from radixmesh_tpu.engine.request import SamplingParams as JSampling
    from radixmesh_tpu.models import llama as jl
    from radixmesh_tpu_torch.models.convert import params_from_jax
    from radixmesh_tpu_torch.models.llama import ModelConfig

    jcfg = jl.ModelConfig.tiny().replace(dtype=jnp.float32)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0))
    want = JEngine(jcfg, jparams, num_slots=512, page_size=PAGE, max_batch=2).generate(
        [PROMPT], JSampling(max_new_tokens=4))[0]
    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    return cfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu"), want


def make_engine(tiny, **kw):
    cfg, params, _ = tiny
    kw.setdefault("num_slots", 512)
    kw.setdefault("page_size", PAGE)
    kw.setdefault("max_batch", 2)
    kw.setdefault("host_cache_slots", 1024)
    kw.setdefault("kv_transfer_async", True)
    kw.setdefault("kv_transfer_chunk_tokens", 16)
    return Engine(cfg, params, device="cpu", **kw)


def drive(eng, reqs, max_steps=5000):
    for _ in range(max_steps):
        if not eng.has_work():
            break
        eng.step()
    assert all(r.state is RequestState.FINISHED for r in reqs)


def seed_and_evict(eng, prompt=PROMPT):
    out = eng.generate([prompt], SAMP)
    assert eng.tree.evict(100_000) > 0
    if eng.kv_transfer is not None:
        assert eng.kv_transfer.wait_host_ready()
    return out


class _HeldEvent:
    """A stand-in for a copy stream's CUDA event that reports incomplete
    until released: what the pump sees while a copy is in flight."""

    def __init__(self):
        self.release = threading.Event()

    def query(self) -> bool:
        return self.release.is_set()

    def synchronize(self) -> None:
        self.release.wait(10.0)


class TestStagedRestore:
    def test_restore_round_trip_identical_output(self, tiny):
        eng = make_engine(tiny)
        try:
            out1 = seed_and_evict(eng)
            assert out1[0] == tiny[2]  # the JAX engine's tokens
            req = eng.add_request(PROMPT, SAMP)
            drive(eng, [req])
            assert req.generated == tiny[2]
            assert eng.stats.cached_tokens >= 100  # a restored hit, not a recompute
            assert eng.kv_transfer.stats()["restored_tokens"] >= 100
        finally:
            eng.close()

    def test_decode_steps_complete_while_restore_in_flight(self, tiny):
        """A host-tier admission never blocks the decode loop: the stage
        barrier holds the restore open; the running request keeps
        producing tokens through it."""
        eng = make_engine(tiny)
        try:
            seed_and_evict(eng)
            bg = eng.add_request(list(range(200, 240)), SamplingParams(max_new_tokens=64))
            eng.step()
            assert bg.state is RequestState.RUNNING
            barrier = threading.Event()
            eng.kv_transfer.stage_barrier = barrier
            req = eng.add_request(PROMPT, SAMP)
            steps_at_park = None
            for _ in range(8):
                eng.step()
                if req.state is RequestState.RESTORING and steps_at_park is None:
                    steps_at_park = eng.stats.decode_steps
            assert req.state is RequestState.RESTORING and steps_at_park is not None
            assert eng.stats.decode_steps > steps_at_park
            barrier.set()
            eng.kv_transfer.stage_barrier = None
            drive(eng, [req, bg])
            assert req.generated == tiny[2]
            assert eng.kv_transfer.idle()
        finally:
            eng.close()

    def test_pump_applies_only_completed_copies(self, tiny, monkeypatch):
        """Every chunk is staged, but its copy's event reports incomplete:
        the pump scatters nothing, the request stays parked and decode keeps
        stepping. Once the events complete the chunks land and the request
        serves the same tokens. The staging ring is whole again after."""
        eng = make_engine(tiny)
        plane = eng.kv_transfer
        held = _HeldEvent()
        try:
            seed_and_evict(eng)
            monkeypatch.setattr(plane, "_record", lambda: held)
            bg = eng.add_request(list(range(200, 240)), SamplingParams(max_new_tokens=64))
            eng.step()
            req = eng.add_request(PROMPT, SAMP)
            eng.step()
            assert req.state is RequestState.RESTORING
            deadline = time.monotonic() + 10
            while plane.stats()["staged_chunks"] < 2 and time.monotonic() < deadline:
                time.sleep(0.005)
            steps0 = eng.stats.decode_steps
            for _ in range(5):
                eng.step()
            st = plane.stats()
            assert req.state is RequestState.RESTORING
            assert st["staged_chunks"] >= 2 and st["restored_tokens"] == 0
            assert eng.stats.decode_steps == steps0 + 5
            held.release.set()
            drive(eng, [req, bg])
            assert req.generated == tiny[2] and req.prefix_len >= 100
            st = plane.stats()
            assert st["stage_free"] == st["stage_depth"]
        finally:
            held.release.set()
            eng.close()

    def test_restore_longer_than_the_staging_ring(self, tiny):
        """Eight chunks through a two-buffer ring: a buffer comes back when
        the pump takes its chunk, so the worker never runs more than two
        chunks ahead and the restore still completes exactly."""
        cfg, params, want = tiny
        eng = Engine(cfg, params, device="cpu", num_slots=512, page_size=PAGE, max_batch=2,
                     host_cache_slots=1024, kv_transfer_async=True, kv_transfer_chunk_tokens=16)
        from radixmesh_tpu_torch.cache.kv_transfer import KVTransferPlane

        eng.kv_transfer.close()
        eng.kv_transfer = eng.tree.plane = KVTransferPlane(chunk_tokens=16, stage_depth=2)
        try:
            seed_and_evict(eng)
            req = eng.add_request(PROMPT, SAMP)
            peak = 0
            for _ in range(5000):
                if not eng.has_work():
                    break
                eng.step()
                peak = max(peak, eng.kv_transfer.stats()["staged_chunks"])
            assert req.generated == want and req.prefix_len >= 100
            assert peak <= 2
            assert eng.kv_transfer.stats()["stage_free"] == 2
        finally:
            eng.close()

    def test_cancel_mid_restore_releases_pages(self, tiny):
        eng = make_engine(tiny)
        try:
            seed_and_evict(eng)
            barrier = threading.Event()
            eng.kv_transfer.stage_barrier = barrier
            req = eng.add_request(PROMPT, SAMP)
            for _ in range(3):
                eng.step()
            assert req.state is RequestState.RESTORING
            assert eng.cancel(req.rid)
            assert req.state is RequestState.FINISHED and req.cancelled
            barrier.set()
            eng.kv_transfer.stage_barrier = None
            deadline = time.monotonic() + 10
            while not eng.kv_transfer.idle() and time.monotonic() < deadline:
                eng.step()
            assert eng.kv_transfer.idle()
            assert eng.tree.protected_size_ == 0
        finally:
            eng.close()

    def test_sync_fallback_below_min_restore_threshold(self, tiny):
        eng = make_engine(tiny, kv_transfer_min_restore_tokens=10_000)
        try:
            seed_and_evict(eng)
            req = eng.add_request(PROMPT, SAMP)
            states = set()
            for _ in range(5000):
                if not eng.has_work():
                    break
                eng.step()
                states.add(req.state)
            assert RequestState.RESTORING not in states
            assert req.generated == tiny[2] and req.prefix_len >= 100
        finally:
            eng.close()


class TestPrefetchHints:
    """Hints called on the plane directly, without the router that sends
    them over the mesh."""

    def test_hint_restores_ahead_and_is_idempotent(self, tiny):
        eng = make_engine(tiny)
        try:
            seed_and_evict(eng)
            fp_before = eng.tree.fingerprint
            nodes_before = sum(1 for _ in eng.tree._all_nodes())
            key = np.asarray(PROMPT, np.int32)
            for _ in range(3):
                eng.kv_transfer.note_hint(key)
            deadline = time.monotonic() + 10
            while not eng.kv_transfer.idle() and time.monotonic() < deadline:
                eng.step()
            assert eng.kv_transfer.idle()
            m = eng.tree.match_prefix(key)
            assert m.length >= 116 and m.host_length == 0
            assert eng.tree.fingerprint == fp_before
            assert sum(1 for _ in eng.tree._all_nodes()) == nodes_before
            assert eng.tree.protected_size_ == 0
            eng.kv_transfer.note_hint(key)  # already device-resident: a no-op
            eng.step()
            assert eng.kv_transfer.idle()
            outcomes = eng.kv_transfer.stats()["hint_outcomes"]
            assert outcomes["started"] >= 1 and outcomes["noop"] >= 1
        finally:
            eng.close()

    def test_hint_for_evicted_prefix_is_safe(self, tiny):
        eng = make_engine(tiny)
        try:
            seed_and_evict(eng)
            eng.tree._evict_host(100_000)  # the host copies die too
            eng.kv_transfer.note_hint(np.asarray(PROMPT, np.int32))
            eng.step()
            assert eng.kv_transfer.idle() and eng.tree.protected_size_ == 0
        finally:
            eng.close()

    def test_hint_racing_real_admission_joins(self, tiny):
        eng = make_engine(tiny)
        try:
            seed_and_evict(eng)
            barrier = threading.Event()
            eng.kv_transfer.stage_barrier = barrier
            eng.kv_transfer.note_hint(np.asarray(PROMPT, np.int32))
            eng.step()  # the hint converts to a held-open restore
            req = eng.add_request(PROMPT, SAMP)
            for _ in range(3):
                eng.step()
            assert req.state is RequestState.RESTORING
            assert eng.kv_transfer.hints_joined >= 1
            barrier.set()
            eng.kv_transfer.stage_barrier = None
            drive(eng, [req])
            assert req.generated == tiny[2]
            assert eng.kv_transfer.idle() and eng.tree.protected_size_ == 0
        finally:
            eng.close()

    def test_hint_during_drain_is_dropped_without_ticket_leak(self, tiny):
        eng = make_engine(tiny)
        try:
            seed_and_evict(eng)
            eng.draining = True
            eng.kv_transfer.note_hint(np.asarray(PROMPT, np.int32))
            for _ in range(3):
                eng.step()
            assert eng.kv_transfer.idle()
            assert eng.kv_transfer.stats()["active_tickets"] == 0
            assert eng.tree.protected_size_ == 0
            assert eng.tree.match_prefix(np.asarray(PROMPT, np.int32)).host_length > 0
            assert eng.kv_transfer.stats()["hint_outcomes"]["draining"] == 1
        finally:
            eng.close()


class TestDrainRequeue:
    def test_requeues_waiting_and_parked_not_running(self, tiny):
        eng = make_engine(tiny)
        try:
            seed_and_evict(eng)
            running = eng.add_request(list(range(200, 240)), SamplingParams(max_new_tokens=64))
            eng.step()
            barrier = threading.Event()
            eng.kv_transfer.stage_barrier = barrier
            parked = eng.add_request(PROMPT, SAMP)
            eng.step()
            assert parked.state is RequestState.RESTORING
            queued = eng.add_request([7, 8, 9], SAMP)
            assert eng.drain_requeue_waiting() == 2
            assert (parked.shed_reason, queued.shed_reason) == ("drain_requeue",) * 2
            assert parked.cancelled and queued.cancelled
            assert running.state is RequestState.RUNNING and not running.shed
            barrier.set()
            eng.kv_transfer.stage_barrier = None
            drive(eng, [running])
            assert eng.kv_transfer.idle() and eng.tree.protected_size_ == 0
        finally:
            eng.close()


class TestWritebackLane:
    def test_fused_gather_per_sweep_and_arena_ordering(self, tiny):
        """One gather per eviction sweep; a synchronous restore right behind
        the async write-back reads the arena only after the worker's write
        landed (the ``wait_host_ready`` barrier)."""
        eng = make_engine(tiny)
        try:
            out1 = eng.generate([PROMPT], SAMP)
            assert eng.tree.evict(100_000) > 0
            assert eng.tree.wb_sweeps == 1 and eng.tree.wb_gathers == 1
            eng._kv_min_restore = 10_000  # force the synchronous path
            req = eng.add_request(PROMPT, SAMP)
            drive(eng, [req])
            assert req.generated == out1[0] and req.prefix_len >= 100
        finally:
            eng.close()

    def test_stats_shape_and_counters(self, tiny):
        eng = make_engine(tiny)
        try:
            seed_and_evict(eng)
            req = eng.add_request(PROMPT, SAMP)
            drive(eng, [req])
            st = eng.kv_transfer.stats()
            for key in ("chunk_tokens", "writebacks_queued", "restores_queued", "staged_chunks",
                        "pending_restore_nodes", "active_tickets", "hints_queued", "hints_seen",
                        "hints_joined", "stage_depth", "stage_free", "pinned", "copy_stream"):
                assert key in st
            assert st["pinned"] is False and st["copy_stream"] is False  # a CPU pool
            assert st["restored_tokens"] > 0
            assert st["lane_bytes"]["writeback"] > 0 and st["lane_bytes"]["restore"] > 0
        finally:
            eng.close()


class TestFailedWritebackDegradation:
    def test_poisoned_host_slots_degrade_without_deadlock(self, tiny):
        """Poisoned arena slots (a failed write-back): the next staged
        restore drops the host copy (no garbage restore) and does not
        deadlock on the plane's lock."""
        eng = make_engine(tiny)
        try:
            seed_and_evict(eng)
            host_ids = [int(s) for n in eng.tree._all_nodes() if n.host_value is not None
                        for s in n.host_value]
            with eng.kv_transfer._lock:
                eng.kv_transfer._poisoned_host.update(host_ids)
            req = eng.add_request(PROMPT, SAMP)
            drive(eng, [req])
            assert req.generated == tiny[2] and req.prefix_len == 0  # recomputed
            assert eng.kv_transfer.idle() and eng.tree.protected_size_ == 0
            assert eng.tree.match_prefix(np.asarray(PROMPT, np.int32)).host_length == 0
        finally:
            eng.close()

    def test_failed_writeback_poisons_and_fails_the_barrier(self, tiny, monkeypatch):
        """An arena copy that raises on the worker: the ticket retires
        failed, ``wait_host_ready`` answers False, and the request serves by
        recomputing, never from the unwritten slots."""
        eng = make_engine(tiny)
        try:
            eng.generate([PROMPT], SAMP)

            def broken(*a, **k):
                raise OSError("arena write failed")

            monkeypatch.setattr(eng.tree.host, "rows", broken)  # the plane's arena access
            assert eng.tree.evict(100_000) > 0
            assert eng.kv_transfer.wait_host_ready() is False
            monkeypatch.undo()
            req = eng.add_request(PROMPT, SAMP)
            drive(eng, [req])
            assert req.generated == tiny[2] and req.prefix_len == 0
            assert eng.kv_transfer.idle() and eng.tree.protected_size_ == 0
        finally:
            eng.close()
