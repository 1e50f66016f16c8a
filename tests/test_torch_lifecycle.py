"""The membership lifecycle plane in the port (``policy/lifecycle.py``,
driven by ``cache/repair_plane.py`` and the runners' drain halves): the
cases of ``tests/test_lifecycle.py``, run against ``radixmesh_tpu_torch``.

Dropped: ``TestEngineDrain``, whose cases build the JAX engine. Its twin is
below, on the port's engine (the tiny model with params converted from the
JAX init, on the CPU), ``EngineRunner`` and ``SLORunner``: the same steps
and assertions."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from _torch_twin import load_twin

load_twin("test_lifecycle", globals(), drop=("TestEngineDrain",))


class TestEngineDrain:
    """Engine-level drain mechanics through the runner seams: admission
    closes retriably, queued and parked work requeues, decodes finish, hot
    prefixes flush through the write-back lane."""

    @pytest.fixture(scope="class")
    def tiny(self):
        from radixmesh_tpu.models import llama as jl
        from radixmesh_tpu_torch.models.convert import params_from_jax
        from radixmesh_tpu_torch.models.llama import ModelConfig

        torch.set_num_threads(1)
        jparams = jl.init_params(jl.ModelConfig.tiny(), jax.random.PRNGKey(0))
        cfg = ModelConfig.tiny()
        return cfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, "cpu")

    def _engine(self, tiny, **kw):
        from radixmesh_tpu_torch.engine.engine import Engine

        cfg, params = tiny
        kw.setdefault("num_slots", 512)
        kw.setdefault("page_size", 4)
        kw.setdefault("max_batch", 2)
        kw.setdefault("host_cache_slots", 1024)
        kw.setdefault("kv_transfer_async", True)
        kw.setdefault("kv_transfer_chunk_tokens", 16)
        return Engine(cfg, params, device="cpu", **kw)

    def test_drain_requeues_queued_and_restoring_then_flushes(self, tiny):
        from radixmesh_tpu_torch.engine.request import RequestState, SamplingParams
        from radixmesh_tpu_torch.server.http_frontend import EngineRunner

        eng = self._engine(tiny)
        prompt = list(range(1, 120))
        samp = SamplingParams(max_new_tokens=4)
        try:
            # Seed the host tier, then park a request mid-restore.
            eng.generate([prompt], samp)
            assert eng.tree.evict(100_000) > 0
            assert eng.kv_transfer.wait_host_ready()
            barrier = threading.Event()
            eng.kv_transfer.stage_barrier = barrier
            parked = eng.add_request(prompt, samp)
            for _ in range(3):
                eng.step()
            assert parked.state is RequestState.RESTORING
            queued = eng.add_request(list(range(300, 340)), samp)

            runner = EngineRunner(eng)  # not started: the test steps it
            runner.begin_drain()
            with pytest.raises(RuntimeError, match="draining"):
                runner.submit(list(range(400, 420)), samp)
            n = runner.drain_requeue()
            assert n == 2
            for req in (parked, queued):
                assert req.state is RequestState.FINISHED
                assert req.shed and req.shed_reason == "drain_requeue"
            barrier.set()
            eng.kv_transfer.stage_barrier = None
            # In-flight work (the cancelled ticket's staged chunks) runs
            # out under the deadline; then hot prefixes flush to host.
            deadline = time.monotonic() + 10
            while eng.has_work() and time.monotonic() < deadline:
                eng.step()
            assert runner.drain_wait_idle(1.0)
            tokens, landed = runner.drain_flush()
            assert tokens > 0 and landed
            assert eng.kv_transfer.wait_host_ready()
            assert eng.tree.evictable_size_ == 0  # nothing left hot
            assert eng.tree.protected_size_ == 0  # no leaked shields
            assert runner.drain_flush_disk() == (0, True)  # no disk tier
        finally:
            eng.kv_transfer.close()

    def test_slo_runner_sheds_draining_with_retry_after(self, tiny):
        from radixmesh_tpu_torch.engine.request import RequestState, SamplingParams
        from radixmesh_tpu_torch.slo import SLOConfig
        from radixmesh_tpu_torch.slo.control import RequestShed
        from radixmesh_tpu_torch.slo.runner import SLORunner

        eng = self._engine(tiny, kv_transfer_async=False)
        runner = SLORunner(eng, SLOConfig())  # not started: nothing dispatches
        waiting = runner.submit(list(range(10)), SamplingParams(max_new_tokens=2), tenant="t0")
        runner.begin_drain(retry_after_s=2.5)
        with pytest.raises(RequestShed) as exc:
            runner.submit(list(range(10)), tenant="t0")
        assert exc.value.reason == "draining"
        assert exc.value.http_status == 503
        assert exc.value.retry_after_s == 2.5
        # A request queued in the control plane is bounced the same way.
        assert waiting.state is RequestState.FINISHED
        assert waiting.shed and waiting.shed_reason == "draining"
