"""SLO-governed engine runner: the control plane wired into serving (the
JAX package's ``slo/runner.py``, over this package's inbox runner).

:class:`SLORunner` replaces the plain
:class:`~radixmesh_tpu_torch.server.http_frontend.EngineRunner` when a
frontend is built with an :class:`~radixmesh_tpu_torch.slo.control.SLOConfig`.
The request path becomes::

    submit() ── offer() ──► shed (RequestShed, 429/503) ─► client retries
        │
        └► enqueue() into per-tenant WFQ queues
                │ (runner thread, every scheduler iteration)
                ▼
            _pump(): tier knobs → e2e-deadline sweep → weighted-fair
            dispatch into engine.waiting (kept shallow: at most one
            admission wave deep, so the SLO layer owns ordering, the
            engine owns batching) → finalize dispatch-time sheds
                │
                ▼
            engine.step()   (unchanged)

Submissions never take the step lock, which the runner holds for a whole
engine step: arrival is stamped first, ``make_request`` validates, and
``offer``/``enqueue`` run under the controller's own lock (with the short
inbox lock ordering them against :meth:`close`). ``_pump`` runs in the
runner's ``_pre_step`` hook with the step lock held, after the inbox is
taken. (The JAX runner holds its runner lock across ``make_request``,
``offer`` and ``enqueue``, so a submit there waits out a running step.)

Degradation tier knobs applied here (the controller only decides the
tier): tier ≥1 zeroes ``engine.spec_decode_tokens``, tier ≥2 caps each
dispatched request's ``max_new_tokens``, tier ≥3 shrinks
``engine.prefill_wave_tokens`` (which, as in the JAX engine, mixed waves do
not read: their scheduler copies the boost width at construction). All
restore on the way back down.

The engine's ``on_first_token`` hook feeds the controller's service-rate
EWMA and retires dispatched tokens from the backlog estimate, on the
runner thread with the step lock held.
"""

from __future__ import annotations

import time
from dataclasses import replace as dc_replace
from typing import Sequence

from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.engine.request import Request, RequestState, SamplingParams
from radixmesh_tpu_torch.obs.tracing import annotate
from radixmesh_tpu_torch.server.http_frontend import EngineRunner
from radixmesh_tpu_torch.slo.control import (
    SHED_DRAINING,
    SHED_SHUTDOWN,
    OverloadController,
    RequestShed,
    SLOConfig,
)
from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = ["SLORunner"]


class SLORunner(EngineRunner):
    """Exclusive engine owner with the overload control plane in the
    admission path. Drop-in for :class:`EngineRunner`; ``submit`` grows
    tenant and deadline parameters and may raise :class:`RequestShed`."""

    def __init__(self, engine: Engine, slo: SLOConfig | None = None, clock=time.monotonic):
        super().__init__(engine)
        self.ctl = OverloadController(slo, clock=clock)
        self._clock = clock
        self._base_spec = engine.spec_decode_tokens
        self._base_wave = engine.prefill_wave_tokens
        self._applied_tier = 0
        self.log = get_logger("slo.runner")
        engine.on_first_token = self._on_first_token

    # -- engine callback (runner thread, step lock held) ----------------

    def _on_first_token(self, req: Request) -> None:
        if req.admit_time > 0:  # dispatched through the SLO queue
            self.ctl.note_first_token(req, self._clock())

    # -- submission path ------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        sampling: SamplingParams | None = None,
        tenant: str = "default",
        ttft_deadline_s: float | None = None,
        e2e_deadline_s: float | None = None,
        resume_tokens: Sequence[int] | None = None,
        trace_id: int | None = None,
    ) -> Request:
        # Arrival is stamped before anything else: time a submit spends
        # here is queueing delay like any other and counts against the
        # deadline and the measured TTFT.
        t_arrival = self._clock()
        # Validation (length bounds) before admission accounting, so a
        # malformed request cannot spend bucket tokens. A resumed request
        # threads its remaining deadline budget in as e2e_deadline_s.
        req = self.engine.make_request(
            prompt,
            sampling,
            tenant=tenant,
            ttft_deadline_s=ttft_deadline_s,
            e2e_deadline_s=e2e_deadline_s,
            resume_tokens=resume_tokens,
            trace_id=trace_id,
        )
        req.submit_time = t_arrival
        # The inbox lock (never held across a step) orders this against
        # close(): nothing is enqueued after the shutdown flush.
        with self._inbox_lock:
            if self._closed:
                raise RuntimeError("engine runner is shut down")
            if self._draining:
                # Graceful drain (policy/lifecycle.py): a retriable 503 with
                # Retry-After; the frontend's shed body names the router to
                # re-route through.
                raise RequestShed(SHED_DRAINING, self._drain_retry_after_s, tenant)
            decision = self.ctl.offer(tenant, len(req.prompt), ttft_deadline_s)
            if not decision.admitted:
                raise RequestShed(decision.reason, decision.retry_after_s, tenant)
            self.ctl.enqueue(req)
        self._wake.set()
        return req

    # -- scheduler loop -------------------------------------------------

    def _pre_step(self) -> None:  # EngineRunner._run hook, step lock held
        self._pump()

    def _pump(self) -> None:
        """One control-plane iteration (step lock held)."""
        now = self._clock()
        tier = self.ctl.update_tier(now)
        if tier != self._applied_tier:
            self._apply_tier(tier)
        self._sweep_e2e_deadlines(now)
        # Keep the engine's own FIFO shallow: dispatch at most one
        # admission wave ahead, so ordering stays with the WFQ and a
        # deadline re-check happens as close to prefill as possible.
        with annotate("slo.pump"):
            while len(self.engine.waiting) < self.engine.max_batch:
                req = self.ctl.pop_ready(now)
                if req is None:
                    break
                if tier >= 2:
                    cap = self.ctl.cfg.tier2_max_new_tokens
                    if req.sampling.max_new_tokens > cap:
                        req.sampling = dc_replace(req.sampling, max_new_tokens=cap)
                req.degradation_tier = tier
                req.admit_time = now
                tr = req.trace
                if tr is not None:
                    # The control-plane leg of the timeline: submit → WFQ
                    # dispatch (engine queue wait is its own span).
                    tr.add("slo_queue", req.submit_time, now - req.submit_time, cat="queue",
                           tenant=req.tenant, tier=tier)
                self.engine.enqueue(req)
        for req in self.ctl.drain_shed():
            self._finalize_shed(req)

    def _apply_tier(self, tier: int) -> None:
        eng = self.engine
        eng.spec_decode_tokens = 0 if tier >= 1 else self._base_spec
        # The speculation ledger records why γ went to zero; its adaptive
        # γ clamps to the base γ at draft time, so it inherits the zero.
        eng.spec_ledger.note_tier(tier)
        eng.prefill_wave_tokens = (
            max(eng.prefill_chunk, int(self._base_wave * self.ctl.cfg.tier3_wave_factor))
            if tier >= 3
            else self._base_wave
        )
        self.log.info("applied degradation tier %d (spec=%d, wave=%d)",
                      tier, eng.spec_decode_tokens, eng.prefill_wave_tokens)
        self._applied_tier = tier

    def _sweep_e2e_deadlines(self, now: float) -> None:
        """Cancel queued, parked and running requests past their
        end-to-end deadline: partial output returns at once (flagged shed)
        instead of the request holding a batch row past the point anyone
        waits. As in the JAX runner, a request in the mixed-wave inline
        backlog is not swept until it is installed in a row."""
        restoring = [r for r, _ in self.engine._restoring]
        expired = [
            r
            for r in list(self.engine.waiting) + restoring + self.engine._rows
            if r is not None
            and r.e2e_deadline_s is not None
            and now - r.submit_time > r.e2e_deadline_s
        ]
        for req in expired:
            req.shed = True
            req.shed_reason = "e2e_deadline"
            self.engine.cancel(req.rid)
            if req.admit_time > 0:
                # Cancelled before a first token: retire its backlog cost
                # (a no-op if the first token already landed).
                self.ctl.note_retired(req, now)

    def _finalize_shed(self, req: Request) -> None:
        """A queued request the controller dropped: surface it to waiters
        like a cancel (QUEUED → FINISHED, no output, flagged)."""
        req.cancelled = True
        req.state = RequestState.FINISHED
        tr = req.trace
        if tr is not None:
            tr.add("slo_shed", req.submit_time, self._clock() - req.submit_time, cat="queue",
                   tenant=req.tenant, reason=req.shed_reason)

    def cancel(self, rid: int) -> bool:
        # Still waiting in the WFQ: the engine has never seen it, so the
        # controller's lock is enough.
        queued = self.ctl.cancel_queued(rid)
        if queued is not None:
            self._finalize_shed(queued)
            return True
        with self._lock:
            eng = self.engine
            req = (
                next((r for r in eng.waiting if r.rid == rid), None)
                or next((r for r in eng._rows if r is not None and r.rid == rid), None)
                or next((r for r, _ in eng._restoring if r.rid == rid), None)
            )
            ok = eng.cancel(rid)
            if ok and req is not None and req.admit_time > 0:
                self.ctl.note_retired(req)
            return ok

    def begin_drain(self, retry_after_s: float = 1.0) -> None:
        """Graceful drain with the control plane in the path: close
        admission (new submits shed ``draining``, a retriable 503), then
        bounce every queued but undispatched request back to its client
        the same way: queued work has produced nothing, so the router
        re-places it on a surviving node with no loss."""
        super().begin_drain(retry_after_s)
        for req in self.ctl.flush(SHED_DRAINING):
            self._finalize_shed(req)

    def close(self, drain_s: float = 0.0) -> None:
        # Close the submit window before flushing: a submit racing into
        # the gap between the flush and the base class's close would
        # enqueue a request nothing ever pumps, stranding its waiter.
        with self._inbox_lock:
            self._closed = True
        for req in self.ctl.flush(SHED_SHUTDOWN):
            self._finalize_shed(req)
        super().close(drain_s=drain_s)
