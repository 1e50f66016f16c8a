"""SLO-aware overload control plane: admission, fairness, load shedding.

This package's own copy of the JAX package's ``slo/control.py`` (the port
imports nothing of the JAX package). The engine below this layer admits
everything FIFO and lets TTFT blow out under wide cold bursts; this module
is the overload control plane above the scheduler, engine-agnostic and
fully deterministic under an injected clock:

- **Per-tenant token buckets** (prompt tokens as the currency — the unit
  admission actually spends prefill throughput on): a tenant past its
  provisioned rate is fast-failed with a computable ``retry_after_s``
  instead of queueing work that starves everyone else.
- **Weighted-fair queueing** (start-time fair queueing over prompt-token
  cost): each queued request gets a virtual finish time
  ``max(V, tenant.vfinish) + cost / weight``; dispatch always takes the
  smallest. Backlogged tenants share admitted tokens in proportion to
  their weights regardless of arrival pattern — a bursty tenant cannot
  convoy a steady one.
- **Deadline-aware admission**: prefill service rate is tracked as an
  EWMA of observed (uncached-tokens / wall-time) samples; a request whose
  estimated queue wait + own service time cannot meet its TTFT deadline
  is shed AT ARRIVAL (retriable 503) rather than rotting in queue, and
  re-checked at dispatch so deadline misses never occupy a batch row.
  The wait estimate is the WFQ delay bound, not the global queue: the
  tenant's own queued tokens drained at its guaranteed share of the
  service rate (weight over the weights of currently-backlogged
  tenants), plus dispatched-but-unserved work. A global estimate would
  shed all tenants equally once the TOTAL backlog neared the deadline —
  capping every tenant's admitted inflow at the same value and silently
  flattening the weighted shares fairness promises; the per-tenant bound
  lets each queue grow to exactly the depth its own entitlement can
  drain within the deadline.
- **Graceful degradation tiers** before shedding: sustained backlog
  (estimated drain seconds, with hysteresis) walks a tier ladder —
  1: disable speculative decoding, 2: cap ``max_new_tokens``,
  3: shrink the prefill wave width — each recovering capacity for first
  tokens before any deadline-capable request has to be refused.

Everything is observable: queue depth, shed counts by reason, admission
wait, backlog, service-rate EWMA, and the degradation tier all export
through ``obs/metrics.py`` under the JAX package's names; tier
transitions keep an event log an overload sweep records.

Thread model: frontend handler threads call :meth:`offer`/:meth:`enqueue`;
the engine runner thread calls :meth:`pop_ready`/:meth:`note_first_token`.
One lock guards all controller state (operations are O(#tenants) at
worst); request objects are only ever mutated by whichever side currently
owns them.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Mapping

from radixmesh_tpu_torch.obs.metrics import get_registry
from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = [
    "AdmissionDecision",
    "OverloadController",
    "RequestShed",
    "SLOConfig",
    "TenantConfig",
]

# Shed reasons (metric label values + HTTP mapping: rate_limited → 429,
# over_burst → 413, everything else → 503; all but over_burst are
# retriable by contract).
SHED_RATE_LIMITED = "rate_limited"
SHED_OVER_BURST = "prompt_exceeds_rate_burst"
SHED_QUEUE_FULL = "queue_full"
SHED_DEADLINE = "deadline_unmeetable"
SHED_DISPATCH_DEADLINE = "deadline_unmeetable_at_dispatch"
SHED_E2E_EXPIRED = "e2e_deadline_expired_in_queue"
SHED_SHUTDOWN = "shutdown"
# Graceful drain (policy/lifecycle.py): the node is leaving the fleet on
# purpose. Retriable 503 + Retry-After — the client re-routes via the
# router, which stopped selecting this node when the DRAINING state
# gossiped; the shed body names the router to retry through.
SHED_DRAINING = "draining"

# Dynamic (client-named) tenants beyond SLOConfig.max_tenants share this
# one state: tenant names arrive from the request body, so without a cap
# a client minting a fresh name per request would grow per-tenant state
# and metric label series without bound AND collect a full fair-share
# entitlement per invented name — an overload-amplifier inside the
# overload control plane. Configured tenants are never folded in.
OVERFLOW_TENANT = "__overflow__"


class RequestShed(RuntimeError):
    """A request was refused (or dropped) by the overload control plane.

    Retriable except ``prompt_exceeds_rate_burst`` (a prompt the tenant's
    bucket can NEVER hold — retrying is futile, so it maps to 413, not
    429): the client should back off ``retry_after_s`` (when given) and
    resubmit. Maps to HTTP 429 for per-tenant rate limiting, 503 for
    capacity/deadline shedding."""

    def __init__(
        self,
        reason: str,
        retry_after_s: float | None = None,
        tenant: str = "default",
    ):
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.tenant = tenant
        super().__init__(
            f"request shed ({reason}, tenant={tenant!r}"
            + (f", retry after {retry_after_s:.3f}s" if retry_after_s else "")
            + ")"
        )

    @property
    def http_status(self) -> int:
        if self.reason == SHED_RATE_LIMITED:
            return 429
        if self.reason == SHED_OVER_BURST:
            return 413
        return 503


@dataclass(frozen=True)
class TenantConfig:
    """Per-tenant entitlement. ``weight`` sets the fair share under
    contention; ``rate_tokens_per_s`` (0 = unlimited) bounds sustained
    prompt-token admission with ``burst_tokens`` of bucket depth
    (0 = one second's worth of rate)."""

    weight: float = 1.0
    rate_tokens_per_s: float = 0.0
    burst_tokens: float = 0.0

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {self.weight}")
        if self.rate_tokens_per_s < 0 or self.burst_tokens < 0:
            raise ValueError("rate/burst must be >= 0")


@dataclass(frozen=True)
class SLOConfig:
    """Control-plane policy. Defaults are deliberately permissive: with no
    tenants configured and no deadline supplied, the layer admits
    everything immediately and only the observability remains — at ≤1×
    load it must be indistinguishable from no SLO layer at all."""

    tenants: Mapping[str, TenantConfig] = field(default_factory=dict)
    default_tenant: TenantConfig = field(default_factory=TenantConfig)
    # Applied when a request carries no explicit TTFT deadline (None =
    # requests without deadlines are never deadline-shed).
    default_ttft_slo_s: float | None = None
    # Admit while est_wait + est_service <= deadline * shed_headroom
    # (>1 tolerates EWMA optimism, <1 sheds conservatively early).
    shed_headroom: float = 1.0
    max_queue_requests: int = 4096
    # Distinct DYNAMIC tenant states kept before further unknown names
    # fold into one shared OVERFLOW_TENANT entry (bounds state, metric
    # cardinality, and the fair-share a client can mint with fresh
    # names). Tenants listed in ``tenants`` always get their own state.
    max_tenants: int = 256
    ewma_alpha: float = 0.3
    # First-token completions are folded into the service-rate EWMA in
    # busy-time windows of at least this span: tokens are accumulated
    # across completions and one AGGREGATE sample (tokens / busy seconds)
    # is emitted per window. Per-request elapsed times would undercount
    # the rate by the batching factor when the engine serves
    # concurrently — a ×8 batch looks ×8 slower per request.
    rate_window_s: float = 0.05
    # Degradation ladder: estimated backlog drain seconds that arm tiers
    # 1..3. Crossing must be SUSTAINED for tier_up_hold_s before the tier
    # steps up; dropping below must hold for tier_down_hold_s before it
    # steps down (hysteresis — a single burst wave must not flap knobs).
    tier_backlog_s: tuple[float, float, float] = (0.5, 1.5, 3.0)
    tier_up_hold_s: float = 0.1
    tier_down_hold_s: float = 1.0
    # Tier-2 output cap and tier-3 prefill-wave shrink factor.
    tier2_max_new_tokens: int = 64
    tier3_wave_factor: float = 0.5

    def __post_init__(self):
        if not (len(self.tier_backlog_s) == 3
                and tuple(sorted(self.tier_backlog_s))
                == tuple(self.tier_backlog_s)):
            raise ValueError(
                f"tier_backlog_s must be 3 ascending thresholds, got "
                f"{self.tier_backlog_s}"
            )
        if not 0 < self.tier3_wave_factor <= 1:
            raise ValueError("tier3_wave_factor must be in (0, 1]")
        if self.max_tenants < 1:
            raise ValueError("max_tenants must be >= 1")

    def tenant(self, name: str) -> TenantConfig:
        return self.tenants.get(name, self.default_tenant)


@dataclass(frozen=True)
class AdmissionDecision:
    admitted: bool
    reason: str | None = None
    retry_after_s: float | None = None
    # Arrival-time estimate of queue wait (telemetry; 0 when uncalibrated).
    est_wait_s: float = 0.0


class _Bucket:
    """Token bucket over prompt tokens; monotonic-clock refill."""

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = rate
        self.burst = burst if burst > 0 else max(rate, 1.0)
        self.tokens = self.burst
        self.last = now

    def try_take(self, cost: float, now: float) -> float | None:
        """Take ``cost`` tokens; returns None on success, else seconds
        until the bucket could cover the cost (capped at a full refill)."""
        self.tokens = min(
            self.burst, self.tokens + (now - self.last) * self.rate
        )
        self.last = now
        if self.tokens >= cost:
            self.tokens -= cost
            return None
        need = min(cost, self.burst) - self.tokens
        return need / self.rate if self.rate > 0 else float("inf")


class _TenantState:
    __slots__ = (
        "name", "cfg", "bucket", "queue", "vfinish", "queued_tokens",
        "admitted_tokens", "admitted_requests", "shed_requests",
    )

    def __init__(self, cfg: TenantConfig, now: float, name: str = "default"):
        self.name = name  # canonical metric-label key (bounds cardinality)
        self.cfg = cfg
        self.bucket = (
            _Bucket(cfg.rate_tokens_per_s, cfg.burst_tokens, now)
            if cfg.rate_tokens_per_s > 0
            else None
        )
        self.queue: deque = deque()  # (vfinish, cost, req)
        self.vfinish = 0.0
        self.queued_tokens = 0  # this tenant's share of the queue backlog
        self.admitted_tokens = 0  # dispatched to the engine (fairness probe)
        # Cumulative REQUEST counts (admitted vs shed, every shed cause):
        # a multi-window SLO burn-rate reader samples these (the telemetry
        # history's ``slo:`` series) — burn is a fraction of requests, so
        # token counts can't stand in for them.
        self.admitted_requests = 0
        self.shed_requests = 0


class OverloadController:
    """The control-plane state machine. See the module docstring for the
    four mechanisms; this class is pure policy — it never touches an
    engine (the :class:`~radixmesh_tpu_torch.slo.runner.SLORunner` applies tier
    knobs and moves requests), so every behavior is testable against a
    virtual clock."""

    def __init__(
        self,
        cfg: SLOConfig | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.cfg = cfg or SLOConfig()
        self.clock = clock
        self.log = get_logger("slo")
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantState] = {}
        self._vtime = 0.0  # WFQ virtual time (token/weight units)
        self._queued_requests = 0
        # Backlog components: tokens still in SLO queues (per-tenant
        # slices live on _TenantState) and tokens dispatched to the
        # engine but not yet at their first token. Their sum is the work
        # ahead of a new arrival — the degradation-tier signal; the
        # per-tenant slice drives the WFQ-bound deadline estimate.
        self._queued_tokens = 0
        self._dispatched_tokens = 0
        self._ewma_tok_s: float | None = None
        # Busy-time service-rate window (see SLOConfig.rate_window_s):
        # anchor is None while the system is idle; set on the dispatch
        # that makes it busy, advanced each time a window's aggregate
        # sample is emitted.
        self._ft_anchor: float | None = None
        self._ft_accum = 0
        self._tier = 0
        self._above_since: float | None = None
        self._below_since: float | None = None
        # (t, old_tier, new_tier, backlog_s) — an overload sweep records
        # these per point; bounded so a flapping config can't
        # grow without bound.
        self.tier_events: list[tuple[float, int, int, float]] = []
        self._shed_at_dispatch: list = []
        self.total_shed = 0
        self.total_admitted = 0

        reg = get_registry()
        self._m_admitted = reg.counter(
            "radixmesh_slo_admitted_requests_total",
            "requests admitted past the SLO control plane",
            ("tenant",),
        )
        self._m_admitted_tokens = reg.counter(
            "radixmesh_slo_admitted_tokens_total",
            "prompt tokens dispatched to the engine per tenant "
            "(the weighted-fair-share currency)",
            ("tenant",),
        )
        self._m_shed = reg.counter(
            "radixmesh_slo_shed_requests_total",
            "requests shed by the SLO control plane",
            ("tenant", "reason"),
        )
        self._m_depth = reg.gauge(
            "radixmesh_slo_queue_depth_requests",
            "requests waiting in the SLO admission queue",
            ("tenant",),
        )
        self._m_backlog = reg.gauge(
            "radixmesh_slo_backlog_tokens",
            "prompt tokens queued or dispatched-awaiting-first-token",
        )
        self._m_tier = reg.gauge(
            "radixmesh_slo_degradation_tier",
            "current graceful-degradation tier (0 = normal)",
        )
        self._m_transitions = reg.counter(
            "radixmesh_slo_degradation_transitions_total",
            "degradation tier changes",
            ("direction",),
        )
        self._m_wait = reg.histogram(
            "radixmesh_slo_admission_wait_seconds",
            "submit-to-dispatch wait inside the SLO queue",
            ("tenant",),
        )
        self._m_ewma = reg.gauge(
            "radixmesh_slo_prefill_rate_tokens_per_second",
            "EWMA of observed prefill service rate",
        )

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def _state(self, tenant: str, now: float) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            if (
                tenant not in self.cfg.tenants
                and len(self._tenants) >= self.cfg.max_tenants
            ):
                tenant = OVERFLOW_TENANT  # see the constant's rationale
                st = self._tenants.get(tenant)
                if st is not None:
                    return st
            st = _TenantState(self.cfg.tenant(tenant), now, name=tenant)
            self._tenants[tenant] = st
        return st

    def _label_locked(self, tenant: str) -> str:
        """Canonical metric-label name for a request's tenant (folded
        names report as the shared overflow entry)."""
        return tenant if tenant in self._tenants else OVERFLOW_TENANT

    def effective_deadline(self, ttft_deadline_s: float | None) -> float | None:
        return (
            ttft_deadline_s
            if ttft_deadline_s is not None
            else self.cfg.default_ttft_slo_s
        )

    def offer(
        self,
        tenant: str,
        n_tokens: int,
        ttft_deadline_s: float | None = None,
        now: float | None = None,
    ) -> AdmissionDecision:
        """Arrival-time admission check (does NOT enqueue — callers that
        get ``admitted`` follow up with :meth:`enqueue`, holding no lock
        in between is fine because both re-derive state under the
        controller lock)."""
        now = self.clock() if now is None else now
        cost = max(int(n_tokens), 1)
        deadline = self.effective_deadline(ttft_deadline_s)
        with self._lock:
            st = self._state(tenant, now)
            if self._queued_requests >= self.cfg.max_queue_requests:
                return self._refuse(st.name, SHED_QUEUE_FULL, None)
            if st.bucket is not None and cost > st.bucket.burst:
                # The bucket can NEVER hold this prompt — a retriable 429
                # would loop the client forever. Non-retriable (413).
                return self._refuse(st.name, SHED_OVER_BURST, None)
            est_wait = self._est_tenant_wait_locked(st)
            if deadline is not None and self._ewma_tok_s:
                est_service = cost / self._ewma_tok_s
                if est_wait + est_service > deadline * self.cfg.shed_headroom:
                    if (
                        self._queued_requests > 0
                        or self._dispatched_tokens > 0
                    ):
                        # Fast-fail NOW: by the time this request reached
                        # the front of the queue its deadline would be
                        # gone. The rate bucket is deliberately untouched
                        # — work that was never admitted must not spend
                        # rate budget and turn into spurious 429s later.
                        retry = max(
                            0.0,
                            est_wait + est_service
                            - deadline * self.cfg.shed_headroom,
                        )
                        return self._refuse(st.name, SHED_DEADLINE, retry)
                    # Probe admission: the system is IDLE, so the only
                    # way the estimate fails is a service-rate model
                    # claiming no request can EVER meet its deadline.
                    # A stale/poisoned EWMA (e.g. a first batch that
                    # paid one-time setup) would otherwise be self-trapping —
                    # everything sheds, so no completion ever lands to
                    # correct it. Admit one request at a time when
                    # idle; its completion refreshes the EWMA.
            if st.bucket is not None:
                retry = st.bucket.try_take(cost, now)
                if retry is not None:
                    return self._refuse(st.name, SHED_RATE_LIMITED, retry)
            return AdmissionDecision(True, est_wait_s=est_wait)

    def _refuse(
        self, tenant: str, reason: str, retry_after_s: float | None
    ) -> AdmissionDecision:
        self.total_shed += 1
        self._m_shed.labels(tenant=tenant, reason=reason).inc()
        st = self._tenants.get(tenant)
        if st is not None:
            st.shed_requests += 1
        return AdmissionDecision(False, reason, retry_after_s)

    def enqueue(self, req, now: float | None = None) -> None:
        """Queue an admitted request for WFQ dispatch. ``req`` is any
        object with ``prompt`` (sized), ``tenant``, ``submit_time``, and
        the shed fields of :class:`~radixmesh_tpu_torch.engine.request.Request`."""
        now = self.clock() if now is None else now
        cost = max(len(req.prompt), 1)
        with self._lock:
            st = self._state(req.tenant, now)
            vf = max(self._vtime, st.vfinish) + cost / st.cfg.weight
            st.vfinish = vf
            st.queue.append((vf, cost, req))
            self._queued_requests += 1
            st.queued_tokens += cost
            self._queued_tokens += cost
            self._m_depth.labels(tenant=st.name).set(len(st.queue))
            self._m_backlog.set(self._queued_tokens + self._dispatched_tokens)

    def pop_ready(self, now: float | None = None):
        """Next request in weighted-fair order, or None. Requests whose
        TTFT deadline is already unmeetable at dispatch time are marked
        shed (``req.shed``/``shed_reason``) and parked for the runner to
        finalize via :meth:`drain_shed` — they never reach the engine."""
        now = self.clock() if now is None else now
        with self._lock:
            while True:
                best: _TenantState | None = None
                for st in self._tenants.values():
                    if st.queue and (
                        best is None or st.queue[0][0] < best.queue[0][0]
                    ):
                        best = st
                if best is None:
                    return None
                vf, cost, req = best.queue.popleft()
                self._queued_requests -= 1
                best.queued_tokens -= cost
                self._queued_tokens -= cost
                self._vtime = max(self._vtime, vf)
                self._m_depth.labels(tenant=best.name).set(len(best.queue))
                e2e = getattr(req, "e2e_deadline_s", None)
                if e2e is not None and now - req.submit_time > e2e:
                    # Already dead end-to-end: dispatching would burn a
                    # full prefill on a client that has given up, then
                    # the runner's sweep would cancel it anyway.
                    self._drop_locked(req, SHED_E2E_EXPIRED)
                    continue
                deadline = self.effective_deadline(req.ttft_deadline_s)
                if deadline is not None and self._ewma_tok_s:
                    waited = now - req.submit_time
                    est_service = cost / self._ewma_tok_s
                    # Mirror of offer()'s probe rule: when the rate model
                    # claims the deadline is unmeetable from a standing
                    # start AND nothing is running, dispatching is the
                    # only way to get a sample that can correct it.
                    probe = (
                        est_service > deadline * self.cfg.shed_headroom
                        and self._dispatched_tokens == 0
                    )
                    if (
                        not probe
                        and waited + est_service
                        > deadline * self.cfg.shed_headroom
                    ):
                        self._drop_locked(req, SHED_DISPATCH_DEADLINE)
                        continue
                if self._ft_anchor is None:
                    self._ft_anchor = now  # system becomes busy
                self._dispatched_tokens += cost
                best.admitted_tokens += cost
                best.admitted_requests += 1
                self.total_admitted += 1
                self._m_admitted.labels(tenant=best.name).inc()
                self._m_admitted_tokens.labels(tenant=best.name).inc(cost)
                self._m_wait.labels(tenant=best.name).observe(
                    max(0.0, now - req.submit_time)
                )
                self._m_backlog.set(
                    self._queued_tokens + self._dispatched_tokens
                )
                return req

    def _drop_locked(self, req, reason: str) -> None:
        req.shed = True
        req.shed_reason = reason
        self.total_shed += 1
        label = self._label_locked(req.tenant)
        self._m_shed.labels(tenant=label, reason=reason).inc()
        st = self._tenants.get(label)
        if st is not None:
            st.shed_requests += 1
        self._shed_at_dispatch.append(req)

    def cancel_queued(self, rid) -> object | None:
        """Remove a request still waiting in the WFQ (client cancel
        before dispatch). Returns it — NOT marked shed; the caller
        finalizes like any cancel — or None if ``rid`` isn't queued.
        Without this an abandoned request would keep inflating
        ``est_wait`` (shedding live traffic) and eventually burn a
        prefill for a client that already left."""
        with self._lock:
            for st in self._tenants.values():
                for i, (_, cost, req) in enumerate(st.queue):
                    if req.rid == rid:
                        del st.queue[i]
                        self._queued_requests -= 1
                        st.queued_tokens -= cost
                        self._queued_tokens -= cost
                        self._m_depth.labels(tenant=st.name).set(
                            len(st.queue)
                        )
                        self._m_backlog.set(
                            self._queued_tokens + self._dispatched_tokens
                        )
                        return req
            return None

    def drain_shed(self) -> list:
        """Requests dropped inside :meth:`pop_ready` (or a shutdown
        :meth:`flush`) since the last call — the runner finalizes their
        state so waiters unblock."""
        with self._lock:
            out, self._shed_at_dispatch = self._shed_at_dispatch, []
            return out

    def flush(self, reason: str = SHED_SHUTDOWN) -> list:
        """Drop every queued request (shutdown sweep). Returns them,
        already marked shed, for the caller to finalize."""
        with self._lock:
            for name, st in self._tenants.items():
                while st.queue:
                    _, cost, req = st.queue.popleft()
                    self._queued_requests -= 1
                    st.queued_tokens -= cost
                    self._queued_tokens -= cost
                    self._drop_locked(req, reason)
                self._m_depth.labels(tenant=name).set(0)
            self._m_backlog.set(self._queued_tokens + self._dispatched_tokens)
            out, self._shed_at_dispatch = self._shed_at_dispatch, []
            return out

    # ------------------------------------------------------------------
    # service-rate feedback
    # ------------------------------------------------------------------

    def note_first_token(self, req, now: float | None = None) -> None:
        """First token landed for a dispatched request: retire its tokens
        from the backlog and fold the service observation into the rate
        EWMA. Samples are AGGREGATE over busy-time windows (uncached
        tokens completed per second while work was in flight), not
        per-request elapsed times: under concurrent/batched service a
        per-request sample undercounts the rate by the batching factor,
        and a rate estimated ×8 low sheds ×8 too eagerly."""
        if getattr(req, "slo_retired", False):
            return  # already retired (cancel raced the first token)
        req.slo_retired = True
        now = self.clock() if now is None else now
        cost = max(len(req.prompt), 1)
        served = max(cost - getattr(req, "prefix_len", 0), 1)
        with self._lock:
            self._dispatched_tokens = max(0, self._dispatched_tokens - cost)
            self._m_backlog.set(self._queued_tokens + self._dispatched_tokens)
            if self._ft_anchor is None:  # direct-injected (tests): anchor
                self._ft_anchor = req.admit_time or req.submit_time
            self._ft_accum += served
            elapsed = now - self._ft_anchor
            drained = (
                self._dispatched_tokens == 0 and self._queued_requests == 0
            )
            if elapsed >= self.cfg.rate_window_s or (drained and elapsed > 0):
                self._fold_rate_locked(self._ft_accum / elapsed)
                self._ft_anchor = None if drained else now
                self._ft_accum = 0

    def note_retired(self, req, now: float | None = None) -> None:
        """A dispatched request left the engine WITHOUT a first token
        (client cancel, e2e-deadline sweep, shutdown): retire its tokens
        from the backlog with no rate sample. Idempotent against
        :meth:`note_first_token` — whichever runs first wins, so a cancel
        racing a landed first token can never double-retire and the
        backlog estimate cannot leak (a leaked cost would inflate
        est_wait forever AND pin ``_dispatched_tokens`` > 0, permanently
        disarming the idle-probe escape)."""
        if getattr(req, "slo_retired", False):
            return
        req.slo_retired = True
        now = self.clock() if now is None else now
        cost = max(len(req.prompt), 1)
        with self._lock:
            self._dispatched_tokens = max(0, self._dispatched_tokens - cost)
            self._m_backlog.set(self._queued_tokens + self._dispatched_tokens)
            if (
                self._dispatched_tokens == 0
                and self._queued_requests == 0
                and self._ft_anchor is not None
            ):
                # System drained with the busy window still open: close it
                # (emitting the aggregate sample if any tokens completed)
                # so idle time never dilutes the next window's rate.
                elapsed = now - self._ft_anchor
                if self._ft_accum and elapsed > 0:
                    self._fold_rate_locked(self._ft_accum / elapsed)
                self._ft_anchor = None
                self._ft_accum = 0

    def _fold_rate_locked(self, rate: float) -> None:
        a = self.cfg.ewma_alpha
        self._ewma_tok_s = (
            rate
            if self._ewma_tok_s is None
            else (1 - a) * self._ewma_tok_s + a * rate
        )
        self._m_ewma.set(self._ewma_tok_s)

    def observe_service(self, tokens: int, seconds: float) -> None:
        """Direct EWMA feed (tests / calibration)."""
        with self._lock:
            if seconds <= 0:
                return
            self._fold_rate_locked(max(tokens, 1) / seconds)

    def _est_wait_locked(self, extra_tokens: int) -> float:
        """Global backlog drain time — the degradation-tier signal."""
        if not self._ewma_tok_s:
            return 0.0  # uncalibrated: admit freely until we can estimate
        return (
            self._queued_tokens + self._dispatched_tokens + extra_tokens
        ) / self._ewma_tok_s

    def _est_tenant_wait_locked(self, st: _TenantState) -> float:
        """WFQ delay bound for an arrival of ``st``'s tenant: its own
        queued tokens drained at its guaranteed share of the service
        rate, behind whatever is already dispatched. (See the module
        docstring for why the GLOBAL estimate would be wrong here.)"""
        if not self._ewma_tok_s:
            return 0.0
        active_w = sum(
            t.cfg.weight for t in self._tenants.values() if t.queue
        )
        if not st.queue:
            active_w += st.cfg.weight  # this arrival makes it active
        share = st.cfg.weight / active_w
        return (
            self._dispatched_tokens / self._ewma_tok_s
            + st.queued_tokens / (self._ewma_tok_s * share)
        )

    def est_wait_s(self) -> float:
        with self._lock:
            return self._est_wait_locked(0)

    # ------------------------------------------------------------------
    # degradation tiers
    # ------------------------------------------------------------------

    def update_tier(self, now: float | None = None) -> int:
        """Recompute the degradation tier from the estimated backlog
        drain time, with sustain/hold hysteresis. Called by the runner
        every pump; safe to call from anywhere."""
        now = self.clock() if now is None else now
        with self._lock:
            backlog_s = self._est_wait_locked(0)
            thresholds = self.cfg.tier_backlog_s
            target = 0
            for k, th in enumerate(thresholds, start=1):
                if backlog_s > th:
                    target = k
            if target > self._tier:
                self._below_since = None
                if self._above_since is None:
                    self._above_since = now
                if now - self._above_since >= self.cfg.tier_up_hold_s:
                    self._transition_locked(now, target, backlog_s, "up")
            elif target < self._tier:
                self._above_since = None
                if self._below_since is None:
                    self._below_since = now
                if now - self._below_since >= self.cfg.tier_down_hold_s:
                    self._transition_locked(now, target, backlog_s, "down")
            else:
                self._above_since = None
                self._below_since = None
            return self._tier

    def _transition_locked(
        self, now: float, target: int, backlog_s: float, direction: str
    ) -> None:
        old = self._tier
        self._tier = target
        self._above_since = None
        self._below_since = None
        if len(self.tier_events) < 4096:
            self.tier_events.append((now, old, target, round(backlog_s, 4)))
        self._m_tier.set(target)
        self._m_transitions.labels(direction=direction).inc()
        self.log.info(
            "degradation tier %d -> %d (est backlog %.2fs)",
            old, target, backlog_s,
        )

    @property
    def tier(self) -> int:
        with self._lock:
            return self._tier

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def admitted_tokens_by_tenant(self) -> dict[str, int]:
        with self._lock:
            return {
                name: st.admitted_tokens for name, st in self._tenants.items()
            }

    def burn_counts(self) -> dict[str, dict[str, int]]:
        """Cumulative per-tenant request outcomes (admitted vs shed,
        all shed causes) — the SLO burn-rate sampler input (the
        telemetry history's ``slo:`` series; the degradation tier rides
        ``.tier``). One lock
        hold; the sampler diffs consecutive snapshots into windowed
        rates."""
        with self._lock:
            return {
                name: {
                    "admitted": st.admitted_requests,
                    "shed": st.shed_requests,
                }
                for name, st in self._tenants.items()
            }

    def snapshot(self) -> dict:
        """Programmatic state view (the serving frontend's /stats)."""
        with self._lock:
            return {
                "tier": self._tier,
                "backlog_tokens": self._queued_tokens
                + self._dispatched_tokens,
                "est_wait_s": round(self._est_wait_locked(0), 4),
                "queued_requests": self._queued_requests,
                "prefill_tok_s_ewma": (
                    round(self._ewma_tok_s, 1) if self._ewma_tok_s else None
                ),
                "total_admitted": self.total_admitted,
                "total_shed": self.total_shed,
                "tenants": {
                    name: {
                        "weight": st.cfg.weight,
                        "queued": len(st.queue),
                        "admitted_tokens": st.admitted_tokens,
                    }
                    for name, st in self._tenants.items()
                },
                "tier_events": len(self.tier_events),
            }
