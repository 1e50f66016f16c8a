"""Token-level speed observability: where each decoded token's time went
(the port's copy of ``TokenTimeline``, ``GoodputLedger`` and the stall
taxonomy from the JAX package's ``obs/token_timeline.py``; ``SpecLedger``
lives in ``obs/spec_ledger.py`` and is re-exported here).

The engine feeds these ledgers from its one per-emitted-token funnel
(``Engine._consume_token``):

- :class:`TokenTimeline` — a bounded, change-compressed ring of
  inter-token latencies (ITL). One append per emitted token, drop-oldest
  overwrite; the engine tests ``timeline is not None`` once per token and
  pays nothing when disabled. Gaps past ``stall_threshold_s`` become
  stall events attributed to a named cause (:data:`STALL_CAUSES`). Served
  on ``GET /debug/tokens``.
- :class:`GoodputLedger` — useful-output tokens per wall second per
  tenant, decomposed into padding waste (from step accounting),
  rejected-draft waste (from the speculation ledger) and stall time (from
  the timeline).

Time stamps are host ``time.monotonic()`` reads taken after each step's
one device-to-host copy of its sampled tokens, so a gap is the host's view
of a step, device time included. Every token of a multi-step launch (k
tokens per row per launch) or of an accepted speculative window shares
one stamp: the first gap of such a launch carries the whole launch, the
others read ~0 — the JAX engine's semantics, kept.

Hot-path contract: the token-append path takes no locks of its own and
allocates nothing beyond the ring slot — the ring is a preallocated list
written only by the scheduler thread; readers snapshot without locks.
"""

from __future__ import annotations

import time

from radixmesh_tpu_torch.obs.metrics import get_registry
from radixmesh_tpu_torch.obs.spec_ledger import DRAFT_SOURCES, SpecLedger

__all__ = [
    "TokenTimeline",
    "SpecLedger",
    "GoodputLedger",
    "STALL_CAUSES",
    "DRAFT_SOURCES",
    "ITL_SECONDS_BUCKETS",
]

# The stall-cause taxonomy, in attribution-priority order. A gap only
# ever gets ONE cause; the engine resolves it at emit time from what it
# knows was in flight during the gap (``Engine._stall_cause``):
#
# - ``restore_park``     — a KV-plane restore was in flight (requests
#                          parked in RESTORING while decode waited).
# - ``prefill_convoy``   — a WHOLE prefill wave ran inside the gap (the
#                          wide-shape TTFT collapse, seen from the token
#                          side).
# - ``prefill_inline``   — a budget-bounded inline prefill chunk rode the
#                          decode wave inside the gap (mixed compute
#                          waves, ``--prefill-inline-budget``). Distinct
#                          from the convoy on purpose: inline chunks are
#                          the MITIGATION, bounded by the budget, and a
#                          gap they stretch must not read as either a
#                          convoy regression or an unexplained
#                          ``scheduler_wait``.
# - ``rebalance_handoff``— an ownership move was draining this node
#                          (external planes latch it via
#                          ``Engine.hint_stall``).
# - ``spec_verify_miss`` — the previous speculative wave rejected this
#                          row's drafts, so the gap re-decoded them.
# - ``scheduler_wait``   — none of the above: the scheduler simply did
#                          not run this row (queueing, host work, GC).
STALL_CAUSES = (
    "restore_park",
    "prefill_convoy",
    "prefill_inline",
    "rebalance_handoff",
    "spec_verify_miss",
    "scheduler_wait",
)

# ITL distribution buckets: decode steps are sub-ms to tens of ms on
# real hardware; DEFAULT_BUCKETS' 1 ms floor would flatten the healthy
# band to zeros, and the tail must still resolve multi-second stalls.
ITL_SECONDS_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)

# Change-compression tolerance: a token whose ITL is within this
# relative band of its request's previous ring entry (same cause) bumps
# that entry's repeat count instead of writing a new slot — steady-state
# decode (thousands of near-identical gaps) compresses to one slot per
# plateau, so the ring's wall coverage is workload-adaptive.
_REL_TOL = 0.25


class TokenTimeline:
    """Bounded per-token ITL ring + stall-cause accounting.

    Writer: the engine scheduler thread only (one ``note_token`` per
    emitted token). Readers (``/debug/tokens``, the doctor) snapshot
    lock-free — worst case they see a slot mid-overwrite, which the
    rid-stamp check discards.
    """

    def __init__(
        self,
        capacity: int = 4096,
        stall_threshold_s: float = 0.05,
        node: str = "",
    ):
        if capacity <= 0:
            raise ValueError("timeline capacity must be positive")
        self.capacity = int(capacity)
        self.stall_threshold_s = float(stall_threshold_s)
        self.node = node
        # Ring slots are [rid, tenant, t_mono, itl_s, repeats, cause].
        self._ring: list = [None] * self.capacity
        self._head = 0  # next slot to write
        self.appends = 0  # note_token calls (uncompressed token count)
        self.points = 0  # ring slots actually written
        # rid -> ring index of that request's latest entry (for repeat
        # compression); bounded by periodic clear, validated by rid
        # stamp before use so stale mappings can't corrupt a slot.
        self._last: dict[int, int] = {}
        # cause -> count / seconds, all-time (the ring forgets, the
        # histogram must not — the doctor reads deltas off the history
        # ring's copy of the counter families).
        self.stall_counts: dict[str, int] = dict.fromkeys(STALL_CAUSES, 0)
        self.stall_seconds: dict[str, float] = dict.fromkeys(
            STALL_CAUSES, 0.0
        )

        reg = get_registry()
        # Fleet-mergeable per-tenant ITL distribution (cumulative bucket
        # counts merge across nodes; exemplars carry trace ids).
        self._m_itl = reg.histogram(
            "radixmesh_token_itl_seconds",
            "inter-token latency per tenant (fleet-mergeable buckets; "
            "exemplars carry trace ids)",
            ("tenant",),
            buckets=ITL_SECONDS_BUCKETS,
        )
        self._m_stalls = reg.counter(
            "radixmesh_token_stalls_total",
            "decode gaps past the stall threshold, by attributed cause",
            ("cause",),
        )
        self._m_stall_children = {
            c: self._m_stalls.labels(cause=c) for c in STALL_CAUSES
        }
        self._itl_children: dict[str, object] = {}

    # -- write path (scheduler thread) ---------------------------------

    def note_token(
        self,
        rid: int,
        tenant: str,
        itl_s: float,
        cause: str | None = None,
        trace_id: int | None = None,
        now: float | None = None,
    ) -> None:
        """Account one emitted token's inter-token gap. ``cause`` is the
        engine's stall attribution (None below threshold)."""
        self.appends += 1
        child = self._itl_children.get(tenant)
        if child is None:
            child = self._m_itl.labels(tenant=tenant)
            self._itl_children[tenant] = child
        child.observe(itl_s, trace_id=trace_id)
        if cause is not None:
            self.stall_counts[cause] += 1
            self.stall_seconds[cause] += itl_s
            self._m_stall_children[cause].inc()
        # Repeat-compress against this request's previous entry: same
        # cause bucket and ITL within the relative band.
        idx = self._last.get(rid)
        if idx is not None:
            slot = self._ring[idx]
            if (
                slot is not None
                and slot[0] == rid
                and slot[5] == cause
                and abs(itl_s - slot[3]) <= _REL_TOL * max(slot[3], 1e-9)
            ):
                slot[4] += 1
                return
        if len(self._last) > 4 * self.capacity:
            # Bounded bookkeeping: stale rids accumulate across request
            # lifetimes; a rare clear only costs one lost compression
            # opportunity per live request.
            self._last.clear()
        t = time.monotonic() if now is None else now
        idx = self._head
        self._ring[idx] = [rid, tenant, t, itl_s, 1, cause]
        self._head = (idx + 1) % self.capacity
        self.points += 1
        self._last[rid] = idx

    # -- read path (any thread, lock-free) -----------------------------

    def snapshot(self, limit: int = 256) -> dict:
        """Point-in-time view for ``/debug/tokens``: ring stats, the
        stall-cause histogram, per-tenant ITL percentiles, and the most
        recent ``limit`` (change-compressed) entries, oldest first."""
        n = min(limit, self.capacity)
        head = self._head
        entries = []
        for off in range(self.capacity):
            slot = self._ring[(head + off) % self.capacity]
            if slot is None:
                continue
            entries.append(slot)
        entries = entries[-n:]
        quantiles = {}
        for tenant, child in list(self._itl_children.items()):
            try:
                quantiles[tenant] = {
                    "count": int(child.count),
                    "p50_s": child.quantile(0.5),
                    "p99_s": child.quantile(0.99),
                }
            except Exception:  # noqa: BLE001 — snapshot must not throw
                continue
        return {
            "capacity": self.capacity,
            "stall_threshold_s": self.stall_threshold_s,
            "appends": self.appends,
            "points": self.points,
            "compressed": self.appends - self.points,
            "dropped": max(0, self.points - self.capacity),
            "stalls": {
                c: n for c, n in self.stall_counts.items() if n
            },
            "stall_seconds": {
                c: round(s, 6)
                for c, s in self.stall_seconds.items()
                if s
            },
            "itl": quantiles,
            "recent": [
                {
                    "rid": e[0],
                    "tenant": e[1],
                    "t": e[2],
                    "itl_s": e[3],
                    "repeats": e[4],
                    "cause": e[5],
                }
                for e in entries
            ],
        }


class GoodputLedger:
    """Useful-output tokens per device-second per tenant, with the waste
    decomposition. Fed per token by the engine (same branch as the
    timeline); ``report()`` refreshes the registry gauges, so every
    caller that reads it (``/debug/tokens``, the doctor, the history
    sampler's derived fold) also keeps the scrape plane fresh."""

    def __init__(self, node: str = "", now=time.monotonic):
        self.node = node
        self._now = now
        self._t0 = now()
        # tenant -> [useful_tokens, stall_seconds]
        self._tenants: dict[str, list] = {}

        reg = get_registry()
        self._m_tps = reg.gauge(
            "radixmesh_goodput_tokens_per_second",
            "useful output tokens per wall second, per tenant",
            ("tenant",),
        )
        self._m_waste = reg.gauge(
            "radixmesh_goodput_waste_fraction",
            "waste share of decode capacity by kind "
            "(padding / rejected_draft / stall)",
            ("kind",),
        )

    # -- write path (scheduler thread) ---------------------------------

    def note_token(self, tenant: str) -> None:
        cell = self._tenants.get(tenant)
        if cell is None:
            cell = self._tenants[tenant] = [0, 0.0]
        cell[0] += 1

    def note_stall(self, tenant: str, stall_s: float) -> None:
        cell = self._tenants.get(tenant)
        if cell is None:
            cell = self._tenants[tenant] = [0, 0.0]
        cell[1] += stall_s

    # -- read path -----------------------------------------------------

    def report(self, step_acct=None, spec: SpecLedger | None = None) -> dict:
        """The decomposition: per-tenant goodput plus where the rest of
        the capacity went. ``step_acct`` contributes padding waste (its
        padded-vs-real token accounting), ``spec`` rejected-draft waste;
        stall time comes from this ledger's own per-tenant sums."""
        now = self._now()
        elapsed = max(now - self._t0, 1e-9)
        tenants = {}
        useful_total = 0
        stall_total = 0.0
        for tenant, (tokens, stall_s) in sorted(self._tenants.items()):
            tps = tokens / elapsed
            tenants[tenant] = {
                "useful_tokens": tokens,
                "tokens_per_second": round(tps, 3),
                "stall_seconds": round(stall_s, 6),
            }
            useful_total += tokens
            stall_total += stall_s
            self._m_tps.labels(tenant=tenant).set(tps)
        padding = 0
        if step_acct is not None:
            try:
                rep = step_acct.report()
                for kind in ("prefill", "decode"):
                    k = rep.get(kind)
                    if isinstance(k, dict):
                        padding += int(
                            k.get("padded_tokens", 0)
                            - k.get("real_tokens", 0)
                        )
            except Exception:  # noqa: BLE001 — seam isolation
                pass
        rejected = 0
        if spec is not None:
            rejected = spec.totals()["rejected"]
        # Waste fractions against the total token positions the device
        # actually processed (useful + padding + rejected); stall is a
        # time share of the wall instead — stalled seconds process
        # nothing, so a token denominator would hide them.
        processed = max(useful_total + padding + rejected, 1)
        waste = {
            "padding": padding / processed,
            "rejected_draft": rejected / processed,
            "stall": min(stall_total / elapsed, 1.0),
        }
        for kind, frac in waste.items():
            self._m_waste.labels(kind=kind).set(frac)
        return {
            "elapsed_s": round(elapsed, 3),
            "useful_tokens": useful_total,
            "tokens_per_second": round(useful_total / elapsed, 3),
            "tenants": tenants,
            "waste": {k: round(v, 6) for k, v in waste.items()},
            "padding_tokens": padding,
            "rejected_draft_tokens": rejected,
            "stall_seconds": round(stall_total, 6),
        }
