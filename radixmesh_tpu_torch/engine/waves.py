"""Mixed compute waves: the token-budgeted wave scheduler (the port's copy
of the JAX package's ``engine/waves.py``).

The legacy schedule alternates WHOLE prefill waves with WHOLE decode
waves: ``step()`` prefills every admissible request to completion, chunk
loop and all, and only then runs one decode step, so a long prompt holds
the device for its entire prefill while every running stream waits (the
prefill convoy).

This module is the Sarathi-Serve/Orca answer, kept as pure host-side
policy so its invariants are testable without a device:

- every wave that has running decode rows *includes* their decode step
  (a mixed wave never skips decode), and
- rides up to ``inline_budget`` tokens of chunked prefill from the
  inline backlog on the SAME fused launch (``prefill_chunk_paged``
  already attends ragged per-row windows; the decode rows are just
  width-1 windows of the same chunk call), and
- may run at most ``max_defer`` CONSECUTIVE prefill-only "boost" waves
  (full ``boost_tokens`` width, for a backlog so deep that budget-sized
  chunks would starve TTFT) before it MUST run a decode-bearing wave
  again — the starvation bound, stated in wave counts (virtual time),
  never wall-clock.

Allotment within a wave is shortest-remaining-first (SPT, FIFO
tiebreak): a late-arriving 16-token prompt jumps the line past a long
groupmate's remaining chunks.

The scheduler holds no references to requests or device state; the
engine feeds it integer remaining-token counts and applies the returned
per-job allotments. The wave mix lands on the registry's
``radixmesh_wave_*`` families, as in the JAX package, and in plain
counters (``counts``, ``inline_tokens``, ``max_defer_observed``) that
``snapshot()`` and the frontend's ``/stats`` read.
"""

from __future__ import annotations

from dataclasses import dataclass

from radixmesh_tpu_torch.obs.metrics import get_registry

__all__ = ["WaveScheduler", "WavePlan", "WAVE_KINDS"]

# Every wave the engine runs is exactly one of these. ``decode`` and
# ``prefill`` are the legacy pure waves; ``mixed`` fuses both; ``boost``
# is a prefill-only catch-up wave that COUNTS AGAINST the defer bound.
WAVE_KINDS = ("decode", "prefill", "mixed", "boost")


@dataclass
class WavePlan:
    """One wave's composition, as decided by :meth:`WaveScheduler.plan`.

    ``kind``    — one of :data:`WAVE_KINDS`.
    ``allot``   — inline prefill tokens per backlog job, parallel to the
                  ``backlog`` list handed to ``plan()`` (0 = job sits
                  this wave out). Sums to ≤ ``inline_budget`` for mixed
                  waves and ≤ ``boost_tokens`` for boost waves — the
                  budget invariant the tests pin.
    ``decode``  — whether this wave carries the decode step for the
                  running rows (always True when ``kind`` is ``decode``
                  or ``mixed``).
    """

    kind: str
    allot: list[int]
    decode: bool


class WaveScheduler:
    def __init__(
        self,
        inline_budget: int,
        max_defer: int = 2,
        chunk: int = 512,
        boost_tokens: int = 4096,
        node: str = "",
    ):
        if inline_budget <= 0:
            raise ValueError("inline_budget must be > 0 (0 disables mixing)")
        self.inline_budget = int(inline_budget)
        self.max_defer = max(0, int(max_defer))
        self.chunk = max(1, int(chunk))
        self.boost_tokens = max(self.inline_budget, int(boost_tokens))
        # Consecutive decode-deferring (boost) waves since the last wave
        # that carried decode — THE starvation counter. Reset by every
        # decode-bearing wave; the bound is ``max_defer``.
        self._defer = 0
        self.max_defer_observed = 0
        # Wave counts by kind and inline tokens advanced, read without a
        # lock by the frontend's /stats.
        self.counts = dict.fromkeys(WAVE_KINDS, 0)
        self.inline_tokens = 0
        reg = get_registry()
        engine = node or "engine"
        waves = reg.counter(
            "radixmesh_wave_total",
            "compute waves by kind (decode / prefill / mixed / boost)",
            ("engine", "kind"),
        )
        self._m_waves = {kind: waves.labels(engine=engine, kind=kind) for kind in WAVE_KINDS}
        self._m_inline_tokens = reg.counter(
            "radixmesh_wave_inline_tokens_total",
            "prefill tokens advanced inside mixed/boost waves",
            ("engine",),
        ).labels(engine=engine)
        self._m_defer = reg.gauge(
            "radixmesh_wave_decode_defer_waves",
            "consecutive waves the decode step has been deferred "
            "(bounded by --prefill-inline-max-defer)",
            ("engine",),
        ).labels(engine=engine)

    # ------------------------------------------------------------------
    # policy
    # ------------------------------------------------------------------

    def plan(self, decode_rows: int, backlog: list[int]) -> WavePlan:
        """Decide the next wave from ``decode_rows`` running decode rows
        and ``backlog`` = remaining UNPREFILLED tokens per inline job
        (engine admission order). Pure; :meth:`note` commits it."""
        remaining = [max(0, int(r)) for r in backlog]
        total = sum(remaining)
        if total <= 0:
            return WavePlan("decode", [0] * len(remaining), decode_rows > 0)
        if decode_rows <= 0:
            # Nobody to starve: catch the backlog up at full wave width
            # (the cold-start path keeps its pre-mixing throughput).
            return WavePlan(
                "prefill", self._allot(remaining, self.boost_tokens), False
            )
        if total >= self.boost_tokens and self._defer < self.max_defer:
            # Backlog deeper than a full legacy wave: budget-sized
            # chunks alone would push TTFT past the old alternating
            # schedule. Spend a bounded number of consecutive waves
            # prefill-only — each one counted against the defer bound,
            # so a decode stream's worst ITL gap is max_defer+1 waves.
            return WavePlan(
                "boost", self._allot(remaining, self.boost_tokens), False
            )
        return WavePlan(
            "mixed", self._allot(remaining, self.inline_budget), True
        )

    def _allot(self, remaining: list[int], budget: int) -> list[int]:
        """Split ``budget`` tokens across jobs, shortest-remaining-first
        (FIFO tiebreak), each share capped at ``chunk``."""
        allot = [0] * len(remaining)
        order = sorted(range(len(remaining)), key=lambda i: (remaining[i], i))
        left = budget
        for i in order:
            if left <= 0:
                break
            take = min(remaining[i], self.chunk, left)
            allot[i] = take
            left -= take
        return allot

    def note(self, plan: WavePlan) -> None:
        """Commit a planned-and-executed wave: defer accounting and the
        counters. The engine calls this exactly once per wave it runs."""
        if plan.kind == "boost":
            # Only boost waves defer anyone: a pure prefill wave runs
            # when there are NO decode rows, so nothing is starved and
            # the counter must not charge it against the bound.
            self._defer += 1
            self.max_defer_observed = max(self.max_defer_observed, self._defer)
        else:
            self._defer = 0
        self._m_defer.set(self._defer)
        self.counts[plan.kind] += 1
        self._m_waves[plan.kind].inc()
        inline = sum(plan.allot)
        if inline:
            self.inline_tokens += inline
            self._m_inline_tokens.inc(inline)

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------

    def snapshot(self) -> dict:
        """Lock-free wave-mix snapshot for ``/stats``."""
        return {
            "budget": self.inline_budget,
            "max_defer": self.max_defer,
            "counts": dict(self.counts),
            "inline_tokens": self.inline_tokens,
            "decode_defer": self._defer,
            "max_defer_observed": self.max_defer_observed,
        }
