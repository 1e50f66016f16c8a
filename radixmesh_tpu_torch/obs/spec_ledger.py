"""Speculation acceptance per request class, and the adaptive-γ
controller behind ``--spec-adaptive`` (the port's copy of
``SpecLedger`` from the JAX package's ``obs/token_timeline.py``).

Per (tenant, request shape, draft source) cell: proposed / accepted /
rejected draft tokens, a per-wave acceptance EWMA and the γ actually used.
With ``adaptive=True`` each (tenant, shape) class's γ shrinks by one when
its acceptance EWMA sits below ``accept_floor`` and grows by one when it
clears ``accept_ceil``, clamped to [1, base γ]; a base γ of 0 (speculation
off) always wins. Each cell's counts also land on the registry's
``radixmesh_spec_*`` families (labels tenant, shape, source), as in the JAX
package; ``report()`` and ``totals()`` read the ledger itself. The token
timeline and the goodput ledger of the JAX module are in
``obs/token_timeline.py``.
"""

from __future__ import annotations

from radixmesh_tpu_torch.obs.metrics import get_registry

__all__ = ["SpecLedger", "DRAFT_SOURCES"]

# Where a draft came from: the radix tree's published continuation
# (replay hits), prompt n-gram lookup, or nothing (empty draft — the
# row rode the verify launch as a plain step).
DRAFT_SOURCES = ("tree", "ngram", "none")


class _SpecClass:
    """One (tenant, shape, source) acceptance cell."""

    __slots__ = (
        "proposed", "accepted", "rejected", "waves", "ewma",
        "gamma_used", "last_wave",
    )

    def __init__(self):
        self.proposed = 0
        self.accepted = 0
        self.rejected = 0
        self.waves = 0
        self.ewma: float | None = None  # cold until the first wave
        self.gamma_used = 0
        self.last_wave = 0


class SpecLedger:
    """Per-class speculation acceptance + the adaptive-γ controller.

    Written by the scheduler thread (one ``note_wave`` per row per
    verify launch); read lock-free. Classes are bounded: past
    ``max_classes`` the least-recently-waved cell is evicted (its
    registry counters keep their totals — only the EWMA state goes)."""

    def __init__(
        self,
        alpha: float = 0.25,
        max_classes: int = 128,
        adaptive: bool = False,
        accept_floor: float = 0.5,
        accept_ceil: float = 0.8,
        node: str = "",
    ):
        if not 0 < alpha <= 1:
            raise ValueError("alpha must be in (0, 1]")
        if not 0 <= accept_floor <= accept_ceil <= 1:
            raise ValueError("need 0 <= accept_floor <= accept_ceil <= 1")
        self.alpha = float(alpha)
        self.max_classes = int(max_classes)
        self.adaptive = bool(adaptive)
        self.accept_floor = float(accept_floor)
        self.accept_ceil = float(accept_ceil)
        self.node = node
        self._cells: dict[tuple[str, str, str], _SpecClass] = {}
        # (tenant, shape) -> current adaptive γ (absent = base).
        self._gamma: dict[tuple[str, str], int] = {}
        # Last SLO degradation tier seen (slo/runner.py notes it when it
        # applies a tier): tier >= 1 means speculation is off by policy.
        self.last_tier = 0
        self._wave_seq = 0

        reg = get_registry()
        labels = ("tenant", "shape", "source")
        self._m_proposed = reg.counter(
            "radixmesh_spec_proposed_tokens_total",
            "draft tokens offered to verification, by request class "
            "and draft source",
            labels,
        )
        self._m_accepted = reg.counter(
            "radixmesh_spec_accepted_tokens_total",
            "draft tokens accepted by verification, by request class "
            "and draft source",
            labels,
        )
        self._m_rejected = reg.counter(
            "radixmesh_spec_rejected_tokens_total",
            "draft tokens rejected by verification, by request class "
            "and draft source",
            labels,
        )
        self._m_ratio = reg.gauge(
            "radixmesh_spec_accept_ratio",
            "per-wave acceptance EWMA by request class and draft source",
            labels,
        )
        self._m_gamma = reg.gauge(
            "radixmesh_spec_gamma_used_tokens",
            "draft window actually used last wave, by request class "
            "and draft source",
            labels,
        )

    # -- write path (scheduler thread) ---------------------------------

    def note_wave(
        self,
        tenant: str,
        shape: str,
        source: str,
        proposed: int,
        accepted: int,
        gamma: int,
    ) -> None:
        """Account one row's verify outcome. ``gamma`` is the draft
        window actually used (≤ the engine's configured γ)."""
        if proposed <= 0:
            return
        rejected = proposed - accepted
        key = (tenant, shape, source)
        cell = self._cells.get(key)
        if cell is None:
            if len(self._cells) >= self.max_classes:
                self._evict_one()
            cell = self._cells[key] = _SpecClass()
        self._wave_seq += 1
        rate = accepted / proposed
        cell.proposed += proposed
        cell.accepted += accepted
        cell.rejected += rejected
        cell.waves += 1
        cell.gamma_used = gamma
        cell.last_wave = self._wave_seq
        # Cold start: the first wave seeds the EWMA directly instead of
        # decaying from an arbitrary prior.
        if cell.ewma is None:
            cell.ewma = rate
        else:
            cell.ewma += self.alpha * (rate - cell.ewma)
        lbl = {"tenant": tenant, "shape": shape, "source": source}
        self._m_proposed.labels(**lbl).inc(proposed)
        self._m_accepted.labels(**lbl).inc(accepted)
        if rejected:
            self._m_rejected.labels(**lbl).inc(rejected)
        self._m_ratio.labels(**lbl).set(cell.ewma)
        self._m_gamma.labels(**lbl).set(gamma)
        if self.adaptive:
            self._steer(tenant, shape, cell.ewma, gamma)

    def _steer(
        self, tenant: str, shape: str, ewma: float, gamma: int
    ) -> None:
        """The control law: one γ step per wave, toward acceptance."""
        key = (tenant, shape)
        g = self._gamma.get(key, gamma)
        if ewma < self.accept_floor:
            g = max(1, g - 1)
        elif ewma > self.accept_ceil:
            g = g + 1  # clamped to base at gamma_for()
        self._gamma[key] = g

    def _evict_one(self) -> None:
        oldest = min(self._cells, key=lambda k: self._cells[k].last_wave)
        del self._cells[oldest]

    def gamma_for(self, tenant: str, shape: str, base: int) -> int:
        """The γ the engine should draft with for this class: ``base``
        when the controller is off (or has no signal yet), else the
        steered value clamped to [1, base]. ``base`` ≤ 0 (speculation
        off, including by SLO tier) always wins."""
        if base <= 0 or not self.adaptive:
            return base
        g = self._gamma.get((tenant, shape))
        if g is None:
            return base
        return max(1, min(base, g))

    def note_tier(self, tier: int) -> None:
        """SLO runner seam: records the degradation tier in force."""
        self.last_tier = int(tier)

    # -- read path -----------------------------------------------------

    def report(self) -> dict:
        """Per-class acceptance snapshot. List-snapshot before iterating:
        the scheduler grows the dict concurrently."""
        cells = list(self._cells.items())
        out = {}
        for (tenant, shape, source), c in sorted(cells):
            out[f"{tenant}/{shape}/{source}"] = {
                "tenant": tenant,
                "shape": shape,
                "source": source,
                "proposed": c.proposed,
                "accepted": c.accepted,
                "rejected": c.rejected,
                "waves": c.waves,
                "accept_ewma": (
                    None if c.ewma is None else round(c.ewma, 4)
                ),
                "gamma_used": c.gamma_used,
            }
        return out

    def totals(self) -> dict:
        cells = list(self._cells.values())
        p = sum(c.proposed for c in cells)
        a = sum(c.accepted for c in cells)
        r = sum(c.rejected for c in cells)
        return {"proposed": p, "accepted": a, "rejected": r}
