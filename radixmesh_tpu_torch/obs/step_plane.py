"""Step attribution: per-wave token accounting, pad fraction, MFU (the
port's copy of the JAX package's ``obs/step_plane.py``).

- Every prefill sub-wave and decode launch reports ``(kind, real
  tokens, padded tokens, wall seconds)`` to a :class:`StepAccounting`
  instance owned by the engine.
- **Pad fraction** = 1 - real/padded: the share of the launch shape
  that was power-of-two or bucket padding — work no request asked for.
- **MFU estimate** = achieved FLOP/s over the card's nominal dense bf16
  peak, with achieved FLOPs from the matmul-dominant analytic model
  ``FLOPs/token ≈ 2 · n_params`` (one multiply-add per weight per token;
  attention's O(s·d) term and the embedding gather are outside it). The
  wall time of a wave is the host's, taken after the wave's one
  device-to-host copy, so it includes host work and launch gaps; exact
  device numbers need a profiler capture (``/debug/profile?seconds=N``
  wraps ``torch.profiler`` for that).
- Emitted as ``radixmesh_step_mfu`` / ``radixmesh_wave_pad_fraction``
  gauges (labels: engine, kind) plus ``step_wave`` recorder spans on the
  ``step:<engine>`` lane, and aggregated into :meth:`report` for
  ``/debug/state``.

Accounting is OFF by default (``Engine(step_accounting=True)`` /
``launch.py serve --step-accounting``): the wave hot paths keep the
one-branch-when-off contract — a single ``is not None`` test.
"""

from __future__ import annotations

import time

from radixmesh_tpu_torch.obs.metrics import get_registry
from radixmesh_tpu_torch.obs.trace_plane import get_recorder

__all__ = [
    "PEAK_TFLOPS_BY_DEVICE",
    "DEFAULT_PEAK_TFLOPS",
    "detect_peak_tflops",
    "analytic_flops_per_token",
    "StepAccounting",
]

# Nominal dense bf16 tensor-core peak by card (TFLOP/s per card, the
# vendor's dense figure, without structured sparsity), matched in order
# as a substring of ``torch.cuda.get_device_name().lower()``. MFU is an
# ESTIMATE: the point is trend lines on one card, not absolute truth — a
# wrong peak scales every reading by one constant.
PEAK_TFLOPS_BY_DEVICE = {
    # H100 PCIe: 756 TFLOP/s dense bf16 (1,513 with sparsity).
    "h100 pcie": 756.0,
    # H100 SXM5: 989 TFLOP/s dense bf16 (1,979 with sparsity); torch
    # names the 80 GB SXM5 card "NVIDIA H100 80GB HBM3".
    "h100 sxm": 989.0,
    "h100 80gb hbm3": 989.0,
}
# Off the card (CPU tests and CPU engines): a nominal 1 TFLOP/s so MFU
# stays finite and comparable across runs on the same host — the value is
# labeled an estimate everywhere it surfaces.
DEFAULT_PEAK_TFLOPS = 1.0


def detect_peak_tflops(device=None) -> float:
    """Peak TFLOP/s of the CUDA card ``device`` (default: the current
    one), by name lookup; the nominal default for a CPU device, where
    torch has no CUDA, or for an unknown card."""
    import torch

    if device is not None and torch.device(device).type != "cuda":
        return DEFAULT_PEAK_TFLOPS
    if not torch.cuda.is_available():
        return DEFAULT_PEAK_TFLOPS
    name = torch.cuda.get_device_name(device).lower()
    for key, tflops in PEAK_TFLOPS_BY_DEVICE.items():
        if key in name:
            return tflops
    return DEFAULT_PEAK_TFLOPS


def analytic_flops_per_token(n_params: int) -> float:
    """Forward-pass FLOPs per processed token, matmul-dominant model:
    2 FLOPs (multiply + add) per parameter per token."""
    return 2.0 * float(n_params)


class StepAccounting:
    """Per-engine wave accounting: tokens, padding, achieved-vs-peak.

    One instance per engine, driven from the single scheduler thread —
    no locking of its own (the metric gauges carry their own locks).
    """

    KINDS = ("prefill", "decode")

    def __init__(
        self,
        engine: str,
        n_params: int,
        peak_tflops: float | None = None,
        device=None,
    ):
        self.engine = engine
        self.n_params = int(n_params)
        self.flops_per_token = analytic_flops_per_token(n_params)
        self.peak_flops = (
            peak_tflops if peak_tflops is not None else detect_peak_tflops(device)
        ) * 1e12
        self._trace_lane = f"step:{engine}"
        self._agg: dict[str, dict[str, float]] = {
            k: {
                "waves": 0,
                "real_tokens": 0,
                "padded_tokens": 0,
                "busy_s": 0.0,
                "mfu_last": 0.0,
                "pad_fraction_last": 0.0,
            }
            for k in self.KINDS
        }
        reg = get_registry()
        mfu = reg.gauge(
            "radixmesh_step_mfu",
            "per-wave model FLOPs utilization estimate (analytic "
            "2*n_params FLOPs/token over the device's nominal peak)",
            ("engine", "kind"),
        )
        pad = reg.gauge(
            "radixmesh_wave_pad_fraction",
            "share of the last wave's launch shape that was padding "
            "(1 - real/padded tokens)",
            ("engine", "kind"),
        )
        waves = reg.counter(
            "radixmesh_step_waves_total",
            "prefill/decode device waves accounted",
            ("engine", "kind"),
        )
        # Eager children: the series exist at 0 from engine start.
        self._g_mfu = {k: mfu.labels(engine=engine, kind=k) for k in self.KINDS}
        self._g_pad = {k: pad.labels(engine=engine, kind=k) for k in self.KINDS}
        self._m_waves = {
            k: waves.labels(engine=engine, kind=k) for k in self.KINDS
        }

    def note_wave(
        self,
        kind: str,
        real_tokens: int,
        padded_tokens: int,
        dt_s: float,
        rows: int = 0,
    ) -> float:
        """Account one device wave; returns its MFU estimate. The MFU
        numerator counts REAL tokens only — padding is wasted peak, so
        it shows up as low MFU plus a high pad fraction, which is
        exactly the pair of signals a scheduling fix must move in
        opposite directions."""
        if kind not in self._agg:
            raise ValueError(f"unknown wave kind {kind!r}")
        real = max(0, int(real_tokens))
        padded = max(real, int(padded_tokens))
        dt = max(1e-9, float(dt_s))
        mfu = (self.flops_per_token * real) / (self.peak_flops * dt)
        pad_fraction = 1.0 - (real / padded) if padded else 0.0
        a = self._agg[kind]
        a["waves"] += 1
        a["real_tokens"] += real
        a["padded_tokens"] += padded
        a["busy_s"] += dt
        a["mfu_last"] = mfu
        a["pad_fraction_last"] = pad_fraction
        self._g_mfu[kind].set(mfu)
        self._g_pad[kind].set(pad_fraction)
        self._m_waves[kind].inc()
        rec = get_recorder()
        if rec.enabled:
            rec.event(
                self._trace_lane,
                "step_wave",
                time.monotonic() - dt,
                dt,
                cat="step",
                kind=kind,
                real_tokens=real,
                padded_tokens=padded,
                rows=int(rows),
                mfu=round(mfu, 6),
                pad_fraction=round(pad_fraction, 4),
            )
        return mfu

    def report(self) -> dict:
        """Aggregates for /debug/state. ``mfu`` is
        the busy-time-weighted mean (total real FLOPs over total busy
        peak-FLOP capacity), not a mean of per-wave ratios."""
        out: dict = {
            "n_params": self.n_params,
            "flops_per_token": self.flops_per_token,
            "peak_tflops": round(self.peak_flops / 1e12, 3),
        }
        for kind, a in self._agg.items():
            busy = a["busy_s"]
            mfu = (
                (self.flops_per_token * a["real_tokens"])
                / (self.peak_flops * busy)
                if busy > 0
                else 0.0
            )
            pad = (
                1.0 - a["real_tokens"] / a["padded_tokens"]
                if a["padded_tokens"]
                else 0.0
            )
            out[kind] = {
                "waves": int(a["waves"]),
                "real_tokens": int(a["real_tokens"]),
                "padded_tokens": int(a["padded_tokens"]),
                "busy_s": round(busy, 6),
                "mfu": mfu,
                "pad_fraction": round(pad, 6),
                "mfu_last": a["mfu_last"],
                "pad_fraction_last": round(a["pad_fraction_last"], 6),
            }
        return out
