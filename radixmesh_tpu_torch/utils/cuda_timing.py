"""Kernel timing on the card, shared by ``chip_smoke.py`` and
``radixmesh_tpu_torch.kernelbench``: CUDA-event times with the L2 cache
flushed before each launch, the host's time per call of a wrapper, the
least time the card could take for the
same work (its bound, with the bytes of paged K/V rows), and the dense K/V
that the ``scaled_dot_product_attention`` yardstick reads.

Peaks are NVIDIA's H100 SXM data sheet figures (dense, no sparsity): HBM3
at 3.35 TB/s, 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 on
the CUDA cores. They assume the card's full 700 W power limit.
"""

from __future__ import annotations

import statistics
import time

import torch

__all__ = ["HBM_BYTES_PER_S", "PEAK_FLOPS", "time_ms", "host_us", "bound", "kv_bytes", "dense_context",
           "sdpa_inputs"]

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

_FLUSH: dict[torch.device, torch.Tensor] = {}


# Cycles of the spin kernel queued after each flush: ~0.5 ms at the H100's
# boost clock, longer than the host takes to enqueue a wrapper's launches.
_SPIN_CYCLES = 1_000_000


def time_ms(fn, iters: int, device: torch.device | str = "cuda") -> float:
    """Median device time of ``fn`` over ``iters`` calls, each timed alone
    by CUDA events after a 256 MB write that evicts the 50 MB L2 (the
    serving path reads each layer's pages cold). A spin kernel queued
    before the start event keeps the card busy while the host enqueues
    ``fn``, so the events bracket device work only, not the host's launch
    time; the median keeps a call that a host stall outlasted the spin
    from moving the reading. One untimed call warms up first."""
    dev = torch.device(device)
    flush = _FLUSH.get(dev)
    if flush is None:
        flush = _FLUSH[dev] = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    fn()
    torch.cuda.synchronize(dev)
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(_SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ``host_us``: the calls per mean, the means per reading, and the cycles of
# the spin kernel that holds the card meanwhile (~50 ms at the H100's boost
# clock, longer than the calls take to enqueue; 200 calls stay well inside
# the launch queue).
_HOST_CALLS, _HOST_REPS, _HOST_SPIN_CYCLES = 200, 5, 100_000_000


def host_us(fn, device: torch.device | str = "cuda") -> float:
    """Host time of one call of ``fn`` in µs (the median of five means
    over 200 calls): the calls are enqueued behind a spin kernel, so the
    host never waits for the card and the clock reads what the host does
    per call — argument checks, allocations, launches."""
    dev = torch.device(device)
    fn()
    torch.cuda.synchronize(dev)
    means = []
    for _ in range(_HOST_REPS):
        torch.cuda._sleep(_HOST_SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(_HOST_CALLS):
            fn()
        means.append((time.perf_counter() - t0) / _HOST_CALLS * 1e6)
        torch.cuda.synchronize(dev)
    return statistics.median(means)


def bound(nbytes: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    """``(ms, "bytes" | "operations")``: the larger of ``nbytes`` at the HBM
    rate and ``flops`` at the dense peak for ``dtype``, and which binds."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kv_bytes(tokens: int, kv_pages: torch.Tensor, quant: bool) -> int:
    """Bytes of ``tokens`` K and V rows over all kv heads of ``kv_pages``
    ``[2, L, Hkv, P, page, D]``, plus a 4-byte scale per row for int8 pools."""
    hkv, d = kv_pages.shape[2], kv_pages.shape[-1]
    return 2 * hkv * tokens * (d * kv_pages.element_size() + (4 if quant else 0))


def dense_context(kv_pages, kv_scales, page_table, layer, counts, width, dtype):
    """K and V ``[B, width, Hkv, D]`` in ``dtype``: row ``b``'s first
    ``counts[b]`` pool tokens of ``layer`` in page-table order (dequantized
    by ``kv_scales`` for int8 pools), zeros after."""
    _, _, hkv, _, page, d = kv_pages.shape
    dev = kv_pages.device
    kd = torch.zeros(len(counts), max(width, 1), hkv, d, dtype=dtype, device=dev)
    vd = torch.zeros_like(kd)
    for b, n in enumerate(int(c) for c in counts):
        if n <= 0:
            continue
        pos = torch.arange(n, device=dev)
        s_b = page_table[b, pos // page].long() * page + pos % page
        for which, dst in ((0, kd), (1, vd)):
            rows = kv_pages[which, layer].reshape(hkv, -1, d)[:, s_b].float()
            if kv_scales is not None:
                rows = rows * kv_scales[which, layer].reshape(hkv, -1)[:, s_b][..., None]
            dst[b, :n] = rows.transpose(0, 1).to(dtype)
    return kd, vd


def sdpa_inputs(kd: torch.Tensor, vd: torch.Tensor, groups: int):
    """``[B, T, Hkv, D]`` K and V as SDPA reads them: ``[B, Hkv * groups,
    T, D]``, each kv head repeated for its ``groups`` query heads."""
    return tuple(x.permute(0, 2, 1, 3).repeat_interleave(groups, dim=1).contiguous() for x in (kd, vd))
