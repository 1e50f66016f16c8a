"""Profiling helpers over ``torch.profiler`` (the port's counterpart of the
JAX package's ``obs/tracing.py``, which wraps ``jax.profiler``).

Two levels:

- :func:`annotate` — named span inside an already-running profile
  (``torch.profiler.record_function``); it shows up on the trace beside the
  CUDA kernels it launched.
- :func:`profile` — capture a host + device trace of a block into a
  directory, as a Chrome trace (``trace.json``, loadable in Perfetto or
  ``chrome://tracing``) plus a ``key_averages`` table (``ops.txt``). CUDA
  activity is recorded where the process has a CUDA device.

:func:`timed` pairs an annotation with a histogram observation;
:func:`recorded` pairs one with a flight-recorder span.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

from radixmesh_tpu_torch.obs.metrics import Histogram
from radixmesh_tpu_torch.obs.trace_plane import get_recorder

__all__ = ["annotate", "prime_profiler", "profile", "recorded", "timed"]


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def prime_profiler() -> None:
    """Start and stop an empty profile on the calling thread. The profiler
    backend initializes on the thread of its first profile and refuses to
    initialize from another one, so a server that profiles from handler
    threads primes it once from the thread that built it."""
    import torch

    with torch.profiler.profile(activities=_activities()):
        pass


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named span on the profiler timeline. Costs next to nothing when no
    profile is running."""
    import torch

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile(log_dir: str) -> Iterator[dict]:
    """Capture a host (+ CUDA, where available) profile of the block into
    ``log_dir``: ``trace.json`` (Chrome trace events) and ``ops.txt`` (the
    profiler's ``key_averages`` table sorted by device time). The yielded
    dict gains ``trace``, ``ops`` and ``device_events`` (events with device
    time) when the block exits."""
    import torch

    os.makedirs(log_dir, exist_ok=True)
    info: dict = {}
    with torch.profiler.profile(activities=_activities()) as prof:
        yield info
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    trace = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(trace)
    ops = os.path.join(log_dir, "ops.txt")
    averages = prof.key_averages()
    sort = "self_device_time_total" if torch.cuda.is_available() else "self_cpu_time_total"
    with open(ops, "w") as fh:
        fh.write(averages.table(sort_by=sort, row_limit=60))
    info.update(trace=trace, ops=ops, device_events=sum(
        1 for e in averages if getattr(e, "self_device_time_total", 0) > 0))


@contextlib.contextmanager
def timed(hist: Histogram, name: str | None = None) -> Iterator[None]:
    """Observe the block's wall time into ``hist`` and annotate the span
    with ``name`` on a running profile."""
    t0 = time.monotonic()
    with annotate(name or hist.name):
        try:
            yield
        finally:
            hist.observe(time.monotonic() - t0)


@contextlib.contextmanager
def recorded(lane: str, name: str, **args) -> Iterator[None]:
    """An annotation for profiler captures and a flight-recorder span
    (``obs/trace_plane.py``) on ``lane``, in one block. One branch when the
    recorder is disabled (it still annotates, which is a no-op without a
    live profile)."""
    rec = get_recorder()
    if not rec.enabled:
        with annotate(name):
            yield
        return
    t0 = time.monotonic()
    with annotate(name):
        try:
            yield
        finally:
            rec.event(lane, name, t0, time.monotonic() - t0, **args)
