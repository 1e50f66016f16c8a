"""Run a JAX-package test module's cases against the port.

The cache mesh is host code that both packages hold in identical copies,
so its tests are the same tests: :func:`load_twin` reads
``tests/<name>.py``, points every ``radixmesh_tpu`` import at
``radixmesh_tpu_torch`` and runs the module's source in the namespace of
the calling ``test_torch_*.py`` file, which pytest then collects. The
JAX pool, which the mesh only allocates from and frees into, is swapped
for the port's on the CPU. Cases that reach a model or the JAX engine are
named in ``drop`` and get a hand-written twin beside the loader call.
The port's metric registry and flight recorder are process-global as the
JAX package's are, so each twinned test gets fresh ones, as
``conftest.py`` gives the JAX package's.
"""

from __future__ import annotations

import contextlib
import re
from pathlib import Path

import pytest

from radixmesh_tpu_torch.cache.kv_pool import PagedKVPool
from radixmesh_tpu_torch.obs import metrics, trace_plane

TESTS = Path(__file__).resolve().parent

__all__ = ["CpuPagedKVPool", "fresh_jax_globals", "fresh_port_globals", "load_twin", "missing_artifact_fields"]


def CpuPagedKVPool(*args, **kwargs) -> PagedKVPool:
    """The port's pool, on the CPU unless a device is named."""
    kwargs.setdefault("device", "cpu")
    return PagedKVPool(*args, **kwargs)


@contextlib.contextmanager
def fresh_port_globals():
    """A fresh port metric registry and flight recorder for the block (a
    module-scoped fixture's, say), the old ones put back after it."""
    old_reg, old_rec = metrics.get_registry(), trace_plane.get_recorder()
    metrics.set_registry(metrics.Registry())
    trace_plane.set_recorder(trace_plane.FlightRecorder())
    try:
        yield
    finally:
        metrics.set_registry(old_reg)
        trace_plane.set_recorder(old_rec)


@contextlib.contextmanager
def fresh_jax_globals():
    """The same for the JAX package's registry and recorder: a JAX scenario
    run in a module-scoped fixture runs before ``conftest.py``'s per-test
    fresh ones, on whatever earlier modules of the worker left behind."""
    from radixmesh_tpu.obs import metrics as jmetrics
    from radixmesh_tpu.obs import trace_plane as jtrace

    old_reg, old_rec = jmetrics.get_registry(), jtrace.get_recorder()
    jmetrics.set_registry(jmetrics.Registry())
    jtrace.set_recorder(jtrace.FlightRecorder())
    try:
        yield
    finally:
        jmetrics.set_registry(old_reg)
        jtrace.set_recorder(old_rec)


@pytest.fixture(autouse=True)
def _fresh_port_registry_and_recorder():
    with fresh_port_globals():
        yield


def load_twin(name: str, namespace: dict, *, drop: tuple[str, ...] = (),
              subs: tuple[tuple[str, str], ...] = ()) -> None:
    """Define ``tests/<name>.py``'s tests in ``namespace`` against the port.

    ``drop`` names top-level test functions or classes (``"TestX"``) or
    single methods (``"TestX.test_y"``) not to twin; ``subs`` are literal
    source replacements, applied first."""
    path = TESTS / f"{name}.py"
    src = path.read_text()
    for old, new in subs:
        if old not in src:
            raise ValueError(f"{name}: substitution target not found: {old!r}")
        src = src.replace(old, new)
    src = src.replace(
        "from radixmesh_tpu.cache.kv_pool import PagedKVPool",
        "from _torch_twin import CpuPagedKVPool as PagedKVPool",
    )
    src = re.sub(r"\bradixmesh_tpu\b", "radixmesh_tpu_torch", src)
    namespace["_fresh_port_registry_and_recorder"] = _fresh_port_registry_and_recorder
    exec(compile(src, str(path), "exec"), namespace)
    for item in drop:
        owner, _, attr = item.partition(".")
        if attr:
            delattr(namespace[owner], attr)
        else:
            del namespace[owner]


def missing_artifact_fields(report: dict, prefix: str, sections: dict[str, str], jax_report: dict) -> list:
    """The fields of the JAX package's artifact schema that a port scenario's
    report lacks: each ``bench.<prefix>_<SECTION>_FIELDS`` in its section, and
    each ``bench.<prefix>_TOP_FIELDS`` entry that the JAX report has
    (``bench.build_*_report`` adds the rest). ``sections`` maps section to
    SECTION; a dotted section (``pathologies.hot_shard``) is a nested one."""
    import functools

    import bench

    missing = [f for f in getattr(bench, f"{prefix}_TOP_FIELDS") if f in jax_report and f not in report]
    for section, const in sections.items():
        sub = functools.reduce(dict.__getitem__, section.split("."), report)
        missing += [f"{section}.{f}" for f in getattr(bench, f"{prefix}_{const}_FIELDS") if f not in sub]
    return missing
