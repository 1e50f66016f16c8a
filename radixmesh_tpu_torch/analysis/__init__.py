"""meshcheck: the AST-based static-analysis plane, over ``radixmesh_tpu_torch``.

The cache layer is a heavily threaded serving mesh whose safety
invariants (send-seam confinement, lifecycle/ownership/heat
single-writers, bounded waits, oplog-kind exhaustiveness) no regex can
hold: a regex cannot see a lock acquired through a helper call, a write
reached through an alias, or a blocking call two frames down a hot
path. This package checks them with real ``ast`` analysis (source only:
it imports nothing it checks and needs no card):

- :mod:`core` — the pluggable framework: :class:`SourceIndex` (one AST
  parse per product file), the :class:`Checker` protocol, per-finding
  ``file:line`` + invariant-id reporting, and the justification-comment
  suppression grammar (``# meshcheck: ok[<invariant-id>] <why>``).
- :mod:`lock_order` — lock-acquisition graph per module (``with``
  nesting, including through one level of intra-module helper calls);
  fails on cycles and on re-entry into a non-reentrant lock.
- :mod:`single_writer` — assignment/call-site analysis for the
  lifecycle-state, shard-ownership, and shard-heat single-writer
  contracts (catches aliased writes and ``setattr``), plus the
  mesh send-seam confinement rule.
- :mod:`hot_path` — intra-package call graph from the serving entry
  points; flags reachable no-timeout ``wait()/join()/get()``,
  ``time.sleep``, and device-sync calls (``torch.cuda.synchronize``,
  stream and event ``.synchronize()``), and carries the tree-wide
  timeout/sleep audits.
- :mod:`wire_kinds` — every oplog kind in ``EXTENSION_KINDS`` /
  ``DATA_KINDS`` has an encode site, a receive branch, and a
  registration, verified structurally.
- :mod:`metrics_vocab` — the ``radixmesh_`` prefix + unit-suffix
  vocabulary, checked at ``counter()/gauge()/histogram()`` call sites.

Run it: ``python -m radixmesh_tpu_torch.meshcheck`` (CI: the whole
plane is one quick-gate test,
``tests/test_torch_analysis.py::test_tree_is_clean``).
"""

from __future__ import annotations

from .core import (
    AnalysisResult,
    Checker,
    Finding,
    SourceIndex,
    Suppression,
    package_root,
    run_checkers,
)
from .guarded_by import GuardedByChecker
from .hot_path import HotPathChecker
from .lock_order import LockOrderChecker
from .metrics_vocab import MetricsVocabChecker
from .protocol import ProtocolChecker
from .single_writer import SingleWriterChecker
from .thread_roots import ThreadRootsChecker, get_thread_map
from .wire_kinds import WireKindsChecker

__all__ = [
    "AnalysisResult",
    "Checker",
    "Finding",
    "SourceIndex",
    "Suppression",
    "package_root",
    "run_checkers",
    "all_checkers",
    "changed_scope",
    "LockOrderChecker",
    "SingleWriterChecker",
    "HotPathChecker",
    "WireKindsChecker",
    "MetricsVocabChecker",
    "ThreadRootsChecker",
    "GuardedByChecker",
    "ProtocolChecker",
    "get_thread_map",
]


def all_checkers() -> list:
    """One fresh instance of every registered checker, default config —
    the set ``python -m radixmesh_tpu_torch.meshcheck`` and the quick
    gate run. Order: the
    thread-root checker runs before guarded-by (both read the shared
    thread map, memoized on the index either way)."""
    return [
        LockOrderChecker(),
        SingleWriterChecker(),
        HotPathChecker(),
        WireKindsChecker(),
        MetricsVocabChecker(),
        ThreadRootsChecker(),
        GuardedByChecker(),
        ProtocolChecker(),
    ]


def changed_scope(index: SourceIndex, changed: list[str]) -> set[str]:
    """The file scope ``meshcheck --changed`` reports on: the
    changed package-relative modules plus every module that (transitively)
    imports one of them — a change can invalidate any finding computed in
    a module that calls into it. Unknown paths are ignored (deleted
    files)."""
    from .callgraph import get_callgraph

    dependents = get_callgraph(index).module_dependents()
    scope: set[str] = set()
    frontier = [rel for rel in changed if rel in index.modules]
    while frontier:
        rel = frontier.pop()
        if rel in scope:
            continue
        scope.add(rel)
        frontier.extend(dependents.get(rel, ()))
    return scope


import functools as _functools


@_functools.lru_cache(maxsize=1)
def tree_index() -> SourceIndex:
    """This package parsed once, cached for the process."""
    return SourceIndex(package_root())


@_functools.lru_cache(maxsize=1)
def check_tree() -> AnalysisResult:
    """The full default plane over this package, cached for the
    process — the quick-gate lint tests (test_torch_mesh_lint /
    test_torch_hotpath_lint / test_torch_metrics_lint /
    test_torch_analysis) all read
    slices of ONE run instead of re-parsing the tree per file. Source
    is assumed immutable within a process (true for tests and the
    CLI); call ``check_tree.cache_clear()`` / ``tree_index.cache_clear()``
    after editing files."""
    return run_checkers(tree_index(), all_checkers())
