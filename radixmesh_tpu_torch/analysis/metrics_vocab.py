"""Metric vocabulary, checked at registration call sites.

Every family the serving stack registers must be ``radixmesh_``-prefixed
(one grep finds the fleet's series; no collision with other exporters on
a shared scrape) and unit-suffixed so dashboards never guess units. The
runtime lint (``tests/test_metrics_lint.py``) walks what actually landed
in the registry; this checker reads the same rules off the AST at every
``counter()/gauge()/histogram()`` call site, so a family registered only
on a code path no lint test constructs is still checked.

Invariants:

- ``metrics-prefix`` — family name missing the ``radixmesh_`` prefix.
- ``metrics-unit`` — counter without ``_total``; histogram without a
  base unit (``_seconds``/``_bytes``/``_tokens``); gauge without a
  declared unit from :data:`GAUGE_SUFFIXES` (a new suffix is a
  conscious vocabulary decision made HERE, not a typo that slips
  through).
- ``metrics-literal`` — the family name is not a string literal; a
  computed name can't be vocabulary-checked statically and breaks the
  one-grep-finds-everything property.
- ``metrics-dead`` — a family is registered but never emitted: no
  ``.set()/.inc()/.dec()/.observe()`` anywhere in the tree flows from
  any of its registration handles. A registered-but-silent family is a
  dashboard lying by omission (the heat-gauge clearing bug class:
  a series everyone believed was live had quietly stopped being
  written). Handle flow is tracked through assignment aliases,
  ``.labels()`` chains, dict/comprehension fan-outs, and literal
  ``getattr(x, "_m_foo")`` indirection, per module, with emit sites
  counted tree-wide.

The suffix vocabulary lives here as the single source of truth; the
runtime lint imports it.
"""

from __future__ import annotations

import ast

from .core import Checker, Finding, SourceIndex, dotted_name

__all__ = ["MetricsVocabChecker", "UNIT_SUFFIXES", "GAUGE_SUFFIXES", "PREFIX"]

PREFIX = "radixmesh_"

# Base units (counters are ``_total``; histograms observe seconds/bytes/
# tokens). Gauges may additionally be counts of a named thing or one of
# the declared dimensionless states.
UNIT_SUFFIXES = ("_seconds", "_bytes", "_total", "_tokens")
GAUGE_SUFFIXES = UNIT_SUFFIXES + (
    "_requests", "_slots", "_nodes", "_rows",
    "_epoch", "_rank", "_flag", "_tier", "_tokens_per_second",
    "_state",  # lifecycle state code (policy/lifecycle.py)
    "_shards",  # owned-shard count (cache/sharding.py)
    "_bytes_per_insert",  # per-insert wire-cost EWMA (cache/sharding.py)
    "_ratio",  # dimensionless max/mean skew (the shard heat map)
    "_mfu",  # model-FLOPs-utilization estimate (obs/step_plane.py)
    "_fraction",  # 0..1 share, e.g. wave padding (obs/step_plane.py)
    "_series",  # telemetry-history ring count (obs/timeseries.py)
    "_points",  # telemetry-history retained points (obs/timeseries.py)
    "_rf_boost",  # extra owners beyond the base walk (cache/rebalance.py)
    "_extents",  # committed durable-tier extent files (cache/kv_tier.py)
    "_peers",  # fleet-aggregator polled peer count (obs/aggregator.py)
    "_waves",  # consecutive decode-deferred wave count (engine/waves.py)
)

_KINDS = ("counter", "gauge", "histogram")

# The metrics framework itself (defines the factories) is exempt.
_FRAMEWORK = "obs/metrics.py"


class MetricsVocabChecker:
    id = "metrics-vocab"
    description = (
        "metric families are radixmesh_-prefixed and unit-suffixed, "
        "checked statically at every counter()/gauge()/histogram() "
        "registration call site"
    )
    invariants = (
        "metrics-prefix", "metrics-unit", "metrics-literal", "metrics-dead",
    )

    def check(self, index: SourceIndex) -> list[Finding]:
        findings: list[Finding] = []
        # family name -> first registration site (for the dead finding)
        registered: dict[str, tuple[str, int]] = {}
        for mod in index.iter_modules():
            if (
                mod.tree is None
                or mod.rel == _FRAMEWORK
                or mod.rel.startswith("analysis/")
            ):
                continue
            for node in ast.walk(mod.tree):
                if not (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _KINDS
                ):
                    continue
                kind = node.func.attr
                # The family name is the first positional or the
                # ``name=`` keyword — a keyword-form registration must
                # not silently bypass the vocabulary.
                if node.args:
                    name_arg = node.args[0]
                else:
                    name_arg = next(
                        (k.value for k in node.keywords if k.arg == "name"),
                        None,
                    )
                    if name_arg is None:
                        continue  # no name argument: not a registration
                if not (
                    isinstance(name_arg, ast.Constant)
                    and isinstance(name_arg.value, str)
                ):
                    findings.append(Finding(
                        mod.rel, node.lineno, "metrics-literal",
                        f"{kind}() family name is not a string literal — "
                        "computed names defeat static vocabulary checks "
                        "and fleet-wide grep",
                    ))
                    continue
                name = name_arg.value
                registered.setdefault(name, (mod.rel, node.lineno))
                if not name.startswith(PREFIX):
                    findings.append(Finding(
                        mod.rel, node.lineno, "metrics-prefix",
                        f"{name!r}: missing the {PREFIX!r} prefix",
                    ))
                    continue
                if kind == "counter" and not name.endswith("_total"):
                    findings.append(Finding(
                        mod.rel, node.lineno, "metrics-unit",
                        f"{name!r}: counter without _total",
                    ))
                elif kind == "histogram" and not name.endswith(
                    ("_seconds", "_bytes", "_tokens")
                ):
                    findings.append(Finding(
                        mod.rel, node.lineno, "metrics-unit",
                        f"{name!r}: histogram without a base unit suffix",
                    ))
                elif kind == "gauge" and not name.endswith(GAUGE_SUFFIXES):
                    findings.append(Finding(
                        mod.rel, node.lineno, "metrics-unit",
                        f"{name!r}: gauge without a declared unit (extend "
                        "GAUGE_SUFFIXES in analysis/metrics_vocab.py if "
                        "this is a conscious vocabulary addition)",
                    ))

        emitted = self._emitted_families(index)
        for name, (rel, line) in sorted(registered.items()):
            if name not in emitted:
                findings.append(Finding(
                    rel, line, "metrics-dead",
                    f"{name!r} is registered but never "
                    ".set()/.inc()/.dec()/.observe()d anywhere in the "
                    "tree — a silent series reads as 'zero activity' on "
                    "every dashboard; emit it or delete the family",
                ))
        return findings

    # ------------------------------------------------------------------
    # dead-family flow analysis
    # ------------------------------------------------------------------

    _EMIT_VERBS = ("set", "inc", "dec", "observe")

    def _emitted_families(self, index: SourceIndex) -> set[str]:
        """Family names with at least one emit site. Taint is scoped
        PER MODULE — two unrelated modules both naming a handle
        ``self._m`` must not alias each other's families (a dead family
        would hide behind a live one's emit) — with two deliberate
        cross-module edges: a bare name follows the module's explicit
        imports (a handle FACTORY like ``eviction_counters`` taints its
        own name where it is defined, and callers reach it through the
        import), and a literal ``getattr(x, "_m_foo")`` resolves
        against the tree-wide attribute taint (getattr IS the explicit
        cross-module indirection)."""
        from .callgraph import get_callgraph

        imports = get_callgraph(index).imports
        taint: dict[tuple[str, str], set[str]] = {}  # (module, name) -> fams
        attr_global: dict[str, set[str]] = {}  # attr name -> fams (getattr only)
        # Worklist of (module, target (name, is_attr) pairs, value expr):
        # plain assignments, for-loop targets (iterating a dict of
        # handles), and function returns.
        pending: list[tuple[str, list[tuple[str, bool]], ast.expr]] = []
        for mod in index.iter_modules():
            if mod.tree is None or mod.rel.startswith("analysis/"):
                continue
            for node in ast.walk(mod.tree):
                if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                    if getattr(node, "value", None) is None:
                        continue
                    targets = (
                        node.targets if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    pending.append(
                        (mod.rel, self._target_names(targets), node.value)
                    )
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    pending.append(
                        (mod.rel, self._target_names([node.target]), node.iter)
                    )
                elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    for sub in ast.walk(node):
                        if isinstance(sub, ast.Return) and sub.value is not None:
                            pending.append(
                                (mod.rel, [(node.name, False)], sub.value)
                            )
        changed = True
        while changed:
            changed = False
            for rel, names, value in pending:
                if not names:
                    continue
                fams = self._value_families(value, rel, taint, attr_global, imports)
                if not fams:
                    continue
                for base, is_attr in names:
                    cur = taint.setdefault((rel, base), set())
                    if not fams <= cur:
                        cur |= fams
                        changed = True
                    if is_attr:
                        gcur = attr_global.setdefault(base, set())
                        if not fams <= gcur:
                            gcur |= fams
                            changed = True

        emitted: set[str] = set()
        for mod in index.iter_modules():
            if mod.tree is None or mod.rel.startswith("analysis/"):
                continue
            for node in ast.walk(mod.tree):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self._EMIT_VERBS
                ):
                    emitted |= self._value_families(
                        node.func.value, mod.rel, taint, attr_global, imports
                    )
        return emitted

    def _value_families(self, value, rel, taint, attr_global, imports) -> set[str]:
        """Families flowing through ``value`` in module ``rel``: literal
        registration calls, ``getattr(x, "_m_foo")`` with a literal
        attr (tree-wide attribute taint), and loads of tainted names —
        bare names fall back through the module's imports (through
        .labels() chains, subscripts, comprehensions; ast.walk sees
        them all)."""
        out: set[str] = set()
        imap = imports.get(rel, {})
        for node in ast.walk(value):
            if isinstance(node, ast.Call):
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _KINDS
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                ):
                    out.add(node.args[0].value)
                elif (
                    isinstance(node.func, ast.Name)
                    and node.func.id == "getattr"
                    and len(node.args) >= 2
                    and isinstance(node.args[1], ast.Constant)
                    and isinstance(node.args[1].value, str)
                ):
                    out |= attr_global.get(node.args[1].value, set())
            elif isinstance(node, ast.Name):
                hit = taint.get((rel, node.id))
                if hit is None and node.id in imap:
                    hit = taint.get((imap[node.id], node.id))
                out |= hit or set()
            elif isinstance(node, ast.Attribute):
                out |= taint.get((rel, node.attr), set())
        return out

    def _target_names(self, targets) -> list[tuple[str, bool]]:
        out: list[tuple[str, bool]] = []
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                out.extend(self._target_names(t.elts))
            else:
                base = self._base_name(t)
                if base is not None:
                    out.append((base, not isinstance(t, ast.Name)))
        return out

    @staticmethod
    def _base_name(expr: ast.expr) -> str | None:
        """The name a handle chain hangs off: ``self._m_x[k].labels(y)``
        → ``_m_x``; plain ``x`` → ``x``."""
        while True:
            if isinstance(expr, ast.Call):
                if isinstance(expr.func, ast.Attribute):
                    expr = expr.func.value
                    continue
                return None
            if isinstance(expr, ast.Subscript):
                expr = expr.value
                continue
            if isinstance(expr, ast.Attribute):
                return expr.attr
            if isinstance(expr, ast.Name):
                return expr.id
            return None
