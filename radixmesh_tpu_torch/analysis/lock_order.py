"""Lock-order deadlock detection.

Extracts a lock-acquisition graph per module from the ASTs: a node per
lock object the module constructs (``self._lock = threading.Lock()``
attributes per class, plus module-level locks), an edge A→B wherever B
is acquired (``with``) while A is held — INCLUDING through one level of
intra-module helper calls (``with self._b: self._helper()`` where
``_helper`` does ``with self._a:`` yields B→A, the exact shape no grep
can see). Fails on:

- ``lock-order-cycle``: a cycle in the acquisition graph — two threads
  entering the cycle from different edges deadlock (the mesh
  drain-claim race class).
- ``lock-order-reentry``: re-acquisition of a NON-reentrant lock
  (``threading.Lock`` / ``Condition``) while it is already held —
  self-deadlock on the spot. Re-entering an ``RLock`` is legal and
  ignored (the mesh's ``RLock`` does this by design).

Resolution is deliberately name-shaped, not type-inferred: a lock is
identified by ``(module, class, attribute)``. Cross-object acquisitions
(``other._lock``) are out of scope — the repo's discipline is that no
module reaches into another object's lock, which the single-writer and
send-seam checkers enforce from the other direction.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .core import Checker, Finding, SourceIndex, dotted_name, iter_functions

__all__ = ["LockOrderChecker"]

_LOCK_KINDS = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}


def _lock_ctor_kind(value: ast.expr) -> str | None:
    """``threading.Lock()`` / ``Lock()`` / ``threading.Condition(x)`` →
    the lock kind; None for any other initializer."""
    if not isinstance(value, ast.Call):
        return None
    name = dotted_name(value.func)
    if name is None:
        return None
    return _LOCK_KINDS.get(name.rsplit(".", 1)[-1])


@dataclass
class _Edge:
    src: str
    dst: str
    rel: str
    line: int
    via: str | None = None  # helper qualname when the edge crosses a call


@dataclass
class _FuncFacts:
    """Per-function facts from pass 1."""

    direct: list[tuple[str, int]] = field(default_factory=list)  # (lock, line)
    # (held locks at the call site, callee qualname, line)
    calls: list[tuple[tuple[str, ...], str, int]] = field(default_factory=list)


class LockOrderChecker:
    id = "lock-order"
    description = (
        "per-module lock-acquisition graph (with-nesting, one level of "
        "intra-module helper calls) must be acyclic; non-reentrant locks "
        "must never be re-acquired while held"
    )
    invariants = ("lock-order-cycle", "lock-order-reentry")

    def check(self, index: SourceIndex) -> list[Finding]:
        findings: list[Finding] = []
        edges: list[_Edge] = []
        kinds: dict[str, str] = {}  # lock id -> lock/rlock/condition
        for mod in index.iter_modules():
            if mod.tree is None:
                continue
            self._check_module(mod.rel, mod.tree, edges, kinds, findings)

        findings.extend(self._cycles(edges))
        return findings

    # ------------------------------------------------------------------
    # per-module extraction
    # ------------------------------------------------------------------

    def _check_module(self, rel, tree, edges, kinds, findings) -> None:
        # Lock inventory: module-level names + per-class self attributes.
        module_locks: dict[str, str] = {}  # name -> lock id
        class_locks: dict[str, dict[str, str]] = {}  # class -> attr -> id
        for node in tree.body:
            if isinstance(node, ast.Assign):
                kind = _lock_ctor_kind(node.value)
                if kind:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            lid = f"{rel}:{t.id}"
                            module_locks[t.id] = lid
                            kinds[lid] = kind
        for qual, cls, fn in iter_functions(tree):
            if cls is None:
                continue
            for stmt in ast.walk(fn):
                if not isinstance(stmt, ast.Assign):
                    continue
                kind = _lock_ctor_kind(stmt.value)
                if not kind:
                    continue
                for t in stmt.targets:
                    name = dotted_name(t)
                    if name and name.startswith("self.") and name.count(".") == 1:
                        attr = name.split(".", 1)[1]
                        lid = f"{rel}:{cls}.{attr}"
                        class_locks.setdefault(cls, {})[attr] = lid
                        kinds[lid] = kind

        if not module_locks and not class_locks:
            return

        # Pass 1: per-function acquisition facts.
        facts: dict[str, _FuncFacts] = {}
        methods_by_class: dict[str, set[str]] = {}
        module_funcs: set[str] = set()
        for qual, cls, fn in iter_functions(tree):
            if cls is None:
                module_funcs.add(qual)
            else:
                methods_by_class.setdefault(cls, set()).add(fn.name)
        for qual, cls, fn in iter_functions(tree):
            f = facts[qual] = _FuncFacts()
            self._walk(
                fn.body, rel, cls, class_locks, module_locks, kinds,
                methods_by_class, module_funcs, (), f, edges, findings,
            )

        # Pass 2: one level of helper expansion — locks a callee acquires
        # directly are treated as acquired at the call site.
        for qual, f in facts.items():
            for held, callee, line in f.calls:
                callee_facts = facts.get(callee)
                if callee_facts is None:
                    continue
                for lock, _ in callee_facts.direct:
                    self._note_acquire(
                        lock, held, rel, line, kinds, edges, findings,
                        via=callee,
                    )

    def _resolve_lock(self, expr, cls, class_locks, module_locks) -> str | None:
        name = dotted_name(expr)
        if name is None:
            return None
        if name.startswith("self.") and name.count(".") == 1 and cls:
            return class_locks.get(cls, {}).get(name.split(".", 1)[1])
        if "." not in name:
            return module_locks.get(name)
        return None

    def _note_acquire(
        self, lock, held, rel, line, kinds, edges, findings, via=None,
    ) -> None:
        if lock in held:
            if kinds.get(lock) != "rlock":
                where = f" (via helper {via})" if via else ""
                findings.append(Finding(
                    rel, line, "lock-order-reentry",
                    f"non-reentrant lock {lock.split(':', 1)[1]!r} "
                    f"re-acquired while already held{where} — "
                    "self-deadlock",
                ))
            return  # re-entrant hold: no edge either way
        for h in held:
            edges.append(_Edge(h, lock, rel, line, via))

    def _walk(
        self, stmts, rel, cls, class_locks, module_locks, kinds,
        methods_by_class, module_funcs, held, f, edges, findings,
    ) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # a closure body runs later, not under this hold
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                acquired: list[str] = []
                inner_held = held
                for item in stmt.items:
                    lock = self._resolve_lock(
                        item.context_expr, cls, class_locks, module_locks
                    )
                    if lock is None:
                        continue
                    f.direct.append((lock, stmt.lineno))
                    self._note_acquire(
                        lock, inner_held, rel, stmt.lineno, kinds, edges,
                        findings,
                    )
                    if lock not in inner_held:
                        inner_held = inner_held + (lock,)
                        acquired.append(lock)
                self._walk(
                    stmt.body, rel, cls, class_locks, module_locks, kinds,
                    methods_by_class, module_funcs, inner_held, f, edges,
                    findings,
                )
                continue
            # Other compound statements keep the same held set: recurse
            # into their nested blocks, then scan only this statement's
            # OWN expressions for calls (nested blocks carry their own
            # context and are handled by the recursion).
            for blocks in self._nested_blocks(stmt):
                self._walk(
                    blocks, rel, cls, class_locks, module_locks, kinds,
                    methods_by_class, module_funcs, held, f, edges,
                    findings,
                )
            for node in self._own_expressions(stmt):
                if not isinstance(node, ast.Call):
                    continue
                callee = self._resolve_call(
                    node.func, cls, methods_by_class, module_funcs
                )
                if callee is not None:
                    f.calls.append((held, callee, node.lineno))

    @staticmethod
    def _nested_blocks(stmt: ast.stmt):
        """The statement-list children of a compound statement."""
        for name in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, name, None)
            if isinstance(sub, list) and sub and isinstance(sub[0], ast.stmt):
                yield sub
        for h in getattr(stmt, "handlers", []) or []:
            yield h.body
        for case in getattr(stmt, "cases", []) or []:
            yield case.body

    @staticmethod
    def _own_expressions(stmt: ast.stmt):
        """Walk the statement's expression parts without descending into
        nested statement blocks (those recurse separately)."""
        todo: list[ast.AST] = []
        for name, value in ast.iter_fields(stmt):
            if isinstance(value, ast.expr):
                todo.append(value)
            elif isinstance(value, list):
                todo.extend(v for v in value if isinstance(v, ast.expr))
        for expr in todo:
            yield from ast.walk(expr)

    def _resolve_call(
        self, func, cls, methods_by_class, module_funcs,
    ) -> str | None:
        name = dotted_name(func)
        if name is None:
            return None
        if name.startswith("self.") and name.count(".") == 1 and cls:
            m = name.split(".", 1)[1]
            if m in methods_by_class.get(cls, ()):
                return f"{cls}.{m}"
            return None
        if "." not in name and name in module_funcs:
            return name
        return None

    # ------------------------------------------------------------------
    # cycle detection (Tarjan SCC over the global edge set)
    # ------------------------------------------------------------------

    def _cycles(self, edges: list[_Edge]) -> list[Finding]:
        graph: dict[str, set[str]] = {}
        by_pair: dict[tuple[str, str], _Edge] = {}
        for e in edges:
            if e.src == e.dst:
                continue
            graph.setdefault(e.src, set()).add(e.dst)
            graph.setdefault(e.dst, set())
            key = (e.src, e.dst)
            if key not in by_pair or (e.rel, e.line) < (
                by_pair[key].rel, by_pair[key].line
            ):
                by_pair[key] = e

        sccs = _tarjan(graph)
        findings = []
        for scc in sccs:
            if len(scc) < 2:
                continue
            members = sorted(scc)
            cyc_edges = sorted(
                (e for (s, d), e in by_pair.items()
                 if s in scc and d in scc),
                key=lambda e: (e.rel, e.line),
            )
            site = cyc_edges[0]
            detail = "; ".join(
                f"{e.src.split(':', 1)[1]}->{e.dst.split(':', 1)[1]} at "
                f"{e.rel}:{e.line}"
                + (f" (via {e.via})" if e.via else "")
                for e in cyc_edges
            )
            findings.append(Finding(
                site.rel, site.line, "lock-order-cycle",
                f"lock-acquisition cycle {{{', '.join(members)}}}: {detail}",
            ))
        return findings


def _tarjan(graph: dict[str, set[str]]) -> list[set[str]]:
    """Iterative Tarjan strongly-connected components."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    sccs: list[set[str]] = []
    counter = [0]

    for start in sorted(graph):
        if start in index:
            continue
        work = [(start, iter(sorted(graph[start])))]
        index[start] = low[start] = counter[0]
        counter[0] += 1
        stack.append(start)
        on_stack.add(start)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(sorted(graph[nxt]))))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc: set[str] = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.add(w)
                    if w == node:
                        break
                sccs.append(scc)
    return sccs
