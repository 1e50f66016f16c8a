"""Guarded-by race inference: lock-set analysis per class attribute.

RacerD (Blackshear et al., OOPSLA 2018) showed data races are findable
WITHOUT annotations by computing, per field access, the set of locks
held, then letting the codebase's own majority usage declare the
guarding lock (Engler et al., SOSP 2001: a convention most sites follow
is a contract the deviant sites break). This checker is that idea at
meshcheck scale:

1. **Lock sets.** For every ``self._x`` access in a class that owns at
   least one lock, compute the locks held — ``with self._lock:``
   nesting, composed through intra-class helper calls with the same
   name-shaped resolution as ``lock_order.py``'s acquisition graph:
   each call edge carries the caller's held set one level into the
   callee, and a private helper's AMBIENT set is the intersection of
   its callers' effective sets (a fixpoint, so lock-then-three-helpers
   chains stay guarded while any single off-lock path degrades the
   intersection to unguarded — RacerD's compositional summary rule).
   Entry frames (public methods, thread targets, helpers nobody calls)
   have an empty ambient set: their callers are other threads. Closure
   bodies are skipped during the normal walk — EXCEPT closures the
   method hands to ``threading.Thread``/``Timer`` (the hedge-leg
   shape), whose bodies are re-walked with an EMPTY held set: they run
   on the spawned thread, not under the spawning frame's locks, so an
   off-lock write inside one is exactly as racy as any other.
2. **Guard inference.** The guard of an attribute is the lock held at
   the MAJORITY of its write sites (all sites when there is only one
   write) — inferred, never annotated. No majority → no contract → no
   finding: deliberately unsynchronized single-thread state stays
   quiet.
3. **Concurrency gate.** A deviant access is only a race if the thread
   map (``thread_roots.py``) says it can actually run concurrently with
   a conflicting guarded access: the two sites' thread-root sets span
   two distinct roots, or share a multi-instance root (HTTP handlers,
   per-peer readers). Single-root state — engine-thread-only fields —
   never fires. A public method no spawned root reaches still runs on
   SOMEBODY's thread (``close()`` on the exit path, ``drain()`` from a
   signal handler — the close-vs-rejoin race class), so it gets a
   synthetic per-method ``caller:`` root, inherited by the private
   helpers only it reaches; two different public entry points are
   assumed concurrently callable, one is not.

Invariants:

- ``guarded-by-race`` — a WRITE without the inferred guard that can run
  concurrently with a guarded access (write-write / lost-update), or a
  guard-free READ deviating from an otherwise-unanimous guard
  convention while a guarded write can run concurrently (read-write:
  torn/stale read). The finding names the attribute, the inferred
  guard, the guard's site coverage, both ``file:line`` sites, and the
  thread roots on each side.

Reads get the stricter unanimity bar on purpose: CPython's GIL makes
single-reference reads atomic, so the lock-free-read idiom (volatile
snapshot, re-checked fast path) is pervasive and LEGAL here — a read is
only deviant when every other access agrees on the guard. Writes get
the plain majority bar: an off-lock write to majority-guarded state is
how the drain-claim and close-vs-rejoin races happened.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .callgraph import get_callgraph
from .core import Checker, Finding, SourceIndex, dotted_name, iter_functions
from .lock_order import LockOrderChecker, _lock_ctor_kind
from .thread_roots import get_thread_map

__all__ = ["GuardedByChecker", "MUTATORS"]

# Method calls on an attribute that mutate the underlying container —
# a ``self._q.append(...)`` is a write to ``_q``'s state even though the
# attribute binding itself is only loaded.
MUTATORS = frozenset((
    "append", "appendleft", "extend", "extendleft", "insert",
    "pop", "popleft", "popitem", "remove", "discard", "clear",
    "add", "update", "setdefault", "difference_update",
    "intersection_update", "symmetric_difference_update",
    "put", "put_nowait", "sort", "reverse",
))

# Constructors whose product is internally synchronized (or is itself a
# lock): accesses to these attributes are exempt — calling .set() on an
# Event or .put_nowait() on a Queue is safe from any thread.
_THREADSAFE_CTORS = frozenset((
    "Lock", "RLock", "Condition", "Event", "Semaphore",
    "BoundedSemaphore", "Barrier", "Queue", "LifoQueue",
    "PriorityQueue", "SimpleQueue", "local",
))

# Registration/handle factories: metric families and logger handles are
# internally locked (obs/metrics.py) — a value built through any of
# these is exempt like the ctors above.
_HANDLE_CALLS = frozenset((
    "counter", "gauge", "histogram", "labels",
    "get_logger", "get_recorder", "get_registry",
))


def _threadsafe_value(value: ast.expr) -> bool:
    for node in ast.walk(value):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        if name is None:
            continue
        last = name.split(".")[-1]
        if last in _THREADSAFE_CTORS or last in _HANDLE_CALLS:
            return True
    return False


@dataclass(frozen=True)
class _Access:
    attr: str
    kind: str  # "read" | "write"
    line: int
    held: frozenset


@dataclass
class _MethodFacts:
    accesses: list[_Access] = field(default_factory=list)
    # (held at call site, callee method name, line)
    calls: list[tuple[frozenset, str, int]] = field(default_factory=list)


@dataclass(frozen=True)
class _Instance:
    """One access in one calling context."""

    attr: str
    kind: str
    line: int
    held: frozenset
    frame: str  # method qual whose roots attribute this instance


class GuardedByChecker:
    id = "guarded-by"
    description = (
        "per-attribute lock-set inference (with-nesting, composed "
        "through intra-class helper chains): the majority-usage guard "
        "is a contract; an off-guard write — or a read deviating from "
        "a unanimous convention — that two thread roots can run "
        "concurrently is a race"
    )
    invariants = ("guarded-by-race",)

    # Majority bar for write-site guard inference.
    WRITE_MAJORITY = 0.5

    def check(self, index: SourceIndex) -> list[Finding]:
        cg = get_callgraph(index)
        tmap = get_thread_map(index)
        root_targets = {r.key for r in tmap.roots if r.key is not None}
        findings: list[Finding] = []
        for mod in index.iter_modules():
            if mod.tree is None or mod.rel.startswith("analysis/"):
                continue
            for node in mod.tree.body:
                if isinstance(node, ast.ClassDef):
                    self._check_class(
                        mod.rel, node, cg, tmap, root_targets, findings
                    )
        return findings

    # ------------------------------------------------------------------
    # per-class analysis
    # ------------------------------------------------------------------

    def _check_class(self, rel, cls_node, cg, tmap, root_targets, findings):
        locks: set[str] = set()
        exempt: set[str] = set()
        methods = {
            n.name: n for n in cls_node.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        for fn in methods.values():
            for stmt in ast.walk(fn):
                if not isinstance(stmt, ast.Assign):
                    continue
                for t in stmt.targets:
                    name = dotted_name(t)
                    if not (name and name.startswith("self.") and name.count(".") == 1):
                        continue
                    attr = name.split(".", 1)[1]
                    if _lock_ctor_kind(stmt.value):
                        locks.add(attr)
                    elif _threadsafe_value(stmt.value):
                        exempt.add(attr)
        if not locks:
            return  # no lock, no inferable contract

        facts: dict[str, _MethodFacts] = {}
        for name, fn in methods.items():
            f = facts[name] = _MethodFacts()
            self._walk(fn.body, locks, frozenset(), methods, f)
            # Closures handed to Thread/Timer run on the SPAWNED thread:
            # re-walk their bodies with no held locks (the normal walk
            # skips nested defs; inline-called closures stay skipped —
            # they run under the caller's locks and attributing an empty
            # held set to them would be a false positive factory).
            for sub in self._spawned_closures(fn):
                self._walk(sub.body, locks, frozenset(), methods, f)

        internal_callers: dict[str, set[str]] = {}
        for caller, f in facts.items():
            if caller == "__init__":
                continue  # construction happens-before publication
            for _, callee, _ in f.calls:
                internal_callers.setdefault(callee, set()).add(caller)

        # Ambient lock sets (the compositional fixpoint): a method that
        # is an ENTRY frame — public, a thread target, or called by
        # nobody in the class — runs with no inherited locks; a private
        # helper inherits the INTERSECTION over its call sites of
        # (caller's ambient ∪ locks held at the site). Monotone
        # decreasing from "all locks", so recursion converges.
        ambient: dict[str, frozenset] = {}
        all_locks = frozenset(locks)
        for name in facts:
            qual = f"{cls_node.name}.{name}"
            entry = (
                not name.startswith("_")
                or not internal_callers.get(name)
                or (rel, qual) in root_targets
            )
            ambient[name] = frozenset() if entry else all_locks
        changed = True
        while changed:
            changed = False
            for caller, f in facts.items():
                if caller == "__init__":
                    continue
                for held, callee, _line in f.calls:
                    if callee not in ambient or ambient[callee] == frozenset():
                        continue
                    eff = ambient[callee] & (ambient[caller] | held)
                    if eff != ambient[callee]:
                        ambient[callee] = eff
                        changed = True

        instances: dict[str, list[_Instance]] = {}
        for name, f in facts.items():
            if name == "__init__":
                continue
            qual = f"{cls_node.name}.{name}"
            for a in f.accesses:
                instances.setdefault(a.attr, []).append(
                    _Instance(a.attr, a.kind, a.line, a.held | ambient[name], qual)
                )

        # Per-frame thread roots: the spawned/declared roots that reach
        # the frame, else — for frames only a public caller can enter —
        # a synthetic caller: root per public entry method, propagated
        # to the private helpers it reaches intra-class.
        caller_roots: dict[str, set[str]] = {n: set() for n in facts}
        for name in facts:
            if name == "__init__" or name.startswith("_"):
                continue
            reach = {name}
            frontier = [name]
            while frontier:
                cf = facts.get(frontier.pop())
                if cf is None:
                    continue
                for _, callee, _ in cf.calls:
                    if callee in facts and callee not in reach:
                        reach.add(callee)
                        frontier.append(callee)
            for m in reach:
                caller_roots[m].add(f"caller:{cls_node.name}.{name}")
        frame_roots: dict[str, tuple[str, ...]] = {}
        for name in facts:
            qual = f"{cls_node.name}.{name}"
            real = tmap.roots_of((rel, qual))
            frame_roots[qual] = real or tuple(sorted(caller_roots[name]))

        for attr, insts in sorted(instances.items()):
            if attr in locks or attr in exempt:
                continue
            self._check_attr(
                rel, cls_node.name, attr, insts, tmap, frame_roots, findings
            )

    @staticmethod
    def _spawned_closures(fn):
        """Nested defs inside ``fn`` that are handed to a Thread/Timer
        as targets (name-matched within the same function)."""
        from .thread_roots import _spawn_kind, _target_expr

        targets: set[str] = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            kind = _spawn_kind(node)
            if kind is None:
                continue
            t = _target_expr(node, kind)
            if isinstance(t, ast.Name):
                targets.add(t.id)
        if not targets:
            return
        for node in ast.walk(fn):
            if (
                isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node is not fn
                and node.name in targets
            ):
                yield node

    # ------------------------------------------------------------------
    # statement walk: held-lock tracking (the lock_order discipline)
    # ------------------------------------------------------------------

    def _walk(self, stmts, locks, held, methods, f: _MethodFacts) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # a closure runs on another thread, not under held
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = held
                for item in stmt.items:
                    lock = self._self_lock(item.context_expr, locks)
                    if lock is not None:
                        inner = inner | {lock}
                # The with-items' own expressions still run under the
                # OUTER held set (the lock acquisition itself).
                for item in stmt.items:
                    self._scan_expr(item.context_expr, locks, held, methods, f)
                self._walk(stmt.body, locks, inner, methods, f)
                continue
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    self._scan_store(t, locks, held, methods, f)
                self._scan_expr(stmt.value, locks, held, methods, f)
                continue
            if isinstance(stmt, ast.AugAssign):
                self._scan_store(stmt.target, locks, held, methods, f, aug=True)
                self._scan_expr(stmt.value, locks, held, methods, f)
                continue
            if isinstance(stmt, ast.AnnAssign):
                if stmt.value is not None:
                    self._scan_store(stmt.target, locks, held, methods, f)
                    self._scan_expr(stmt.value, locks, held, methods, f)
                continue
            if isinstance(stmt, ast.Delete):
                for t in stmt.targets:
                    self._scan_store(t, locks, held, methods, f)
                continue
            for blocks in LockOrderChecker._nested_blocks(stmt):
                self._walk(blocks, locks, held, methods, f)
            for expr in self._own_exprs(stmt):
                self._scan_expr(expr, locks, held, methods, f)

    @staticmethod
    def _own_exprs(stmt):
        for _name, value in ast.iter_fields(stmt):
            if isinstance(value, ast.expr):
                yield value
            elif isinstance(value, list):
                yield from (v for v in value if isinstance(v, ast.expr))

    @staticmethod
    def _self_attr(node) -> str | None:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return node.attr
        return None

    def _self_lock(self, expr, locks) -> str | None:
        attr = self._self_attr(expr)
        return attr if attr in locks else None

    def _scan_store(self, target, locks, held, methods, f, aug=False) -> None:
        attr = self._self_attr(target)
        if attr is not None:
            f.accesses.append(_Access(attr, "write", target.lineno, held))
            return
        if isinstance(target, ast.Subscript):
            attr = self._self_attr(target.value)
            if attr is not None:
                f.accesses.append(_Access(attr, "write", target.lineno, held))
            else:
                self._scan_expr(target.value, locks, held, methods, f)
            self._scan_expr(target.slice, locks, held, methods, f)
            return
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._scan_store(elt, locks, held, methods, f)
            return
        if isinstance(target, (ast.Attribute, ast.Starred)):
            self._scan_expr(target, locks, held, methods, f)

    def _scan_expr(self, expr, locks, held, methods, f) -> None:
        if expr is None:
            return
        mutated: set[ast.AST] = set()
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                # self._m(...) — intra-class helper call (one level).
                if isinstance(node.func, ast.Attribute):
                    base = self._self_attr(node.func)
                    if base is not None and base in methods:
                        f.calls.append((held, base, node.lineno))
                        continue
                    # self._q.append(...) — container mutation.
                    inner = self._self_attr(node.func.value)
                    if inner is not None and node.func.attr in MUTATORS:
                        mutated.add(node.func.value)
        for node in ast.walk(expr):
            attr = self._self_attr(node)
            if attr is None or attr in locks:
                continue
            kind = "write" if node in mutated else "read"
            f.accesses.append(_Access(attr, kind, node.lineno, held))

    # ------------------------------------------------------------------
    # per-attribute verdict
    # ------------------------------------------------------------------

    def _check_attr(self, rel, cls, attr, insts, tmap, frame_roots, findings) -> None:
        writes = [i for i in insts if i.kind == "write"]
        if not writes:
            return  # read-only after construction: no race possible

        def roots(i: _Instance):
            return frame_roots.get(i.frame, ())

        # Guard inference: majority over write sites (all sites when
        # only one write exists — one guarded write among consistently
        # guarded reads is still a convention).
        basis = writes if len(writes) >= 2 else insts
        counts: dict[str, int] = {}
        for i in basis:
            for lock in i.held:
                counts[lock] = counts.get(lock, 0) + 1
        if not counts:
            return  # nothing ever guarded: no contract to deviate from
        guard, n_guard = max(counts.items(), key=lambda kv: (kv[1], kv[0]))
        if n_guard < 2 or n_guard / len(basis) <= self.WRITE_MAJORITY:
            return
        guarded = [i for i in insts if guard in i.held]
        coverage = f"{len(guarded)}/{len(insts)}"

        seen: set[tuple[int, str]] = set()
        for u in insts:
            if guard in u.held:
                continue
            key = (u.line, u.kind)
            if key in seen:
                continue
            if u.kind == "read":
                # Unanimity bar: every OTHER access must hold the guard
                # (the lock-free-read idiom is legal unless the class's
                # own convention says otherwise).
                others = [i for i in insts if i.line != u.line]
                if not others or any(guard not in i.held for i in others):
                    continue
                conflicting = [i for i in guarded if i.kind == "write"]
            else:
                conflicting = guarded
            hit = next(
                (v for v in conflicting
                 if tmap.concurrent(roots(u), roots(v))),
                None,
            )
            if hit is None:
                continue
            seen.add(key)
            pair = (
                "write-write" if u.kind == "write" and hit.kind == "write"
                else "read-write"
            )
            findings.append(Finding(
                rel, u.line, "guarded-by-race",
                f"{cls}.{attr}: {u.kind} without the inferred guard "
                f"'{guard}' (held at {coverage} access sites) — "
                f"{pair} race with the guarded {hit.kind} at "
                f"{rel}:{hit.line}; this side runs on thread root(s) "
                f"{list(roots(u))}, that side on {list(roots(hit))}",
            ))
