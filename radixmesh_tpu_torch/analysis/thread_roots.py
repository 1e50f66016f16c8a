"""Tree-wide thread map: which functions can run concurrently with which.

The mesh runs on ~20 long-lived threads (ring sender loops,
``_owner_sender``, the repair scanner, the kv-transfer worker, the
lifecycle housekeeper, the recovery watcher, per-connection HTTP
handlers, the engine step loop) plus short-lived drain/hedge threads.
Every concurrency checker needs the same fact no single module can
state: *from which thread does this function run?* This module derives
it once per index:

- **Spawn discovery** — every ``threading.Thread(target=...)`` and
  ``threading.Timer(..., fn)`` call site, with the target resolved
  through the shared call graph (``self._run`` methods, module
  functions, constructor-typed attributes). A target that is a nested
  ``def`` (the recovery plane's hedge legs) maps to its ENCLOSING
  function — ``ast.walk`` already folds closure bodies into the
  enclosing frame's call edges, so reachability composes. A target on a
  known class with no in-package body (``self._server.serve_forever``)
  is an *external* root: real concurrency, no package-side frames —
  the handler-class rule below carries its in-package half.
- **HTTP handlers** — any class (module-level or nested) whose base
  names ``BaseHTTPRequestHandler``: each ``do_*`` method is a root, and
  the root is *multi* (``ThreadingHTTPServer`` runs one thread per
  connection, so a handler races with itself).
- **Declared roots** (:data:`DECLARED_ROOTS`) — call-graph seams the
  name-shaped resolver cannot cross (transport read callbacks into
  ``MeshCache.oplog_received``, runner-owned ``Engine.step``, the
  submit-side entry points). Pinned exactly like
  ``hot_path.DEFAULT_ENTRY_POINTS``; missing entries are skipped so the
  map builds unmodified over fixture trees.

A root is **multi** when more than one instance of it can be live at
once: spawned in a loop, spawned at ≥2 sites, an HTTP handler, or a
declared multi seam. Multi matters to the race checker: a single-
instance root cannot race with itself, but two connection handlers can.

Checker invariants (the map must stay COMPLETE to mean anything):

- ``thread-target-unresolved`` — a ``Thread``/``Timer`` target the map
  cannot resolve (lambda, computed callable, ``functools.partial``):
  every function it runs escapes the concurrency plane, so every
  guarded-by verdict downstream of it is unsound. Name a real function
  or justify in-source.
- ``thread-daemonless`` — a spawn without ``daemon=True``: a non-daemon
  thread that outlives ``close()`` wedges interpreter shutdown (the
  housekeeper bug class). Justify the rare thread that must survive.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .callgraph import CallGraph, get_callgraph
from .core import Checker, Finding, SourceIndex, dotted_name, iter_functions

__all__ = [
    "ThreadRoot",
    "ThreadMap",
    "ThreadRootsChecker",
    "DECLARED_ROOTS",
    "get_thread_map",
]

# (module, qualname, root name, multi) — concurrency entry points behind
# callback seams the name-shaped call graph cannot cross. The wire
# receive path runs on one transport reader thread PER PEER (multi), the
# engine step loop is the single runner thread, submits arrive on
# arbitrary caller/handler threads (multi).
DECLARED_ROOTS: tuple[tuple[str, str, str, bool], ...] = (
    ("cache/mesh_cache.py", "MeshCache.oplog_received", "wire-receive", True),
    ("engine/engine.py", "Engine.step", "engine-loop", False),
    ("engine/engine.py", "Engine.enqueue", "submit", True),
    ("slo/control.py", "OverloadController.enqueue", "slo-submit", True),
    ("engine/disagg.py", "DecodeWorker.submit", "disagg-submit", True),
    ("engine/disagg.py", "DecodeWorker.step", "disagg-loop", False),
    ("server/recovery.py", "RecoveryCoordinator.run_to_completion",
     "recovery-edge", True),
    # The port's own seams. A pool-bound mesh replica on the leader of a
    # multi-rank engine frees slots through ``MeshPoolProxy.free`` from
    # its apply and GC threads (the mesh holds the proxy as its pool).
    # The KV plane's handoff lane runs ``PrefillWorker``'s ``_ship``
    # closures on the plane's worker (``submit_task``), one at a time.
    # The plane's other lanes run on that worker's own spawned root; the
    # step agreement (parallel/step_sync.py) runs on the engine loop; tp,
    # sp and pp ranks are processes, each with its own engine loop.
    ("parallel/step_sync.py", "MeshPoolProxy.free", "mesh-pool-free", True),
    ("engine/disagg.py", "PrefillWorker.prefill_handoff_stream",
     "kv-handoff-lane", False),
)


@dataclass(frozen=True)
class ThreadRoot:
    """One concurrency entry point."""

    name: str  # display name: thread name= literal, else target qual
    key: tuple[str, str] | None  # (rel, qual) start frame; None=external
    spawn_rel: str
    spawn_line: int
    multi: bool  # >1 instance can be live at once
    kind: str  # "spawn" | "timer" | "handler" | "declared" | "external"

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "target": None if self.key is None else f"{self.key[0]}:{self.key[1]}",
            "file": self.spawn_rel,
            "line": self.spawn_line,
            "multi": self.multi,
            "kind": self.kind,
        }


@dataclass
class ThreadMap:
    """The derived map: roots plus per-root reachable function sets."""

    roots: list[ThreadRoot] = field(default_factory=list)
    # function key -> tuple of root names that can be running it
    _roots_of: dict[tuple[str, str], tuple[str, ...]] = field(default_factory=dict)
    _multi: dict[str, bool] = field(default_factory=dict)
    # root name -> call chain per reachable function (finding messages)
    chains: dict[str, dict[tuple[str, str], tuple[str, ...]]] = field(
        default_factory=dict
    )

    def roots_of(self, key: tuple[str, str]) -> tuple[str, ...]:
        return self._roots_of.get(key, ())

    def is_multi(self, root_name: str) -> bool:
        return self._multi.get(root_name, False)

    def concurrent(self, roots_a, roots_b) -> bool:
        """Can an access on one of ``roots_a`` run concurrently with an
        access on one of ``roots_b``? Yes when the sets span two distinct
        roots, or share a multi-instance root."""
        a, b = set(roots_a), set(roots_b)
        if not a or not b:
            return False
        if (a | b) > a or (a | b) > b:
            return True  # two distinct roots exist across the pair
        if len(a | b) >= 2:
            return True
        return any(self._multi.get(r, False) for r in a & b)


_THREAD_CTORS = {"Thread": "spawn", "Timer": "timer"}


def _spawn_kind(call: ast.Call) -> str | None:
    name = dotted_name(call.func)
    if name is None:
        return None
    parts = name.split(".")
    last = parts[-1]
    if last not in _THREAD_CTORS:
        return None
    # `threading.Thread(...)` / bare `Thread(...)` (from-imports).
    if len(parts) == 1 or parts[0] in ("threading", "_threading"):
        return _THREAD_CTORS[last]
    return None


def _target_expr(call: ast.Call, kind: str) -> ast.expr | None:
    if kind == "spawn":
        for kw in call.keywords:
            if kw.arg == "target":
                return kw.value
        if call.args:
            return call.args[1] if len(call.args) >= 2 else None  # (group, target)
        return None
    # Timer(interval, function)
    for kw in call.keywords:
        if kw.arg == "function":
            return kw.value
    return call.args[1] if len(call.args) >= 2 else None


def _literal_name(call: ast.Call) -> str | None:
    for kw in call.keywords:
        if kw.arg == "name" and isinstance(kw.value, ast.Constant):
            if isinstance(kw.value.value, str):
                return kw.value.value
    return None


def _daemon_true(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
            return kw.value.value is True
    return False


def _enclosing_handler_classes(tree: ast.Module):
    """Every ClassDef (module-level or nested) whose base name ends with
    'BaseHTTPRequestHandler', with the enclosing function qual if any."""
    out = []  # (classdef, enclosing Func qual or None)
    for qual, cls, fn in iter_functions(tree):
        for node in ast.walk(fn):
            if isinstance(node, ast.ClassDef) and _is_handler(node):
                out.append((node, qual))
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and _is_handler(node):
            out.append((node, None))
    return out


def _is_handler(node: ast.ClassDef) -> bool:
    for base in node.bases:
        name = dotted_name(base) or ""
        if name.split(".")[-1] == "BaseHTTPRequestHandler":
            return True
    return False


def build_thread_map(
    index: SourceIndex, declared=DECLARED_ROOTS
) -> tuple[ThreadMap, list[Finding]]:
    """Derive the thread map; returns it plus the completeness findings
    (unresolved targets, daemonless spawns)."""
    cg = get_callgraph(index)
    findings: list[Finding] = []
    roots: list[ThreadRoot] = []
    spawn_count: dict[tuple[str, str], int] = {}  # target key -> sites

    for mod in index.iter_modules():
        if mod.tree is None or mod.rel.startswith("analysis/"):
            continue
        for qual, cls, fn in iter_functions(mod.tree):
            f = cg.funcs[(mod.rel, qual)]
            loops = _loop_spans(fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                kind = _spawn_kind(node)
                if kind is None:
                    continue
                if kind == "spawn" and not _daemon_true(node):
                    findings.append(Finding(
                        mod.rel, node.lineno, "thread-daemonless",
                        "thread spawned without daemon=True — if it "
                        "outlives close() it wedges interpreter "
                        "shutdown; pass daemon=True or justify",
                    ))
                target = _target_expr(node, kind)
                key, external = _resolve_target(target, f, fn, cg)
                if key is None and not external:
                    findings.append(Finding(
                        mod.rel, node.lineno, "thread-target-unresolved",
                        f"{kind} target is not a resolvable function "
                        "reference — every frame it runs escapes the "
                        "concurrency plane (guarded-by verdicts go "
                        "unsound); name a def/method or justify",
                    ))
                    continue
                in_loop = any(a <= node.lineno <= b for a, b in loops)
                name = _literal_name(node) or (
                    key[1] if key is not None else "external"
                )
                if key is not None:
                    spawn_count[key] = spawn_count.get(key, 0) + 1
                roots.append(ThreadRoot(
                    name=name,
                    key=key,
                    spawn_rel=mod.rel,
                    spawn_line=node.lineno,
                    multi=in_loop or kind == "timer",
                    kind="external" if key is None else kind,
                ))
        # HTTP handler classes: each do_* method is a multi root. Nested
        # handler classes (the frontends define them inside __init__)
        # map to the enclosing function — its edge set already contains
        # the handler bodies' calls.
        for cls_node, enclosing in _enclosing_handler_classes(mod.tree):
            dos = [
                n.name for n in cls_node.body
                if isinstance(n, ast.FunctionDef) and n.name.startswith("do_")
            ]
            if not dos:
                continue
            if enclosing is not None:
                key = (mod.rel, enclosing)
            else:
                key = (mod.rel, f"{cls_node.name}.{dos[0]}")
                if key not in cg.funcs:
                    key = None
            roots.append(ThreadRoot(
                # Unique per enclosing frame: two frontends both nest a
                # class named Handler, and a name collision would drop
                # the second root's reachable set on the floor.
                name=f"http:{enclosing or cls_node.name}@{mod.rel}:{cls_node.lineno}",
                key=key,
                spawn_rel=mod.rel,
                spawn_line=cls_node.lineno,
                multi=True,
                kind="handler",
            ))

    # A target spawned from >=2 distinct sites has >=2 live instances.
    # Collapse by (name, target): two spawns of the SAME target under
    # one name are one logical root (multi via the >=2-sites rule); two
    # DIFFERENT targets sharing a display name are distinct live
    # threads and must both keep their reachable sets.
    counted: dict[tuple, ThreadRoot] = {}
    final: list[ThreadRoot] = []
    for r in roots:
        multi = r.multi or (r.key is not None and spawn_count.get(r.key, 0) >= 2)
        r = ThreadRoot(r.name, r.key, r.spawn_rel, r.spawn_line, multi, r.kind)
        ident = (r.name, r.key)
        prev = counted.get(ident)
        if prev is not None:
            if multi and not prev.multi:
                final[final.index(prev)] = counted[ident] = ThreadRoot(
                    prev.name, prev.key, prev.spawn_rel, prev.spawn_line,
                    True, prev.kind,
                )
            continue
        counted[ident] = r
        final.append(r)

    names = {r.name for r in final}
    for rel, qual, name, multi in declared:
        if (rel, qual) in cg.funcs and name not in names:
            final.append(ThreadRoot(
                name, (rel, qual), rel,
                cg.funcs[(rel, qual)].node.lineno, multi, "declared",
            ))

    # Concurrency is judged per NAME (ThreadMap._multi): a name shared
    # by two different targets means two live threads under one label,
    # so the whole group is multi — otherwise the shared name would
    # read as "one single-instance root" and hide real races.
    name_counts: dict[str, int] = {}
    for r in final:
        name_counts[r.name] = name_counts.get(r.name, 0) + 1
    final = [
        ThreadRoot(r.name, r.key, r.spawn_rel, r.spawn_line, True, r.kind)
        if name_counts[r.name] >= 2 and not r.multi else r
        for r in final
    ]

    tmap = ThreadMap(roots=final)
    roots_of: dict[tuple[str, str], set[str]] = {}
    for r in final:
        tmap._multi[r.name] = r.multi
        if r.key is None:
            continue
        reachable, chains = cg.reach([r.key])
        tmap.chains[r.name] = chains
        for key in reachable:
            roots_of.setdefault(key, set()).add(r.name)
    tmap._roots_of = {k: tuple(sorted(v)) for k, v in roots_of.items()}
    return tmap, findings


def _loop_spans(fn) -> list[tuple[int, int]]:
    return [
        (n.lineno, n.end_lineno or n.lineno)
        for n in ast.walk(fn)
        if isinstance(n, (ast.For, ast.While, ast.AsyncFor))
    ]


def _resolve_target(target, f, fn, cg: CallGraph):
    """Resolve a Thread/Timer target expression. Returns ``(key,
    external)``: a function key, or ``(None, True)`` for a known-object
    out-of-package method (stdlib serve_forever), or ``(None, False)``
    when genuinely unresolvable (lambda/partial/computed)."""
    if target is None:
        return None, False
    if isinstance(target, ast.Lambda) or isinstance(target, ast.Call):
        return None, False
    name = dotted_name(target)
    if name is None:
        return None, False
    # Nested def: the closure runs its enclosing frame's resolved calls
    # (ast.walk folds closure bodies into the enclosing function).
    parts = name.split(".")
    if len(parts) == 1:
        for node in ast.walk(fn):
            if (
                isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name == parts[0]
                and node is not fn
            ):
                return (f.rel, f.qual), False
    hits = list(cg.call_targets(target, f))
    if hits:
        return hits[0], False
    # self.<attr>.<method> where <attr> is constructor-typed to a known
    # class but the method body is out of package (inherited/stdlib):
    # real thread, no in-package frames.
    if len(parts) == 3 and parts[0] == "self" and f.cls is not None:
        if cg.attr_types.get((f.rel, f.cls), {}).get(parts[1]):
            return None, True
    return None, False


def get_thread_map(index: SourceIndex) -> ThreadMap:
    """The index's thread map, derived once per index instance (the
    guarded-by checker and the artifact writer share it)."""
    cached = getattr(index, "_thread_map", None)
    if cached is None:
        cached = build_thread_map(index)
        index._thread_map = cached
    return cached[0]


class ThreadRootsChecker:
    id = "thread-roots"
    description = (
        "tree-wide thread map: every Thread/Timer target resolves into "
        "the call graph (an escaped target blinds the concurrency "
        "plane) and spawns are daemon=True"
    )
    invariants = ("thread-target-unresolved", "thread-daemonless")

    def check(self, index: SourceIndex) -> list[Finding]:
        cached = getattr(index, "_thread_map", None)
        if cached is None:
            cached = build_thread_map(index)
            index._thread_map = cached
        return list(cached[1])
