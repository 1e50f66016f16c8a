"""Shared intra-package call graph — the resolution substrate under the
hot-path, thread-root, and guarded-by checkers.

One graph per :class:`~radixmesh_tpu_torch.analysis.core.SourceIndex`, built
once and memoized on the index (``get_callgraph``): every checker that
needs reachability ("which functions can this entry point reach", "which
thread roots can run this function") reads the same edges instead of
re-deriving its own.

Resolution is deliberately name-shaped, the same discipline the
lock-order checker documents: same-module functions, ``self.`` methods,
constructor-typed ``self.x`` / local attributes, imported symbols,
functions called through an imported module (``import
radixmesh_tpu_torch.cache.oplog as oplog_mod; oplog_mod.f()``), and
nested ``def``s (a closure handed to ``threading.Thread`` executes its
enclosing function's resolved calls — ``ast.walk`` already folds the
closure body into the enclosing frame's edge set). Unresolvable calls
(first-class callbacks, computed attributes) simply contribute no edge;
checkers that NEED those edges pin explicit roots/entry points instead
(``hot_path.DEFAULT_ENTRY_POINTS``, ``thread_roots.DECLARED_ROOTS``).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from .core import PACKAGE, SourceIndex, dotted_name, iter_functions

__all__ = ["Func", "CallGraph", "get_callgraph"]


@dataclass(frozen=True)
class Func:
    rel: str
    qual: str  # "Class.method" or "func"
    cls: str | None
    node: ast.AST

    @property
    def key(self) -> tuple[str, str]:
        return (self.rel, self.qual)


class CallGraph:
    """Functions, classes, imports, constructor-typed attributes, and
    call edges for one parsed package tree."""

    def __init__(self, index: SourceIndex):
        self.index = index
        self.funcs: dict[tuple[str, str], Func] = {}
        self.classes: dict[str, dict[str, str]] = {}  # class name -> {rel}
        self.imports: dict[str, dict[str, str]] = {}
        # Per module: local name -> module rel, for names bound to a
        # package MODULE (``import pkg.x as y``, ``from pkg import x``).
        self.module_aliases: dict[str, dict[str, str]] = {}
        self.attr_types: dict[tuple[str, str], dict[str, tuple[str, str]]] = {}
        self._build_symbols(index)
        self.edges = self._build_edges(index)

    # ------------------------------------------------------------------
    # symbol tables
    # ------------------------------------------------------------------

    def _build_symbols(self, index: SourceIndex) -> None:
        for mod in index.iter_modules():
            if mod.tree is None:
                continue
            for qual, cls, fn in iter_functions(mod.tree):
                self.funcs[(mod.rel, qual)] = Func(mod.rel, qual, cls, fn)
            for node in mod.tree.body:
                if isinstance(node, ast.ClassDef):
                    self.classes.setdefault(node.name, {})[mod.rel] = node.name

        # Per-module import map: name -> module rel it came from.
        for mod in index.iter_modules():
            if mod.tree is None:
                continue
            imap: dict[str, str] = {}
            mmap: dict[str, str] = {}
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ImportFrom):
                    target = self._resolve_import(mod.rel, node, index)
                    if target is None:
                        continue
                    for alias in node.names:
                        imap[alias.asname or alias.name] = target
                        # `from radixmesh_tpu_torch.cache import oplog`
                        # binds a module, not a symbol of the package.
                        if target.endswith("__init__.py"):
                            sub = self._module_rel(
                                target.split("/")[:-1] + [alias.name], index
                            )
                            if sub is not None:
                                mmap[alias.asname or alias.name] = sub
                elif isinstance(node, ast.Import):
                    # `import radixmesh_tpu_torch.cache.oplog as oplog_mod`:
                    # the edge feeds module_dependents() (the --changed
                    # scope widener) and the calls made through the alias.
                    for alias in node.names:
                        if not alias.name.startswith(PACKAGE + "."):
                            continue
                        cand = self._module_rel(alias.name.split(".")[1:], index)
                        if cand is None:
                            continue
                        imap[alias.asname or alias.name] = cand
                        mmap[alias.asname or alias.name] = cand
            self.imports[mod.rel] = imap
            self.module_aliases[mod.rel] = mmap

        # Constructor-typed self attributes: self.x = ClassName(...) in
        # any method -> (class scope) x: rel-of-ClassName + ClassName.
        for mod in index.iter_modules():
            if mod.tree is None:
                continue
            for qual, cls, fn in iter_functions(mod.tree):
                if cls is None:
                    continue
                for node in ast.walk(fn):
                    if not (
                        isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)
                        and isinstance(node.value.func, ast.Name)
                    ):
                        continue
                    cname = node.value.func.id
                    crel = self.class_rel(cname, mod.rel)
                    if crel is None:
                        continue
                    for t in node.targets:
                        name = dotted_name(t)
                        if name and name.startswith("self.") and name.count(".") == 1:
                            self.attr_types.setdefault((mod.rel, cls), {})[
                                name.split(".", 1)[1]
                            ] = (crel, cname)

    @staticmethod
    def _module_rel(parts: list[str], index) -> str | None:
        """``["cache", "oplog"]`` -> ``cache/oplog.py`` (or the package's
        ``__init__.py``) when the index holds it."""
        cand = "/".join(parts) + ".py"
        if parts and cand in index:
            return cand
        pkg = "/".join(parts + ["__init__.py"])
        if pkg in index:
            return pkg
        return None

    def _resolve_import(self, rel: str, node: ast.ImportFrom, index) -> str | None:
        """Map an ImportFrom to a package-relative module path, or None
        for out-of-package imports (the package name is matched
        exactly: ``radixmesh_tpu`` is not this package)."""
        if node.level == 0:
            mod = node.module or ""
            if mod != PACKAGE and not mod.startswith(PACKAGE + "."):
                return None
            parts = mod.split(".")[1:]
        else:
            base = rel.split("/")[:-1]
            up = node.level - 1
            parts = (base[: len(base) - up] if up else base) + (
                node.module.split(".") if node.module else []
            )
        return self._module_rel(parts, index)

    def class_rel(self, cname: str, rel: str) -> str | None:
        """The module a class name resolves to from ``rel`` (definition
        in the same module wins, then the import map, then a package-wide
        unique definition)."""
        rels = self.classes.get(cname)
        if not rels:
            return None
        if rel in rels:
            return rel
        imported_from = self.imports.get(rel, {}).get(cname)
        if imported_from in rels:
            return imported_from
        if len(rels) == 1:
            return next(iter(rels))
        return None

    # ------------------------------------------------------------------
    # call edges
    # ------------------------------------------------------------------

    def _build_edges(self, index: SourceIndex):
        edges: dict[tuple[str, str], set[tuple[str, str]]] = {}
        for (rel, qual), f in self.funcs.items():
            out: set[tuple[str, str]] = set()
            local_types: dict[str, tuple[str, str]] = {}
            for node in ast.walk(f.node):
                if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                    # t = Thing(...) -> t.m() resolves one level.
                    if isinstance(node.value.func, ast.Name):
                        cname = node.value.func.id
                        crel = self.class_rel(cname, rel)
                        if crel is not None:
                            for t in node.targets:
                                if isinstance(t, ast.Name):
                                    local_types[t.id] = (crel, cname)
                if not isinstance(node, ast.Call):
                    continue
                for target in self.call_targets(node.func, f, local_types):
                    out.add(target)
            edges[(rel, qual)] = out
        return edges

    def call_targets(self, func_expr: ast.expr, f: Func, local_types=None):
        """Resolve one call (or bare callable reference) expression from
        inside ``f`` to zero or more ``(rel, qual)`` function keys."""
        name = dotted_name(func_expr)
        if name is None:
            return
        local_types = local_types or {}
        rel = f.rel
        parts = name.split(".")
        if len(parts) == 1:
            # bare g() — same module, else an imported function.
            if (rel, parts[0]) in self.funcs:
                yield (rel, parts[0])
            else:
                src = self.imports.get(rel, {}).get(parts[0])
                if src and (src, parts[0]) in self.funcs:
                    yield (src, parts[0])
                # Constructor call: edge into __init__.
                crel = self.class_rel(parts[0], rel)
                if crel and (crel, f"{parts[0]}.__init__") in self.funcs:
                    yield (crel, f"{parts[0]}.__init__")
        elif parts[0] == "self" and f.cls is not None:
            if len(parts) == 2:
                if (rel, f"{f.cls}.{parts[1]}") in self.funcs:
                    yield (rel, f"{f.cls}.{parts[1]}")
            elif len(parts) == 3:
                typed = self.attr_types.get((rel, f.cls), {}).get(parts[1])
                if typed:
                    trel, tcls = typed
                    if (trel, f"{tcls}.{parts[2]}") in self.funcs:
                        yield (trel, f"{tcls}.{parts[2]}")
        elif len(parts) == 2:
            # local constructor-typed var.m().
            typed = local_types.get(parts[0])
            if typed:
                trel, tcls = typed
                if (trel, f"{tcls}.{parts[1]}") in self.funcs:
                    yield (trel, f"{tcls}.{parts[1]}")
            # module_alias.f() / module_alias.Class().
            mrel = self.module_aliases.get(rel, {}).get(parts[0])
            if mrel is not None:
                if (mrel, parts[1]) in self.funcs:
                    yield (mrel, parts[1])
                elif (mrel, f"{parts[1]}.__init__") in self.funcs:
                    yield (mrel, f"{parts[1]}.__init__")

    def reach(self, roots):
        """BFS from ``roots`` (function keys). Returns ``(reachable set,
        {key: call chain from its root})`` — missing roots are skipped so
        callers run unmodified over partial fixture trees."""
        chains: dict[tuple[str, str], tuple[str, ...]] = {}
        frontier: list[tuple[str, str]] = []
        for ep in roots:
            if ep in self.funcs and ep not in chains:
                chains[ep] = (f"{ep[0]}:{ep[1]}",)
                frontier.append(ep)
        while frontier:
            cur = frontier.pop()
            for nxt in self.edges.get(cur, ()):
                if nxt in chains:
                    continue
                chains[nxt] = chains[cur] + (f"{nxt[0]}:{nxt[1]}",)
                frontier.append(nxt)
        return set(chains), chains

    def module_dependents(self) -> dict[str, set[str]]:
        """Reverse import map: ``{rel: modules that import rel}`` — the
        scope widener behind ``python -m radixmesh_tpu_torch.meshcheck --changed`` (a change
        to a module can invalidate any finding computed in a module that
        calls into it, and name-shaped calls follow imports)."""
        out: dict[str, set[str]] = {rel: set() for rel in self.index.modules}
        for rel, imap in self.imports.items():
            targets = set(imap.values()) | set(self.module_aliases.get(rel, {}).values())
            for target in targets:
                out.setdefault(target, set()).add(rel)
        return out


def get_callgraph(index: SourceIndex) -> CallGraph:
    """The index's call graph, built once per index instance (checkers
    sharing one ``SourceIndex`` share one graph)."""
    cg = getattr(index, "_callgraph", None)
    if cg is None:
        cg = CallGraph(index)
        index._callgraph = cg
    return cg
