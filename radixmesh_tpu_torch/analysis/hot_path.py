"""Hot-path blocking audit: call graph from the serving entry points.

Builds an intra-package call graph (name-shaped resolution: same-module
functions, ``self.`` methods, constructor-typed ``self.x`` / local
attributes, imported symbols) rooted at the serving entry points —
``Engine.step`` / ``Engine.enqueue`` (admission), ``match_prefix``,
``OverloadController.enqueue``, the disagg submit/step path, and the
oplog receive path — then flags what a grep scoped to one file can
never see: a blocking call two frames down.

Invariants:

- ``hotpath-blocking`` — a function REACHABLE from a serving entry
  point contains a no-timeout ``wait()/join()/get()``, a
  ``time.sleep``, or a device-sync call (``torch.cuda.synchronize()``,
  ``.synchronize()`` of a stream or an event). The finding message
  carries the call chain from the entry point.
- ``timeout-audit`` — tree-wide: a blocking ``wait()/join()/get()``
  with NO timeout/deadline argument anywhere in product code parks a
  thread a dead peer can wedge forever (AST-checked).
  The few intentionally unbounded seams carry in-source
  ``# meshcheck: ok[timeout-audit] <why>`` justifications.
- ``sleep-audit`` — tree-wide: every ``time.sleep`` product call site
  is either on a cold path with an in-source justification or a bug;
  hot ones surface as ``hotpath-blocking`` instead.
- ``hotpath-sync`` — the staging boundary, scoped exactly as the
  old grep lint was: the engine scheduler, the hierarchical cache's
  match path, and the disagg admit path must not host-materialize KV
  (``.cpu()``/``.numpy()``/``.tolist()``/``.item()``/``.to("cpu")``/
  ``np.asarray`` over a pool gather, ``gather_padded``, inline
  ``host.read``) or force a device sync; ``cache/kv_transfer.py`` is
  the ONE module allowed to block on device→host data. The engine's
  reads of its sampled tokens (``.cpu().numpy()`` of a few ints a
  step) are not KV and stay legal.
- ``hotpath-file-io`` — the durable-tier boundary: no blocking
  file I/O (builtin ``open``, ``os.fsync``/``os.replace``/renames/
  unlinks/dir scans, pathlib read/write helpers) REACHABLE from a
  serving entry point. The disk tier (``cache/kv_tier.py``) does all
  of this on the KV-plane worker and on cold boot/drain paths; a
  refactor that drags an extent read into ``Engine.step``,
  ``match_prefix``, or the oplog receive path is a serving stall the
  size of a disk seek, and this invariant is how it gets caught two
  frames down.
"""

from __future__ import annotations

import ast

from .callgraph import get_callgraph
from .core import Checker, Finding, SourceIndex, dotted_name

__all__ = ["HotPathChecker", "DEFAULT_ENTRY_POINTS"]

# (module, qualname) serving entry points. Missing ones are skipped so
# the checker runs unmodified over positive-control fixture trees that
# mimic only one corner of the package.
DEFAULT_ENTRY_POINTS: tuple[tuple[str, str], ...] = (
    ("engine/engine.py", "Engine.step"),
    ("engine/engine.py", "Engine.enqueue"),
    ("cache/mesh_cache.py", "MeshCache.match_prefix"),
    ("cache/mesh_cache.py", "MeshCache.oplog_received"),
    ("slo/control.py", "OverloadController.enqueue"),
    ("engine/disagg.py", "DecodeWorker.submit"),
    ("engine/disagg.py", "DecodeWorker.step"),
)

# The designated sync owner: allowed to block on device→host.
_SYNC_OWNER = "cache/kv_transfer.py"

# The old test_hotpath_lint scopes: (functions-or-whole-module, banned
# construct families). ``host_read`` is banned in the engine scheduler
# but NOT in the hierarchical cache's match path — ``match_and_load``'s
# arena read is the documented synchronous fallback; the fused sweep
# gather lives in the flush/plane seam.
_SYNC_SCOPES: dict[str, tuple[tuple[str, ...] | None, tuple[str, ...]]] = {
    # None = the whole module.
    "engine/engine.py": (
        None, ("device_sync", "gather", "host_read"),
    ),
    "cache/host_cache.py": (
        (
            "HierarchicalCache.match_and_load",
            "HierarchicalCache._writeback",
            "HierarchicalCache._evict_host",
        ),
        ("device_sync", "gather"),
    ),
    "engine/disagg.py": (
        ("DecodeWorker._admit_one",),
        ("device_sync", "any_asarray"),
    ),
}

_BLOCKING_ATTRS = ("wait", "join", "get")


def _module_sleep_names(tree: ast.Module) -> tuple[set[str], set[str]]:
    """(bare names bound to time.sleep via ``from time import sleep``
    [as x], module aliases of ``time`` via ``import time as x``) — the
    import styles that would otherwise evade a dotted-name match."""
    bare: set[str] = set()
    mods: set[str] = {"time", "_time"}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name == "sleep":
                    bare.add(alias.asname or alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "time":
                    mods.add(alias.asname or alias.name)
    return bare, mods


def _is_time_sleep(call: ast.Call, sleep_names=(), time_mods=("time", "_time")) -> bool:
    name = dotted_name(call.func)
    if name is None:
        return False
    parts = name.split(".")
    if len(parts) == 1:
        return parts[0] in sleep_names
    return len(parts) == 2 and parts[1] == "sleep" and parts[0] in time_mods


def _is_unbounded_blocking(call: ast.Call) -> str | None:
    """``x.wait()`` / ``x.join()`` / ``x.get()`` with NO argument at all
    (a timeout positional or keyword makes those bounded) — plus the
    ``get`` forms whose argument is the BLOCK flag, not a timeout:
    ``q.get(True)`` / ``q.get(block=True)`` park forever."""
    if not (
        isinstance(call.func, ast.Attribute)
        and call.func.attr in _BLOCKING_ATTRS
    ):
        return None
    attr = call.func.attr
    if not call.args and not call.keywords:
        return attr
    if attr == "get":
        kw = {k.arg: k.value for k in call.keywords}
        if "timeout" in kw or len(call.args) >= 2:
            return None
        block_true = (
            call.args
            and isinstance(call.args[0], ast.Constant)
            and call.args[0].value is True
        ) or (
            isinstance(kw.get("block"), ast.Constant)
            and kw["block"].value is True
        )
        if block_true:
            return "get"
    return None


# Blocking file-I/O shapes for the ``hotpath-file-io`` invariant:
# builtin/io open, the os-module file mutators the extent store uses,
# and the pathlib one-shot read/write helpers.
_FILE_IO_OS = {
    "os.fsync", "os.replace", "os.rename", "os.remove", "os.unlink",
    "os.listdir", "os.makedirs", "io.open",
}
_FILE_IO_ATTRS = ("write_bytes", "write_text", "read_bytes", "read_text")


def _is_file_io(call: ast.Call) -> str | None:
    name = dotted_name(call.func)
    if name == "open":
        return "open()"
    if name in _FILE_IO_OS:
        return name
    if (
        isinstance(call.func, ast.Attribute)
        and call.func.attr in _FILE_IO_ATTRS
    ):
        return f".{call.func.attr}()"
    return None


def _is_device_sync(call: ast.Call) -> str | None:
    """``torch.cuda.synchronize()`` and ``.synchronize()`` of a stream or
    an event (``torch.cuda.current_stream(d).synchronize()`` included):
    the host waits for the card."""
    name = dotted_name(call.func)
    if name == "synchronize":  # from torch.cuda import synchronize
        return "synchronize()"
    if isinstance(call.func, ast.Attribute) and call.func.attr == "synchronize":
        return name or ".synchronize()"
    return None


# Tensor -> host materializations: the method forms, plus ``.to("cpu")``
# and ``np.asarray`` (handled in :func:`_host_copy`).
_HOST_COPY_ATTRS = ("cpu", "numpy", "tolist", "item")
_POOL_GATHERS = ("gather", "gather_raw")


def _host_copy(call: ast.Call) -> tuple[str, ast.expr] | None:
    """``(label, operand)`` when ``call`` copies a tensor to the host:
    ``x.cpu()``, ``x.numpy()``, ``x.tolist()``, ``x.item()``,
    ``x.to("cpu")`` or ``np.asarray(x)``."""
    name = dotted_name(call.func)
    if name in ("np.asarray", "numpy.asarray"):
        return ("np.asarray", call.args[0]) if call.args else None
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    if attr in _HOST_COPY_ATTRS:
        return f".{attr}()", call.func.value
    if attr == "to":
        dev = call.args[0] if call.args else next(
            (k.value for k in call.keywords if k.arg == "device"), None
        )
        if isinstance(dev, ast.Constant) and dev.value == "cpu":
            return '.to("cpu")', call.func.value
    return None


def _pool_gather_in(expr: ast.expr) -> bool:
    """Whether the receiver chain of ``expr`` holds a pool gather:
    ``pool.gather(...)``, ``self.pool.gather_raw(...)[0].float()``..."""
    while True:
        if isinstance(expr, ast.Call):
            parts = (dotted_name(expr.func) or "").split(".")
            if parts[-1] in _POOL_GATHERS and "pool" in parts:
                return True
            expr = expr.func
        elif isinstance(expr, (ast.Attribute, ast.Subscript)):
            expr = expr.value
        else:
            return False


def _banned_construct(call: ast.Call, families: tuple[str, ...]) -> str | None:
    """The staging-boundary constructs, by family: ``device_sync``
    (``torch.cuda.synchronize``, ``.synchronize()``), ``gather`` (a
    host copy over a pool gather, the fused gather helper),
    ``host_read`` (inline host-arena read), ``any_asarray`` (the disagg
    admit path bans every host materialization of a tensor)."""
    name = dotted_name(call.func)
    if "device_sync" in families:
        why = _is_device_sync(call)
        if why is not None:
            return why
    if "gather" in families:
        if name in ("gather_padded",) or (name or "").endswith(".gather_padded"):
            return "gather_padded"
        copy = _host_copy(call)
        if copy is not None and _pool_gather_in(copy[1]):
            return f"{copy[0]} of a pool gather"
    if "host_read" in families:
        if name is not None and name.split(".")[-1] == "read" and (
            "host" in name.split(".")
        ):
            return "host.read"
    if "any_asarray" in families:
        copy = _host_copy(call)
        if copy is not None:
            return copy[0]
    return None


class HotPathChecker:
    id = "hot-path"
    description = (
        "no blocking call (unbounded wait/join/get, time.sleep, device "
        "sync) reachable from a serving entry point; tree-wide "
        "timeout/sleep audits; the staging boundary"
    )
    invariants = (
        "hotpath-blocking", "timeout-audit", "sleep-audit", "hotpath-sync",
        "hotpath-file-io",
    )

    def __init__(self, entry_points=DEFAULT_ENTRY_POINTS):
        self.entry_points = tuple(entry_points)

    # ------------------------------------------------------------------

    def check(self, index: SourceIndex) -> list[Finding]:
        # The shared call graph (analysis/callgraph.py) — symbol tables
        # and edges are built once per index and shared with the
        # thread-root and guarded-by checkers.
        cg = get_callgraph(index)
        funcs = cg.funcs
        reachable, chains = cg.reach(self.entry_points)
        findings: list[Finding] = []
        self._scan_blocking(index, funcs, reachable, chains, findings)
        self._scan_sync_scopes(index, funcs, findings)
        return findings

    # ------------------------------------------------------------------
    # scans
    # ------------------------------------------------------------------

    def _scan_blocking(self, index, funcs, reachable, chains, findings):
        sleep_names: dict[str, tuple[set[str], set[str]]] = {
            mod.rel: _module_sleep_names(mod.tree)
            for mod in index.iter_modules() if mod.tree is not None
        }
        for (rel, qual), f in funcs.items():
            if rel.startswith("analysis/"):
                continue
            hot = (rel, qual) in reachable
            bare, mods = sleep_names[rel]
            for node in ast.walk(f.node):
                if not isinstance(node, ast.Call):
                    continue
                label = None
                inv = None
                if _is_time_sleep(node, bare, mods):
                    label, inv = "time.sleep", "sleep-audit"
                else:
                    b = _is_unbounded_blocking(node)
                    if b is not None:
                        label, inv = f".{b}() without a timeout", "timeout-audit"
                    else:
                        d = _is_device_sync(node)
                        if d is not None and hot:
                            label, inv = d, "hotpath-blocking"
                        elif hot:
                            f_io = _is_file_io(node)
                            if f_io is not None:
                                label, inv = f_io, "hotpath-file-io"
                if label is None:
                    continue
                if inv == "hotpath-file-io":
                    chain = " -> ".join(chains[(rel, qual)])
                    findings.append(Finding(
                        rel, node.lineno, "hotpath-file-io",
                        f"{label} — blocking file I/O on a serving hot "
                        f"path (reached via {chain}); the disk tier "
                        "does file I/O only on the KV-plane worker "
                        "(cache/kv_tier.py threading contract)",
                    ))
                elif hot:
                    chain = " -> ".join(chains[(rel, qual)])
                    findings.append(Finding(
                        rel, node.lineno, "hotpath-blocking",
                        f"{label} on a serving hot path (reached via "
                        f"{chain})",
                    ))
                else:
                    findings.append(Finding(
                        rel, node.lineno, inv,
                        f"{label} — a dead peer (or a cold loop) parks "
                        "this thread unboundedly; pass a deadline or "
                        "justify in-source"
                        if inv == "timeout-audit"
                        else f"{label} off the hot path — convert to a "
                        "condition/deadline wait or justify in-source",
                    ))

        # Module-level statements (rare, but a sleep at import time is
        # still a sleep).
        for mod in index.iter_modules():
            if mod.tree is None or mod.rel.startswith("analysis/"):
                continue
            bare, mods = sleep_names[mod.rel]
            for stmt in mod.tree.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    continue
                for node in ast.walk(stmt):
                    if isinstance(node, ast.Call) and _is_time_sleep(node, bare, mods):
                        findings.append(Finding(
                            mod.rel, node.lineno, "sleep-audit",
                            "time.sleep at module scope",
                        ))

    def _scan_sync_scopes(self, index, funcs, findings):
        for rel, (scope, families) in _SYNC_SCOPES.items():
            if rel not in index:
                continue
            mod = index.module(rel)
            if mod.tree is None:
                continue
            if scope is None:
                nodes = [mod.tree]
            else:
                nodes = [
                    f.node for (r, q), f in funcs.items()
                    if r == rel and q in scope
                ]
            for root in nodes:
                for node in ast.walk(root):
                    if not isinstance(node, ast.Call):
                        continue
                    why = _banned_construct(node, families)
                    if why is not None:
                        findings.append(Finding(
                            rel, node.lineno, "hotpath-sync",
                            f"{why} — blocking KV materialization "
                            f"outside the staging module ({_SYNC_OWNER} "
                            "is the one sync owner)",
                        ))
