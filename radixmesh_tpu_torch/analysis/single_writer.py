"""Single-writer enforcement: lifecycle state, shard ownership, shard
heat — plus the mesh send-seam confinement rule.

Replaces the three grep single-writer lints (``test_mesh_lint.py``'s
``TestLifecycleStateOwnership`` / ``TestOwnershipSingleWriter`` /
``TestShardHeatSingleWriter``) with assignment/call-site AST analysis
that also catches what a grep cannot:

- **aliased writes** — ``st = LifecycleState.ACTIVE`` followed by
  ``plane.state = st`` is two findings, not an invisible write; the
  same for ``OM = OwnershipMap`` / ``note = heat.note_insert`` aliases
  of a guarded constructor or counting method;
- **setattr** — ``setattr(plane, "state", LifecycleState.ACTIVE)`` and
  ``setattr(m, "owners", ...)`` are writes, not string operations;
- **comparison reads stay legal** — ``if st is LifecycleState.ACTIVE``
  and ``d.lifecycle != LifecycleState.ACTIVE.value`` bind nothing.

Invariants:

- ``single-writer-lifecycle`` — only ``policy/lifecycle.py`` may bind a
  ``LifecycleState`` value (a module that could flip a node to ACTIVE
  mid-bootstrap silently re-enables cold hit-routing).
- ``single-writer-ownership`` — only ``cache/sharding.py`` constructs
  an ``OwnershipMap`` or pokes ``.owners`` (two nodes deriving
  different owner sets for one shard is delivery-plane split-brain).
- ``single-writer-overrides`` — only ``cache/rebalance.py`` constructs
  a ``ShardOverrides`` or pokes ``.moves`` (a second decision-maker
  forking the override map forks the effective owner sets the whole
  delivery plane derives from — the same split-brain one layer up).
- ``single-writer-heat`` — only ``cache/mesh_cache.py`` (and the
  defining ``cache/sharding.py``) constructs ``ShardHeat`` or calls
  ``note_insert/note_hit/note_pull`` (a second counter double-counts
  the same traffic and skews the rebalancer signal).
- ``send-seam`` — in ``cache/mesh_cache.py``, no raw ``.send(`` at all,
  and ``.try_send(`` only inside the documented seam methods (sender
  loops, router fan-out, graceful close, the droppable dedicated
  channels).
"""

from __future__ import annotations

import ast

from .core import Checker, Finding, SourceIndex, dotted_name, iter_functions

__all__ = ["SingleWriterChecker"]

# The ONLY MeshCache methods allowed to touch a transport's try_send:
# the two sender-thread loops, the (sender-thread-only) router fan-out,
# the best-effort graceful-close announcement, and the dedicated
# fire-and-forget channels — each short-deadline and droppable by
# contract. (Carried over from the grep lint's ALLOWED_TRY_SEND.)
ALLOWED_TRY_SEND = (
    "_sender_loop",
    "_fan_out_to_routers",
    "close",
    "send_prefetch",
    "send_repair",
    "_owner_sender",
    "send_shard_pull",
)

_MESH = "cache/mesh_cache.py"
_HEAT_NOTES = ("note_insert", "note_hit", "note_pull")


def _contains_state_value(expr: ast.expr) -> int | None:
    """Line of a ``LifecycleState.X`` value USED AS A VALUE inside
    ``expr`` (i.e. not merely compared against); None when the
    expression only reads/compares."""
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(expr):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    for node in ast.walk(expr):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "LifecycleState"
        ):
            p = parents.get(node)
            inside_compare = False
            while p is not None:
                if isinstance(p, ast.Compare):
                    inside_compare = True
                    break
                p = parents.get(p)
            if not inside_compare:
                return node.lineno
    return None


class SingleWriterChecker:
    id = "single-writer"
    description = (
        "lifecycle state / shard ownership / shard heat each have ONE "
        "writer module (aliases and setattr count as writes); mesh "
        "network sends are confined to the try_send seam methods"
    )
    invariants = (
        "single-writer-lifecycle", "single-writer-ownership",
        "single-writer-overrides", "single-writer-heat", "send-seam",
    )

    def check(self, index: SourceIndex) -> list[Finding]:
        findings: list[Finding] = []
        for mod in index.iter_modules():
            if mod.tree is None or mod.rel.startswith("analysis/"):
                continue
            if mod.rel != "policy/lifecycle.py":
                self._lifecycle(mod.rel, mod.tree, findings)
            if mod.rel != "cache/sharding.py":
                self._ownership(mod.rel, mod.tree, findings)
            if mod.rel != "cache/rebalance.py":
                self._overrides(mod.rel, mod.tree, findings)
            if mod.rel not in ("cache/sharding.py", _MESH):
                self._heat(mod.rel, mod.tree, findings)
            if mod.rel == _MESH:
                self._send_seam(mod.rel, mod.tree, findings)
        return findings

    # ------------------------------------------------------------------
    # lifecycle state
    # ------------------------------------------------------------------

    def _lifecycle(self, rel: str, tree: ast.Module, out: list[Finding]) -> None:
        # Pass 1: every name bound to a LifecycleState value anywhere in
        # the module (``ast.walk`` is breadth-first, so a one-pass scan
        # would miss a store that lexically follows a binding nested in
        # a deeper block). A later attribute-store through such an alias
        # is the grep-invisible second write.
        aliases: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                if node.value is None:
                    continue
                if _contains_state_value(node.value) is not None:
                    targets = (
                        node.targets if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    for t in targets:
                        if isinstance(t, ast.Name):
                            aliases.add(t.id)
        for node in ast.walk(tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                value = node.value
                if value is None:
                    continue
                line = _contains_state_value(value)
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                if line is not None:
                    out.append(Finding(
                        rel, node.lineno, "single-writer-lifecycle",
                        "binds a LifecycleState value outside "
                        "policy/lifecycle.py (single-writer contract: "
                        "ask the plane to transition instead)",
                    ))
                    continue
                # Attribute store THROUGH an alias of a state value.
                if (
                    isinstance(value, ast.Name) and value.id in aliases
                    and any(isinstance(t, ast.Attribute) for t in targets)
                ):
                    out.append(Finding(
                        rel, node.lineno, "single-writer-lifecycle",
                        f"writes lifecycle state through alias "
                        f"{value.id!r} outside policy/lifecycle.py",
                    ))
            elif isinstance(node, ast.Call):
                if (
                    isinstance(node.func, ast.Name)
                    and node.func.id == "setattr"
                    and len(node.args) >= 3
                    and (
                        _contains_state_value(node.args[2]) is not None
                        or (
                            isinstance(node.args[2], ast.Name)
                            and node.args[2].id in aliases
                        )
                    )
                ):
                    out.append(Finding(
                        rel, node.lineno, "single-writer-lifecycle",
                        "setattr of a LifecycleState value outside "
                        "policy/lifecycle.py",
                    ))

    # ------------------------------------------------------------------
    # ownership map
    # ------------------------------------------------------------------

    def _ownership(self, rel: str, tree: ast.Module, out: list[Finding]) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                if isinstance(node.func, ast.Name) and node.func.id == "OwnershipMap":
                    out.append(Finding(
                        rel, node.lineno, "single-writer-ownership",
                        "constructs an OwnershipMap outside "
                        "cache/sharding.py — derive through "
                        "build_ownership() and treat the result as "
                        "immutable",
                    ))
                elif (
                    isinstance(node.func, ast.Name)
                    and node.func.id == "setattr"
                    and len(node.args) >= 2
                    and isinstance(node.args[1], ast.Constant)
                    and node.args[1].value == "owners"
                ):
                    out.append(Finding(
                        rel, node.lineno, "single-writer-ownership",
                        "setattr on an ownership map's owner set outside "
                        "cache/sharding.py",
                    ))
            elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    base = t
                    if isinstance(base, ast.Subscript):
                        base = base.value
                    if isinstance(base, ast.Attribute) and base.attr == "owners":
                        out.append(Finding(
                            rel, node.lineno, "single-writer-ownership",
                            "mutates an ownership map's .owners outside "
                            "cache/sharding.py (split-brain on the "
                            "delivery plane)",
                        ))
                # Aliasing the constructor is a write waiting to happen.
                if (
                    isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "OwnershipMap"
                ):
                    out.append(Finding(
                        rel, node.lineno, "single-writer-ownership",
                        "aliases the OwnershipMap constructor outside "
                        "cache/sharding.py",
                    ))

    # ------------------------------------------------------------------
    # ownership overrides (cache/rebalance.py)
    # ------------------------------------------------------------------

    def _overrides(self, rel: str, tree: ast.Module, out: list[Finding]) -> None:
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                if (
                    isinstance(node.func, ast.Name)
                    and node.func.id == "ShardOverrides"
                ):
                    out.append(Finding(
                        rel, node.lineno, "single-writer-overrides",
                        "constructs a ShardOverrides outside "
                        "cache/rebalance.py — decisions flow through the "
                        "rebalance plane; everything else folds whole "
                        "immutable instances",
                    ))
                elif (
                    isinstance(node.func, ast.Name)
                    and node.func.id == "setattr"
                    and len(node.args) >= 2
                    and isinstance(node.args[1], ast.Constant)
                    and node.args[1].value == "moves"
                ):
                    out.append(Finding(
                        rel, node.lineno, "single-writer-overrides",
                        "setattr on an override map's move set outside "
                        "cache/rebalance.py",
                    ))
            elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    base = t
                    if isinstance(base, ast.Subscript):
                        base = base.value
                    if isinstance(base, ast.Attribute) and base.attr == "moves":
                        out.append(Finding(
                            rel, node.lineno, "single-writer-overrides",
                            "mutates an override map's .moves outside "
                            "cache/rebalance.py (forked owner sets on "
                            "the delivery plane)",
                        ))
                if (
                    isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "ShardOverrides"
                ):
                    out.append(Finding(
                        rel, node.lineno, "single-writer-overrides",
                        "aliases the ShardOverrides constructor outside "
                        "cache/rebalance.py",
                    ))

    # ------------------------------------------------------------------
    # shard heat
    # ------------------------------------------------------------------

    def _heat(self, rel: str, tree: ast.Module, out: list[Finding]) -> None:
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "ShardHeat"
            ):
                out.append(Finding(
                    rel, node.lineno, "single-writer-heat",
                    "constructs a ShardHeat outside cache/mesh_cache.py "
                    "(single-writer contract)",
                ))
            elif isinstance(node, ast.Attribute) and node.attr in _HEAT_NOTES:
                # Any access — a call counts traffic; a bare alias load
                # is the grep-invisible way to smuggle the call out.
                out.append(Finding(
                    rel, node.lineno, "single-writer-heat",
                    f"touches the heat counter {node.attr}() outside "
                    "cache/mesh_cache.py — the same traffic would be "
                    "double-counted",
                ))
            elif (
                isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Name)
                and node.value.id == "ShardHeat"
            ):
                out.append(Finding(
                    rel, node.lineno, "single-writer-heat",
                    "aliases the ShardHeat constructor outside "
                    "cache/mesh_cache.py",
                ))

    # ------------------------------------------------------------------
    # send seam (mesh_cache only)
    # ------------------------------------------------------------------

    def _send_seam(self, rel: str, tree: ast.Module, out: list[Finding]) -> None:
        allowed_spans: list[tuple[int, int]] = []
        for qual, cls, fn in iter_functions(tree):
            if fn.name in ALLOWED_TRY_SEND:
                allowed_spans.append((fn.lineno, fn.end_lineno or fn.lineno))
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                continue
            if node.func.attr == "send":
                out.append(Finding(
                    rel, node.lineno, "send-seam",
                    "raw .send( in mesh_cache.py — a blocking, failure-"
                    "detection-blind network touch; use the bounded "
                    "try_send seam",
                ))
            elif node.func.attr == "try_send":
                if not any(a <= node.lineno <= b for a, b in allowed_spans):
                    out.append(Finding(
                        rel, node.lineno, "send-seam",
                        "try_send outside the allowed seam methods "
                        f"{ALLOWED_TRY_SEND} — route new network writes "
                        "through the sender loop or a documented "
                        "dedicated-channel method",
                    ))
