"""Wire-kind exhaustiveness, verified structurally.

The oplog protocol's forward-compat contract (``cache/oplog.py``): every
kind added AFTER the unknown-kind pass-through tolerance (``PREFETCH``
and everything newer) must be registered in ``EXTENSION_KINDS`` so an
old wire forwards it instead of raising — and every kind the mesh
actually speaks must have an encode site and an explicit receive branch
BEFORE the data-apply default, so a non-data payload can never fall
through and corrupt a replica's tree.

The old lint verified this by substring (``"OplogType.X" in src``); this
checker reads structure:

- ``wire-unregistered`` — an ``OplogType`` member declared at/after
  ``PREFETCH`` that is not a member of the ``EXTENSION_KINDS`` set
  display (reported at the member's declaration line).
- ``wire-no-encode`` — a kind in ``EXTENSION_KINDS``/``DATA_KINDS``
  that is never passed as a call argument anywhere in the package
  (``Oplog(OplogType.K, ...)`` or through a sender helper like
  ``send_repair(rank, OplogType.K, ...)``) — dead vocabulary.
- ``wire-no-receive`` — a kind in ``EXTENSION_KINDS``/``DATA_KINDS``
  with no comparison against ``OplogType.K`` inside any
  ``oplog_received`` function — the frame would fall through to the
  data-apply default.
- ``wire-data-kinds`` — ``DATA_KINDS`` drifted from the exact
  replicated-tree-op set {INSERT, DELETE, RESET} that drives
  early-probe arming.
"""

from __future__ import annotations

import ast

from .core import Checker, Finding, SourceIndex, dotted_name, iter_functions

__all__ = ["WireKindsChecker"]

_OPLOG = "cache/oplog.py"
_EXPECTED_DATA = ("INSERT", "DELETE", "RESET")


def _kind_refs(root: ast.AST) -> set[str]:
    """All ``OplogType.K`` member names referenced under ``root``."""
    out = set()
    for node in ast.walk(root):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "OplogType"
        ):
            out.add(node.attr)
    return out


class WireKindsChecker:
    id = "wire-kinds"
    description = (
        "every oplog kind in EXTENSION_KINDS/DATA_KINDS has an encode "
        "site, an explicit receive branch, and (post-tolerance kinds) a "
        "registration — verified structurally, not by substring"
    )
    invariants = (
        "wire-unregistered", "wire-no-encode", "wire-no-receive",
        "wire-data-kinds",
    )

    def check(self, index: SourceIndex) -> list[Finding]:
        if _OPLOG not in index or index.module(_OPLOG).tree is None:
            return []
        tree = index.module(_OPLOG).tree
        members, member_lines = self._enum_members(tree)
        if not members:
            return []
        ext, ext_line = self._set_members(tree, "EXTENSION_KINDS")
        data, data_line = self._set_members(tree, "DATA_KINDS")
        findings: list[Finding] = []

        # 1. Registration: PREFETCH (where the pass-through tolerance
        # shipped) and every later kind must be in EXTENSION_KINDS.
        if "PREFETCH" in members:
            tolerance_at = members.index("PREFETCH")
            for name in members[tolerance_at:]:
                if name not in ext:
                    findings.append(Finding(
                        _OPLOG, member_lines[name], "wire-unregistered",
                        f"OplogType.{name} post-dates the unknown-kind "
                        "pass-through tolerance but is missing from "
                        "EXTENSION_KINDS — an old wire would raise on it "
                        "instead of forwarding",
                    ))

        # 2. DATA_KINDS is pinned to the replicated tree ops.
        if data_line and tuple(sorted(data)) != tuple(sorted(_EXPECTED_DATA)):
            findings.append(Finding(
                _OPLOG, data_line, "wire-data-kinds",
                f"DATA_KINDS is {sorted(data)}, expected exactly "
                f"{sorted(_EXPECTED_DATA)} (it drives early-probe "
                "arming: the kinds whose loss diverges a replica, and "
                "nothing else)",
            ))

        # 3/4. Encode sites + receive branches for the spoken vocabulary.
        spoken = [n for n in members if n in ext or n in data]
        encoded = self._encoded_kinds(index)
        received = self._received_kinds(index)
        for name in spoken:
            if name not in encoded:
                findings.append(Finding(
                    _OPLOG, member_lines.get(name, ext_line or 1),
                    "wire-no-encode",
                    f"OplogType.{name} is registered but never passed "
                    "to any call in the package — no encode site",
                ))
            if name not in received:
                findings.append(Finding(
                    _OPLOG, member_lines.get(name, ext_line or 1),
                    "wire-no-receive",
                    f"OplogType.{name} has no explicit comparison branch "
                    "in any oplog_received — the frame would fall "
                    "through to the data-apply default",
                ))
        return findings

    # ------------------------------------------------------------------

    def _enum_members(self, tree) -> tuple[list[str], dict[str, int]]:
        for node in tree.body:
            if isinstance(node, ast.ClassDef) and node.name == "OplogType":
                names: list[str] = []
                lines: dict[str, int] = {}
                for stmt in node.body:
                    if (
                        isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)
                    ):
                        names.append(stmt.targets[0].id)
                        lines[stmt.targets[0].id] = stmt.lineno
                return names, lines
        return [], {}

    def _set_members(self, tree, set_name: str) -> tuple[set[str], int | None]:
        for node in tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == set_name
            ):
                return _kind_refs(node.value), node.lineno
        return set(), None

    def _encoded_kinds(self, index: SourceIndex) -> set[str]:
        out: set[str] = set()
        for mod in index.iter_modules():
            if mod.tree is None or mod.rel == _OPLOG:
                continue
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    out |= _kind_refs(arg)
        return out

    def _received_kinds(self, index: SourceIndex) -> set[str]:
        out: set[str] = set()
        for mod in index.iter_modules():
            if mod.tree is None:
                continue
            for qual, cls, fn in iter_functions(mod.tree):
                if fn.name != "oplog_received":
                    continue
                for node in ast.walk(fn):
                    if isinstance(node, ast.Compare):
                        out |= _kind_refs(node)
        return out
