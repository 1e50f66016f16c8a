"""Protocol state-machine checking: declared transition tables vs code.

``wire_kinds.py`` proved the structural idea on the oplog vocabulary:
read the DECLARED set off the AST, read the ACTUAL usage off the AST,
and flag the drift. This checker lifts it to state machines. The mesh
has two load-bearing ones — the membership lifecycle
(``policy/lifecycle.py``: BOOTSTRAPPING→ACTIVE→DRAINING→LEFT) and the
request admission lifecycle (``engine/request.py``: QUEUED↔RUNNING /
RESTORING → FINISHED) — and both have had "review hardening" races
where a site transitioned a state the table never allowed. Each
protocol declares its table IN SOURCE (``_VALID_TRANSITIONS`` /
``VALID_TRANSITIONS``, a set of ``(Enum.SRC, Enum.DST)`` tuples); the
checker extracts the actual relation from assignment and compare sites
across the whole package:

- ``protocol-undeclared-transition`` — an assignment
  ``x.state = Enum.DST`` whose SOURCE state is statically known (the
  innermost enclosing ``if`` compares the same ``.state`` expression
  against ``Enum.SRC``) but ``(SRC, DST)`` is not in the declared
  table; or any assignment/transition call whose DST never appears as a
  destination in the table at all. Assignments inside the declared
  transition function (which validates at runtime) and class-body
  defaults are exempt.
- ``protocol-no-exit`` — an enum member with no outgoing edge in the
  table that is not a declared terminal: a state the machine can enter
  but never leave (reported at the member's declaration line).
- ``protocol-unhandled-state`` — a dispatch site (an ``if``/``elif``
  chain comparing one ``.state`` expression against ≥2 distinct members
  with no ``else``) that does not cover every declared state — the
  uncovered state falls through silently, the exact shape of the
  heat-gauge clearing bug and wire_kinds' fall-through-to-data-apply.
- ``protocol-no-table`` — the protocol's module parses but its declared
  table vanished: the whole check would silently become vacuous
  (the stale-suppression rule, applied to the checker's own config).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from .core import Checker, Finding, SourceIndex, dotted_name, iter_functions

__all__ = ["ProtocolChecker", "ProtocolSpec", "DEFAULT_PROTOCOLS"]


@dataclass(frozen=True)
class ProtocolSpec:
    """One checked state machine."""

    name: str
    module: str  # where the enum + table are declared
    enum: str  # enum class name, e.g. "LifecycleState"
    table: str  # module-level set of (Enum.SRC, Enum.DST) tuples
    state_attrs: tuple[str, ...]  # attribute names holding this state
    terminals: tuple[str, ...]  # states that legally have no exit
    # Functions whose bodies assign the state after validating against
    # the table at runtime (the single-writer transition seam).
    transition_fns: tuple[str, ...] = ()


DEFAULT_PROTOCOLS: tuple[ProtocolSpec, ...] = (
    ProtocolSpec(
        name="lifecycle",
        module="policy/lifecycle.py",
        enum="LifecycleState",
        table="_VALID_TRANSITIONS",
        state_attrs=("_state",),
        terminals=("LEFT",),
        transition_fns=("LifecyclePlane._transition", "LifecyclePlane.__init__"),
    ),
    ProtocolSpec(
        name="request",
        module="engine/request.py",
        enum="RequestState",
        table="VALID_TRANSITIONS",
        state_attrs=("state",),
        terminals=("FINISHED",),
        transition_fns=("Request.__init__",),
    ),
)


class ProtocolChecker:
    id = "protocol"
    description = (
        "state machines match their declared transition tables: no "
        "undeclared transition, no non-terminal state without an exit, "
        "no state dispatch that silently drops a declared state"
    )
    invariants = (
        "protocol-undeclared-transition",
        "protocol-no-exit",
        "protocol-unhandled-state",
        "protocol-no-table",
    )

    def __init__(self, protocols=DEFAULT_PROTOCOLS):
        self.protocols = tuple(protocols)

    def check(self, index: SourceIndex) -> list[Finding]:
        findings: list[Finding] = []
        for spec in self.protocols:
            if spec.module not in index:
                continue  # fixture trees mimic one corner of the package
            mod = index.module(spec.module)
            if mod.tree is None:
                continue
            members = self._enum_members(mod.tree, spec.enum)
            if not members:
                continue
            table, table_line = self._table(mod.tree, spec)
            if table_line is None:
                findings.append(Finding(
                    spec.module, 1, "protocol-no-table",
                    f"{spec.enum} has no declared transition table "
                    f"{spec.table!r} — the {spec.name} protocol check "
                    "is vacuous without it",
                ))
                continue
            self._check_exits(spec, members, table, findings)
            for m in index.iter_modules():
                if m.tree is None or m.rel.startswith("analysis/"):
                    continue
                self._check_module(spec, m.rel, m.tree, members, table, findings)
        return findings

    # ------------------------------------------------------------------
    # declarations
    # ------------------------------------------------------------------

    def _enum_members(self, tree, enum_name) -> dict[str, int]:
        for node in tree.body:
            if isinstance(node, ast.ClassDef) and node.name == enum_name:
                out: dict[str, int] = {}
                for stmt in node.body:
                    if (
                        isinstance(stmt, ast.Assign)
                        and len(stmt.targets) == 1
                        and isinstance(stmt.targets[0], ast.Name)
                    ):
                        out[stmt.targets[0].id] = stmt.lineno
                return out
        return {}

    def _table(self, tree, spec) -> tuple[set[tuple[str, str]], int | None]:
        for node in tree.body:
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == spec.table
            ):
                edges: set[tuple[str, str]] = set()
                for elt in ast.walk(node.value):
                    if isinstance(elt, ast.Tuple) and len(elt.elts) == 2:
                        pair = [self._member(e, spec.enum) for e in elt.elts]
                        if None not in pair:
                            edges.add((pair[0], pair[1]))
                return edges, node.lineno
        return set(), None

    @staticmethod
    def _member(node, enum_name) -> str | None:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == enum_name
        ):
            return node.attr
        return None

    def _check_exits(self, spec, members, table, findings) -> None:
        sources = {s for s, _ in table}
        for name, line in members.items():
            if name not in sources and name not in spec.terminals:
                findings.append(Finding(
                    spec.module, line, "protocol-no-exit",
                    f"{spec.enum}.{name} has no outgoing edge in "
                    f"{spec.table} and is not a declared terminal — a "
                    "machine entering it can never leave",
                ))

    # ------------------------------------------------------------------
    # actual transitions + dispatch exhaustiveness
    # ------------------------------------------------------------------

    def _check_module(self, spec, rel, tree, members, table, findings) -> None:
        destinations = {d for _, d in table}
        parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node

        for qual, cls, fn in iter_functions(tree):
            exempt = rel == spec.module and qual in spec.transition_fns
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    dst = self._member(node.value, spec.enum)
                    if dst is None:
                        continue
                    for t in node.targets:
                        attr_chain = dotted_name(t)
                        if attr_chain is None or "." not in attr_chain:
                            continue
                        if attr_chain.rsplit(".", 1)[1] not in spec.state_attrs:
                            continue
                        if exempt:
                            continue
                        src = self._known_source(
                            node, t, attr_chain, spec, parents
                        )
                        if src is not None and (src, dst) not in table:
                            findings.append(Finding(
                                rel, node.lineno,
                                "protocol-undeclared-transition",
                                f"{spec.enum}: transition {src} -> {dst} "
                                f"is not in {spec.module}:{spec.table} — "
                                "declare it or fix the site",
                            ))
                        elif src is None and dst not in destinations:
                            findings.append(Finding(
                                rel, node.lineno,
                                "protocol-undeclared-transition",
                                f"{spec.enum}: assignment to {dst}, which "
                                f"is a destination of NO declared edge in "
                                f"{spec.module}:{spec.table}",
                            ))
                elif isinstance(node, ast.Call):
                    # self._transition(Enum.DST): the runtime validator —
                    # statically, DST must at least be a declared
                    # destination.
                    fname = dotted_name(node.func) or ""
                    short = fname.split(".")[-1]
                    if not any(
                        short == t.split(".")[-1] for t in spec.transition_fns
                    ):
                        continue
                    for arg in node.args:
                        dst = self._member(arg, spec.enum)
                        if dst is not None and dst not in destinations:
                            findings.append(Finding(
                                rel, node.lineno,
                                "protocol-undeclared-transition",
                                f"{spec.enum}: {short}({spec.enum}.{dst}) "
                                f"targets a state that is a destination "
                                f"of NO declared edge in "
                                f"{spec.module}:{spec.table}",
                            ))

            self._check_dispatches(spec, rel, fn, members, findings)

    def _known_source(self, assign, target, attr_chain, spec, parents):
        """The statically-known source state of an assignment: the
        innermost enclosing ``if`` whose test compares the SAME dotted
        ``.state`` chain against one member with ``is``/``==``, with the
        assignment in the body (not orelse). None = unknown (legal —
        most sites transition from several states)."""
        node = assign
        while True:
            parent = parents.get(node)
            if parent is None:
                return None
            if isinstance(parent, ast.If) and node in getattr(parent, "body", []):
                src = self._compare_member(parent.test, attr_chain, spec)
                if src is not None:
                    return src
            node = parent

    def _compare_member(self, test, attr_chain, spec):
        if not (
            isinstance(test, ast.Compare)
            and len(test.ops) == 1
            and isinstance(test.ops[0], (ast.Is, ast.Eq))
        ):
            return None
        if dotted_name(test.left) != attr_chain:
            return None
        return self._member(test.comparators[0], spec.enum)

    def _check_dispatches(self, spec, rel, fn, members, findings) -> None:
        """An if/elif chain testing one ``.state`` expression against ≥2
        distinct members with no else must cover every declared state."""
        chains_seen: set[int] = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.If) or node.lineno in chains_seen:
                continue
            handled: list[str] = []
            subject: str | None = None
            cur: ast.If | None = node
            exhaustive_else = False
            while cur is not None:
                m = self._dispatch_test(cur.test, spec)
                if m is None:
                    handled = []
                    break
                chain_subject, member = m
                if subject is None:
                    subject = chain_subject
                elif subject != chain_subject:
                    handled = []
                    break
                handled.append(member)
                chains_seen.add(cur.lineno)
                if len(cur.orelse) == 1 and isinstance(cur.orelse[0], ast.If):
                    cur = cur.orelse[0]
                elif cur.orelse:
                    exhaustive_else = True
                    cur = None
                else:
                    cur = None
            if exhaustive_else or len(set(handled)) < 2:
                continue
            missing = sorted(set(members) - set(handled))
            if missing:
                findings.append(Finding(
                    rel, node.lineno, "protocol-unhandled-state",
                    f"{spec.enum} dispatch on {subject!r} handles "
                    f"{sorted(set(handled))} with no else — "
                    f"{missing} fall(s) through silently; handle them "
                    "or add an else",
                ))

    def _dispatch_test(self, test, spec):
        """``x.state is Enum.M`` → (dotted subject, member)."""
        if not (
            isinstance(test, ast.Compare)
            and len(test.ops) == 1
            and isinstance(test.ops[0], (ast.Is, ast.Eq))
        ):
            return None
        subject = dotted_name(test.left)
        if subject is None:
            return None
        if subject.rsplit(".", 1)[-1] not in spec.state_attrs:
            return None
        member = self._member(test.comparators[0], spec.enum)
        if member is None:
            return None
        return subject, member
