"""meshcheck framework core: source index, checker protocol, suppressions.

The contract every checker plugs into:

- :class:`SourceIndex` parses every product file ONCE (``ast`` + a
  tokenize pass for comments) and hands checkers the trees; no checker
  re-reads the filesystem, so a full run is one pass over the package.
- A checker is anything with an ``id``, a ``description``, and a
  ``check(index) -> list[Finding]`` method (:class:`Checker` protocol).
  Each :class:`Finding` names the violated invariant (a stable
  kebab-case id), the package-relative file, the 1-based line, and a
  human message — the file:line is load-bearing: the CI gate prints it
  and the suppression mechanism matches on it.
- Suppression is IN-SOURCE and justified, never config: a comment

      # meshcheck: ok[<invariant-id>(,<invariant-id>)*] <justification>

  on the offending line (or the line directly above it) excuses exactly
  the named invariants there. The justification text is REQUIRED — a
  bare ``ok[...]`` is itself a finding (``suppression-grammar``), and a
  suppression that no longer matches any finding is flagged
  (``stale-suppression``) so the excuse list can never rot — the same
  positive-control discipline the old grep allowlists enforced by hand.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator, Protocol, Sequence, runtime_checkable

__all__ = [
    "Finding",
    "Suppression",
    "ModuleInfo",
    "SourceIndex",
    "Checker",
    "AnalysisResult",
    "run_checkers",
    "package_root",
    "iter_functions",
    "dotted_name",
    "FRAMEWORK_INVARIANTS",
    "PACKAGE",
]

# The package the analysis plane checks: the name its absolute imports
# carry, matched exactly (``radixmesh_tpu`` is another package).
PACKAGE = "radixmesh_tpu_torch"

# Invariant ids emitted by the framework itself (not by any checker).
FRAMEWORK_INVARIANTS = (
    "syntax-error",
    "suppression-grammar",
    "stale-suppression",
)


@dataclass(frozen=True, order=True)
class Finding:
    """One invariant violation at a concrete source location."""

    file: str  # package-relative posix path, e.g. "cache/mesh_cache.py"
    line: int  # 1-based
    invariant: str  # stable kebab-case id, e.g. "lock-order-cycle"
    message: str

    def __str__(self) -> str:  # the CLI / assertion rendering
        return f"{self.file}:{self.line}: [{self.invariant}] {self.message}"


@dataclass
class Suppression:
    """A parsed justification comment (``ok[...]`` / ``file-ok[...]``)."""

    file: str
    line: int  # where the directive itself sits
    invariants: tuple[str, ...]  # ("*",) suppresses any invariant here
    justification: str
    scope: str = "line"  # "line" | "file"
    anchor: int = 0  # last line of the contiguous comment block
    used: bool = False

    def __post_init__(self):
        if not self.anchor:
            self.anchor = self.line

    def covers(self, finding: Finding) -> bool:
        if finding.file != self.file:
            return False
        # Line scope: the directive's own line (trailing comment), any
        # line of its contiguous comment block, or the first line after
        # the block (comment-above style — multi-line justifications
        # are encouraged). File scope: anywhere in the file (the old
        # per-file grep-allowlist shape, e.g. a load generator that
        # paces its arrivals).
        if self.scope != "file" and not (
            self.line <= finding.line <= self.anchor + 1
        ):
            return False
        return "*" in self.invariants or finding.invariant in self.invariants


# Directive grammar. Valid bodies after the banner are
# ``ok[ids] justification`` (this line / the line below) and
# ``file-ok[ids] justification`` (the whole file — the shape of the old
# per-file grep allowlists). Anything else under the banner is a
# grammar error: a typo with no reason must not silently suppress
# nothing. (The banner is spelled split here so this comment does not
# itself register as a directive.)
_DIRECTIVE = re.compile("#\\s*" + "meshcheck" + ":\\s*(?P<body>.*)$")
_OK = re.compile(
    r"^(?P<scope>file-)?ok\[(?P<ids>[a-z0-9*][a-z0-9*,\- ]*)\]"
    r"\s*(?:[-—–:]\s*)?(?P<why>.*)$"
)


@dataclass
class ModuleInfo:
    """One parsed product file."""

    rel: str  # posix path relative to the package root
    path: Path
    source: str
    tree: ast.Module | None  # None when the file failed to parse
    suppressions: list[Suppression] = field(default_factory=list)
    grammar_errors: list[Finding] = field(default_factory=list)


def _parse_comments(rel: str, source: str) -> tuple[list[Suppression], list[Finding]]:
    """Tokenize-based comment scan: string literals that merely CONTAIN
    the directive text (this module's own docstring, tests) never
    register as suppressions."""
    sups: list[Suppression] = []
    errors: list[Finding] = []
    comment_lines: set[int] = set()
    pending: list[tuple[int, str]] = []  # (line, directive body)
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            comment_lines.add(tok.start[0])
            m = _DIRECTIVE.search(tok.string)
            if not m:
                continue
            line = tok.start[0]
            ok = _OK.match(m.group("body").strip())
            why = ok.group("why").strip() if ok else ""
            if not ok or not why:
                errors.append(Finding(
                    rel, line, "suppression-grammar",
                    "malformed meshcheck directive (grammar: "
                    "'# meshcheck: ok[<invariant-id>] <justification>'; "
                    "the justification is required): "
                    f"{tok.string.strip()!r}",
                ))
                continue
            ids = tuple(
                s.strip() for s in ok.group("ids").split(",") if s.strip()
            )
            scope = "file" if ok.group("scope") else "line"
            pending.append((line, ids, why, scope))
    except tokenize.TokenError:
        pass  # the ast parse reports the syntax error with a location
    for line, ids, why, scope in pending:
        anchor = line
        while anchor + 1 in comment_lines:
            anchor += 1
        sups.append(Suppression(rel, line, ids, why, scope, anchor))
    return sups, errors


def package_root() -> Path:
    """The ``radixmesh_tpu_torch`` package directory (the one this module
    lives in) — the default analysis root for the CLI and the CI gate."""
    return Path(__file__).resolve().parent.parent


class SourceIndex:
    """Every ``*.py`` under ``root``, parsed once.

    ``root`` is a package-shaped directory: checkers address modules by
    posix-relative path (``cache/mesh_cache.py``), which is also how the
    positive-control fixtures mimic the real tree (a fixture directory
    containing ``engine/engine.py`` indexes identically to the product
    package, so checkers run on fixtures unmodified).
    """

    def __init__(self, root: Path | str):
        self.root = Path(root)
        self.modules: dict[str, ModuleInfo] = {}
        self.errors: list[Finding] = []
        for path in sorted(self.root.rglob("*.py")):
            rel = path.relative_to(self.root).as_posix()
            if "__pycache__" in rel:
                continue
            source = path.read_text()
            try:
                tree = ast.parse(source, filename=rel)
            except SyntaxError as e:
                tree = None
                self.errors.append(Finding(
                    rel, int(e.lineno or 1), "syntax-error",
                    f"file does not parse: {e.msg}",
                ))
            sups, gerrs = _parse_comments(rel, source)
            self.modules[rel] = ModuleInfo(rel, path, source, tree, sups, gerrs)

    def __contains__(self, rel: str) -> bool:
        return rel in self.modules

    def module(self, rel: str) -> ModuleInfo:
        return self.modules[rel]

    def iter_modules(self) -> Iterator[ModuleInfo]:
        for rel in sorted(self.modules):
            yield self.modules[rel]

    def suppressions(self) -> list[Suppression]:
        return [s for m in self.iter_modules() for s in m.suppressions]


@runtime_checkable
class Checker(Protocol):
    """What the framework requires of a checker plugin."""

    id: str
    description: str

    def check(self, index: SourceIndex) -> list[Finding]: ...


@dataclass
class AnalysisResult:
    """One full run: what survived suppression, what was excused, and
    the per-checker accounting the artifact schema pins."""

    findings: list[Finding]  # unsuppressed — the gate fails on any
    suppressed: list[tuple[Finding, Suppression]]
    raw_by_checker: dict[str, list[Finding]]
    kept_by_checker: dict[str, list[Finding]]
    suppressions: list[Suppression]

    @property
    def clean(self) -> bool:
        return not self.findings

    def pretty(self) -> str:
        if not self.findings:
            return "meshcheck: tree is clean"
        return "\n".join(str(f) for f in sorted(self.findings))


def run_checkers(
    index: SourceIndex,
    checkers: Sequence[Checker],
    flag_stale: bool = True,
) -> AnalysisResult:
    """Run every checker over the index, apply suppressions, and (in
    full runs) flag suppressions that excuse nothing. Scoped callers —
    the lint-test wrappers running a single checker — pass
    ``flag_stale=False`` because a suppression aimed at a checker that
    is not in ``checkers`` is not stale, just out of scope."""
    sups = index.suppressions()
    raw_by_checker: dict[str, list[Finding]] = {}
    kept_by_checker: dict[str, list[Finding]] = {}
    findings: list[Finding] = []
    suppressed: list[tuple[Finding, Suppression]] = []

    framework = list(index.errors)
    for m in index.iter_modules():
        framework.extend(m.grammar_errors)
    raw_by_checker["framework"] = framework

    seen: set[tuple[str, int, str]] = set()
    for checker in checkers:
        raw = checker.check(index)
        raw_by_checker[checker.id] = raw
        kept_by_checker[checker.id] = []
        for f in sorted(raw):
            key = (f.file, f.line, f.invariant)
            if key in seen:
                continue
            seen.add(key)
            sup = next((s for s in sups if s.covers(f)), None)
            if sup is not None:
                sup.used = True
                suppressed.append((f, sup))
            else:
                findings.append(f)
                kept_by_checker[checker.id].append(f)

    # Framework findings are never suppressible: a malformed directive
    # or an unparseable file must always surface.
    kept_by_checker["framework"] = list(framework)
    findings.extend(framework)

    if flag_stale:
        stale = [
            Finding(
                s.file, s.line, "stale-suppression",
                f"suppression for {','.join(s.invariants)} excuses no "
                f"finding — remove it (justification was: "
                f"{s.justification!r})",
            )
            for s in sups if not s.used
        ]
        kept_by_checker["framework"].extend(stale)
        raw_by_checker["framework"].extend(stale)
        findings.extend(stale)

    return AnalysisResult(
        findings=sorted(findings),
        suppressed=suppressed,
        raw_by_checker=raw_by_checker,
        kept_by_checker=kept_by_checker,
        suppressions=sups,
    )


# ---------------------------------------------------------------------------
# Shared AST helpers
# ---------------------------------------------------------------------------

def iter_functions(
    tree: ast.Module,
) -> Iterator[tuple[str, str | None, ast.FunctionDef | ast.AsyncFunctionDef]]:
    """Yield ``(qualname, class_name, node)`` for every module-level
    function and every method of a module-level class. Nested defs
    (closures) are analyzed as part of their enclosing function's body
    by checkers that walk, so they are not yielded separately."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, None, node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield f"{node.name}.{sub.name}", node.name, sub


def dotted_name(node: ast.expr) -> str | None:
    """``self.mesh._lock`` → ``"self.mesh._lock"``; None when the
    expression is not a pure attribute chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None
