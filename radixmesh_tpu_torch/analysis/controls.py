"""Positive-control harness: prove every checker still trips.

A static-analysis gate that reports "clean" is only evidence if the
checkers demonstrably still SEE the bug classes they claim to. Each
fixture under ``tests/fixtures/analysis/<name>/`` (the trees written
for the JAX package's checkers, read here as data: they only need to
parse) and ``tests/fixtures/analysis_torch/<name>/`` (this package's
own: the torch device-sync vocabulary, the plain-import call edge) is
a miniature package tree with a deliberately seeded defect; this
module runs the full default checker set over each fixture and
verifies that every seeded marker trips with the right invariant-id at
the right file:line.

Marker grammar (inside fixture files):

- ``# seeded: <invariant-id>[, <invariant-id>...]`` — trailing comment:
  a finding with each listed invariant must land on THIS line.
- ``# seeded-at: <rel-path>:<line> <invariant-id>`` — remote form, for
  lines where a trailing comment would change what is being tested
  (e.g. a malformed suppression directive).

``python -m radixmesh_tpu_torch.meshcheck`` embeds the results in the
ANALYSIS artifact (``positive_controls``), and
``analysis.report.validate_analysis`` fails the
artifact if any control did not trip — the analysis-plane equivalent of
the old lint tests' ``test_positive_control_*`` methods, but enforced
for every checker uniformly.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path

from .core import SourceIndex, package_root, run_checkers

__all__ = [
    "ControlExpectation",
    "run_positive_controls",
    "default_fixtures_root",
    "default_fixtures_roots",
]

_SEEDED = re.compile(r"#\s*seeded:\s*(?P<ids>[a-z0-9\-]+(?:\s*,\s*[a-z0-9\-]+)*)")
_SEEDED_AT = re.compile(
    r"#\s*seeded-at:\s*(?P<rel>\S+):(?P<line>\d+)\s+(?P<id>[a-z0-9\-]+)"
)


@dataclass
class ControlExpectation:
    """One seeded defect and whether the run reproduced it."""

    fixture: str
    invariant: str
    file: str  # fixture-relative posix path
    line: int
    tripped: bool = False

    def as_dict(self) -> dict:
        return {
            "fixture": self.fixture,
            "invariant": self.invariant,
            "file": self.file,
            "line": self.line,
            "tripped": self.tripped,
        }


def default_fixtures_root() -> Path:
    """``tests/fixtures/analysis`` resolved from the repo checkout this
    package was imported from (the fixtures are not shipped in wheels —
    callers outside a checkout pass an explicit root)."""
    return package_root().parent / "tests" / "fixtures" / "analysis"


def default_fixtures_roots() -> tuple[Path, ...]:
    """Every default fixtures root: the shared trees, then this
    package's own (``tests/fixtures/analysis_torch``)."""
    shared = default_fixtures_root()
    return (shared, shared.parent / "analysis_torch")


def run_positive_controls(
    fixtures_root: Path | str | None = None,
    checker_factory=None,
) -> list[ControlExpectation]:
    """Run the default checkers over every fixture tree; return one
    expectation per seeded marker with its tripped verdict. An empty
    return means a fixtures directory is missing — callers treat that
    as a failure (controls that cannot run prove nothing)."""
    from . import all_checkers

    factory = checker_factory or all_checkers
    roots = (Path(fixtures_root),) if fixtures_root else default_fixtures_roots()
    if not all(root.is_dir() for root in roots):
        return []
    out: list[ControlExpectation] = []
    fixture_dirs = [
        p for root in roots for p in sorted(root.iterdir()) if p.is_dir()
    ]
    for fixture_dir in fixture_dirs:
        index = SourceIndex(fixture_dir)
        expectations = _collect_expectations(fixture_dir.name, index)
        if not expectations:
            continue
        # Markers match the UNSUPPRESSED findings — a control asserts
        # what the gate would actually fail on. Fixtures carry no
        # justification comments by design (stale flagging is therefore
        # irrelevant and off).
        result = run_checkers(index, factory(), flag_stale=False)
        hits = {(f.file, f.line, f.invariant) for f in result.findings}
        for exp in expectations:
            exp.tripped = (exp.file, exp.line, exp.invariant) in hits
            out.append(exp)
    return out


def _collect_expectations(
    fixture: str, index: SourceIndex
) -> list[ControlExpectation]:
    out: list[ControlExpectation] = []
    for mod in index.iter_modules():
        for i, text in enumerate(mod.source.splitlines(), start=1):
            m = _SEEDED.search(text)
            if m:
                for inv in re.split(r"\s*,\s*", m.group("ids")):
                    out.append(ControlExpectation(fixture, inv, mod.rel, i))
            m = _SEEDED_AT.search(text)
            if m:
                out.append(ControlExpectation(
                    fixture, m.group("id"), m.group("rel"),
                    int(m.group("line")),
                ))
    return out
