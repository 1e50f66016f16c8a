"""The ANALYSIS artifact's schema: what ``python -m
radixmesh_tpu_torch.meshcheck --write-artifact`` writes and validates
before writing.

One JSON per round records (a) zero unsuppressed findings over the
package tree, (b) every positive-control fixture tripping its checker —
a "clean" report is only evidence when the controls prove the checkers
still see the bug classes they claim to — and (c) the full
justification-comment ledger, so the excuses are audited, not grepped
for. The fields, the checker ids and the version are the ones the
JAX package's ``bench.validate_analysis`` pins, so one validator reads
both packages' artifacts; ``package`` names which tree was checked.
"""

from __future__ import annotations

from .core import PACKAGE

__all__ = [
    "ANALYSIS_SCHEMA_VERSION",
    "ANALYSIS_CHECKER_IDS",
    "validate_analysis",
    "build_analysis_report",
]

ANALYSIS_SCHEMA_VERSION = 2

# Every checker the default meshcheck run must include — a report that
# silently dropped a checker would read as clean while checking less.
# v2 adds the concurrency plane: thread-roots / guarded-by / protocol.
# v1 artifacts validate against the v1 tuple.
ANALYSIS_CHECKER_IDS_V1 = (
    "lock-order", "single-writer", "hot-path", "wire-kinds",
    "metrics-vocab",
)
ANALYSIS_CHECKER_IDS = ANALYSIS_CHECKER_IDS_V1 + (
    "thread-roots", "guarded-by", "protocol",
)

ANALYSIS_TOP_FIELDS = (
    "schema_version", "metric", "value", "package", "files_indexed",
    "checkers", "findings", "suppressions", "positive_controls", "clean",
)
# v2: the derived thread map rides the artifact (root count + entries) —
# a concurrency verdict is only auditable alongside the roots it assumed.
ANALYSIS_TOP_FIELDS_V2 = ANALYSIS_TOP_FIELDS + ("thread_roots",)
ANALYSIS_CHECKER_FIELDS = (
    "id", "description", "raw_findings", "kept_findings", "suppressed",
)
# v2: per-checker positive-control accounting (count + tripped count).
ANALYSIS_CHECKER_FIELDS_V2 = ANALYSIS_CHECKER_FIELDS + (
    "controls", "controls_tripped",
)
ANALYSIS_CONTROL_FIELDS = ("fixture", "invariant", "file", "line", "tripped")
ANALYSIS_SUPPRESSION_FIELDS = (
    "file", "line", "scope", "invariants", "justification",
)
ANALYSIS_THREAD_ROOT_FIELDS = ("name", "target", "file", "line", "multi", "kind")


def validate_analysis(report) -> list[str]:
    """Schema violations of an ANALYSIS artifact vs the pinned contract
    (empty = valid). Gates: ZERO unsuppressed findings on the tree, all
    default checkers present (version-matched set), every positive
    control tripped, every suppression carrying a non-empty
    justification, and (v2) a non-empty thread map. v1 artifacts stay
    valid against the v1 field/checker sets. Import-safe from artifact
    tests and the meshcheck CLI (no torch, no jax)."""
    if not isinstance(report, dict):
        return ["artifact is not a JSON object"]
    version = report.get("schema_version", 1)
    v2 = isinstance(version, int) and version >= 2
    top_fields = ANALYSIS_TOP_FIELDS_V2 if v2 else ANALYSIS_TOP_FIELDS
    checker_ids = ANALYSIS_CHECKER_IDS if v2 else ANALYSIS_CHECKER_IDS_V1
    checker_fields = (
        ANALYSIS_CHECKER_FIELDS_V2 if v2 else ANALYSIS_CHECKER_FIELDS
    )
    problems = [f for f in top_fields if f not in report]

    findings = report.get("findings")
    if not isinstance(findings, list):
        problems.append("findings is not a list")
    elif findings:
        problems.append(
            f"{len(findings)} unsuppressed finding(s) on the tree — the "
            "gate is zero (fix them or justify in-source)"
        )
    if report.get("clean") is not (findings == []):
        problems.append("clean flag disagrees with the findings list")

    checkers = report.get("checkers")
    if not isinstance(checkers, list):
        problems.append("checkers is not a list")
    else:
        seen = set()
        for c in checkers:
            if not isinstance(c, dict):
                problems.append("checkers entry is not an object")
                continue
            problems += [
                f"checkers[{c.get('id', '?')}].{f}"
                for f in checker_fields if f not in c
            ]
            seen.add(c.get("id"))
        for cid in checker_ids:
            if cid not in seen:
                problems.append(
                    f"checker {cid!r} missing from the report — the run "
                    "checked less than the default plane"
                )

    controls = report.get("positive_controls")
    if not isinstance(controls, list) or not controls:
        problems.append(
            "positive_controls empty — a clean tree proves nothing "
            "unless the checkers demonstrably still trip"
        )
    else:
        for c in controls:
            if not isinstance(c, dict):
                problems.append("positive_controls entry is not an object")
                continue
            problems += [
                f"positive_controls[{c.get('fixture', '?')}].{f}"
                for f in ANALYSIS_CONTROL_FIELDS if f not in c
            ]
            if c.get("tripped") is not True:
                problems.append(
                    f"positive control NOT tripped: {c.get('fixture')} "
                    f"{c.get('invariant')} at {c.get('file')}:"
                    f"{c.get('line')} — the checker went blind"
                )

    sups = report.get("suppressions")
    if isinstance(sups, list):
        for s in sups:
            if not isinstance(s, dict):
                problems.append("suppressions entry is not an object")
                continue
            problems += [
                f"suppressions[{s.get('file', '?')}:{s.get('line', '?')}].{f}"
                for f in ANALYSIS_SUPPRESSION_FIELDS if f not in s
            ]
            if not str(s.get("justification", "")).strip():
                problems.append(
                    f"suppression at {s.get('file')}:{s.get('line')} has "
                    "no justification — that is silencing, not excusing"
                )
    elif sups is not None:
        problems.append("suppressions is not a list")

    if v2:
        roots = report.get("thread_roots")
        if not isinstance(roots, dict):
            problems.append("thread_roots is not an object")
        else:
            count = roots.get("count")
            entries = roots.get("roots")
            if not isinstance(count, int) or count < 1:
                problems.append(
                    "thread_roots.count < 1 — a concurrency plane that "
                    "found no thread roots checked nothing"
                )
            if not isinstance(entries, list) or len(entries) != (count or 0):
                problems.append("thread_roots.roots disagrees with count")
            else:
                for r in entries:
                    problems += [
                        f"thread_roots[{r.get('name', '?')}].{f}"
                        for f in ANALYSIS_THREAD_ROOT_FIELDS if f not in r
                    ]
    return problems


def build_analysis_report(
    result, controls, files_indexed: int, thread_roots=None
) -> dict:
    """Assemble a schema-complete ANALYSIS artifact from a framework
    :class:`~radixmesh_tpu_torch.analysis.core.AnalysisResult` plus the
    positive-control expectations (``analysis/controls.py``) and (v2)
    the derived thread map (``analysis/thread_roots.py``)."""
    checkers_meta = []
    from . import all_checkers

    # invariant-id -> checker-id, for the per-checker control counts;
    # framework invariants (syntax/suppression grammar/staleness) are
    # controls on the framework itself.
    owner: dict = {}
    checkers = all_checkers()
    for checker in checkers:
        for inv in getattr(checker, "invariants", ()):
            owner[inv] = checker.id
    for checker in checkers:
        raw = result.raw_by_checker.get(checker.id, [])
        kept = result.kept_by_checker.get(checker.id, [])
        mine = [c for c in controls if owner.get(c.invariant) == checker.id]
        checkers_meta.append({
            "id": checker.id,
            "description": checker.description,
            "raw_findings": len(raw),
            "kept_findings": len(kept),
            "suppressed": len(raw) - len(kept),
            "controls": len(mine),
            "controls_tripped": sum(c.tripped for c in mine),
        })
    root_entries = [r.as_dict() for r in (thread_roots or [])]
    return {
        "schema_version": ANALYSIS_SCHEMA_VERSION,
        "metric": "unsuppressed_findings",
        "value": len(result.findings),
        "package": PACKAGE,
        "files_indexed": files_indexed,
        "thread_roots": {"count": len(root_entries), "roots": root_entries},
        "checkers": checkers_meta,
        "findings": [
            {
                "file": f.file, "line": f.line,
                "invariant": f.invariant, "message": f.message,
            }
            for f in result.findings
        ],
        "suppressions": [
            {
                "file": s.file, "line": s.line, "scope": s.scope,
                "invariants": list(s.invariants),
                "justification": s.justification,
                "used": s.used,
            }
            for s in result.suppressions
        ],
        "positive_controls": [c.as_dict() for c in controls],
        "clean": not result.findings,
    }
