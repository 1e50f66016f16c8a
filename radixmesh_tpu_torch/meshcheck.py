"""meshcheck CLI: run the AST-based static-analysis plane over the port.

Runs every checker (``radixmesh_tpu_torch/analysis/``) over the
``radixmesh_tpu_torch`` package, runs the positive-control fixtures
(``tests/fixtures/analysis/`` and ``tests/fixtures/analysis_torch/``),
prints findings as ``file:line: [invariant-id] message``, and optionally
writes the round's schema-pinned ``ANALYSIS_torch_r{N}.json`` artifact
(validated against ``analysis.report.validate_analysis`` before writing
— a violation is recorded in the artifact, not silently shipped). The
plane reads source only: it imports nothing it checks and needs no card.

Exit status (pinned — commit hooks branch on it):
  0 = tree clean AND all positive controls tripped
  1 = findings (or a blind checker) — fix or justify in-source
  2 = framework error: the run itself could not happen (missing
      fixtures, git unavailable in --changed mode, refused flags)

Usage::

    python -m radixmesh_tpu_torch.meshcheck                # full tree
    python -m radixmesh_tpu_torch.meshcheck --changed      # changed files
                                                           #   + reverse-import deps
    python -m radixmesh_tpu_torch.meshcheck --json         # full report
    python -m radixmesh_tpu_torch.meshcheck --write-artifact
    python -m radixmesh_tpu_torch.meshcheck --write-artifact --out X.json
    python -m radixmesh_tpu_torch.meshcheck --no-fixtures  # skip controls
    python -m radixmesh_tpu_torch.meshcheck --root DIR --no-fixtures

``--changed`` analyzes the WHOLE tree (one parse is the cheap part;
cross-module checkers need full context) but reports only findings in
files touched by ``git diff HEAD`` / untracked files, widened to every
module that transitively imports one (``analysis.changed_scope``).
Positive controls are skipped in --changed mode unless a file under
``analysis/`` changed — a checker edit must re-prove its controls.

The artifact's default name is not the JAX package's ``ANALYSIS_r{N}``:
``scripts/meshcheck.py`` counts its rounds from those names, and this
CLI never writes over one of its files.

The quick CI gate runs the same plane in-process as ONE test:
``tests/test_torch_analysis.py::test_tree_is_clean``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

from radixmesh_tpu_torch.analysis import all_checkers, changed_scope, get_thread_map
from radixmesh_tpu_torch.analysis.controls import run_positive_controls
from radixmesh_tpu_torch.analysis.core import PACKAGE, SourceIndex, package_root, run_checkers
from radixmesh_tpu_torch.analysis.report import (
    ANALYSIS_SCHEMA_VERSION,
    build_analysis_report,
    validate_analysis,
)

_REPO_ROOT = str(package_root().parent)
# Every plane's round artifact, and this CLI's own (lower-case "torch":
# the JAX CLI's round pattern, the first one, does not match it).
_ROUND = re.compile(r"[A-Z_]+_r(\d+)\.json")
_OWN = re.compile(r"ANALYSIS_torch_r(\d+)\.json")
_JAX_ANALYSIS = re.compile(r"ANALYSIS_r\d+\.json")


def analysis_round(repo_root: str = _REPO_ROOT) -> int:
    """The round in progress = 1 + the highest N across every OTHER
    plane's recorded ``*_r{N}.json`` artifact (ANALYSIS rides whatever
    round they are on). An existing ``ANALYSIS_torch`` artifact at/after
    that round is OVERWRITTEN only when it already carries the current
    schema version (a rerun of this round); an older-schema artifact is
    history — a schema bump starts the next round instead of clobbering
    it."""
    rounds = [0]
    own = []
    for name in os.listdir(repo_root):
        m = _OWN.fullmatch(name)
        if m:
            own.append((int(m.group(1)), name))
            continue
        m = _ROUND.fullmatch(name)
        if m and not name.startswith("ANALYSIS_"):
            rounds.append(int(m.group(1)))
    base = max(rounds) + 1
    for n, name in sorted(own):
        if n < base:
            continue
        try:
            with open(os.path.join(repo_root, name)) as fh:
                version = json.load(fh).get("schema_version", 1)
        except (OSError, ValueError):
            version = None
        base = n if version == ANALYSIS_SCHEMA_VERSION else n + 1
    return base


def _jax_artifact(path: str) -> bool:
    """Whether ``path`` is (or would be taken for) the JAX package's
    ANALYSIS artifact: its round name, or an existing report of its
    package."""
    if _JAX_ANALYSIS.fullmatch(os.path.basename(path)):
        return True
    try:
        with open(path) as fh:
            return json.load(fh).get("package") not in (None, PACKAGE)
    except (OSError, ValueError, AttributeError):
        return False


def git_changed_files() -> list[str] | None:
    """Package-relative paths of changed + untracked ``radixmesh_tpu_torch``
    modules, or None when git itself fails (framework error)."""
    out: set[str] = set()
    for cmd in (
        ["git", "diff", "--name-only", "HEAD"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        try:
            proc = subprocess.run(
                cmd, cwd=_REPO_ROOT, capture_output=True, text=True,
                timeout=30,
            )
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode != 0:
            return None
        out.update(ln.strip() for ln in proc.stdout.splitlines() if ln.strip())
    prefix = PACKAGE + "/"
    return [
        path[len(prefix):] for path in sorted(out)
        if path.startswith(prefix) and path.endswith(".py")
    ]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--root", default=None,
        help="package directory to analyze (default: radixmesh_tpu_torch)",
    )
    ap.add_argument(
        "--fixtures", default=None,
        help="positive-control fixtures root (default: "
        "tests/fixtures/analysis and tests/fixtures/analysis_torch)",
    )
    ap.add_argument(
        "--no-fixtures", action="store_true",
        help="skip the positive-control pass (a clean verdict then "
        "proves less; the artifact writer refuses this mode)",
    )
    ap.add_argument(
        "--changed", action="store_true",
        help="report only findings in git-changed files plus their "
        "reverse-import dependents (the per-commit gate)",
    )
    ap.add_argument("--json", action="store_true", help="print the full report")
    ap.add_argument(
        "--write-artifact", action="store_true",
        help="write the round's ANALYSIS_torch_r{N}.json to the repo root",
    )
    ap.add_argument("--out", default=None, help="artifact path override")
    args = ap.parse_args(argv)

    if args.changed and args.write_artifact:
        print(
            "meshcheck: refusing --write-artifact with --changed (the "
            "round artifact must cover the whole tree)",
            file=sys.stderr,
        )
        return 2
    if args.write_artifact and args.no_fixtures:
        print(
            "meshcheck: refusing --write-artifact with --no-fixtures "
            "(the schema gates on positive controls)",
            file=sys.stderr,
        )
        return 2
    if args.write_artifact and args.out and _jax_artifact(args.out):
        print(
            f"meshcheck: refusing to write {args.out}: that is the JAX "
            "package's ANALYSIS artifact",
            file=sys.stderr,
        )
        return 2

    root = args.root or package_root()
    index = SourceIndex(root)
    result = run_checkers(index, all_checkers())
    thread_map = get_thread_map(index)
    scope: set[str] | None = None

    run_fixtures = not args.no_fixtures
    if args.changed:
        changed = git_changed_files()
        if changed is None:
            print("meshcheck: git diff failed — cannot scope", file=sys.stderr)
            return 2
        scope = changed_scope(index, changed)
        # Fixture controls re-run per commit only when checker code
        # itself changed — a checker edit must re-prove it still trips.
        run_fixtures = run_fixtures and any(
            rel.startswith("analysis/") for rel in changed
        )
        # Scope the WHOLE accounting, not just the headline list — a
        # --json consumer reconciling value/findings against the
        # per-checker counts must never see a contradiction.
        result.findings = [f for f in result.findings if f.file in scope]
        result.raw_by_checker = {
            k: [f for f in v if f.file in scope]
            for k, v in result.raw_by_checker.items()
        }
        result.kept_by_checker = {
            k: [f for f in v if f.file in scope]
            for k, v in result.kept_by_checker.items()
        }
        result.suppressed = [
            (f, s) for f, s in result.suppressed if f.file in scope
        ]

    controls = []
    if run_fixtures:
        controls = run_positive_controls(args.fixtures)
        if not controls:
            print(
                "meshcheck: no positive-control fixtures found "
                "(tests/fixtures/analysis, tests/fixtures/analysis_torch) "
                "— a clean tree proves nothing",
                file=sys.stderr,
            )
            return 2

    report = build_analysis_report(
        result, controls, len(index.modules), thread_map.roots
    )
    blind = [c for c in controls if not c.tripped]

    if args.json:
        print(json.dumps(report, indent=1))
    else:
        for f in result.findings:
            print(f)
        for c in blind:
            print(
                f"POSITIVE CONTROL MISSED: {c.fixture} {c.invariant} at "
                f"{c.file}:{c.line}"
            )
        scoped = (
            "" if scope is None
            else f" (scope: {len(scope)}/{len(index.modules)} changed+dependent files)"
        )
        print(
            f"meshcheck: {len(index.modules)} files, "
            f"{len(thread_map.roots)} thread roots, "
            f"{len(result.findings)} finding(s), "
            f"{len(result.suppressed)} suppressed by "
            f"{len(result.suppressions)} justification(s), "
            f"{sum(c.tripped for c in controls)}/{len(controls)} "
            f"controls tripped{scoped}"
        )

    if args.write_artifact:
        path = args.out or os.path.join(
            _REPO_ROOT, f"ANALYSIS_torch_r{analysis_round():02d}.json"
        )
        problems = validate_analysis(report)
        if problems:
            report["schema_violation"] = problems
            print(f"meshcheck: SCHEMA VIOLATION {problems}", file=sys.stderr)
        with open(path, "w") as fh:
            json.dump(report, fh, indent=1)
            fh.write("\n")
        print(f"meshcheck: wrote {os.path.basename(path)}")

    return 0 if (not result.findings and not blind) else 1


if __name__ == "__main__":
    sys.exit(main())
