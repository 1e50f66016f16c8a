"""Schema-aware diff of two rounds of one artifact kind (the regression
sentinel's command line, ``scripts/benchdiff.py`` of the JAX package):
``reports.compare_rounds`` over the two files, the pinned metrics of the
kind judged against their thresholds, every other numeric field listed.
Reads either package's artifacts (the schemas are one).

Exit codes (pinned: CI gates on them): 0 clean, 1 regression, 2 schema
mismatch or an unreadable file.

Usage::

    python -m radixmesh_tpu_torch.scripts.benchdiff OLD.json NEW.json [--kind KIND] [--json] \\
        [--threshold-scale X | --strict]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from radixmesh_tpu_torch import reports


def _load(path: str) -> dict:
    with open(path) as fh:
        obj = json.load(fh)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: artifact is not a JSON object")
    return obj


def _fmt_row(row: dict) -> str:
    mark = {"regression": "✗", "improvement": "✓", "ok": "·"}[row["verdict"]]
    rel = "" if row["rel"] is None else f" ({row['rel']:+.1%})"
    return (f"  {mark} {row['path']}: {row['old']} → {row['new']}{rel}"
            f"  [{row['direction']} better, ±{row['threshold']:.0%}]")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="benchdiff")
    ap.add_argument("old", help="baseline artifact (<KIND>_r<N>.json or <KIND>_torch_r<N>.json)")
    ap.add_argument("new", help="candidate artifact (same kind)")
    ap.add_argument("--kind", default=None, help="artifact kind override (else detected from filename/metric)")
    ap.add_argument("--json", action="store_true", help="emit the full diff as JSON")
    ap.add_argument("--threshold-scale", type=float, default=1.0, metavar="X",
                    help="scale every significance threshold (2.0 = twice as lax)")
    ap.add_argument("--strict", action="store_true",
                    help="zero thresholds: ANY adverse move flags (same as --threshold-scale 0)")
    args = ap.parse_args(argv)

    try:
        old, new = _load(args.old), _load(args.new)
    except (OSError, ValueError) as e:  # json.JSONDecodeError is a ValueError
        print(f"benchdiff: cannot read artifact: {e}", file=sys.stderr)
        return reports.BENCHDIFF_EXIT_MISMATCH

    result = reports.compare_rounds(old, new, kind=args.kind, old_name=args.old, new_name=args.new,
                                    threshold_scale=0.0 if args.strict else args.threshold_scale)
    if args.json:
        print(json.dumps(result, indent=1))
    else:
        print(f"benchdiff: {os.path.basename(args.old)} → {os.path.basename(args.new)} "
              f"[kind={result.get('kind')}] status={result['status'].upper()}")
        for m in result.get("mismatches", []):
            print(f"  ! {m}")
        for row in result.get("rows", []):
            print(_fmt_row(row))
        for path in result.get("skipped", []):
            print(f"  - {path}: skipped (absent on one side of a schema-version change)")
        vc = result.get("version_change")
        if vc:
            print(f"  ~ schema_version {vc['old']!r} → {vc['new']!r} (additive bump; diff proceeds)")
        info = result.get("info_changes", [])
        if info:
            print(f"  … {len(info)} unguarded numeric field(s) moved (--json lists them)")
    return {
        "clean": reports.BENCHDIFF_EXIT_CLEAN,
        "regression": reports.BENCHDIFF_EXIT_REGRESSION,
        "schema_mismatch": reports.BENCHDIFF_EXIT_MISMATCH,
    }[result["status"]]


if __name__ == "__main__":
    sys.exit(main())
