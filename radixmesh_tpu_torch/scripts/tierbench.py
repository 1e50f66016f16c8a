"""Durable-tier acceptance bench over the port: the TIER artifact's
command line (``scripts/tierbench.py`` of the JAX package).

Runs ``workload.run_tier_workload``: capacity (the hit rate at a working
set of at least 10x the host arena beats the no-tier baseline), restore
overlap (decode keeps stepping while requests park behind staged disk
restores) and the cold cell (killed mid-decode, one extent bit-flipped and
one truncated, restarted from the extent directory alone: no failed
request, every interrupted stream resumed byte-identical, corrupt extents
detected and never served). Then runs the port's meshcheck
(``radixmesh_tpu_torch.analysis``) and keeps the findings that land on the
tier plane: the artifact gates on 0 there, with the ``hotpath-file-io``
positive control tripping.

Prints ONE JSON line validated against ``reports.validate_tier``; exit 1 on
a schema violation, 2 on a refused ``--out``.

Usage::

    python -m radixmesh_tpu_torch.scripts.tierbench [--seed 0] [--device cuda|cpu] \\
        [--model llama3-8b|toy] [--out FILE] [--write-artifact]
"""

from __future__ import annotations

import argparse
import sys

from radixmesh_tpu_torch import reports
from radixmesh_tpu_torch.scripts._cli import add_engine_args, refuse_jax_out, scenario_cfg
from radixmesh_tpu_torch.workload import run_tier_workload

# The durability plane meshcheck must report clean for the artifact to
# gate green.
PLANE_FILES = ("cache/kv_tier.py", "cache/kv_transfer.py", "cache/host_cache.py")


def meshcheck_plane() -> dict:
    """The port's full checker set over its tree, keeping the findings that
    land on the tier plane's files (a full-tree parse: ``hotpath-file-io``
    is about OTHER modules' call chains reaching this plane's I/O), and the
    ``hotpath-file-io`` positive control tripping (a clean verdict from a
    blind checker is not a verdict)."""
    from radixmesh_tpu_torch.analysis import check_tree
    from radixmesh_tpu_torch.analysis.controls import run_positive_controls

    plane_findings = [
        f for f in check_tree().findings
        if f.file in PLANE_FILES or f.invariant == "hotpath-file-io" or "kv_tier" in f.message
    ]
    fio = [c for c in run_positive_controls() if c.invariant == "hotpath-file-io"]
    control_ok = bool(fio) and all(c.tripped for c in fio)
    return {
        "files": list(PLANE_FILES),
        "findings": len(plane_findings) + (0 if control_ok else 1),
        "clean": not plane_findings and control_ok,
        "file_io_controls": len(fio),
        "file_io_controls_tripped": sum(c.tripped for c in fio),
        "detail": [str(f) for f in plane_findings[:16]],
    }


def run(seed: int, *, cfg=None, device=None) -> dict:
    res = run_tier_workload(seed=seed, cfg=cfg, device=device)
    return reports.checked(reports.build_tier_report(res, meshcheck=meshcheck_plane()), reports.validate_tier)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="tierbench")
    ap.add_argument("--seed", type=int, default=0)
    add_engine_args(ap)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--write-artifact", action="store_true",
                    help="write the round's TIER_torch_r{N}.json to the repo root")
    args = ap.parse_args(argv)
    if refuse_jax_out("tierbench", "TIER", args.out):
        return 2
    report = run(args.seed, cfg=scenario_cfg(args), device=args.device)
    return reports.emit(report, "tierbench", "TIER", args.out, args.write_artifact)


if __name__ == "__main__":
    sys.exit(main())
