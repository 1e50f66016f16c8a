"""Rebalance acceptance bench over the port: the REBALANCE artifact's
command line (``scripts/rebalancebench.py`` of the JAX package). Host code
alone.

Runs ``workload.run_chaos_workload`` with a short fault window and only
its rebalance and router-kill phases after it (phases 1-4 are CHAOS's
evidence): on a sharded mesh a zipf storm's skew drops once the decider
boosts the hot shards, with zero failed requests mid-move and the
override version converged fleet-wide; a router killed behind the front
door loses no stream. Then runs the port's meshcheck
(``radixmesh_tpu_torch.analysis``) and keeps the findings that land on
the rebalance plane: the artifact gates on 0 there.

Prints ONE JSON line validated against ``reports.validate_rebalance``;
exit 1 on a schema violation, 2 on a refused ``--out``.

Usage::

    python -m radixmesh_tpu_torch.scripts.rebalancebench [--seed 0] [--replication-factor 2] \\
        [--out FILE] [--write-artifact]
"""

from __future__ import annotations

import argparse
import sys

from radixmesh_tpu_torch import reports
from radixmesh_tpu_torch.scripts._cli import refuse_jax_out
from radixmesh_tpu_torch.workload import run_chaos_workload

# The robustness plane meshcheck must report clean for the artifact to
# gate green.
PLANE_FILES = ("cache/rebalance.py", "router/front_door.py")


def meshcheck_plane() -> dict:
    """The port's full checker set over its tree, keeping the findings that
    land on the rebalance plane's files (a full-tree parse: the
    single-writer contracts are about OTHER modules touching this plane's
    types)."""
    from radixmesh_tpu_torch.analysis import check_tree

    plane_findings = [
        f for f in check_tree().findings
        if f.file in PLANE_FILES or "rebalance" in f.message or "ShardOverrides" in f.message
    ]
    return {
        "files": list(PLANE_FILES),
        "findings": len(plane_findings),
        "clean": not plane_findings,
        "detail": [str(f) for f in plane_findings[:16]],
    }


def run(seed: int, replication_factor: int) -> dict:
    res = run_chaos_workload(
        seed=seed,
        # A short fault window: phases 1-4 are CHAOS's job; this
        # artifact's evidence is the rebalance + router-kill phases.
        partition_s=1.2, partition_delay_s=0.3, n_requests=60, quiesce_window_s=0.8, timeout_s=60.0,
        join_drain=False, crash=False, replication_factor=replication_factor, rebalance=True,
        router_kill=True,
    )
    return reports.checked(reports.build_rebalance_report(res, meshcheck=meshcheck_plane()),
                           reports.validate_rebalance)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="rebalancebench")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replication-factor", type=int, default=2, metavar="RF",
                    help="sharding factor for the mesh under test (must leave the 6-node ring below "
                    "the N <= RF degeneracy or there is nothing to boost onto; the acceptance run "
                    "pins 2)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--write-artifact", action="store_true",
                    help="write the round's REBALANCE_torch_r{N}.json to the repo root")
    args = ap.parse_args(argv)
    if refuse_jax_out("rebalancebench", "REBALANCE", args.out):
        return 2
    report = run(args.seed, args.replication_factor)
    return reports.emit(report, "rebalancebench", "REBALANCE", args.out, args.write_artifact)


if __name__ == "__main__":
    sys.exit(main())
