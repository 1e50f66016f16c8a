"""Fleet-aggregation acceptance bench over the port: the AGG artifact's
command line (``scripts/aggbench.py`` of the JAX package).

Runs ``workload.run_agg_workload``: a router's ``FleetAggregator`` pulling
every node's history; the merged TTFT p99 within one bucket of the raw
records', a seeded straggler named by rank, the p99 exemplar stitched to
its span, a killed node surfacing as a telemetry gap, and a fan-in sweep
over ``--sim-peers`` synthetic rings within its overhead budget.

Prints ONE JSON line validated against ``reports.validate_agg``; exit 1 on
a schema violation, 2 on a refused ``--out``.

Usage::

    python -m radixmesh_tpu_torch.scripts.aggbench [--seed 0] [--replication-factor 3] \\
        [--history-interval 0.2] [--agg-interval 0.25] [--sim-peers 200] [--device cuda|cpu] \\
        [--model llama3-8b|toy] [--out FILE] [--write-artifact]
"""

from __future__ import annotations

import argparse
import sys

from radixmesh_tpu_torch import reports
from radixmesh_tpu_torch.scripts._cli import add_engine_args, refuse_jax_out, scenario_cfg
from radixmesh_tpu_torch.workload import run_agg_workload


def run(seed: int, replication_factor: int, history_interval_s: float, agg_interval_s: float, sim_peers: int,
        *, cfg=None, device=None) -> dict:
    res = run_agg_workload(seed=seed, replication_factor=replication_factor,
                           history_interval_s=history_interval_s, agg_interval_s=agg_interval_s,
                           sim_peers=sim_peers, cfg=cfg, device=device)
    return reports.checked(reports.build_agg_report(res), reports.validate_agg)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="aggbench")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replication-factor", type=int, default=3, metavar="RF",
                    help="sharding factor for the mesh under test (the acceptance run pins 3)")
    ap.add_argument("--history-interval", type=float, default=0.2, metavar="SECONDS",
                    help="per-node telemetry-history sample cadence (production default is 1 s; the "
                    "acceptance run samples faster so verdicts land in the rings quickly)")
    ap.add_argument("--agg-interval", type=float, default=0.25, metavar="SECONDS",
                    help="aggregator pull cadence (production default is 2 s)")
    ap.add_argument("--sim-peers", type=int, default=200, metavar="N",
                    help="synthetic ring count for the fan-in gate (the schema floor is 200; lowering "
                    "it below that fails validation: for local profiling only)")
    add_engine_args(ap)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--write-artifact", action="store_true",
                    help="write the round's AGG_torch_r{N}.json to the repo root")
    args = ap.parse_args(argv)
    if refuse_jax_out("aggbench", "AGG", args.out):
        return 2
    report = run(args.seed, args.replication_factor, args.history_interval, args.agg_interval, args.sim_peers,
                 cfg=scenario_cfg(args), device=args.device)
    return reports.emit(report, "aggbench", "AGG", args.out, args.write_artifact)


if __name__ == "__main__":
    sys.exit(main())
