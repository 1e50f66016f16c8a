"""Self-healing bench over the port: the CHAOS artifact's command line
(``scripts/chaosbench.py`` of the JAX package). Host code alone.

Runs ``workload.run_chaos_workload``: seeded frame loss and a scheduled
partition diverge the replicas of an in-process mesh, and the repair
plane must converge every replica within a bounded number of rounds while
requests keep being served, then go quiet; a graceful drain under loss
and a cold rejoin under a partition; an unclean decode-node kill whose
streams resume from the replicated cache; on a sharded mesh
(``--replication-factor`` > 0) a rebalance under a zipf storm; and a
router kill behind the front door.

Prints ONE JSON line validated against ``reports.validate_chaos``; exit 1
on a schema violation, 2 on a refused ``--out``.

Usage::

    python -m radixmesh_tpu_torch.scripts.chaosbench [--drop-p 0.2] [--partition 10] \\
        [--requests 150] [--round-budget 8] [--seed 0] [--replication-factor 0] \\
        [--no-join-drain] [--join-partition 1.5] [--crash | --no-crash] [--crash-streams 12] \\
        [--no-rebalance] [--no-router-kill] [--out FILE]
"""

from __future__ import annotations

import argparse
import sys

from radixmesh_tpu_torch import reports
from radixmesh_tpu_torch.scripts._cli import refuse_jax_out
from radixmesh_tpu_torch.workload import run_chaos_workload


def run(drop_p: float, partition_s: float, requests: int, round_budget: int, seed: int, join_drain: bool = True,
        join_partition_s: float = 1.5, crash: bool = True, crash_streams: int = 12, replication_factor: int = 0,
        rebalance: bool = True, router_kill: bool = True) -> dict:
    res = run_chaos_workload(drop_p=drop_p, partition_s=partition_s, n_requests=requests,
                             round_budget=round_budget, seed=seed, join_drain=join_drain,
                             join_partition_s=join_partition_s, crash=crash, crash_streams=crash_streams,
                             replication_factor=replication_factor, rebalance=rebalance,
                             router_kill=router_kill)
    return reports.checked(reports.build_chaos_report(res), reports.validate_chaos)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="chaosbench")
    ap.add_argument("--drop-p", type=float, default=0.2)
    ap.add_argument("--partition", type=float, default=10.0, metavar="SECONDS")
    ap.add_argument("--requests", type=int, default=150)
    ap.add_argument("--round-budget", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replication-factor", type=int, default=0, metavar="RF",
                    help="rerun the whole scenario on a SHARDED mesh (cache/sharding.py): inserts "
                    "deliver to RF owner replicas instead of circulating the ring, and every "
                    "convergence gate becomes per-shard/owner-scoped. 0 = full replica")
    ap.add_argument("--no-join-drain", action="store_true",
                    help="skip the membership-lifecycle phases (graceful drain under loss + cold "
                    "rejoin during a partition)")
    ap.add_argument("--join-partition", type=float, default=1.5, metavar="SECONDS",
                    help="partition window the rejoin starts under")
    crash_group = ap.add_mutually_exclusive_group()
    crash_group.add_argument("--crash", dest="crash", action="store_true", default=True,
                             help="run the unclean decode-node kill phase (request resurrection from "
                             "the replicated cache; default on)")
    crash_group.add_argument("--no-crash", dest="crash", action="store_false", help="skip the crash phase")
    ap.add_argument("--crash-streams", type=int, default=12, help="live streams decoding when the kill lands")
    ap.add_argument("--no-rebalance", action="store_true",
                    help="skip the rebalance-under-storm phase (runs only on sharded meshes, "
                    "--replication-factor > 0, anyway)")
    ap.add_argument("--no-router-kill", action="store_true", help="skip the multi-router front-door kill phase")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if refuse_jax_out("chaosbench", "CHAOS", args.out):
        return 2
    report = run(args.drop_p, args.partition, args.requests, args.round_budget, args.seed,
                 join_drain=not args.no_join_drain, join_partition_s=args.join_partition, crash=args.crash,
                 crash_streams=args.crash_streams, replication_factor=args.replication_factor,
                 rebalance=not args.no_rebalance, router_kill=not args.no_router_kill)
    return reports.emit(report, "chaosbench", "CHAOS", args.out)


if __name__ == "__main__":
    sys.exit(main())
