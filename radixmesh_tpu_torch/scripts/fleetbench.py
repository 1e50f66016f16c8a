"""Fleet-telemetry bench over the port: the FLEET artifact's command line
(``scripts/fleetbench.py`` of the JAX package). Host code alone.

Runs ``workload.run_fleet_churn_workload``: digest fan-in across an
in-process ring, fingerprint convergence under multi-writer churn and an
injected divergence (detected and healed), and the health score's
reaction to an injected stall (the stalled node demoted).

Prints ONE JSON line validated against ``reports.validate_fleet``; exit 1
on a schema violation, 2 on a refused ``--out``.

Usage::

    python -m radixmesh_tpu_torch.scripts.fleetbench [--inserts 120] [--interval 0.1] \\
        [--fan-in-rounds 5] [--seed 0] [--out FILE]
"""

from __future__ import annotations

import argparse
import sys

from radixmesh_tpu_torch import reports
from radixmesh_tpu_torch.scripts._cli import refuse_jax_out
from radixmesh_tpu_torch.workload import run_fleet_churn_workload


def run(inserts: int, interval_s: float, fan_in_rounds: int, seed: int) -> dict:
    res = run_fleet_churn_workload(n_inserts=inserts, digest_interval_s=interval_s,
                                   fan_in_rounds=fan_in_rounds, seed=seed)
    return reports.checked(reports.build_fleet_report(res), reports.validate_fleet)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="fleetbench")
    ap.add_argument("--inserts", type=int, default=120)
    ap.add_argument("--interval", type=float, default=0.1)
    ap.add_argument("--fan-in-rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if refuse_jax_out("fleetbench", "FLEET", args.out):
        return 2
    report = run(args.inserts, args.interval, args.fan_in_rounds, args.seed)
    return reports.emit(report, "fleetbench", "FLEET", args.out)


if __name__ == "__main__":
    sys.exit(main())
