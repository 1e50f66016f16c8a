"""Black-box acceptance bench over the port: the BLACKBOX artifact's
command line (``scripts/blackboxbench.py`` of the JAX package).

Runs ``workload.run_blackbox_workload``: a healthy phase with every doctor
rule silent, a zipf storm onto one shard, a hard kill of its hot owner,
and a post-mortem from the dumps alone (``obs/doctor.py``'s
``postmortem_report`` over the observer's and the victim's black boxes)
that names the hot shard, the victim's crash window and its truncated
dump.

Prints ONE JSON line validated against ``reports.validate_blackbox``; exit
1 on a schema violation, 2 on a refused ``--out``.

Usage::

    python -m radixmesh_tpu_torch.scripts.blackboxbench [--seed 0] [--replication-factor 3] \\
        [--history-interval 0.25] [--keep-dumps DIR] [--device cuda|cpu] \\
        [--model llama3-8b|toy] [--out FILE] [--write-artifact]
"""

from __future__ import annotations

import argparse
import sys

from radixmesh_tpu_torch import reports
from radixmesh_tpu_torch.scripts._cli import add_engine_args, refuse_jax_out, scenario_cfg
from radixmesh_tpu_torch.workload import run_blackbox_workload


def run(seed: int, replication_factor: int, history_interval_s: float, blackbox_dir: str | None, *, cfg=None,
        device=None) -> dict:
    res = run_blackbox_workload(seed=seed, replication_factor=replication_factor,
                                history_interval_s=history_interval_s, blackbox_dir=blackbox_dir, cfg=cfg,
                                device=device)
    return reports.checked(reports.build_blackbox_report(res), reports.validate_blackbox)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="blackboxbench")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replication-factor", type=int, default=3, metavar="RF",
                    help="sharding factor for the mesh under test (the hot-owner kill needs RF > 0; "
                    "the acceptance run pins 3)")
    ap.add_argument("--history-interval", type=float, default=0.25, metavar="SECONDS",
                    help="telemetry-history sample cadence for the run (production default is 1 s; "
                    "the acceptance run samples faster so the storm and the crash land in the "
                    "rings quickly)")
    ap.add_argument("--keep-dumps", default=None, metavar="DIR",
                    help="write the observer + victim black-box dumps under DIR and keep them "
                    "(default: a temp dir, removed after the run); point "
                    "`python -m radixmesh_tpu_torch.doctor --blackbox` at DIR/observer to replay "
                    "the post-mortem")
    add_engine_args(ap)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--write-artifact", action="store_true",
                    help="write the round's BLACKBOX_torch_r{N}.json to the repo root")
    args = ap.parse_args(argv)
    if refuse_jax_out("blackboxbench", "BLACKBOX", args.out):
        return 2
    report = run(args.seed, args.replication_factor, args.history_interval, args.keep_dumps,
                 cfg=scenario_cfg(args), device=args.device)
    return reports.emit(report, "blackboxbench", "BLACKBOX", args.out, args.write_artifact)


if __name__ == "__main__":
    sys.exit(main())
