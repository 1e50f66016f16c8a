"""Speculation/token-plane acceptance bench over the port: the SPEC
artifact's command line (``scripts/specbench.py`` of the JAX package).

Runs ``workload.run_spec_workload`` (one engine driven through
repeat-then-replay prompt schedules so both draft sources land) and holds
the four token-plane verdicts: acceptance (draft-token conservation on
every verify path), itl (real inter-token percentiles and a seeded stall
attributed to ``scheduler_wait``), adaptive (the adaptive-gamma arm's
goodput no worse than the fixed arm's) and overhead (the token-append
path under 1% of the wall at a 1k tok/s cadence).

Prints ONE JSON line validated against ``reports.validate_spec``; exit 1 on
a schema violation, 2 on a refused ``--out``.

Usage::

    python -m radixmesh_tpu_torch.scripts.specbench [--seed 0] [--gamma 4] \\
        [--device cuda|cpu] [--model llama3-8b|toy] [--out FILE] [--write-artifact]
"""

from __future__ import annotations

import argparse
import sys

from radixmesh_tpu_torch import reports
from radixmesh_tpu_torch.scripts._cli import add_engine_args, refuse_jax_out, scenario_cfg
from radixmesh_tpu_torch.workload import run_spec_workload


def run(seed: int, gamma: int, overhead_tokens: int, *, cfg=None, device=None) -> dict:
    res = run_spec_workload(seed=seed, gamma=gamma, overhead_tokens=overhead_tokens, cfg=cfg, device=device)
    return reports.checked(reports.build_spec_report(res), reports.validate_spec)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="specbench")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gamma", type=int, default=4, metavar="N",
                    help="base speculative draft width for both A-B arms (the adaptive arm may clamp "
                    "below it, never above)")
    ap.add_argument("--overhead-tokens", type=int, default=1000, metavar="N",
                    help="synthetic appends for the overhead row (judged against wall at a 1k tok/s "
                    "decode cadence)")
    add_engine_args(ap)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--write-artifact", action="store_true",
                    help="write the round's SPEC_torch_r{N}.json to the repo root")
    args = ap.parse_args(argv)
    if refuse_jax_out("specbench", "SPEC", args.out):
        return 2
    report = run(args.seed, args.gamma, args.overhead_tokens, cfg=scenario_cfg(args), device=args.device)
    return reports.emit(report, "specbench", "SPEC", args.out, args.write_artifact)


if __name__ == "__main__":
    sys.exit(main())
