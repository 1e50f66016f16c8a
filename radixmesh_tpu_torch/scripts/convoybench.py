"""Prefill-convoy acceptance bench over the port: the CONVOY artifact's
command line (``scripts/convoybench.py`` of the JAX package).

Runs ``workload.run_convoy_workload``: a late short arrival behind long
prefills, the legacy alternating schedule against mixed prefill+decode
waves (TTFT speedup, stall causes, the same tokens in both arms), the
starvation bound of the boost waves, and the dense/bucketed crossover
sweep (the paged pool kernel against the dense leg). With a preset model
the run is float32, so the arms' tokens can be held equal.

Prints ONE JSON line validated against ``reports.validate_convoy``; exit 1
on a schema violation, 2 on a refused ``--out``.

Usage::

    python -m radixmesh_tpu_torch.scripts.convoybench [--seed 0] [--inline-budget 32] \\
        [--max-defer 2] [--reps 5] [--device cuda|cpu] [--model llama3-8b|toy] \\
        [--out FILE] [--write-artifact]
"""

from __future__ import annotations

import argparse
import sys

import torch

from radixmesh_tpu_torch import reports
from radixmesh_tpu_torch.scripts._cli import add_engine_args, refuse_jax_out, scenario_cfg
from radixmesh_tpu_torch.workload import run_convoy_workload


def run(seed: int, inline_budget: int, max_defer: int, reps: int, *, cfg=None, device=None) -> dict:
    res = run_convoy_workload(seed=seed, inline_budget=inline_budget, max_defer=max_defer, reps=reps,
                              cfg=cfg, device=device)
    return reports.checked(reports.build_convoy_report(res), reports.validate_convoy)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="convoybench")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inline-budget", type=int, default=32, metavar="N",
                    help="prefill tokens ridden per mixed wave in the treatment arm (the base arm "
                    "always runs 0 = the legacy alternating schedule)")
    ap.add_argument("--max-defer", type=int, default=2, metavar="N",
                    help="starvation bound: max consecutive prefill-only boost waves before a "
                    "decode-bearing wave is forced")
    ap.add_argument("--reps", type=int, default=5, metavar="N",
                    help="measured A-B iterations per arm (one extra warmup iteration absorbs "
                    "compiles and is discarded)")
    add_engine_args(ap)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--write-artifact", action="store_true",
                    help="write the round's CONVOY_torch_r{N}.json to the repo root")
    args = ap.parse_args(argv)
    if refuse_jax_out("convoybench", "CONVOY", args.out):
        return 2
    report = run(args.seed, args.inline_budget, args.max_defer, args.reps,
                 cfg=scenario_cfg(args, dtype=torch.float32), device=args.device)
    return reports.emit(report, "convoybench", "CONVOY", args.out, args.write_artifact)


if __name__ == "__main__":
    sys.exit(main())
