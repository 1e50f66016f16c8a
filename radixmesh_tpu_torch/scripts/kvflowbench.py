"""KV-movement bench over the port: the KVFLOW artifact's command line
(``scripts/kvflowbench.py`` of the JAX package).

Runs ``workload.run_kvflow_workload``: host-tier restores parked behind
the async KV plane while decode keeps stepping, against the synchronous
baseline; one gather per write-back sweep; prefetch hints joined ahead of
their requests.

Prints ONE JSON line validated against ``reports.validate_kvflow``; exit 1
on a schema violation, 2 on a refused ``--out``.

Usage::

    python -m radixmesh_tpu_torch.scripts.kvflowbench [--requests 4] [--prompt-tokens 768] \\
        [--chunk-tokens 512] [--repeats 3] [--seed 0] [--device cuda|cpu] \\
        [--model llama3-8b|toy] [--out FILE]
"""

from __future__ import annotations

import argparse
import sys

from radixmesh_tpu_torch import reports
from radixmesh_tpu_torch.scripts._cli import add_engine_args, refuse_jax_out, scenario_cfg
from radixmesh_tpu_torch.workload import run_kvflow_workload


def run(requests: int, prompt_tokens: int, chunk_tokens: int, repeats: int, seed: int, *, cfg=None,
        device=None) -> dict:
    res = run_kvflow_workload(n_restore_requests=requests, prompt_tokens=prompt_tokens,
                              chunk_tokens=chunk_tokens, repeats=repeats, seed=seed, cfg=cfg, device=device)
    return reports.checked(reports.build_kvflow_report(res), reports.validate_kvflow)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="kvflowbench")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-tokens", type=int, default=768)
    ap.add_argument("--chunk-tokens", type=int, default=512)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    add_engine_args(ap)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if refuse_jax_out("kvflowbench", "KVFLOW", args.out):
        return 2
    report = run(args.requests, args.prompt_tokens, args.chunk_tokens, args.repeats, args.seed,
                 cfg=scenario_cfg(args), device=args.device)
    return reports.emit(report, "kvflowbench", "KVFLOW", args.out)


if __name__ == "__main__":
    sys.exit(main())
