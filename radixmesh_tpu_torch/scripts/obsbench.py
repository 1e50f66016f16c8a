"""Mesh-wide observability bench over the port: the OBS artifact's
command line (``scripts/obsbench.py`` of the JAX package).

Runs ``workload.run_obs_workload``: a decode node killed mid-stream under
full tracing and the interrupted requests stitched across node tracks in
one Perfetto export; per-shard heat and skew from zipf inserts, the router
naming the hot shard and its owners from gossip alone; the wire gate
(traceless frames unchanged); and, unless ``--no-engine-steps``, the step
accounting of a prefill and a decode wave on an engine.

Prints ONE JSON line validated against ``reports.validate_obs``; exit 1 on
a schema violation, 2 on a refused ``--out``.

Usage::

    python -m radixmesh_tpu_torch.scripts.obsbench [--seed 0] [--replication-factor 3] \\
        [--streams 8] [--zipf-inserts 400] [--no-engine-steps] [--trace-out FILE] \\
        [--device cuda|cpu] [--model llama3-8b|toy] [--out FILE]
"""

from __future__ import annotations

import argparse
import sys

from radixmesh_tpu_torch import reports
from radixmesh_tpu_torch.scripts._cli import add_engine_args, refuse_jax_out, scenario_cfg
from radixmesh_tpu_torch.workload import run_obs_workload


def run(seed: int, replication_factor: int, streams: int, zipf_inserts: int, engine_steps: bool = True,
        stitched_trace_path: str | None = None, *, cfg=None, device=None) -> dict:
    res = run_obs_workload(seed=seed, replication_factor=replication_factor, streams=streams,
                           zipf_inserts=zipf_inserts, engine_steps=engine_steps,
                           stitched_trace_path=stitched_trace_path, cfg=cfg, device=device)
    return reports.checked(reports.build_obs_report(res), reports.validate_obs)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="obsbench")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replication-factor", type=int, default=3, metavar="RF",
                    help="sharding factor for the mesh under test (the heat map and owner-set gate "
                    "need RF > 0; the acceptance run pins 3)")
    ap.add_argument("--streams", type=int, default=8, help="live traced streams decoding when the kill lands")
    ap.add_argument("--zipf-inserts", type=int, default=400,
                    help="total zipf-distributed inserts driving the heat map")
    ap.add_argument("--no-engine-steps", action="store_true",
                    help="skip the engine's step-accounting leg (no model is built)")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="also write the stitched Perfetto trace here")
    add_engine_args(ap)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if refuse_jax_out("obsbench", "OBS", args.out):
        return 2
    report = run(args.seed, args.replication_factor, args.streams, args.zipf_inserts,
                 engine_steps=not args.no_engine_steps, stitched_trace_path=args.trace_out,
                 cfg=scenario_cfg(args), device=args.device)
    return reports.emit(report, "obsbench", "OBS", args.out)


if __name__ == "__main__":
    sys.exit(main())
