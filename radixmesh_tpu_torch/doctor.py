"""The mesh doctor's command line: diagnose a live node, or a dead node from
its black-box dump.

Live mode (the default) reads a frontend's ``GET /cluster/doctor`` (the
doctor runs in the frontend, whose burn-rate windows persist across GETs)
and renders the ranked findings with their evidence; ``--watch SECONDS``
re-reads it until interrupted. Any frontend of either package answers.

Post-mortem mode (``--blackbox DIR``) loads a black-box dump directory
(``obs/blackbox.py``: the finals a SIGTERM, drain, watchdog or ``POST
/admin/blackbox`` wrote, or the bare segments a hard kill left) and replays
the doctor's rules over the recorded history
(``obs/doctor.py::postmortem_report``): hot shards, replication lag, burn
rates at their in-window peaks, tier thrash, and the crash itself
(``node_crash``: health-collapse windows, an unclean end). A router's dump
judges the serving nodes it watched. ``--json`` prints the whole report.

Workload mode (``--workload``) runs the seeded acceptance scenario
(``workload.run_doctor_workload``: a healthy phase, then a hot shard, a
prefill convoy and a parked restore lane, each to be named with its
evidence), attaches the benchdiff sentinel's self-check
(``reports.benchdiff_selfcheck``), and writes the DOCTOR artifact,
validated against ``reports.validate_doctor``: ``DOCTOR_torch_r{N}.json``
in the repo root, or ``--out`` (which may not name a JAX artifact). Its
engines run on the card unless ``--device cpu``, at Llama-3-8B's widths 2
layers deep with the scenario sizes tuned for them, or with ``--model toy``
on the scenario's own model at its own sizes.

Exit codes: 0 healthy (workload mode: all three pathologies named, no
schema violation), 1 findings (or not), 2 unreachable, unreadable, a bad
response or a refused ``--out``.

    python -m radixmesh_tpu_torch.doctor [--url http://HOST:PORT] [--watch SECONDS]
    python -m radixmesh_tpu_torch.doctor --blackbox /var/dumps/router@3 [--json]
    python -m radixmesh_tpu_torch.doctor --workload [--seed 0] [--device cpu --model toy] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import urllib.request

from radixmesh_tpu_torch.scripts._cli import add_engine_args

__all__ = ["main"]


def _render(report: dict) -> None:
    findings = report.get("findings", [])
    checked = report.get("rules_checked", [])
    attached = [k for k, v in report.get("inputs", {}).items() if v]
    if not findings:
        print(f"HEALTHY — {len(checked)} rule(s) ran over planes {attached}, zero findings")
        return
    print(f"{len(findings)} finding(s), ranked (planes {attached}):")
    for i, f in enumerate(findings, 1):
        print(f"  {i}. [{f['rule']}] score={f['score']:.2f}")
        print(f"     {f['summary']}")
        print("     evidence: " + ", ".join(f"{k}={v!r}" for k, v in f["evidence"].items()))


def _live(url: str, watch: float | None) -> int:
    endpoint = url.rstrip("/") + "/cluster/doctor"
    while True:
        try:
            with urllib.request.urlopen(endpoint, timeout=10) as resp:
                report = json.load(resp)
        except Exception as e:  # noqa: BLE001 — any transport failure is the same verdict
            print(f"doctor: {endpoint} unreachable: {e}", file=sys.stderr)
            return 2
        if not isinstance(report, dict) or "findings" not in report:
            print(f"doctor: {endpoint} returned no findings field", file=sys.stderr)
            return 2
        if watch is None:
            _render(report)
            return 0 if report.get("healthy") else 1
        print(f"\n=== {time.strftime('%H:%M:%S')} ===", flush=True)
        _render(report)
        # meshcheck: ok[sleep-audit] the --watch cadence: the sleep IS the
        # requested polling interval of an operator's CLI loop, on no
        # serving thread.
        time.sleep(watch)


def _postmortem(path: str, as_json: bool) -> int:
    from radixmesh_tpu_torch.obs.blackbox import load_blackbox
    from radixmesh_tpu_torch.obs.doctor import postmortem_report

    try:
        dump = load_blackbox(path)
    except (OSError, ValueError) as e:  # json.JSONDecodeError is a ValueError
        print(f"doctor: cannot load black box at {path}: {e}", file=sys.stderr)
        return 2
    report = postmortem_report(dump)
    if as_json:
        print(json.dumps(report, indent=1))
    else:
        state = ("UNCLEAN (segments only — hard kill)" if dump["unclean"]
                 else f"flushed ({', '.join(dump['causes'])})")
        print(f"black box: node {dump['node']!r}, {dump['segments']} segment(s) + "
              f"{dump['finals']} final(s) [{state}], {report['samples']} samples over "
              f"{report['series']} series")
        _render(report)
    return 0 if report.get("healthy") else 1


def _workload(args) -> int:
    from radixmesh_tpu_torch import reports
    from radixmesh_tpu_torch.scripts._cli import DOCTOR_KW, TOY, refuse_jax_out, scenario_cfg
    from radixmesh_tpu_torch.workload import run_doctor_workload

    if refuse_jax_out("doctor", "DOCTOR", args.out):
        return 2
    sizes = {} if args.model == TOY else DOCTOR_KW
    res = run_doctor_workload(seed=args.seed, cfg=scenario_cfg(args), device=args.device, **sizes)
    res["benchdiff"] = reports.benchdiff_selfcheck()
    report = reports.build_doctor_report(res)
    problems = reports.validate_doctor(report)
    if problems:
        report["schema_violation"] = problems
    path = args.out or reports.artifact_path("DOCTOR")
    with open(path, "w") as fh:
        json.dump(report, fh, indent=1, sort_keys=True)
        fh.write("\n")
    named = report["value"]
    print(json.dumps({
        "metric": report["metric"],
        "value": named,
        "healthy_findings": len(report["healthy"]["findings"]),
        "audited": report["attribution"]["audited"],
        "max_sum_error_s": report["attribution"]["max_sum_error_s"],
        "benchdiff": report["benchdiff"],
        "schema_violation": problems or None,
        "artifact": os.path.basename(path),
    }))
    return 0 if named == len(reports.DOCTOR_PATHOLOGIES) and not problems else 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m radixmesh_tpu_torch.doctor")
    ap.add_argument("--url", default="http://127.0.0.1:8000",
                    help="frontend base URL (serving or router; both expose /cluster/doctor)")
    ap.add_argument("--watch", type=float, default=None, metavar="SECONDS",
                    help="re-diagnose every SECONDS (live mode only; ctrl-c to stop)")
    ap.add_argument("--blackbox", default=None, metavar="DIR",
                    help="post-mortem mode: replay the doctor's rules over a black-box dump "
                    "directory instead of a live node (segment-only dumps of a hard kill too)")
    ap.add_argument("--json", action="store_true",
                    help="print the whole post-mortem report as JSON (--blackbox mode)")
    ap.add_argument("--workload", action="store_true",
                    help="run the seeded acceptance workload and write DOCTOR_torch_r{N}.json instead of "
                    "querying a live node")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="workload-mode artifact path (default DOCTOR_torch_r{N}.json)")
    add_engine_args(ap)
    args = ap.parse_args(argv)
    if args.blackbox:
        return _postmortem(args.blackbox, args.json)
    if args.workload:
        return _workload(args)
    return _live(args.url, args.watch)


if __name__ == "__main__":
    sys.exit(main())
