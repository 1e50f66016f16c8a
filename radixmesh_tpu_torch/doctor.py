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

Exit codes: 0 healthy, 1 findings, 2 unreachable, unreadable or a bad
response.

    python -m radixmesh_tpu_torch.doctor [--url http://HOST:PORT] [--watch SECONDS]
    python -m radixmesh_tpu_torch.doctor --blackbox /var/dumps/router@3 [--json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request

__all__ = ["main"]

# Modes of the JAX package's doctor command whose pieces are not ported yet,
# with the ROADMAP.md queue item that brings each.
_NOT_PORTED = {"--workload": "A7b, the artifact command lines (scripts/doctor.py --workload)"}


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
    argv = sys.argv[1:] if argv is None else argv
    for arg in argv:
        flag = arg.split("=", 1)[0]
        if flag in _NOT_PORTED:
            ap.error(f"{flag} is not supported by the PyTorch port yet "
                     f"(see ROADMAP.md, queue {_NOT_PORTED[flag]})")
    args = ap.parse_args(argv)
    if args.blackbox:
        return _postmortem(args.blackbox, args.json)
    return _live(args.url, args.watch)


if __name__ == "__main__":
    sys.exit(main())
