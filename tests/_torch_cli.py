"""Drive a port command line (``radixmesh_tpu_torch/scripts/``) on a
scenario result that a test module's fixture already computed: the
scenario function the command line calls is replaced by one that records
its arguments and returns a copy of that result, so no scenario runs
twice in the suite. What is held is the command line's own work: the
arguments it passes, the report it builds, validates, prints and writes,
and its exit code."""

from __future__ import annotations

import copy
import json

import bench

from radixmesh_tpu_torch import reports

__all__ = ["run_cli", "hold_report"]


def run_cli(monkeypatch, tmp_path, capsys, module, scenario: str, result: dict, argv: list[str]):
    """``module.main(argv + ["--out", FILE])`` with ``module.<scenario>``
    returning ``result``; returns (exit code, the written report, the
    scenario's keyword arguments)."""
    seen = {}

    def scenario_fn(**kw):
        seen.update(kw)
        return copy.deepcopy(result)

    monkeypatch.setattr(module, scenario, scenario_fn)
    out = tmp_path / "report.json"
    rc = module.main([*argv, "--out", str(out)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    report = json.loads(out.read_text())
    assert json.loads(line) == report
    return rc, report, seen


# The validators' verdicts that read the wall clock, by kind and the start
# of their message: a short scenario on a loaded CPU misses these budgets
# and ratios with nothing wrong in what it computed. SPEC: the adaptive
# controller's goodput ratio and the timeline's share of the wall;
# CONVOY: the late arrival's TTFT ratio, the mixed arm's ITL p99, the
# convoy's seconds per request and the crossover sweep's timings;
# BLACKBOX: the history sampler's share of the wall; AGG: the pulls' share
# of the wall and one sweep against the pull cadence; DOCTOR: the prefill
# convoy rule, which fires when a long prompt's prefill dominates its e2e
# (the reduced run of ``test_torch_workload_doctor.py`` does so only now
# and then). Every other verdict is held.
WALL_CLOCK = {
    "spec": ("adaptive: goodput ratio ", "overhead: timeline cost "),
    "convoy": ("interleave: late-arrival TTFT ratio ", "interleave: mixed decode ITL p99 ",
               "stalls: prefill_convoy s/req drop ratio ", "crossover: small-batch effective path ",
               "crossover: bucketed wrapper "),
    "blackbox": ("history: sampler overhead ",),
    "agg": ("overhead: aggregation cost ", "fan_in: one sweep took "),
    "doctor": ("pathologies.prefill_convoy: ",),
}


def hold_report(kind: str, rc: int, report: dict) -> list[str]:
    """The port's validator and the JAX package's find the same problems in
    the written report, and none but ``WALL_CLOCK``'s verdicts of its kind;
    the command line recorded as many in ``schema_violation`` (the messages
    may quote a dict in another key order: the file is written with its
    keys sorted) and exits 1 on them, else 0. Returns the problems."""
    problems = getattr(reports, f"validate_{kind}")(report)
    assert problems == getattr(bench, f"validate_{kind}")(report)
    exempt = WALL_CLOCK.get(kind, ())
    assert [p for p in problems if not p.startswith(exempt)] == [], problems
    recorded = report.get("schema_violation", [])
    assert len(recorded) == len(problems) and all(p.startswith(exempt) for p in recorded), (recorded, problems)
    assert rc == (1 if problems else 0), (rc, problems)
    return problems
