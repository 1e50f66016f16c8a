"""The port's report plane: the schema-pinned artifacts that the command
lines under ``radixmesh_tpu_torch/scripts/`` (and ``python -m
radixmesh_tpu_torch.doctor --workload``) build from a scenario's result,
validate and write.

Each validator, builder and the benchdiff sentinel below is ``bench.py``'s
function, copied with only its imports changed (``tests/test_torch_isolation.py``
compares the code), so one schema reads both packages' artifacts: a
port report passes ``bench.validate_<kind>`` and a JAX report passes the
validator here. The ANALYSIS schema is ``analysis/report.py``'s, re-exported.

The port names its artifacts ``<KIND>_torch_r{N}.json`` (:func:`artifact_path`):
the JAX package's round patterns (``<KIND>_r{N}.json``, upper case only) do
not count them, and a command line refuses to write over a JAX artifact
(:func:`jax_artifact`).
"""

from __future__ import annotations

import json
import os
import re
import sys

from radixmesh_tpu_torch.analysis.report import (  # noqa: F401  (re-exported: one copy of the schema)
    ANALYSIS_CHECKER_IDS,
    ANALYSIS_CHECKER_IDS_V1,
    ANALYSIS_SCHEMA_VERSION,
    build_analysis_report,
    validate_analysis,
)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Any plane's round artifact, the JAX package's (``CHAOS_r08.json``) or the
# port's (``CHAOS_torch_r22.json``).
_ANY_ROUND = re.compile(r"([A-Z][A-Z0-9_]*?)(?:_torch)?_r(\d+)\.json")
# The JAX package's names alone: upper case, no ``_torch``.
_JAX_ROUND = re.compile(r"[A-Z][A-Z0-9_]*_r\d+\.json")


def artifact_round(kind: str, repo_root: str | None = None) -> int:
    """The round in progress = 1 + the highest N across every OTHER plane's
    recorded ``*_r{N}.json`` artifact, the JAX package's and the port's
    (KIND rides whatever round they are on, as ``scripts/*bench.py`` count
    it): a rerun within a round writes over the port's own file of that
    round, never a JAX file."""
    rounds = [0]
    for name in os.listdir(repo_root or _REPO_ROOT):
        m = _ANY_ROUND.fullmatch(name)
        if m and m.group(1) != kind:
            rounds.append(int(m.group(2)))
    return max(rounds) + 1


def artifact_path(kind: str, repo_root: str | None = None) -> str:
    """Where ``--write-artifact`` puts the port's KIND report this round."""
    repo_root = repo_root or _REPO_ROOT
    return os.path.join(repo_root, f"{kind}_torch_r{artifact_round(kind, repo_root):02d}.json")


def jax_artifact(path: str) -> bool:
    """Whether ``path`` names a JAX package artifact (``<KIND>_r{N}.json``),
    which the port never writes over."""
    return bool(_JAX_ROUND.fullmatch(os.path.basename(path)))


def checked(report: dict, validate) -> dict:
    """``report`` with ``schema_violation`` set to ``validate``'s problems
    when there are any (a violation is recorded, never silently shipped)."""
    problems = validate(report)
    if problems:
        report["schema_violation"] = problems
    return report


def emit(report: dict, prog: str, kind: str, out: str | None = None, write_artifact: bool = False) -> int:
    """What every ``scripts/*bench.py`` does with its report: print it as one
    JSON line, write that line to ``out``, write the round's artifact
    (indented, keys sorted) with ``write_artifact``; exit 1 on a schema
    violation, else 0."""
    line = json.dumps(report)
    print(line)
    if out:
        with open(out, "w") as fh:
            fh.write(line + "\n")
    if write_artifact:
        path = artifact_path(kind)
        with open(path, "w") as fh:
            json.dump(report, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"{prog}: wrote {os.path.basename(path)}", file=sys.stderr)
    return 1 if "schema_violation" in report else 0


# ----------------------------------------------------------------------
# RINGBENCH stable schema (an earlier round's artifact lacked
# lap_latency at top level, the next dropped its ratio/paired fields —
# cross-round comparability was eroding). scripts/ringbench.py emits this
# shape every round and validates against it before writing; the schema
# is documented in BASELINE.md. Bump the version ONLY when adding fields
# (fields are never removed or renamed).
# ----------------------------------------------------------------------

RINGBENCH_SCHEMA_VERSION = 2

# Every per-configuration run section must carry these.
RINGBENCH_RUN_FIELDS = (
    "metric", "value", "unit", "transport", "topology",
    "inserts_per_writer", "key_len_tokens", "page_size",
    "wire_bytes_per_insert", "ingest_s_max", "converge_s_max",
    "oplog_applies_per_s", "lap_latency", "route", "wall_s",
)

# The artifact's top level: both configurations (page-granular wire vs
# the token-granular baseline, same keys/inserts), their ratios, and the
# fixed early wire-format reference point.
RINGBENCH_TOP_FIELDS = (
    "schema_version", "metric", "value", "unit", "workload",
    "page_granular", "token_granular_baseline", "bytes_per_insert_ratio",
    "inserts_per_s_ratio", "lap_latency", "round3_wire_bytes_per_insert",
    "vs_round3_wire",
)

# The same 256-token insert cost 2092 wire bytes on the early v2 wire
# (int32 arrays, token-granular) — the fixed denominator of
# ``vs_round3_wire`` (RINGBENCH_r04.json first recorded it).
RINGBENCH_ROUND3_WIRE_BYTES = 2092

RINGBENCH_LAP_FIELDS = ("p50_ms", "p99_ms", "mean_ms", "n")


def validate_ringbench(report: dict) -> list[str]:
    """Missing-field paths of a RINGBENCH artifact vs the pinned schema
    (empty = valid). Import-safe from scripts (no jax at module scope)."""
    missing = [f for f in RINGBENCH_TOP_FIELDS if f not in report]
    for section in ("page_granular", "token_granular_baseline"):
        run = report.get(section)
        if not isinstance(run, dict):
            continue  # the absent section is already reported above
        missing += [
            f"{section}.{f}" for f in RINGBENCH_RUN_FIELDS if f not in run
        ]
        lap = run.get("lap_latency")
        if isinstance(lap, dict):
            missing += [
                f"{section}.lap_latency.{f}"
                for f in RINGBENCH_LAP_FIELDS
                if f not in lap
            ]
    return missing


# ----------------------------------------------------------------------
# RINGSCALE v2 schema (scripts/ringscale.py): the wire-scaling sweep,
# extended by prefix-ownership sharding (cache/sharding.py). v2 adds
# per-row rf/mode (live threaded vs simulated transport — sizes above
# the sim threshold run the real delivery/serialization code over an
# in-memory pump with MODELED hop latency) and the structural gates the
# sharding claim rides on:
#   * FLATNESS — for every rf > 0 row group, bytes-per-insert at the
#     largest N must stay within RINGSCALE_FLATNESS_MAX_RATIO of the
#     smallest N (the O(N) wire wall is broken, not just bent);
#   * PROPAGATION — sharded propagation-to-owners p99 must be no worse
#     than the full-replica ring's p99 at the SMALLEST size, compared
#     within the same hop delay and measurement mode.
# v1 artifacts (no schema_version; full-replica rows only) stay valid.
# ----------------------------------------------------------------------

# v3: the sweep carries at least one owner-propagation row
# measured WITH an adopted ShardOverrides map (a deferred measurement) —
# the override row must pass the same propagation gate as every sharded
# row, and its measured writer-side serial cost must stay within
# RINGSCALE_OVERRIDES_SERIAL_MAX_RATIO of the matching no-override row.
# v1/v2 artifacts stay valid as-is.
RINGSCALE_SCHEMA_VERSION = 3

RINGSCALE_TOP_FIELDS = (
    "schema_version", "metric", "mode", "sizes", "hop_delays_ms", "rfs",
    "results", "bytes_per_insert_growth",
)
RINGSCALE_ROW_FIELDS = (
    "n_nodes", "topology", "rf", "mode", "hop_delay_ms", "frame_bytes",
    "frames_per_insert", "measured_frames_per_insert",
    "ring_bytes_per_insert", "prop_p50_ms", "prop_p99_ms",
)
RINGSCALE_OVERRIDE_ROW_FIELDS = (
    "overrides_active", "boosted_shards", "rf_boost",
    "writer_serial_p50_ms", "writer_serial_p99_ms",
)
RINGSCALE_FLATNESS_MAX_RATIO = 1.5
RINGSCALE_OVERRIDES_SERIAL_MAX_RATIO = 3.0


def validate_ringscale(report) -> list[str]:
    """Schema violations of a RINGSCALE artifact (empty = valid).
    v1 artifacts — ``metric == "ring_scale_sweep"`` with no
    ``schema_version`` — predate sharding and stay valid as-is; v2
    artifacts must carry the per-row fields plus the flatness and
    propagation gates documented above. Import-safe from scripts (no
    jax at module scope)."""
    if not isinstance(report, dict):
        return ["artifact is not a JSON object"]
    if report.get("metric") != "ring_scale_sweep":
        return ["metric is not ring_scale_sweep"]
    if "schema_version" not in report:
        # v1 (pre-sharding): full-replica rows only; minimal contract.
        if not isinstance(report.get("results"), list) or not report["results"]:
            return ["v1 artifact has no results rows"]
        return []
    problems = [f for f in RINGSCALE_TOP_FIELDS if f not in report]
    rows = report.get("results") or []
    if not rows:
        problems.append("results is empty")
    for i, row in enumerate(rows):
        problems += [
            f"results[{i}].{f}" for f in RINGSCALE_ROW_FIELDS if f not in row
        ]
    if problems:
        return problems
    # Flatness gate: sharded bytes-per-insert must be ~independent of N.
    by_group: dict = {}
    for row in rows:
        if int(row.get("rf", 0)) > 0:
            by_group.setdefault(
                (row["rf"], row["hop_delay_ms"]), []
            ).append(row)
    for (rf, delay), group in by_group.items():
        group = sorted(group, key=lambda r: r["n_nodes"])
        if len(group) < 2:
            continue
        lo, hi = group[0], group[-1]
        ratio = hi["ring_bytes_per_insert"] / max(
            1, lo["ring_bytes_per_insert"]
        )
        if ratio > RINGSCALE_FLATNESS_MAX_RATIO:
            problems.append(
                f"flatness: rf={rf} bytes/insert grew {ratio:.2f}x from "
                f"N={lo['n_nodes']} to N={hi['n_nodes']} (max "
                f"{RINGSCALE_FLATNESS_MAX_RATIO}x) — the O(N) wall is back"
            )
    # Propagation gate: sharded owner-propagation p99 no worse than the
    # full-replica ring at the smallest size (same delay + mode — live
    # measurements and modeled sim rows are not comparable).
    for (delay, mode) in {
        (r["hop_delay_ms"], r["mode"]) for r in rows
    }:
        sub = [
            r for r in rows
            if r["hop_delay_ms"] == delay and r["mode"] == mode
        ]
        base = sorted(
            (r for r in sub if int(r.get("rf", 0)) == 0
             and r["topology"] == "ring"),
            key=lambda r: r["n_nodes"],
        )
        sharded = [r for r in sub if int(r.get("rf", 0)) > 0]
        if not base or not sharded:
            continue
        floor = base[0]
        for row in sharded:
            if row["prop_p99_ms"] > floor["prop_p99_ms"]:
                problems.append(
                    f"propagation: rf={row['rf']} N={row['n_nodes']} p99 "
                    f"{row['prop_p99_ms']}ms exceeds the full-replica "
                    f"N={floor['n_nodes']} ring's {floor['prop_p99_ms']}ms "
                    f"(delay={delay}ms, mode={mode})"
                )
    # v3: owner propagation under an ACTIVE override map (the deferred
    # measurement). The override row already rode the propagation gate
    # above (it is a sharded row); additionally its writer-side serial
    # cost — the component a wider owner fan-out actually grows — must
    # stay within ratio of the matching no-override row.
    version = report.get("schema_version")
    if isinstance(version, int) and version >= 3:
        ov_rows = [r for r in rows if r.get("overrides_active")]
        if not ov_rows:
            problems.append(
                "v3 artifact has no overrides_active row — the "
                "owner-propagation-under-overrides measurement is the "
                "version's whole point"
            )
        for row in ov_rows:
            problems += [
                f"override row N={row.get('n_nodes')}: missing {f}"
                for f in RINGSCALE_OVERRIDE_ROW_FIELDS
                if f not in row
            ]
            if int(row.get("rf", 0)) <= 0:
                problems.append(
                    "override row must be sharded (rf > 0): overrides "
                    "mean nothing on a full-replica ring"
                )
            pair = next(
                (
                    r for r in rows
                    if not r.get("overrides_active")
                    and r["n_nodes"] == row["n_nodes"]
                    and r["rf"] == row["rf"]
                    and r["hop_delay_ms"] == row["hop_delay_ms"]
                    and r["mode"] == row["mode"]
                    and "writer_serial_p99_ms" in r
                ),
                None,
            )
            if pair is not None and "writer_serial_p99_ms" in row:
                lim = RINGSCALE_OVERRIDES_SERIAL_MAX_RATIO * max(
                    1e-6, pair["writer_serial_p99_ms"]
                )
                if row["writer_serial_p99_ms"] > lim:
                    problems.append(
                        f"overrides: N={row['n_nodes']} rf={row['rf']} "
                        f"writer-serial p99 {row['writer_serial_p99_ms']}"
                        f"ms exceeds {RINGSCALE_OVERRIDES_SERIAL_MAX_RATIO}x "
                        f"the no-override row's "
                        f"{pair['writer_serial_p99_ms']}ms"
                    )
    return problems


def validate_trace(obj) -> list[str]:
    """Schema violations of a Chrome trace-event artifact emitted by the
    flight recorder (``radixmesh_tpu/obs/trace_plane.py``) — empty list =
    valid. Pinned contract: a JSON object with a ``traceEvents`` list;
    every complete event (``ph == "X"``) carries numeric non-negative
    ``ts``/``dur`` and a ``tid``; within each tid lane the ``ts`` values
    are non-decreasing (Perfetto renders out-of-order lanes, but a
    regression here means the exporter's sort broke). Import-safe from
    artifact tests (no jax at module scope)."""
    problems: list[str] = []
    if not isinstance(obj, dict):
        return ["artifact is not a JSON object"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    last_ts: dict = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"traceEvents[{i}] is not an object")
            continue
        if ev.get("ph") != "X":
            continue  # metadata / instant events carry no duration
        ts, dur, tid = ev.get("ts"), ev.get("dur"), ev.get("tid")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"traceEvents[{i}].ts invalid: {ts!r}")
            continue
        if not isinstance(dur, (int, float)) or dur < 0:
            problems.append(f"traceEvents[{i}].dur invalid: {dur!r}")
        if tid is None:
            problems.append(f"traceEvents[{i}].tid missing")
            continue
        if ts < last_ts.get(tid, 0.0):
            problems.append(
                f"traceEvents[{i}].ts={ts} regresses within tid={tid} "
                f"(prev {last_ts[tid]})"
            )
        last_ts[tid] = ts
    return problems


# ----------------------------------------------------------------------
# FLEET stable schema (fleet telemetry plane): one artifact per
# round recording digest fan-in, fingerprint-convergence behavior under
# churn/divergence, and health-score reaction to an injected stall
# (radixmesh_tpu/obs/fleet_plane.py + workload.run_fleet_churn_workload).
# Bump the version ONLY when adding fields (never remove or rename).
# ----------------------------------------------------------------------

FLEET_SCHEMA_VERSION = 1

FLEET_TOP_FIELDS = (
    "schema_version", "metric", "value", "unit", "workload", "nodes",
    "topology", "digest_interval_s", "digest_bytes", "digest_byte_budget",
    "fan_in", "convergence", "stall_reaction", "health_aware_demotion",
    "digests_published", "digest_frames_per_publish", "wall_s",
)
FLEET_FAN_IN_FIELDS = ("rounds", "p50_s", "max_s")
FLEET_CONVERGENCE_FIELDS = (
    "inserts", "writers", "churn_s", "max_age_during_churn_s",
    "quiesce_to_converged_s", "converged", "injected_divergence_detected",
    "age_while_diverged_s", "healed", "heal_s",
)
FLEET_STALL_FIELDS = (
    "injected", "detected", "reaction_s", "score_after", "threshold",
)


def validate_fleet(report) -> list[str]:
    """Schema violations of a FLEET artifact vs the pinned contract
    (empty = valid): all top/section fields present, the serialized
    digest within its pinned byte budget, and digest ring overhead at
    most one frame per origination. Import-safe from artifact tests (no
    jax at module scope)."""
    if not isinstance(report, dict):
        return ["artifact is not a JSON object"]
    problems = [f for f in FLEET_TOP_FIELDS if f not in report]
    for section, fields in (
        ("fan_in", FLEET_FAN_IN_FIELDS),
        ("convergence", FLEET_CONVERGENCE_FIELDS),
        ("stall_reaction", FLEET_STALL_FIELDS),
    ):
        sec = report.get(section)
        if isinstance(sec, dict):
            problems += [f"{section}.{f}" for f in fields if f not in sec]
    db, budget = report.get("digest_bytes"), report.get("digest_byte_budget")
    if isinstance(db, (int, float)) and isinstance(budget, (int, float)):
        if db > budget:
            problems.append(
                f"digest_bytes {db} exceeds digest_byte_budget {budget}"
            )
    frames = report.get("digest_frames_per_publish")
    if isinstance(frames, (int, float)) and frames > 1.0 + 1e-9:
        problems.append(
            f"digest_frames_per_publish {frames} > 1 (piggyback contract)"
        )
    return problems


def build_fleet_report(res: dict) -> dict:
    """Assemble a schema-complete FLEET artifact from
    ``workload.run_fleet_churn_workload``'s result."""
    from radixmesh_tpu_torch.obs.fleet_plane import DIGEST_BYTE_BUDGET

    conv = res.get("convergence", {})
    return {
        "schema_version": FLEET_SCHEMA_VERSION,
        "metric": "fleet_digest_fan_in_p50_s",
        "value": round(res["fan_in"]["p50_s"], 6),
        "unit": "s (one digest round visible on every node incl. router)",
        "workload": (
            f"{conv.get('inserts', 0)} inserts over "
            f"{conv.get('writers', 0)} writers + injected divergence + "
            "injected stall (inproc ring)"
        ),
        "digest_byte_budget": DIGEST_BYTE_BUDGET,
        **res,
    }


# ----------------------------------------------------------------------
# CHAOS stable schema (self-healing mesh; v2 membership lifecycle; v3
# request recovery): one artifact per round
# recording the chaos acceptance scenario — seeded frame loss + a
# scheduled partition (comm/faults.py) diverge replicas; the
# anti-entropy repair plane (cache/repair_plane.py) must converge every
# replica (router included) within a bounded number of repair rounds
# while requests keep being served, then go quiet.
# v2 adds the elastic-membership phases (policy/lifecycle.py): a
# graceful drain under sustained loss (zero failed requests, in-flight
# requeued-and-served, hot tokens written back, departure via LEAVE —
# never failure detection) and a cold rejoin during an active partition
# (bulk-bootstrap from a donor within the round budget, router
# withholding cache hits until convergence).
# v3 adds the crash phase (server/recovery.py): an UNCLEAN decode-node
# kill mid-stream under loss — zero failed requests, every interrupted
# stream resumed with a byte-identical delivered prefix, resurrection
# served ≥ 0.8 from the replicated cache, every recovery hop bounded by
# the admission deadline budget, hedged prefill first-writer-wins.
# Bump the version ONLY when adding fields (never remove or rename);
# v1/v2 artifacts — which predate the newer sections — stay valid.
# ----------------------------------------------------------------------

CHAOS_SCHEMA_VERSION = 4

CHAOS_TOP_FIELDS = (
    "schema_version", "metric", "value", "unit", "workload", "nodes",
    "topology", "round_budget", "fault_plan", "served", "divergence",
    "repair", "quiescence", "wall_s",
)
CHAOS_FAULT_FIELDS = (
    "seed", "drop_p", "drop_window_s", "partition_s", "partitioned_node",
    "frames_dropped", "frames_delivered",
)
CHAOS_SERVED_FIELDS = ("attempted", "ok", "ok_rate_during_fault")
CHAOS_DIVERGENCE_FIELDS = ("detected", "peak_diverged_pairs", "max_age_s")
CHAOS_REPAIR_FIELDS = (
    "converged", "converge_s", "max_episode_rounds", "within_round_budget",
    "probes_sent", "summaries_sent", "keys_pushed", "oplogs_reemitted",
    "heals",
)
CHAOS_QUIESCENCE_FIELDS = (
    "window_s", "traffic_before", "traffic_after", "quiet",
)
# v2 membership-lifecycle sections. Required when the section reports
# performed=True (a run that skipped the phase ships {"performed":
# false} and is schema-valid but gate-exempt).
CHAOS_DRAIN_FIELDS = (
    "performed", "node", "drop_p", "requeued", "requeued_served",
    "attempted_during_drain", "ok_during_drain", "zero_failed",
    "left_without_failure_detection", "writeback_tokens",
    "writeback_flushed", "drain_s",
)
CHAOS_JOIN_FIELDS = (
    "performed", "joiner", "donor_rank", "partition_active_at_join",
    "partition_s", "bootstrap_converge_s", "bootstrap_rounds",
    "round_budget", "within_round_budget", "converged_with_donor",
    "withheld_hits", "hits_to_bootstrapping",
    "fleet_converged_after_join",
)
# v3 request-recovery section (crash-mid-decode). Required when the
# section reports performed=True; {"performed": false} is schema-valid
# and gate-exempt, like the v2 sections.
CHAOS_CRASH_FIELDS = (
    "performed", "node", "drop_p", "streams", "tokens_per_stream",
    "killed_at_token", "interrupted", "resumed", "failed",
    "prefix_identical", "replayed_tokens", "replayed_cached_tokens",
    "resurrection_hit_ratio", "retries", "resurrections",
    "failover_routes", "detection", "budget", "hedge", "crash_s",
)
# The structural acceptance floor the resurrection claim rides on.
CHAOS_CRASH_MIN_HIT_RATIO = 0.8

# v4 robustness-loop sections: heat-driven rebalancing under a
# zipf storm, and a router kill at an N>=2 multi-router front door.
# Required when performed=True; {"performed": false} is schema-valid
# and gate-exempt, the v2/v3 convention.
CHAOS_REBALANCE_FIELDS = (
    "performed", "skew_before", "skew_after", "skew_dropped", "moves",
    "max_moves_per_round", "moves_bounded", "boosted_shards", "hot_shard",
    "attempted_mid_move", "ok_mid_move", "failed_mid_move",
    "overrides_version", "overrides_converged", "handoff_entries",
    "rebalance_s",
)
CHAOS_ROUTER_KILL_FIELDS = (
    "performed", "routers", "killed", "survivor", "streams",
    "inflight_at_kill", "completed", "failed", "failovers",
    "survivor_served", "router_kill_s",
)


def _rebalance_section_problems(sec: dict) -> list[str]:
    """Gates for a performed rebalance-under-storm section (shared by
    validate_chaos and validate_rebalance): the skew score STRICTLY
    dropped, zero requests failed mid-move, movement happened and
    stayed bounded, and every node converged on the decider's override
    version."""
    problems = [
        f"rebalance.{f}" for f in CHAOS_REBALANCE_FIELDS if f not in sec
    ]
    before, after = sec.get("skew_before"), sec.get("skew_after")
    if (
        not isinstance(before, (int, float))
        or not isinstance(after, (int, float))
        or not (after < before)
    ):
        problems.append(
            f"rebalance: the zipf storm's skew score did not strictly "
            f"drop under rebalancing ({before} -> {after})"
        )
    if sec.get("failed_mid_move", 1) != 0:
        problems.append(
            f"rebalance: {sec.get('failed_mid_move')} request(s) failed "
            "mid-move — an ownership move must be invisible to traffic"
        )
    if not sec.get("moves", 0):
        problems.append(
            "rebalance: zero adopted moves (the storm never triggered "
            "the rebalancer — the drop proves nothing)"
        )
    if sec.get("moves_bounded") is not True:
        problems.append(
            f"rebalance: {sec.get('moves')} moves exceeded the per-round "
            f"bound of {sec.get('max_moves_per_round')}"
        )
    if sec.get("overrides_converged") is not True:
        problems.append(
            "rebalance: the fleet never converged on the decider's "
            "override version (split-brain owner sets)"
        )
    return problems


def _router_kill_section_problems(sec: dict) -> list[str]:
    """Gates for a performed router-kill section: N >= 2 routers, the
    kill landed mid-traffic, every in-flight request completed through
    the surviving router's edge, and the front door actually failed
    over (a kill nobody noticed proves nothing)."""
    problems = [
        f"router_kill.{f}" for f in CHAOS_ROUTER_KILL_FIELDS if f not in sec
    ]
    if int(sec.get("routers", 0) or 0) < 2:
        problems.append(
            f"router_kill: only {sec.get('routers')} router(s) — the "
            "multi-router front door needs N >= 2 to prove failover"
        )
    if sec.get("failed", 1) != 0:
        problems.append(
            f"router_kill: {sec.get('failed')} request(s) LOST to the "
            "router kill — the front door exists to make this zero"
        )
    if sec.get("completed") != sec.get("streams"):
        problems.append(
            "router_kill: in-flight requests did not all complete "
            f"({sec.get('completed')}/{sec.get('streams')})"
        )
    if not sec.get("inflight_at_kill", 0):
        problems.append(
            "router_kill: the kill interrupted zero in-flight streams "
            "(the failover path went unexercised)"
        )
    if not sec.get("failovers", 0):
        problems.append(
            "router_kill: the front door never failed over (was the "
            "victim really killed mid-traffic?)"
        )
    if sec.get("survivor_served") is not True:
        problems.append(
            "router_kill: the surviving router's edge served no "
            "post-kill routes"
        )
    return problems


def validate_chaos(report) -> list[str]:
    """Schema violations of a CHAOS artifact vs the pinned contract
    (empty = valid): all top/section fields present, plus the three
    structural acceptance gates — every replica converged, within the
    repair-round budget, and ZERO repair traffic once converged
    (quiescence). Import-safe from artifact tests and
    ``scripts/chaosbench.py`` (no jax at module scope)."""
    if not isinstance(report, dict):
        return ["artifact is not a JSON object"]
    problems = [f for f in CHAOS_TOP_FIELDS if f not in report]
    for section, fields in (
        ("fault_plan", CHAOS_FAULT_FIELDS),
        ("served", CHAOS_SERVED_FIELDS),
        ("divergence", CHAOS_DIVERGENCE_FIELDS),
        ("repair", CHAOS_REPAIR_FIELDS),
        ("quiescence", CHAOS_QUIESCENCE_FIELDS),
    ):
        sec = report.get(section)
        if isinstance(sec, dict):
            problems += [f"{section}.{f}" for f in fields if f not in sec]
    rep = report.get("repair")
    if isinstance(rep, dict):
        if rep.get("converged") is not True:
            problems.append(
                "repair.converged is not True (replicas never healed)"
            )
        if rep.get("within_round_budget") is not True:
            problems.append(
                f"repair.max_episode_rounds {rep.get('max_episode_rounds')} "
                f"exceeded round_budget {report.get('round_budget')}"
            )
    div = report.get("divergence")
    if isinstance(div, dict) and div.get("detected") is not True:
        problems.append(
            "divergence.detected is not True (the fault injected nothing — "
            "the heal proves nothing)"
        )
    q = report.get("quiescence")
    if isinstance(q, dict) and q.get("quiet") is not True:
        problems.append(
            f"quiescence: repair traffic kept flowing after convergence "
            f"({q.get('traffic_before')} → {q.get('traffic_after')})"
        )
    # v2 membership-lifecycle sections + gates (v1 artifacts predate
    # them and stay valid without).
    v2 = int(report.get("schema_version", 0) or 0) >= 2
    drain = report.get("drain")
    if v2 and not isinstance(drain, dict):
        problems.append("drain section missing (schema v2)")
    if isinstance(drain, dict) and drain.get("performed"):
        problems += [
            f"drain.{f}" for f in CHAOS_DRAIN_FIELDS if f not in drain
        ]
        if drain.get("zero_failed") is not True:
            problems.append(
                "drain: requests failed during the graceful drain "
                f"({drain.get('ok_during_drain')}/"
                f"{drain.get('attempted_during_drain')} ok, "
                f"{drain.get('requeued_served')}/{drain.get('requeued')} "
                "requeued-and-served)"
            )
        if drain.get("requeued_served") != drain.get("requeued"):
            problems.append(
                "drain: parked requests were requeued but not all served "
                f"({drain.get('requeued_served')}/{drain.get('requeued')})"
            )
        if drain.get("left_without_failure_detection") is not True:
            problems.append(
                "drain: the planned departure tripped failure detection "
                "(a 'dead'-cause successor transition fired)"
            )
        if drain.get("writeback_flushed") is not True:
            problems.append(
                "drain: hot prefixes were not written back before LEAVE"
            )
    join = report.get("join")
    if v2 and not isinstance(join, dict):
        problems.append("join section missing (schema v2)")
    if isinstance(join, dict) and join.get("performed"):
        problems += [
            f"join.{f}" for f in CHAOS_JOIN_FIELDS if f not in join
        ]
        if join.get("converged_with_donor") is not True:
            problems.append(
                "join: the bootstrapping node never converged with its "
                "donor"
            )
        if join.get("within_round_budget") is not True:
            problems.append(
                f"join: bootstrap took {join.get('bootstrap_rounds')} "
                f"rounds, over the budget of {join.get('round_budget')}"
            )
        if join.get("hits_to_bootstrapping", 0) != 0:
            problems.append(
                "join: the router routed cache hits to a BOOTSTRAPPING "
                f"node ({join.get('hits_to_bootstrapping')} times)"
            )
        if not join.get("withheld_hits", 0) and not int(
            report.get("replication_factor", 0) or 0
        ):
            # Sharded runs (replication_factor > 0) are exempt: the
            # router routes from owner summaries there, and a COLD
            # joiner advertises no warmth — there is never a hit to
            # withhold, and hits_to_bootstrapping == 0 (gated above) is
            # the whole invariant.
            problems.append(
                "join: the router never withheld a hit during bootstrap "
                "(the withhold path went unexercised — the gate proves "
                "nothing)"
            )
    # v3 request-recovery section + gates (v1/v2 artifacts predate it
    # and stay valid without).
    v3 = int(report.get("schema_version", 0) or 0) >= 3
    crash = report.get("crash")
    if v3 and not isinstance(crash, dict):
        problems.append("crash section missing (schema v3)")
    if isinstance(crash, dict) and crash.get("performed"):
        problems += [
            f"crash.{f}" for f in CHAOS_CRASH_FIELDS if f not in crash
        ]
        if crash.get("failed") != 0:
            problems.append(
                f"crash: {crash.get('failed')} request(s) LOST to the "
                "unclean kill — a node death must be a latency blip, "
                "never a request loss"
            )
        if not crash.get("interrupted", 0):
            problems.append(
                "crash: the kill interrupted zero live streams (the "
                "resurrection path went unexercised — the gate proves "
                "nothing)"
            )
        if crash.get("resumed") != crash.get("interrupted"):
            problems.append(
                "crash: interrupted streams were not all resurrected "
                f"({crash.get('resumed')}/{crash.get('interrupted')})"
            )
        if crash.get("prefix_identical") is not True:
            problems.append(
                "crash: a resumed stream re-emitted, skipped, or "
                "corrupted already-delivered tokens (prefix not "
                "byte-identical)"
            )
        ratio = crash.get("resurrection_hit_ratio")
        if not isinstance(ratio, (int, float)) or (
            ratio < CHAOS_CRASH_MIN_HIT_RATIO
        ):
            problems.append(
                f"crash: resurrection cache-hit ratio {ratio} below "
                f"{CHAOS_CRASH_MIN_HIT_RATIO} — replay recomputed what "
                "the replicated tree should have served"
            )
        budget = crash.get("budget")
        if not isinstance(budget, dict) or (
            budget.get("within_one_backoff") is not True
        ):
            problems.append(
                "crash: a recovered request overran its admission "
                "deadline by more than one retry backoff (the budget "
                "was not threaded through every hop)"
            )
        hedge = crash.get("hedge")
        if isinstance(hedge, dict) and hedge.get("fired"):
            if hedge.get("first_writer_wins") is not True:
                problems.append(
                    "crash: the hedge's first successful writer did "
                    "not win"
                )
            if hedge.get("loser_cancelled") is not True:
                problems.append(
                    "crash: the hedge loser was not cancelled (its "
                    "pages would leak)"
                )
    # v4 robustness-loop sections + gates (v1-v3 artifacts predate them
    # and stay valid without).
    v4 = int(report.get("schema_version", 0) or 0) >= 4
    reb = report.get("rebalance")
    if v4 and not isinstance(reb, dict):
        problems.append("rebalance section missing (schema v4)")
    if isinstance(reb, dict) and reb.get("performed"):
        problems += _rebalance_section_problems(reb)
    rk = report.get("router_kill")
    if v4 and not isinstance(rk, dict):
        problems.append("router_kill section missing (schema v4)")
    if isinstance(rk, dict) and rk.get("performed"):
        problems += _router_kill_section_problems(rk)
    return problems


def build_chaos_report(res: dict) -> dict:
    """Assemble a schema-complete CHAOS artifact from
    ``workload.run_chaos_workload``'s result."""
    fp = res.get("fault_plan", {})
    rep = res.get("repair", {})
    return {
        "schema_version": CHAOS_SCHEMA_VERSION,
        "metric": "chaos_heal_converge_s",
        "value": rep.get("converge_s"),
        "unit": "s from fault-window close to ALL replicas (P/D/router) "
        "pairwise fingerprint-equal via anti-entropy repair",
        "workload": (
            f"{int(100 * fp.get('drop_p', 0))}% seeded frame loss for "
            f"{fp.get('drop_window_s', 0)}s + {fp.get('partition_s', 0)}s "
            f"symmetric partition of {fp.get('partitioned_node')} while "
            "routed requests keep flowing, then a graceful drain under "
            "re-opened loss, a cold rejoin during a fresh partition, "
            "and an unclean decode-node kill mid-stream with "
            "request resurrection from the replicated prefix cache "
            "(inproc ring; see workload.run_chaos_workload)"
        ),
        **res,
    }


# ----------------------------------------------------------------------
# OBS stable schema (mesh-wide observability plane): one artifact
# per round recording the three legs of workload.run_obs_workload —
# (a) cross-node trace stitching (crash+resurrection under full tracing,
# one Perfetto export, interrupted request on >= OBS_MIN_NODE_TRACKS
# node tracks under a single trace id), (b) per-shard heat & skew (zipf
# inserts drive the skew score; the router names the hot shard + owner
# set from gossip alone), and (c) TPU step attribution (per-wave MFU +
# pad fraction for prefill AND decode), plus the wire gate (traceless
# frames bit-for-bit as before the plane). Bump the version ONLY when adding fields
# (never remove or rename).
# ----------------------------------------------------------------------

OBS_SCHEMA_VERSION = 1

OBS_TOP_FIELDS = (
    "schema_version", "metric", "value", "unit", "workload", "nodes",
    "topology", "replication_factor", "stitch", "heat", "steps", "wire",
    "wall_s",
)
OBS_STITCH_FIELDS = (
    "performed", "node", "streams", "tokens_per_stream", "interrupted",
    "resumed", "failed", "trace_id", "node_tracks", "nodes_on_track",
    "replication_edges", "publish_edges", "span_count", "stitched_events",
)
OBS_HEAT_FIELDS = (
    "performed", "inserts", "distinct_keys", "zipf_alpha", "skew_score",
    "hot_shard", "expected_hot_shard", "hot_owners", "expected_hot_owners",
    "owner_set_correct", "reporters",
)
OBS_STEP_FIELDS = ("performed", "n_params", "peak_tflops", "prefill", "decode")
OBS_WAVE_FIELDS = ("waves", "real_tokens", "padded_tokens", "mfu", "pad_fraction")
OBS_WIRE_FIELDS = (
    "rf0_traceless_unchanged", "trace_trailer_roundtrip", "trailer_bytes",
)
# Structural acceptance floors.
OBS_MIN_NODE_TRACKS = 3
OBS_MIN_SKEW_SCORE = 2.0


def validate_obs(report) -> list[str]:
    """Schema violations of an OBS artifact vs the pinned contract
    (empty = valid). Gates: the stitched trace shows the interrupted
    request on >= OBS_MIN_NODE_TRACKS node tracks under ONE trace id
    with replication edges visible and zero lost streams; the zipf hot
    shard is detected with the correct owner set and a skew score above
    the floor; per-wave MFU + pad fraction are reported for BOTH
    prefill and decode; and the traceless wire is bit-for-bit the
    pre-trace encoding. Sections with performed=False are schema-valid
    but gate-exempt (the CHAOS v2/v3 convention). Import-safe from
    artifact tests and scripts/obsbench.py (no jax at module scope)."""
    if not isinstance(report, dict):
        return ["artifact is not a JSON object"]
    problems = [f for f in OBS_TOP_FIELDS if f not in report]
    stitch = report.get("stitch")
    if isinstance(stitch, dict) and stitch.get("performed"):
        problems += [
            f"stitch.{f}" for f in OBS_STITCH_FIELDS if f not in stitch
        ]
        if stitch.get("failed") != 0:
            problems.append(
                f"stitch: {stitch.get('failed')} stream(s) LOST during the "
                "traced crash drill"
            )
        if not stitch.get("interrupted", 0):
            problems.append(
                "stitch: the kill interrupted zero live streams (the "
                "cross-node path went unexercised)"
            )
        if stitch.get("resumed") != stitch.get("interrupted"):
            problems.append(
                "stitch: interrupted streams were not all resurrected "
                f"({stitch.get('resumed')}/{stitch.get('interrupted')})"
            )
        tracks = stitch.get("node_tracks")
        if not isinstance(tracks, int) or tracks < OBS_MIN_NODE_TRACKS:
            problems.append(
                f"stitch: interrupted request spans only {tracks} node "
                f"track(s) (< {OBS_MIN_NODE_TRACKS}) — the journey did "
                "not stitch"
            )
        if not stitch.get("replication_edges", 0):
            problems.append(
                "stitch: no replication edges under the trace id (the "
                "oplog trace trailer never landed receiver-side)"
            )
    heat = report.get("heat")
    if isinstance(heat, dict) and heat.get("performed"):
        problems += [f"heat.{f}" for f in OBS_HEAT_FIELDS if f not in heat]
        skew = heat.get("skew_score")
        if not isinstance(skew, (int, float)) or skew < OBS_MIN_SKEW_SCORE:
            problems.append(
                f"heat: skew score {skew} below {OBS_MIN_SKEW_SCORE} — the "
                "zipf workload failed to drive (or the plane failed to "
                "measure) a hot shard"
            )
        if heat.get("hot_shard") != heat.get("expected_hot_shard"):
            problems.append(
                f"heat: detected hot shard {heat.get('hot_shard')} != "
                f"ground truth {heat.get('expected_hot_shard')}"
            )
        if heat.get("owner_set_correct") is not True:
            problems.append(
                "heat: the hot shard's owner set was not correctly named "
                f"({heat.get('hot_owners')} vs "
                f"{heat.get('expected_hot_owners')})"
            )
        if not heat.get("reporters", 0):
            problems.append("heat: zero heat reporters (gossip never folded)")
    steps = report.get("steps")
    if isinstance(steps, dict) and steps.get("performed"):
        problems += [f"steps.{f}" for f in OBS_STEP_FIELDS if f not in steps]
        for kind in ("prefill", "decode"):
            wave = steps.get(kind)
            if not isinstance(wave, dict):
                continue
            problems += [
                f"steps.{kind}.{f}" for f in OBS_WAVE_FIELDS if f not in wave
            ]
            if not wave.get("waves", 0):
                problems.append(f"steps: zero {kind} waves accounted")
            mfu = wave.get("mfu")
            if not isinstance(mfu, (int, float)) or not (mfu > 0):
                problems.append(
                    f"steps: {kind} MFU {mfu!r} not a positive number"
                )
            pad = wave.get("pad_fraction")
            if not isinstance(pad, (int, float)) or not (0.0 <= pad < 1.0):
                problems.append(
                    f"steps: {kind} pad fraction {pad!r} outside [0, 1)"
                )
    wire = report.get("wire")
    if isinstance(wire, dict):
        problems += [f"wire.{f}" for f in OBS_WIRE_FIELDS if f not in wire]
        if wire.get("rf0_traceless_unchanged") is not True:
            problems.append(
                "wire: a traceless frame is NOT bit-for-bit the pre-trace "
                "encoding (tracing off must cost zero wire bytes)"
            )
        if wire.get("trace_trailer_roundtrip") is not True:
            problems.append("wire: the trace trailer did not round-trip")
    return problems


def build_obs_report(res: dict) -> dict:
    """Assemble a schema-complete OBS artifact from
    ``workload.run_obs_workload``'s result."""
    stitch = res.get("stitch", {})
    heat = res.get("heat", {})
    return {
        "schema_version": OBS_SCHEMA_VERSION,
        "metric": "obs_stitched_node_tracks",
        "value": stitch.get("node_tracks"),
        "unit": (
            "node tracks carrying the interrupted request's spans in ONE "
            "stitched Perfetto trace under a single 64-bit trace id"
        ),
        "workload": (
            f"{stitch.get('streams', 0)} traced streams, busiest decode "
            "node killed mid-stream, resurrection on the survivor "
            f"(rf={res.get('replication_factor')}); zipf(alpha="
            f"{heat.get('zipf_alpha')}) inserts over "
            f"{heat.get('distinct_keys')} subtree roots for the heat map; "
            "tiny-engine burst for step attribution "
            "(see workload.run_obs_workload)"
        ),
        **res,
    }


# ----------------------------------------------------------------------
# KVFLOW stable schema (async KV-movement plane): one artifact per
# round recording restore-stall vs overlapped TTFT, write-back gather
# fusion, and prefetch hit-ahead rate (radixmesh_tpu/cache/kv_transfer.py
# + workload.run_kvflow_workload). Bump the version ONLY when adding
# fields (never remove or rename).
# ----------------------------------------------------------------------

KVFLOW_SCHEMA_VERSION = 1

KVFLOW_TOP_FIELDS = (
    "schema_version", "metric", "value", "unit", "workload",
    "restore", "writeback", "prefetch", "chunk_tokens",
    "ttft_chunk_tokens", "page_size", "wall_s",
)
KVFLOW_RESTORE_FIELDS = (
    "requests", "repeats", "sync_ttft_s", "overlapped_ttft_s",
    "overlap_ratio", "overlap_wins", "sync_ttft_trials_s",
    "overlapped_ttft_trials_s", "sync_restore_ttft_s",
    "overlapped_restore_ttft_s", "sync_fresh_ttft_s",
    "overlapped_fresh_ttft_s", "restored_tokens", "parked_requests",
    "decode_steps_during_restore", "sync_decode_steps_during_restore",
    "max_decode_gap_s", "sync_max_decode_gap_s",
)
KVFLOW_WRITEBACK_FIELDS = (
    "tokens_written_back", "sweeps", "gathers", "gathers_per_sweep",
    "sync_gathers_per_sweep", "evict_stall_s", "sync_evict_stall_s",
)
KVFLOW_PREFETCH_FIELDS = ("hints_sent", "hints_joined", "hit_ahead_rate")


def validate_kvflow(report) -> list[str]:
    """Schema violations of a KVFLOW artifact vs the pinned contract
    (empty = valid): all top/section fields present, plus the two
    deterministic structural contracts — write-back gathers fused to at
    most one per eviction sweep, and decode progress strictly greater
    than the synchronous path's zero while a restore is in flight. The
    TTFT comparison is REPORTED (``overlap_wins``), not schema-gated:
    on CPU it measures scheduling structure against ms-scale noise.
    Import-safe from artifact tests (no jax at module scope)."""
    if not isinstance(report, dict):
        return ["artifact is not a JSON object"]
    problems = [f for f in KVFLOW_TOP_FIELDS if f not in report]
    for section, fields in (
        ("restore", KVFLOW_RESTORE_FIELDS),
        ("writeback", KVFLOW_WRITEBACK_FIELDS),
        ("prefetch", KVFLOW_PREFETCH_FIELDS),
    ):
        sec = report.get(section)
        if isinstance(sec, dict):
            problems += [f"{section}.{f}" for f in fields if f not in sec]
    wb = report.get("writeback")
    if isinstance(wb, dict):
        for key in ("gathers_per_sweep", "sync_gathers_per_sweep"):
            g = wb.get(key)
            if isinstance(g, (int, float)) and g > 1.0 + 1e-9:
                problems.append(
                    f"writeback.{key} {g} > 1 (fused-gather contract)"
                )
    rs = report.get("restore")
    if isinstance(rs, dict):
        a = rs.get("decode_steps_during_restore")
        s = rs.get("sync_decode_steps_during_restore")
        if isinstance(a, (int, float)) and isinstance(s, (int, float)):
            if not a > s:
                problems.append(
                    f"restore.decode_steps_during_restore {a} must exceed "
                    f"the synchronous path's {s} (decode-never-blocks "
                    "contract)"
                )
    return problems


def build_kvflow_report(res: dict) -> dict:
    """Assemble a schema-complete KVFLOW artifact from
    ``workload.run_kvflow_workload``'s result."""
    rs = res.get("restore", {})
    return {
        "schema_version": KVFLOW_SCHEMA_VERSION,
        "metric": "kv_restore_overlapped_ttft_ratio",
        "value": rs.get("overlap_ratio"),
        "unit": "overlapped/sync mean TTFT of a mixed restore+fresh burst "
        "(<= 1: staging restores off the scheduling thread stops fresh "
        "admissions convoying behind inline KV copies)",
        "workload": (
            f"{rs.get('requests', 0)} host-tier restore requests "
            f"interleaved with {rs.get('requests', 0)} fresh requests x "
            f"{rs.get('repeats', 0)} interleaved trials + background-"
            "decode overlap phase + prefetch hit-ahead phase (CPU-sized "
            "engine; see workload.run_kvflow_workload)"
        ),
        **res,
    }


# ----------------------------------------------------------------------
# DOCTOR stable schema (the diagnosis plane): the acceptance
# artifact for ``obs/doctor.py`` + ``obs/attribution.py``. One JSON per
# round recording (a) ZERO findings over a provably healthy cluster
# phase with every rule running, (b) three deterministically seeded
# pathologies each NAMED by the doctor with correct pinned evidence
# (the hot shard's true owner set, the convoying shape, the throttled
# restore lane), (c) the critical-path decomposition summing to e2e
# within epsilon on every audited request, and (d) the benchdiff
# sentinel proving ``compare_rounds`` flags a synthetic regression while
# passing an identical pair. ``workload.run_doctor_workload`` produces
# the data; ``scripts/doctor.py --workload`` emits the artifact. Bump
# the version ONLY when adding fields (never remove or rename).
# ----------------------------------------------------------------------

# v2: the healthy-phase rules_checked gate grew the
# rebalancer_asleep rule. v3: it grew tier_thrash (the durable
# KV tier's flapping detector). v4: it grew the three fleet
# rules (straggler_node, fleet_burn_slope, telemetry_gap) judged over
# the FleetAggregator's cross-node store. v5: it grew the three
# token-plane rules (decode_stall, spec_misconfigured,
# goodput_regression) judged over the per-token timeline, the
# speculation ledger, and the history ring's goodput series. Artifacts
# validate against the rule set pinned for THEIR version (see
# _required_doctor_rules) — a checked-in artifact can never
# retroactively have run a rule that postdates it.
DOCTOR_SCHEMA_VERSION = 5

DOCTOR_TOP_FIELDS = (
    "schema_version", "metric", "value", "unit", "workload", "nodes",
    "topology", "replication_factor", "healthy", "pathologies",
    "attribution", "benchdiff", "wall_s",
)
DOCTOR_HEALTHY_FIELDS = (
    "performed", "findings", "rules_checked", "inputs", "audited_requests",
)
# Every pathology section: did the doctor fire the right rule, and did
# the finding's evidence match the seeded ground truth.
DOCTOR_PATHOLOGY_FIELDS = (
    "performed", "rule", "detected", "evidence_correct", "score",
    "summary", "evidence", "expected",
)
# The three seeded pathologies the acceptance run must name.
DOCTOR_PATHOLOGIES = ("hot_shard", "prefill_convoy", "restore_park_stall")
DOCTOR_ATTRIBUTION_FIELDS = (
    "audited", "refused", "max_sum_error_s", "epsilon_s", "sums_ok",
    "phases",
)
DOCTOR_BENCHDIFF_FIELDS = (
    "identical_clean", "regression_flagged", "mismatch_detected",
)
# |sum(exclusive phase times) - e2e| ceiling per audited request: the
# decomposition is exact by construction (each elementary segment lands
# in exactly one phase), so only float addition error is tolerated.
DOCTOR_SUM_EPSILON_S = 1e-6


# Doctor rules that existed when the v1 DOCTOR/BLACKBOX artifacts were
# pinned. Rules added later (rebalancer_asleep) are required of
# artifacts emitted at HIGHER schema versions only — a checked-in v1
# artifact's healthy phase can never retroactively have run a rule that
# postdates it.
DOCTOR_RULES_V1 = (
    "hot_shard", "prefill_convoy", "restore_park_stall",
    "replication_lag", "slo_burn_rate", "spec_efficiency",
)
DOCTOR_RULES_V2 = DOCTOR_RULES_V1 + ("rebalancer_asleep",)
DOCTOR_RULES_V3 = DOCTOR_RULES_V2 + ("tier_thrash",)
DOCTOR_RULES_V4 = DOCTOR_RULES_V3 + (
    "straggler_node", "fleet_burn_slope", "telemetry_gap",
)


def _required_doctor_rules(report, live_rules) -> list[str]:
    version = int(report.get("schema_version", 0) or 0)
    if version <= 1:
        return [r for r in live_rules if r in DOCTOR_RULES_V1]
    if version == 2:
        return [r for r in live_rules if r in DOCTOR_RULES_V2]
    if version == 3:
        return [r for r in live_rules if r in DOCTOR_RULES_V3]
    if version == 4:
        return [r for r in live_rules if r in DOCTOR_RULES_V4]
    return list(live_rules)


def validate_doctor(report) -> list[str]:
    """Schema violations of a DOCTOR artifact vs the pinned contract
    (empty = valid). Gates: the healthy phase ran ALL rules and found
    nothing; each seeded pathology was detected by its rule with
    evidence matching the seeded ground truth (carrying at least the
    rule's pinned evidence fields); every audited request's phase
    decomposition summed to its e2e within epsilon with zero holed-trace
    refusals; and the benchdiff sentinel passed an identical pair while
    flagging a synthetic regression and a schema mismatch. Sections with
    performed=False are schema-valid but gate-exempt (the CHAOS v2/v3
    convention). Import-safe from artifact tests and scripts/doctor.py
    (no jax at module scope)."""
    from radixmesh_tpu_torch.obs.doctor import RULE_EVIDENCE_FIELDS, RULES

    if not isinstance(report, dict):
        return ["artifact is not a JSON object"]
    problems = [f for f in DOCTOR_TOP_FIELDS if f not in report]
    healthy = report.get("healthy")
    if isinstance(healthy, dict) and healthy.get("performed"):
        problems += [
            f"healthy.{f}" for f in DOCTOR_HEALTHY_FIELDS if f not in healthy
        ]
        if healthy.get("findings") != []:
            problems.append(
                "healthy: the doctor reported findings on the healthy "
                f"phase ({healthy.get('findings')}) — a diagnosis plane "
                "that cries wolf gets muted"
            )
        checked = healthy.get("rules_checked") or []
        missing_rules = [
            r for r in _required_doctor_rules(report, RULES)
            if r not in checked
        ]
        if missing_rules:
            problems.append(
                f"healthy: rules {missing_rules} never ran — 'no findings' "
                "is only evidence when every rule looked"
            )
        if not healthy.get("audited_requests", 0):
            problems.append(
                "healthy: zero audited requests — the healthy verdict "
                "never saw real traffic"
            )
    pathologies = report.get("pathologies")
    if isinstance(pathologies, dict):
        problems += [
            f"pathologies.{p}" for p in DOCTOR_PATHOLOGIES
            if p not in pathologies
        ]
        for name in DOCTOR_PATHOLOGIES:
            sec = pathologies.get(name)
            if not isinstance(sec, dict) or not sec.get("performed"):
                continue
            problems += [
                f"pathologies.{name}.{f}"
                for f in DOCTOR_PATHOLOGY_FIELDS
                if f not in sec
            ]
            if sec.get("detected") is not True:
                problems.append(
                    f"pathologies.{name}: the seeded pathology was NOT "
                    "detected"
                )
            if sec.get("evidence_correct") is not True:
                problems.append(
                    f"pathologies.{name}: finding evidence does not match "
                    f"the seeded ground truth ({sec.get('evidence')} vs "
                    f"expected {sec.get('expected')})"
                )
            ev = sec.get("evidence")
            if isinstance(ev, dict):
                missing_ev = [
                    k
                    for k in RULE_EVIDENCE_FIELDS.get(sec.get("rule"), ())
                    if k not in ev
                ]
                if missing_ev:
                    problems.append(
                        f"pathologies.{name}: evidence missing pinned "
                        f"fields {missing_ev}"
                    )
    attribution = report.get("attribution")
    if isinstance(attribution, dict):
        problems += [
            f"attribution.{f}"
            for f in DOCTOR_ATTRIBUTION_FIELDS
            if f not in attribution
        ]
        if not attribution.get("audited", 0):
            problems.append("attribution: zero audited waterfalls")
        if attribution.get("sums_ok") is not True:
            problems.append(
                "attribution: phase decomposition did NOT sum to e2e "
                f"within epsilon (max error "
                f"{attribution.get('max_sum_error_s')}s > "
                f"{attribution.get('epsilon_s')}s)"
            )
        if attribution.get("refused", 0):
            problems.append(
                f"attribution: {attribution.get('refused')} holed-trace "
                "refusal(s) during the acceptance run (the recorder ring "
                "was sized to lose nothing)"
            )
    bd = report.get("benchdiff")
    if isinstance(bd, dict):
        problems += [
            f"benchdiff.{f}" for f in DOCTOR_BENCHDIFF_FIELDS if f not in bd
        ]
        if bd.get("identical_clean") is not True:
            problems.append(
                "benchdiff: an identical artifact pair did not compare "
                "clean"
            )
        if bd.get("regression_flagged") is not True:
            problems.append(
                "benchdiff: a synthetically regressed artifact was NOT "
                "flagged"
            )
        if bd.get("mismatch_detected") is not True:
            problems.append(
                "benchdiff: a cross-schema pair was NOT rejected as a "
                "mismatch"
            )
    return problems


def build_doctor_report(res: dict) -> dict:
    """Assemble a schema-complete DOCTOR artifact from
    ``workload.run_doctor_workload``'s result."""
    pathologies = res.get("pathologies", {})
    detected = sum(
        1
        for p in DOCTOR_PATHOLOGIES
        if pathologies.get(p, {}).get("detected")
        and pathologies.get(p, {}).get("evidence_correct")
    )
    return {
        "schema_version": DOCTOR_SCHEMA_VERSION,
        "metric": "doctor_pathologies_named",
        "value": detected,
        "unit": (
            f"of {len(DOCTOR_PATHOLOGIES)} deterministically seeded "
            "pathologies named by the mesh doctor with correct pinned "
            "evidence (and zero findings on the healthy phase)"
        ),
        "workload": (
            "healthy balanced phase, then zipf heat storm + convoying "
            "long-prompt burst + throttled restore lane over one rf=3 "
            "inproc cluster and a traced CPU engine "
            "(see workload.run_doctor_workload)"
        ),
        **res,
    }


# ----------------------------------------------------------------------
# BLACKBOX stable schema: the flight-recorder acceptance
# artifact. A node killed mid-zipf-storm must yield black-box dumps
# (obs/blackbox.py) from which the post-mortem doctor
# (obs/doctor.py::postmortem_report) names the seeded hot shard and the
# crash window FROM THE DUMPS ALONE, the live history-backed doctor must
# stay silent on the healthy phase, and the telemetry sampler's
# self-accounted overhead must stay under 1% of the (step-accounting)
# run. scripts/blackboxbench.py is the paired emitter.
# ----------------------------------------------------------------------

# v2: the healthy-phase rules_checked gate grew the
# rebalancer_asleep rule; v3: tier_thrash; v4: the
# three fleet rules (the workload arms an in-proc FleetAggregator for
# its healthy phase); v5: the three token-plane rules
# (decode_stall, spec_misconfigured, goodput_regression). Older
# artifacts validate against their version's pinned rule set
# (_required_doctor_rules).
BLACKBOX_SCHEMA_VERSION = 5

BLACKBOX_TOP_FIELDS = (
    "schema_version", "metric", "value", "unit", "workload", "nodes",
    "topology", "replication_factor", "healthy", "storm", "crash",
    "postmortem", "history", "blackbox", "wall_s",
)
BLACKBOX_HEALTHY_FIELDS = (
    "performed", "findings", "rules_checked", "inputs", "history_samples",
)
BLACKBOX_CRASH_FIELDS = (
    "performed", "victim_rank", "victim_is_hot_owner", "t_kill",
    "observer_detected_live",
)
BLACKBOX_OVERHEAD_FIELDS = (
    "sample_seconds_total", "wall_s", "fraction", "budget_fraction",
    "under_budget",
)
# The three post-mortem verdicts the acceptance run must name from the
# dumps alone.
BLACKBOX_NAMED_TOTAL = 3


def validate_blackbox(report) -> list[str]:
    """Schema violations of a BLACKBOX artifact vs the pinned contract
    (empty = valid). Gates: the healthy phase ran EVERY live rule and
    found nothing; the post-mortem doctor named the seeded hot shard
    and a crash window containing the true kill time from the
    OBSERVER's dump, and the unclean-death truncation from the
    VICTIM's segment-only dump; the victim's dump really is unclean
    (segments, no final); and the sampler's self-accounted overhead
    stayed under its budget. Sections with performed=False are
    schema-valid but gate-exempt (the CHAOS convention). Import-safe
    from artifact tests and scripts (no jax at module scope)."""
    from radixmesh_tpu_torch.obs.doctor import RULES

    if not isinstance(report, dict):
        return ["artifact is not a JSON object"]
    problems = [f for f in BLACKBOX_TOP_FIELDS if f not in report]
    healthy = report.get("healthy")
    if isinstance(healthy, dict) and healthy.get("performed"):
        problems += [
            f"healthy.{f}" for f in BLACKBOX_HEALTHY_FIELDS if f not in healthy
        ]
        if healthy.get("findings") != []:
            problems.append(
                "healthy: the live doctor reported findings on the "
                f"healthy phase ({healthy.get('findings')})"
            )
        missing_rules = [
            r for r in _required_doctor_rules(report, RULES)
            if r not in (healthy.get("rules_checked") or [])
        ]
        if missing_rules:
            problems.append(
                f"healthy: rules {missing_rules} never ran — 'no "
                "findings' is only evidence when every rule looked"
            )
        if not healthy.get("history_samples", 0):
            problems.append(
                "healthy: zero history samples — the rings never saw "
                "the healthy phase"
            )
    crash = report.get("crash")
    if isinstance(crash, dict) and crash.get("performed"):
        problems += [
            f"crash.{f}" for f in BLACKBOX_CRASH_FIELDS if f not in crash
        ]
        if crash.get("victim_is_hot_owner") is not True:
            problems.append(
                "crash: the killed node was not an owner of the hot "
                "shard — the scenario must kill where the storm lives"
            )
        if crash.get("observer_detected_live") is not True:
            problems.append(
                "crash: the observer's rings never recorded the "
                "victim's health collapse"
            )
    pm = report.get("postmortem")
    if isinstance(pm, dict):
        obs = pm.get("observer", {})
        victim = pm.get("victim", {})
        if obs.get("hot_shard_named") is not True:
            problems.append(
                "postmortem: the observer dump did not name the seeded "
                f"hot shard (evidence {obs.get('hot_shard_evidence')} vs "
                f"expected {pm.get('expected')})"
            )
        if obs.get("crash_window_named") is not True:
            problems.append(
                "postmortem: the observer dump's crash window does not "
                f"contain the true kill time (evidence "
                f"{obs.get('crash_evidence')} vs expected "
                f"{pm.get('expected')})"
            )
        if victim.get("truncation_named") is not True:
            problems.append(
                "postmortem: the victim's segment-only dump did not "
                "yield an unclean-death truncation window within one "
                "segment of the kill"
            )
        if victim.get("unclean") is not True:
            problems.append(
                "postmortem: the victim dump is not unclean — a final "
                "flush survived the 'hard kill', so nothing was proven "
                "about crash survival"
            )
    hist = report.get("history")
    if isinstance(hist, dict):
        overhead = hist.get("self_overhead")
        if not isinstance(overhead, dict):
            problems.append("history.self_overhead")
        else:
            problems += [
                f"history.self_overhead.{f}"
                for f in BLACKBOX_OVERHEAD_FIELDS
                if f not in overhead
            ]
            if overhead.get("under_budget") is not True:
                problems.append(
                    "history: sampler overhead "
                    f"{overhead.get('fraction')} exceeded the "
                    f"{overhead.get('budget_fraction')} budget"
                )
    if isinstance(pm, dict) and report.get("value") != BLACKBOX_NAMED_TOTAL:
        problems.append(
            f"value: {report.get('value')} of {BLACKBOX_NAMED_TOTAL} "
            "post-mortem verdicts named"
        )
    return problems


def build_blackbox_report(res: dict) -> dict:
    """Assemble a schema-complete BLACKBOX artifact from
    ``workload.run_blackbox_workload``'s result."""
    return {
        "schema_version": BLACKBOX_SCHEMA_VERSION,
        "metric": "blackbox_postmortem_named",
        "value": res.get("named", 0),
        "unit": (
            f"of {BLACKBOX_NAMED_TOTAL} post-mortem verdicts (hot shard, "
            "crash window, unclean-death truncation) named from "
            "black-box dumps alone, with zero live findings on the "
            "healthy phase and sampler overhead under budget"
        ),
        "workload": (
            "healthy balanced phase + zipf heat storm over one rf=3 "
            "inproc cluster with per-node fleet digesters and a "
            "step-accounted CPU engine; the hot shard's primary owner "
            "is killed hard mid-storm (segments survive, no final "
            "flush) and the post-mortem doctor diagnoses from the "
            "observer + victim dumps alone "
            "(see workload.run_blackbox_workload)"
        ),
        **res,
    }


# ----------------------------------------------------------------------
# REBALANCE stable schema (the closed robustness loop): one
# artifact per round recording (a) the heat-driven rebalancer dropping
# a zipf storm's skew score with zero failed requests mid-move (elastic
# RF boost + zero-loss ownership handoff), (b) a router kill at an
# N>=2 multi-router front door completing every in-flight request
# through the surviving router's edge, and (c) meshcheck reporting the
# new rebalance plane clean. scripts/rebalancebench.py is the paired
# emitter; the sections share their gate logic with CHAOS v4.
# ----------------------------------------------------------------------

REBALANCE_SCHEMA_VERSION = 1

REBALANCE_TOP_FIELDS = (
    "schema_version", "metric", "value", "unit", "workload", "nodes",
    "topology", "replication_factor", "rebalance", "router_kill",
    "meshcheck", "wall_s",
)
REBALANCE_MESHCHECK_FIELDS = ("files", "findings", "clean")


def validate_rebalance(report) -> list[str]:
    """Schema violations of a REBALANCE artifact vs the pinned contract
    (empty = valid). Gates: the zipf storm's skew score strictly drops
    under rebalancing with zero failed requests mid-move and bounded,
    fleet-converged movement; a router kill at N >= 2 routers
    mid-traffic completes every in-flight request via the surviving
    router's edge with zero losses; and meshcheck reports 0 findings on
    the rebalance plane. performed=False sections are schema-valid but
    gate-exempt (the CHAOS convention). Import-safe from artifact tests
    and ``scripts/rebalancebench.py`` (no jax at module scope)."""
    if not isinstance(report, dict):
        return ["artifact is not a JSON object"]
    problems = [f for f in REBALANCE_TOP_FIELDS if f not in report]
    reb = report.get("rebalance")
    if "rebalance" in report and not isinstance(reb, dict):
        # A present-but-garbage section must not silently skip every
        # gate (the validate_chaos v4 discipline).
        problems.append("rebalance section is not an object")
    if isinstance(reb, dict) and reb.get("performed"):
        problems += _rebalance_section_problems(reb)
    rk = report.get("router_kill")
    if "router_kill" in report and not isinstance(rk, dict):
        problems.append("router_kill section is not an object")
    if isinstance(rk, dict) and rk.get("performed"):
        problems += _router_kill_section_problems(rk)
    mc = report.get("meshcheck")
    if "meshcheck" in report and not isinstance(mc, dict):
        problems.append("meshcheck section is not an object")
    if isinstance(mc, dict):
        problems += [
            f"meshcheck.{f}" for f in REBALANCE_MESHCHECK_FIELDS
            if f not in mc
        ]
        if mc.get("clean") is not True or mc.get("findings", 1) != 0:
            problems.append(
                f"meshcheck: {mc.get('findings')} finding(s) on the "
                "rebalance plane — the new single-writer plane must be "
                "statically clean"
            )
    val = report.get("value")
    if isinstance(reb, dict) and reb.get("performed"):
        if not isinstance(val, (int, float)) or val <= 1.0:
            problems.append(
                f"value: skew drop ratio {val} is not > 1 (the storm "
                "did not get flatter)"
            )
    return problems


def build_rebalance_report(res: dict, meshcheck: dict | None = None) -> dict:
    """Assemble a schema-complete REBALANCE artifact from
    ``workload.run_chaos_workload``'s result (the rebalance +
    router-kill phases) plus a meshcheck verdict on the plane."""
    reb = res.get("rebalance", {}) or {}
    before = float(reb.get("skew_before") or 0.0)
    after = float(reb.get("skew_after") or 0.0)
    ratio = round(before / after, 4) if after > 0 else 0.0
    return {
        "schema_version": REBALANCE_SCHEMA_VERSION,
        "metric": "rebalance_skew_drop_ratio",
        "value": ratio,
        "unit": (
            "zipf-storm skew score before / after heat-driven "
            "rebalancing (elastic RF boost + zero-loss ownership "
            "handoff), with zero failed requests mid-move and a "
            "mid-traffic router kill losing nothing at an N>=2 "
            "multi-router front door"
        ),
        "workload": (
            "zipf heat storm over an rf>0 inproc cluster with a "
            "RebalancePlane decider on the view master, then a second "
            "storm wave under the adopted overrides; one of 2 routers "
            "process-killed mid-traffic with client-side front-door "
            "failover (see workload.run_chaos_workload rebalance / "
            "router_kill phases)"
        ),
        "nodes": res.get("nodes"),
        "topology": res.get("topology"),
        "replication_factor": res.get("replication_factor"),
        "rebalance": reb,
        "router_kill": res.get("router_kill", {}),
        "meshcheck": meshcheck or {"files": [], "findings": -1, "clean": False},
        "wall_s": res.get("wall_s"),
    }


# ----------------------------------------------------------------------
# TIER stable schema (the durable KV spill tier): one artifact
# per round recording (a) hit-rate at a working set >= 10x host
# capacity beating the no-tier baseline (the tier stack finally
# outlives DRAM), (b) the restore-overlap contract extended one tier
# down — decode never blocks on disk restores (KVFLOW's
# decode-never-blocks discipline), (c) the cold-cell resurrection drill:
# the WHOLE serving cell killed hard mid-decode, restarted, every
# interrupted stream resumed byte-identical from disk alone, with
# seeded torn/corrupt extents detected and dropped rather than served,
# and (d) meshcheck clean on the new plane (the hotpath-file-io
# invariant live with its positive control tripping).
# scripts/tierbench.py is the paired emitter.
# ----------------------------------------------------------------------

TIER_SCHEMA_VERSION = 1

TIER_TOP_FIELDS = (
    "schema_version", "metric", "value", "unit", "workload",
    "capacity", "spill", "restore_overlap", "cold_start", "corruption",
    "meshcheck", "page_size", "wall_s",
)
TIER_CAPACITY_FIELDS = (
    "working_set_tokens", "host_slots", "working_set_ratio",
    "tier_hit_rate", "baseline_hit_rate", "hit_rate_gain",
    "requests", "distinct_prefixes",
)
TIER_SPILL_FIELDS = (
    "spilled_tokens", "extents", "demotes", "promotes", "drops",
    "resident_bytes",
)
TIER_RESTORE_FIELDS = (
    "parked_requests", "disk_restored_tokens",
    "decode_steps_during_restore", "max_decode_gap_s", "overlap_ok",
)
TIER_COLD_START_FIELDS = (
    "performed", "interrupted", "resumed", "byte_identical", "failed",
    "disk_hit_tokens", "grafted_nodes", "orphaned",
    "corrupt_detected", "corrupt_served", "restart_s",
)
TIER_CORRUPTION_FIELDS = (
    "extents_attacked", "truncated", "bitflipped", "detected",
    "served_corrupt",
)
TIER_MESHCHECK_FIELDS = ("files", "findings", "clean")
TIER_MIN_WORKING_SET_RATIO = 10.0


def validate_tier(report) -> list[str]:
    """Schema violations of a TIER artifact vs the pinned contract
    (empty = valid). Gates: working set >= 10x host capacity with the
    tier's hit-rate strictly beating the no-tier baseline; decode
    progress > 0 while disk restores were parked (the restore-overlap
    contract one tier down); the cold-start phase losing zero requests,
    resuming every interrupted stream byte-identical from disk alone,
    and detecting (never serving) every seeded corrupt/torn extent; and
    meshcheck clean on the tier plane. performed=False sections are
    schema-valid but gate-exempt (the CHAOS convention). Import-safe
    from artifact tests and scripts/tierbench.py (no jax at module
    scope)."""
    if not isinstance(report, dict):
        return ["artifact is not a JSON object"]
    problems = [f for f in TIER_TOP_FIELDS if f not in report]
    for section, fields in (
        ("capacity", TIER_CAPACITY_FIELDS),
        ("spill", TIER_SPILL_FIELDS),
        ("restore_overlap", TIER_RESTORE_FIELDS),
        ("cold_start", TIER_COLD_START_FIELDS),
        ("corruption", TIER_CORRUPTION_FIELDS),
        ("meshcheck", TIER_MESHCHECK_FIELDS),
    ):
        sec = report.get(section)
        if section in report and not isinstance(sec, dict):
            problems.append(f"{section} section is not an object")
            continue
        if isinstance(sec, dict):
            if section == "cold_start" and not sec.get("performed"):
                # The CHAOS convention: a skipped phase is schema-valid
                # ({"performed": False}) but gate-exempt.
                continue
            problems += [f"{section}.{f}" for f in fields if f not in sec]
    cap = report.get("capacity")
    if isinstance(cap, dict):
        ratio = cap.get("working_set_ratio")
        if isinstance(ratio, (int, float)) and ratio < TIER_MIN_WORKING_SET_RATIO:
            problems.append(
                f"capacity: working set only {ratio}x host capacity "
                f"(gate {TIER_MIN_WORKING_SET_RATIO}x) — the claim is "
                "'past DRAM', not 'fits in DRAM'"
            )
        t, b = cap.get("tier_hit_rate"), cap.get("baseline_hit_rate")
        if (
            isinstance(t, (int, float))
            and isinstance(b, (int, float))
            and not t > b
        ):
            problems.append(
                f"capacity: tier hit-rate {t} does not beat the no-tier "
                f"baseline {b}"
            )
    ro = report.get("restore_overlap")
    if isinstance(ro, dict):
        if not ro.get("parked_requests", 0):
            problems.append(
                "restore_overlap: zero parked disk restores — the "
                "overlap claim never saw a disk restore"
            )
        steps = ro.get("decode_steps_during_restore")
        if isinstance(steps, (int, float)) and not steps > 0:
            problems.append(
                "restore_overlap: decode made zero progress while disk "
                "restores were in flight (decode-never-blocks contract, "
                "one tier down)"
            )
        if ro.get("overlap_ok") is not True:
            problems.append("restore_overlap: overlap_ok is not True")
    cs = report.get("cold_start")
    if isinstance(cs, dict) and cs.get("performed"):
        if cs.get("failed", 1) != 0:
            problems.append(
                f"cold_start: {cs.get('failed')} request(s) failed — "
                "the full-restart drill must lose nothing"
            )
        if not cs.get("interrupted", 0):
            problems.append(
                "cold_start: zero interrupted streams — nothing was "
                "proven about mid-decode crash recovery"
            )
        if cs.get("resumed") != cs.get("interrupted"):
            problems.append(
                f"cold_start: resumed {cs.get('resumed')} != interrupted "
                f"{cs.get('interrupted')}"
            )
        if cs.get("byte_identical") is not True:
            problems.append(
                "cold_start: resumed streams were NOT byte-identical to "
                "their pre-kill expectation"
            )
        if not cs.get("disk_hit_tokens", 0):
            problems.append(
                "cold_start: zero disk-served hit tokens after restart "
                "— recovery never actually read the durable tier"
            )
        if not cs.get("corrupt_detected", 0):
            problems.append(
                "cold_start: the seeded corrupt extent was not detected"
            )
        if cs.get("corrupt_served", 1) != 0:
            problems.append(
                f"cold_start: {cs.get('corrupt_served')} corrupt "
                "extent(s) SERVED — the checksum gate failed"
            )
    cor = report.get("corruption")
    if isinstance(cor, dict):
        attacked = int(cor.get("extents_attacked", 0) or 0)
        if attacked:
            if cor.get("detected") != attacked:
                problems.append(
                    f"corruption: {cor.get('detected')} of {attacked} "
                    "attacked extents detected — torn tails/bit-flips "
                    "must never go unnoticed"
                )
            if cor.get("served_corrupt", 1) != 0:
                problems.append(
                    f"corruption: {cor.get('served_corrupt')} corrupt "
                    "extent(s) served"
                )
    mc = report.get("meshcheck")
    if isinstance(mc, dict):
        if mc.get("clean") is not True or mc.get("findings", 1) != 0:
            problems.append(
                f"meshcheck: {mc.get('findings')} finding(s) on the "
                "tier plane — the hotpath-file-io boundary must be "
                "statically clean"
            )
    val = report.get("value")
    if isinstance(cap, dict):
        if not isinstance(val, (int, float)) or val <= 1.0:
            problems.append(
                f"value: hit-rate gain {val} is not > 1 (the tier did "
                "not beat the no-tier baseline)"
            )
    return problems


def build_tier_report(res: dict, meshcheck: dict | None = None) -> dict:
    """Assemble a schema-complete TIER artifact from
    ``workload.run_tier_workload``'s result plus a meshcheck verdict."""
    cap = res.get("capacity", {}) or {}
    return {
        "schema_version": TIER_SCHEMA_VERSION,
        "metric": "tier_hit_rate_gain",
        "value": cap.get("hit_rate_gain"),
        "unit": (
            "prefix-cache hit-rate with the durable disk tier / no-tier "
            "baseline, at a working set >= 10x host capacity (> 1 = the "
            "tier serves what DRAM alone cannot), with decode never "
            "blocking on disk restores and a whole-cell kill-and-restart "
            "resuming every stream byte-identical from disk alone"
        ),
        "workload": (
            "zipf re-visit traffic over a working set 10x the host "
            "arena (tier vs no-tier engines), a parked-disk-restore "
            "decode-overlap phase, and a cold-cell drill: every volatile "
            "tier destroyed mid-decode, one extent bit-flipped + one "
            "truncated, the cell restarted from the extent directory "
            "and interrupted streams resumed byte-identical "
            "(see workload.run_tier_workload)"
        ),
        "capacity": cap,
        "spill": res.get("spill", {}),
        "restore_overlap": res.get("restore_overlap", {}),
        "cold_start": res.get("cold_start", {}),
        "corruption": res.get("corruption", {}),
        "meshcheck": meshcheck
        or {"files": [], "findings": -1, "clean": False},
        "page_size": res.get("page_size"),
        "wall_s": res.get("wall_s"),
    }


# ----------------------------------------------------------------------
# AGG stable schema (the control room): one artifact per round
# recording fleet-wide telemetry aggregation over an inproc 4P+2D+2R
# rf=3 cell — (a) the fleet-MERGED p99 TTFT (bucket counts summed
# across nodes, obs/aggregator.py) matching ground truth computed from
# raw request records within one histogram bucket, (b) a seeded
# straggler (delayed decode node) named BY RANK by the fleet doctor,
# (c) the fleet-p99-bucket exemplar resolving to a stitched trace
# containing the slow node's span, (d) a killed node surfacing as
# telemetry_gap rather than silence, (e) aggregation overhead under 1%
# of run wall time, and (f) an N=200 simulated-transport fan-in row
# completing one pull sweep within one cadence interval.
# scripts/aggbench.py is the paired emitter.
# ----------------------------------------------------------------------

AGG_SCHEMA_VERSION = 1

AGG_TOP_FIELDS = (
    "schema_version", "metric", "value", "unit", "workload", "nodes",
    "topology", "replication_factor", "percentiles", "straggler",
    "exemplar", "gap", "overhead", "fan_in", "wall_s",
)
AGG_PERCENTILE_FIELDS = (
    "performed", "tenant", "fleet_p99_s", "truth_p99_s", "bucket_lo_s",
    "bucket_hi_s", "within_one_bucket", "count", "nodes",
)
AGG_STRAGGLER_FIELDS = (
    "performed", "seeded_rank", "named_rank", "detected", "ratio",
    "signal",
)
AGG_EXEMPLAR_FIELDS = (
    "performed", "trace_id", "node", "le", "stitched",
    "has_straggler_span",
)
AGG_GAP_FIELDS = (
    "performed", "killed_peer", "detected", "verdict", "stalled_s",
)
AGG_OVERHEAD_FIELDS = (
    "pull_seconds_total", "wall_s", "fraction", "budget_fraction",
    "under_budget",
)
AGG_FANIN_FIELDS = (
    "performed", "peers", "sweep_s", "cadence_s", "within_cadence",
    "points",
)
# The four fleet verdicts the acceptance run must name (percentile
# match, straggler by rank, exemplar→trace, killed node as gap).
AGG_NAMED_TOTAL = 4


def validate_agg(report) -> list[str]:
    """Schema violations of an AGG artifact vs the pinned contract
    (empty = valid). Gates: the fleet-merged p99 TTFT lands within one
    histogram bucket of the raw-record ground truth; the seeded
    straggler is named by rank; the merged-p99-bucket exemplar resolves
    to a stitched trace carrying the slow node's span; the killed node
    surfaces as ``telemetry_gap`` (never silence); aggregation overhead
    stays under its budget; and the N=200 fan-in sweep completes inside
    one pull cadence. Sections with performed=False are schema-valid
    but gate-exempt (the CHAOS convention). Import-safe from artifact
    tests and scripts/aggbench.py (no jax at module scope)."""
    if not isinstance(report, dict):
        return ["artifact is not a JSON object"]
    problems = [f for f in AGG_TOP_FIELDS if f not in report]
    named = 0
    pct = report.get("percentiles")
    if "percentiles" in report and not isinstance(pct, dict):
        problems.append("percentiles section is not an object")
    if isinstance(pct, dict) and pct.get("performed"):
        problems += [
            f"percentiles.{f}" for f in AGG_PERCENTILE_FIELDS if f not in pct
        ]
        if pct.get("within_one_bucket") is not True:
            problems.append(
                f"percentiles: fleet-merged p99 {pct.get('fleet_p99_s')}s "
                f"is NOT within one bucket of the raw-record truth "
                f"{pct.get('truth_p99_s')}s — the merge is the whole "
                "point; average-of-percentiles would fail exactly here"
            )
        else:
            named += 1
        if not pct.get("count", 0):
            problems.append(
                "percentiles: zero merged observations — the fleet "
                "store never saw a request"
            )
        if len(pct.get("nodes") or []) < 2:
            problems.append(
                "percentiles: fewer than 2 reporting nodes — nothing "
                "was merged ACROSS nodes"
            )
    strag = report.get("straggler")
    if "straggler" in report and not isinstance(strag, dict):
        problems.append("straggler section is not an object")
    if isinstance(strag, dict) and strag.get("performed"):
        problems += [
            f"straggler.{f}" for f in AGG_STRAGGLER_FIELDS if f not in strag
        ]
        if strag.get("detected") is not True or str(
            strag.get("named_rank")
        ) != str(strag.get("seeded_rank")):
            problems.append(
                f"straggler: seeded rank {strag.get('seeded_rank')} was "
                f"not named (doctor named {strag.get('named_rank')}, "
                f"detected={strag.get('detected')})"
            )
        else:
            named += 1
    ex = report.get("exemplar")
    if "exemplar" in report and not isinstance(ex, dict):
        problems.append("exemplar section is not an object")
    if isinstance(ex, dict) and ex.get("performed"):
        problems += [
            f"exemplar.{f}" for f in AGG_EXEMPLAR_FIELDS if f not in ex
        ]
        if (
            ex.get("stitched") is not True
            or ex.get("has_straggler_span") is not True
        ):
            problems.append(
                "exemplar: the fleet-p99-bucket exemplar did not "
                "resolve to a stitched trace containing the slow "
                f"node's span (stitched={ex.get('stitched')}, "
                f"straggler span={ex.get('has_straggler_span')})"
            )
        else:
            named += 1
    gap = report.get("gap")
    if "gap" in report and not isinstance(gap, dict):
        problems.append("gap section is not an object")
    if isinstance(gap, dict) and gap.get("performed"):
        problems += [f"gap.{f}" for f in AGG_GAP_FIELDS if f not in gap]
        if gap.get("detected") is not True or gap.get("verdict") not in (
            "node_dead", "sampler_dead",
        ):
            problems.append(
                f"gap: killed peer {gap.get('killed_peer')} did not "
                f"surface as telemetry_gap (detected="
                f"{gap.get('detected')}, verdict={gap.get('verdict')}) "
                "— a dead ring must never read as silence"
            )
        else:
            named += 1
    ov = report.get("overhead")
    if "overhead" in report and not isinstance(ov, dict):
        problems.append("overhead section is not an object")
    if isinstance(ov, dict):
        problems += [
            f"overhead.{f}" for f in AGG_OVERHEAD_FIELDS if f not in ov
        ]
        if ov.get("under_budget") is not True:
            problems.append(
                f"overhead: aggregation cost {ov.get('fraction')} of "
                f"wall exceeded the {ov.get('budget_fraction')} budget"
            )
    fi = report.get("fan_in")
    if "fan_in" in report and not isinstance(fi, dict):
        problems.append("fan_in section is not an object")
    if isinstance(fi, dict) and fi.get("performed"):
        problems += [f"fan_in.{f}" for f in AGG_FANIN_FIELDS if f not in fi]
        if int(fi.get("peers", 0) or 0) < 200:
            problems.append(
                f"fan_in: only {fi.get('peers')} simulated peers — the "
                "row exists to prove the N=200 ringscale regime"
            )
        if fi.get("within_cadence") is not True:
            problems.append(
                f"fan_in: one sweep took {fi.get('sweep_s')}s, past the "
                f"{fi.get('cadence_s')}s pull cadence — the aggregator "
                "would fall behind its own schedule"
            )
    performed_any = any(
        isinstance(report.get(s), dict) and report.get(s, {}).get("performed")
        for s in ("percentiles", "straggler", "exemplar", "gap")
    )
    if performed_any and report.get("value") != named:
        problems.append(
            f"value: {report.get('value')} does not equal the {named} "
            "fleet verdict(s) actually named"
        )
    return problems


def build_agg_report(res: dict) -> dict:
    """Assemble a schema-complete AGG artifact from
    ``workload.run_agg_workload``'s result."""
    return {
        "schema_version": AGG_SCHEMA_VERSION,
        "metric": "agg_fleet_verdicts_named",
        "value": res.get("named", 0),
        "unit": (
            f"of {AGG_NAMED_TOTAL} fleet verdicts (merged-p99-vs-truth "
            "within one bucket, straggler named by rank, p99 exemplar "
            "resolved to a stitched trace with the slow node's span, "
            "killed node surfaced as telemetry_gap) named over the "
            "aggregator's cross-node store, with aggregation overhead "
            "under budget and N=200 fan-in inside one cadence"
        ),
        "workload": (
            "inproc 4P+2D+2R rf=3 cell with per-node telemetry "
            "histories cursor-pulled by a router-hosted "
            "FleetAggregator; one decode node seeded slow, one node "
            "killed mid-run, plus an N=200 simulated-transport fan-in "
            "row (see workload.run_agg_workload)"
        ),
        **res,
    }


# ----------------------------------------------------------------------
# SPEC stable schema (the speedometer): one artifact per round
# recording the speculation/token-plane verdicts — (a) draft-token
# conservation (proposed == accepted + rejected on every verify path)
# with accepted-tokens-per-verify-wave broken down BY SHAPE and BY
# DRAFT SOURCE (tree-peek vs n-gram), (b) per-token ITL percentiles
# from the bounded timeline ring with a SEEDED stall named by cause,
# (c) the adaptive-γ controller A-B: acceptance-weighted goodput no
# worse than the fixed-γ baseline, and (d) the token-timeline sampler's
# measured overhead under 1% of run wall. scripts/specbench.py is the
# paired emitter; ROADMAP item 1's gate names this artifact.
# ----------------------------------------------------------------------

SPEC_SCHEMA_VERSION = 1

SPEC_TOP_FIELDS = (
    "schema_version", "metric", "value", "unit", "workload",
    "acceptance", "itl", "adaptive", "overhead", "wall_s",
)
SPEC_ACCEPTANCE_FIELDS = (
    "performed", "proposed", "accepted", "rejected", "conserved",
    "accepted_per_step", "waves", "by_shape", "by_source",
)
SPEC_ITL_FIELDS = (
    "performed", "count", "p50_s", "p99_s", "stalls", "stall_seconds",
    "seeded_cause", "seeded_detected",
)
SPEC_ADAPTIVE_FIELDS = (
    "performed", "gamma_base", "fixed_goodput_tps",
    "adaptive_goodput_tps", "goodput_ratio", "no_worse",
    "fixed_acceptance", "adaptive_acceptance",
)
SPEC_OVERHEAD_FIELDS = (
    "tokens", "timeline_on_s", "timeline_off_s", "fraction",
    "budget_fraction", "under_budget",
)
# Adaptive-γ may not cost goodput: the A-B ratio floor (a hair under
# 1.0 — CPU-tier walltime jitter must not fail a controller that is
# actually neutral-or-better).
SPEC_ADAPTIVE_RATIO_FLOOR = 0.85
SPEC_OVERHEAD_BUDGET = 0.01


def validate_spec(report) -> list[str]:
    """Schema violations of a SPEC artifact vs the pinned contract
    (empty = valid). Gates: draft-token conservation held on every
    verify path (proposed == accepted + rejected) with per-shape AND
    per-draft-source breakdowns present and a positive
    accepted-per-wave rate; the ITL section saw real tokens and named
    the seeded stall by cause; the adaptive-γ A-B's acceptance-weighted
    goodput is no worse than fixed γ (ratio over the pinned floor); and
    the token-timeline sampler's measured overhead stays under its 1%
    budget. Sections with performed=False are schema-valid but
    gate-exempt (the CHAOS convention). Import-safe from artifact tests
    and scripts/specbench.py (no jax at module scope)."""
    if not isinstance(report, dict):
        return ["artifact is not a JSON object"]
    problems = [f for f in SPEC_TOP_FIELDS if f not in report]
    acc = report.get("acceptance")
    if "acceptance" in report and not isinstance(acc, dict):
        problems.append("acceptance section is not an object")
    if isinstance(acc, dict) and acc.get("performed"):
        problems += [
            f"acceptance.{f}" for f in SPEC_ACCEPTANCE_FIELDS if f not in acc
        ]
        if acc.get("conserved") is not True:
            problems.append(
                f"acceptance: conservation broke — proposed "
                f"{acc.get('proposed')} != accepted {acc.get('accepted')}"
                f" + rejected {acc.get('rejected')} (a verify path is "
                "dropping draft tokens from the ledger)"
            )
        if not acc.get("proposed", 0):
            problems.append(
                "acceptance: zero proposed draft tokens — nothing was "
                "proven about speculation"
            )
        aps = acc.get("accepted_per_step")
        if isinstance(aps, (int, float)) and not aps > 0:
            problems.append(
                f"acceptance: accepted-per-wave {aps} is not > 0 — "
                "every draft missed; that is a broken drafter, not a "
                "measured one"
            )
        for axis in ("by_shape", "by_source"):
            ax = acc.get(axis)
            if isinstance(ax, dict) and not ax:
                problems.append(
                    f"acceptance: {axis} is empty — the per-class "
                    "breakdown is the artifact's reason to exist"
                )
    itl = report.get("itl")
    if "itl" in report and not isinstance(itl, dict):
        problems.append("itl section is not an object")
    if isinstance(itl, dict) and itl.get("performed"):
        problems += [f"itl.{f}" for f in SPEC_ITL_FIELDS if f not in itl]
        if not itl.get("count", 0):
            problems.append(
                "itl: zero timed inter-token gaps — the percentiles "
                "are vacuous"
            )
        if itl.get("seeded_detected") is not True:
            problems.append(
                f"itl: the seeded {itl.get('seeded_cause')!r} stall was "
                "not attributed — stall-cause attribution is the "
                "timeline's whole point"
            )
        p50, p99 = itl.get("p50_s"), itl.get("p99_s")
        if (
            isinstance(p50, (int, float))
            and isinstance(p99, (int, float))
            and p99 < p50
        ):
            problems.append(f"itl: p99 {p99} < p50 {p50}")
    ad = report.get("adaptive")
    if "adaptive" in report and not isinstance(ad, dict):
        problems.append("adaptive section is not an object")
    if isinstance(ad, dict) and ad.get("performed"):
        problems += [
            f"adaptive.{f}" for f in SPEC_ADAPTIVE_FIELDS if f not in ad
        ]
        if ad.get("no_worse") is not True:
            problems.append(
                f"adaptive: goodput ratio {ad.get('goodput_ratio')} "
                f"(adaptive/fixed) under the "
                f"{SPEC_ADAPTIVE_RATIO_FLOOR} floor — the controller "
                "costs more than it saves"
            )
    ov = report.get("overhead")
    if "overhead" in report and not isinstance(ov, dict):
        problems.append("overhead section is not an object")
    if isinstance(ov, dict):
        problems += [
            f"overhead.{f}" for f in SPEC_OVERHEAD_FIELDS if f not in ov
        ]
        if ov.get("under_budget") is not True:
            problems.append(
                f"overhead: timeline cost {ov.get('fraction')} of wall "
                f"exceeded the {ov.get('budget_fraction')} budget — the "
                "speedometer may not slow the car"
            )
    val = report.get("value")
    if isinstance(acc, dict) and acc.get("performed"):
        if not isinstance(val, (int, float)) or not val > 0:
            problems.append(
                f"value: accepted tokens per verify wave {val} is not "
                "> 0"
            )
    return problems


def build_spec_report(res: dict) -> dict:
    """Assemble a schema-complete SPEC artifact from
    ``workload.run_spec_workload``'s result."""
    acc = res.get("acceptance", {}) or {}
    return {
        "schema_version": SPEC_SCHEMA_VERSION,
        "metric": "spec_accepted_tokens_per_step",
        "value": acc.get("accepted_per_step"),
        "unit": (
            "draft tokens accepted per speculative verify wave, with "
            "conservation (proposed == accepted + rejected) on every "
            "verify path, per-shape and per-draft-source breakdowns, "
            "seeded-stall ITL attribution, adaptive-γ goodput no worse "
            "than fixed γ, and token-timeline overhead under 1% of wall"
        ),
        "workload": (
            "repetitive + replayed prompts over a tiny CPU model so "
            "tree-peek and n-gram drafts land; a mid-decode driver "
            "sleep seeding a scheduler_wait stall; fixed-γ vs "
            "adaptive-γ A-B on identical seeds; timeline on/off A-B "
            "for the overhead bound (see workload.run_spec_workload)"
        ),
        **res,
    }


CONVOY_SCHEMA_VERSION = 1

CONVOY_TOP_FIELDS = (
    "schema_version", "metric", "value", "unit", "workload",
    "interleave", "stalls", "starvation", "crossover", "wall_s",
)
CONVOY_INTERLEAVE_FIELDS = (
    "performed", "reps", "inline_budget", "base_ttft_p50_s",
    "mixed_ttft_p50_s", "ttft_ratio", "base_itl_p99_s",
    "mixed_itl_p99_s", "outputs_match", "base_accepted_per_wave",
    "mixed_accepted_per_wave", "waves",
)
CONVOY_STALL_FIELDS = (
    "performed", "stall_threshold_s", "base_convoy_s_per_req",
    "mixed_convoy_s_per_req", "convoy_drop_ratio", "base_causes",
    "mixed_causes", "inline_attributed_s",
)
CONVOY_STARVATION_FIELDS = (
    "performed", "skew", "max_defer_bound", "max_step_gap",
    "max_defer_observed", "boost_waves", "bounded", "carrier_tokens",
)
CONVOY_CROSSOVER_FIELDS = (
    "performed", "paged_min_batch", "sweep", "small_batch_ok",
    "large_batch_ok",
)
# The acceptance bars: mixed waves must better the convoy'd
# TTFT by at least this factor, and the per-request prefill_convoy
# stall seconds must drop by at least the drop floor. The ITL ceiling
# and spec floor keep the win honest — interleaving may not buy TTFT
# by starving decode or breaking speculation.
CONVOY_TTFT_RATIO_FLOOR = 1.5
CONVOY_DROP_FLOOR = 2.0
CONVOY_ITL_CEILING = 1.5
CONVOY_SPEC_FLOOR = 0.9
CONVOY_CROSSOVER_FLOOR = 0.9


def validate_convoy(report) -> list[str]:
    """Schema violations of a CONVOY artifact vs the pinned contract
    (empty = valid). Gates: the mixed-wave arm beats the legacy
    alternating schedule's late-arrival TTFT by the pinned floor with
    BIT-IDENTICAL outputs, decode ITL p99 within the ceiling, and spec
    accepted-per-wave within the floor; the per-request
    ``prefill_convoy`` stall seconds drop by the drop floor; the
    starvation proof held its wave-count bound with boost waves
    actually exercised; and the paged/dense crossover chose a path
    within the floor of dense at every swept batch. Sections with
    performed=False are schema-valid but gate-exempt (the CHAOS
    convention). Import-safe from artifact tests and
    scripts/convoybench.py (no jax at module scope)."""
    if not isinstance(report, dict):
        return ["artifact is not a JSON object"]
    problems = [f for f in CONVOY_TOP_FIELDS if f not in report]
    il = report.get("interleave")
    if "interleave" in report and not isinstance(il, dict):
        problems.append("interleave section is not an object")
    if isinstance(il, dict) and il.get("performed"):
        problems += [
            f"interleave.{f}" for f in CONVOY_INTERLEAVE_FIELDS if f not in il
        ]
        ratio = il.get("ttft_ratio")
        if isinstance(ratio, (int, float)) and not (
            ratio >= CONVOY_TTFT_RATIO_FLOOR
        ):
            problems.append(
                f"interleave: late-arrival TTFT ratio {ratio} under the "
                f"{CONVOY_TTFT_RATIO_FLOOR} floor — mixed waves did not "
                "beat the convoy"
            )
        if il.get("outputs_match") is not True:
            problems.append(
                "interleave: outputs diverged between the legacy and "
                "mixed schedules — interleaving changed WHAT was "
                "generated, not just when"
            )
        b_itl, m_itl = il.get("base_itl_p99_s"), il.get("mixed_itl_p99_s")
        if (
            isinstance(b_itl, (int, float))
            and isinstance(m_itl, (int, float))
            and m_itl > b_itl * CONVOY_ITL_CEILING
        ):
            problems.append(
                f"interleave: mixed decode ITL p99 {m_itl} exceeds "
                f"base {b_itl} x{CONVOY_ITL_CEILING} — the TTFT win "
                "was bought by starving decode"
            )
        b_acc = il.get("base_accepted_per_wave")
        m_acc = il.get("mixed_accepted_per_wave")
        if (
            isinstance(b_acc, (int, float))
            and isinstance(m_acc, (int, float))
            and b_acc > 0
            and m_acc < b_acc * CONVOY_SPEC_FLOOR
        ):
            problems.append(
                f"interleave: spec accepted-per-wave fell {b_acc} -> "
                f"{m_acc} under the {CONVOY_SPEC_FLOOR} floor — inline "
                "chunks are breaking speculation"
            )
    st = report.get("stalls")
    if "stalls" in report and not isinstance(st, dict):
        problems.append("stalls section is not an object")
    if isinstance(st, dict) and st.get("performed"):
        problems += [
            f"stalls.{f}" for f in CONVOY_STALL_FIELDS if f not in st
        ]
        drop = st.get("convoy_drop_ratio")
        if isinstance(drop, (int, float)) and not (
            drop >= CONVOY_DROP_FLOOR
        ):
            problems.append(
                f"stalls: prefill_convoy s/req drop ratio {drop} under "
                f"the {CONVOY_DROP_FLOOR} floor — the convoy survived "
                "the interleave"
            )
        if not isinstance(st.get("base_causes"), dict) or not st.get(
            "base_causes"
        ):
            problems.append(
                "stalls: base_causes decomposition is empty — the base "
                "arm never even stalled; nothing was proven"
            )
    sv = report.get("starvation")
    if "starvation" in report and not isinstance(sv, dict):
        problems.append("starvation section is not an object")
    if isinstance(sv, dict) and sv.get("performed"):
        problems += [
            f"starvation.{f}" for f in CONVOY_STARVATION_FIELDS if f not in sv
        ]
        if sv.get("bounded") is not True:
            problems.append(
                f"starvation: decode went {sv.get('max_step_gap')} steps "
                f"(defer {sv.get('max_defer_observed')}) without a token "
                f"against a bound of {sv.get('max_defer_bound')} — the "
                "starvation bound broke"
            )
        if not sv.get("boost_waves", 0):
            problems.append(
                "starvation: zero boost waves fired — the skew never "
                "exercised deferral, so the bound was proven vacuously"
            )
    cx = report.get("crossover")
    if "crossover" in report and not isinstance(cx, dict):
        problems.append("crossover section is not an object")
    if isinstance(cx, dict) and cx.get("performed"):
        problems += [
            f"crossover.{f}" for f in CONVOY_CROSSOVER_FIELDS if f not in cx
        ]
        if isinstance(cx.get("sweep"), list) and not cx["sweep"]:
            problems.append(
                "crossover: empty sweep — no batch sizes were measured"
            )
        if cx.get("small_batch_ok") is not True:
            problems.append(
                "crossover: small-batch effective path fell under "
                f"{CONVOY_CROSSOVER_FLOOR} of dense — the dispatch is "
                "picking the slow path below --paged-min-batch"
            )
        if cx.get("large_batch_ok") is not True:
            problems.append(
                "crossover: bucketed wrapper regressed the at-bucket "
                "batch — padding is costing where it should be free"
            )
    val = report.get("value")
    if isinstance(il, dict) and il.get("performed"):
        if not isinstance(val, (int, float)) or not val > 0:
            problems.append(
                f"value: late-arrival TTFT speedup {val} is not > 0"
            )
    return problems


def build_convoy_report(res: dict) -> dict:
    """Assemble a schema-complete CONVOY artifact from
    ``workload.run_convoy_workload``'s result."""
    il = res.get("interleave", {}) or {}
    return {
        "schema_version": CONVOY_SCHEMA_VERSION,
        "metric": "convoy_ttft_speedup",
        "value": il.get("ttft_ratio"),
        "unit": (
            "late-arrival p50 TTFT ratio (legacy alternating waves / "
            "decode-interleaved mixed waves) on an identical virtual "
            "arrival schedule, with bit-identical outputs, decode ITL "
            "p99 and spec accepted-per-wave no worse, prefill_convoy "
            "stall s/req dropped, a wave-counted starvation bound, and "
            "the paged/dense crossover holding at small batch"
        ),
        "workload": (
            "a decoding carrier stream convoyed by a 960-token prompt "
            "with a late 16-token arrival, A-B across "
            "prefill_inline_budget 0 vs >0; 20:1 skew with boost waves "
            "for the starvation proof; jnp-path dense/bucketed timing "
            "sweep at batch 2/4/8/32 (see workload.run_convoy_workload)"
        ),
        **res,
    }


# ----------------------------------------------------------------------
# compare_rounds (the bench regression sentinel): schema-aware
# diffing of any two SAME-schema artifacts. The artifact schemas
# accumulated round over round with nothing machine-checking the
# trajectory between them — a silently regressed hit ratio or a halved
# ring throughput would ride a green round. Each kind pins the metrics
# worth guarding (dotted path, direction, relative significance
# threshold); everything else diffs informationally. scripts/benchdiff.py
# is the CLI with pinned exit codes (0 clean / 1 regression / 2 schema
# mismatch) so CI can gate on the trajectory.
# ----------------------------------------------------------------------

BENCHDIFF_EXIT_CLEAN = 0
BENCHDIFF_EXIT_REGRESSION = 1
BENCHDIFF_EXIT_MISMATCH = 2

# Relative-change denominator floor for zero-valued baselines (a clean
# 0.0 like attribution.max_sum_error_s must tolerate float dust without
# any threshold being able to): deltas are judged relative to at least
# this scale. 1e-6 = the attribution epsilon, the smallest magnitude any
# guarded metric treats as meaningful.
_ZERO_BASELINE_FLOOR = 1e-6

# kind → ((dotted path, direction, relative significance threshold), …).
# direction: "higher" = bigger is better, "lower" = smaller is better.
# A move AGAINST direction by more than the threshold (relative to the
# old value) is a regression; a move WITH it is an improvement; inside
# the threshold is noise ("ok"). Thresholds are deliberately loose —
# the sentinel exists to catch silent cliffs, not to litigate jitter.
COMPARE_RULES: dict = {
    "BENCH_FULL": (
        ("value", "higher", 0.15),
        ("vs_baseline", "higher", 0.15),
        ("serving_mix.ratio", "higher", 0.15),
        ("north_star.hit_rate", "higher", 0.10),
        ("north_star.p99_ttft_ms", "lower", 0.50),
    ),
    "RINGBENCH": (
        ("value", "higher", 0.20),
        ("wire_bytes_per_insert", "lower", 0.05),
        ("lap_latency.p99_ms", "lower", 0.50),
        ("converge_s_max", "lower", 0.50),
    ),
    "RINGSCALE": (
        ("bytes_per_insert_growth.rf3.growth", "lower", 0.25),
    ),
    "CHAOS": (
        ("value", "lower", 0.50),
        ("crash.resurrection_hit_ratio", "higher", 0.10),
        ("repair.converge_s", "lower", 0.50),
    ),
    "FLEET": (
        ("value", "lower", 0.50),
        ("stall_reaction.reaction_s", "lower", 0.50),
    ),
    "KVFLOW": (
        ("value", "lower", 0.20),
        ("restore.decode_steps_during_restore", "higher", 0.30),
        ("prefetch.hit_ahead_rate", "higher", 0.10),
    ),
    "OBS": (
        ("value", "higher", 0.0),
        ("heat.skew_score", "higher", 0.30),
        ("stitch.replication_edges", "higher", 0.50),
    ),
    "ANALYSIS": (
        ("value", "lower", 0.0),  # unsuppressed findings: any rise flags
        ("files_indexed", "higher", 0.20),
    ),
    "DOCTOR": (
        ("value", "higher", 0.0),
        ("attribution.audited", "higher", 0.50),
        ("attribution.max_sum_error_s", "lower", 10.0),
    ),
    "BLACKBOX": (
        ("value", "higher", 0.0),  # named post-mortem verdicts: any drop flags
        ("history.self_overhead.fraction", "lower", 2.0),
        ("history.points", "higher", 0.75),
    ),
    "REBALANCE": (
        ("value", "higher", 0.30),  # skew drop ratio
        ("rebalance.failed_mid_move", "lower", 0.0),  # any rise flags
        ("router_kill.failed", "lower", 0.0),
        ("meshcheck.findings", "lower", 0.0),
    ),
    "TIER": (
        ("value", "higher", 0.30),  # hit-rate gain over no-tier
        ("cold_start.failed", "lower", 0.0),  # any rise flags
        ("cold_start.corrupt_served", "lower", 0.0),
        ("restore_overlap.decode_steps_during_restore", "higher", 0.50),
        ("meshcheck.findings", "lower", 0.0),
    ),
    "AGG": (
        ("value", "higher", 0.0),  # named fleet verdicts: any drop flags
        ("overhead.fraction", "lower", 2.0),
        ("fan_in.sweep_s", "lower", 1.0),
        ("percentiles.count", "higher", 0.75),
    ),
    "SPEC": (
        ("value", "higher", 0.20),  # accepted draft tokens per verify wave
        ("acceptance.accepted_per_step", "higher", 0.20),
        ("adaptive.goodput_ratio", "higher", 0.20),
        ("itl.p99_s", "lower", 1.0),
        ("overhead.fraction", "lower", 2.0),
    ),
    "CONVOY": (
        ("value", "higher", 0.25),  # late-arrival TTFT speedup
        ("interleave.ttft_ratio", "higher", 0.25),
        ("stalls.mixed_convoy_s_per_req", "lower", 1.0),
        ("interleave.mixed_itl_p99_s", "lower", 1.0),
        ("starvation.max_defer_observed", "lower", 0.0),  # any rise flags
    ),
    # Kinds with no pinned directional metrics still get the schema
    # check + informational numeric diff.
    "SLO": (),
    "SOAK": (
        ("value", "higher", 0.20),
        ("server_p50_ttft_ms", "lower", 0.50),
    ),
}

# metric-name → kind, for artifacts compared without a filename (stdin,
# tests). Filename prefixes remain the primary detector.
_METRIC_KINDS = {
    "decode_tokens_per_sec_per_chip": "BENCH_FULL",
    "ring_insert_throughput": "RINGBENCH",
    "ring_scale_sweep": "RINGSCALE",
    "chaos_heal_converge_s": "CHAOS",
    "fleet_digest_fan_in_p50_s": "FLEET",
    "kv_restore_overlapped_ttft_ratio": "KVFLOW",
    "obs_stitched_node_tracks": "OBS",
    "unsuppressed_findings": "ANALYSIS",
    "doctor_pathologies_named": "DOCTOR",
    "blackbox_postmortem_named": "BLACKBOX",
    "rebalance_skew_drop_ratio": "REBALANCE",
    "tier_hit_rate_gain": "TIER",
    "agg_fleet_verdicts_named": "AGG",
    "spec_accepted_tokens_per_step": "SPEC",
    "convoy_ttft_speedup": "CONVOY",
    "slo_goodput_vs_offered_load": "SLO",
    "soak_requests": "SOAK",
}


def artifact_kind(report, filename: str | None = None) -> str | None:
    """The artifact's schema kind — from its ``<KIND>_r{N}.json``
    filename when given, else from its pinned ``metric`` name. None =
    unrecognized (compare_rounds refuses rather than guessing)."""
    import re

    if filename:
        m = re.fullmatch(
            r"([A-Z][A-Z0-9_]*?)_r\d+\.json",
            os.path.basename(filename),
        )
        if m:
            return m.group(1)
    if isinstance(report, dict):
        return _METRIC_KINDS.get(report.get("metric"))
    return None


def _dotted_get(obj, path: str):
    """Resolve ``a.b.c`` through nested dicts; None when any hop is
    absent or non-dict."""
    cur = obj
    for part in path.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    return cur


def _numeric_leaves(obj, prefix: str = "", out: dict | None = None) -> dict:
    """dotted-path → value for every bool/int/float leaf (lists skipped:
    entry counts shift round-to-round and carry no stable identity)."""
    if out is None:
        out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            _numeric_leaves(v, f"{prefix}{k}.", out)
    elif isinstance(obj, bool) or isinstance(obj, (int, float)):
        out[prefix[:-1]] = float(obj)
    return out


def compare_rounds(
    old: dict,
    new: dict,
    kind: str | None = None,
    old_name: str | None = None,
    new_name: str | None = None,
    threshold_scale: float = 1.0,
) -> dict:
    """Schema-aware diff of two same-schema artifacts.

    Returns ``{"status": "clean"|"regression"|"schema_mismatch", ...}``
    with per-metric rows. ``status`` maps one-to-one onto the CLI's
    pinned exit codes (``BENCHDIFF_EXIT_*``). A diff across KINDS
    compares apples to oranges and refuses outright. Schema versions
    only bump additively in this repo (fields are never removed or
    renamed), so a version difference is same-schema and diffable: it
    is recorded in ``version_change`` and a pinned path present on
    only one side is listed in ``skipped`` instead of judged. At EQUAL
    versions a one-sided pinned path is real schema rot and refuses.
    ``threshold_scale`` scales every significance threshold (CLI
    ``--strict`` passes 0; 2.0 doubles the tolerance)."""
    mismatches: list[str] = []
    old_kind = kind or artifact_kind(old, old_name)
    new_kind = kind or artifact_kind(new, new_name)
    if old_kind is None or new_kind is None:
        mismatches.append(
            "unrecognized artifact kind "
            f"(old={old_kind!r}, new={new_kind!r}) — name the files "
            "<KIND>_r<N>.json or pass kind explicitly"
        )
    elif old_kind != new_kind:
        mismatches.append(f"kind mismatch: {old_kind} vs {new_kind}")
    if mismatches:
        return {
            "status": "schema_mismatch",
            "kind": old_kind if old_kind == new_kind else None,
            "mismatches": mismatches,
            "rows": [],
            "regressions": [],
            "improvements": [],
        }
    ver_old, ver_new = old.get("schema_version"), new.get("schema_version")
    version_change = (
        None if ver_old == ver_new else {"old": ver_old, "new": ver_new}
    )
    rows: list[dict] = []
    regressions: list[str] = []
    improvements: list[str] = []
    skipped: list[str] = []
    rules = COMPARE_RULES.get(old_kind, ())
    for path, direction, threshold in rules:
        a, b = _dotted_get(old, path), _dotted_get(new, path)
        if a is None and b is None:
            continue  # optional section absent in both rounds
        if a is None or b is None:
            if version_change is not None:
                # Additive schema change: the field arrived (or the
                # section is newer than the old round) — declared, not
                # silently dropped, and never judged.
                skipped.append(path)
            else:
                mismatches.append(
                    f"{path}: present in only one artifact at the same "
                    f"schema version ({a!r} vs {b!r})"
                )
            continue
        if not isinstance(a, (int, float)) or not isinstance(b, (int, float)):
            mismatches.append(f"{path}: non-numeric ({a!r} vs {b!r})")
            continue
        thr = threshold * threshold_scale
        delta = b - a
        # Zero baselines: a bare delta/0 makes ANY move from 0.0
        # infinitely relative — no threshold could ever tolerate it, so
        # a 2e-16 float-dust drift off a clean 0.0 (max_sum_error_s)
        # would flag forever. Floor the denominator instead: moves the
        # size of the floor read as moves relative to it, genuine
        # regressions (0 findings → 1) still blow past any threshold.
        rel = delta / max(abs(a), _ZERO_BASELINE_FLOOR)
        adverse = -rel if direction == "higher" else rel
        if adverse > thr:
            verdict = "regression"
            regressions.append(path)
        elif adverse < -thr:
            verdict = "improvement"
            improvements.append(path)
        else:
            verdict = "ok"
        rows.append({
            "path": path,
            "old": a,
            "new": b,
            "delta": round(delta, 6),
            "rel": round(rel, 6) if rel != float("inf") else None,
            "direction": direction,
            "threshold": thr,
            "verdict": verdict,
        })
    if mismatches:
        return {
            "status": "schema_mismatch",
            "kind": old_kind,
            "mismatches": mismatches,
            "rows": rows,
            "regressions": regressions,
            "improvements": improvements,
            "skipped": skipped,
        }
    # Informational sweep: every numeric leaf NOT already covered by a
    # pinned rule, so a reviewer sees what else moved (no verdicts —
    # direction is unknown there by definition).
    pinned = {r["path"] for r in rows}
    leaves_old = _numeric_leaves(old)
    leaves_new = _numeric_leaves(new)
    info: list[dict] = []
    for path in sorted(leaves_old.keys() & leaves_new.keys()):
        if path in pinned or path == "schema_version":
            continue
        a, b = leaves_old[path], leaves_new[path]
        if a != b:
            info.append({
                "path": path, "old": a, "new": b,
                "delta": round(b - a, 6),
            })
    return {
        "status": "regression" if regressions else "clean",
        "kind": old_kind,
        "schema_version": ver_new,
        "version_change": version_change,
        "mismatches": [],
        "rows": rows,
        "regressions": regressions,
        "improvements": improvements,
        "skipped": skipped,
        "info_changes": info,
    }


def benchdiff_selfcheck() -> dict:
    """The regression sentinel's positive control, pinned and
    deterministic (no checked-in files needed): an identical artifact
    pair must compare clean, a synthetically regressed copy must flag,
    and a cross-kind pair must refuse as a schema mismatch — proven for
    the CHAOS, BLACKBOX, TIER, AGG, SPEC, and CONVOY schemas, so every
    pinned rule table a sentinel relies on has a demonstrated trigger.
    The DOCTOR artifact carries the result (``validate_doctor`` gates
    the three headline fields) — a sentinel nobody proved can still
    fire is not a sentinel."""
    base = {
        "metric": "chaos_heal_converge_s",
        "schema_version": CHAOS_SCHEMA_VERSION,
        "value": 0.4,
        "crash": {"resurrection_hit_ratio": 0.95},
        "repair": {"converge_s": 0.4},
    }
    regressed = {
        **base,
        "value": 1.8,  # 4.5x slower heal: past the 50% threshold
        "repair": {"converge_s": 1.8},
    }
    other_kind = {
        "metric": "obs_stitched_node_tracks",
        "schema_version": OBS_SCHEMA_VERSION,
        "value": 6,
    }
    bb_base = {
        "metric": "blackbox_postmortem_named",
        "schema_version": BLACKBOX_SCHEMA_VERSION,
        "value": BLACKBOX_NAMED_TOTAL,
        "history": {"points": 4000, "self_overhead": {"fraction": 0.004}},
    }
    bb_regressed = {
        **bb_base,
        # One lost verdict: the zero-threshold value rule must flag it.
        "value": BLACKBOX_NAMED_TOTAL - 1,
    }
    tier_base = {
        "metric": "tier_hit_rate_gain",
        "schema_version": TIER_SCHEMA_VERSION,
        "value": 8.0,
        "cold_start": {"failed": 0, "corrupt_served": 0},
        "restore_overlap": {"decode_steps_during_restore": 40},
        "meshcheck": {"findings": 0},
    }
    tier_regressed = {
        **tier_base,
        # One corrupt extent served: the zero-threshold rule must flag.
        "cold_start": {"failed": 0, "corrupt_served": 1},
    }
    agg_base = {
        "metric": "agg_fleet_verdicts_named",
        "schema_version": AGG_SCHEMA_VERSION,
        "value": AGG_NAMED_TOTAL,
        "overhead": {"fraction": 0.002},
        "fan_in": {"sweep_s": 0.05},
        "percentiles": {"count": 400},
    }
    agg_regressed = {
        **agg_base,
        # One lost fleet verdict: the zero-threshold value rule must flag.
        "value": AGG_NAMED_TOTAL - 1,
    }
    spec_base = {
        "metric": "spec_accepted_tokens_per_step",
        "schema_version": SPEC_SCHEMA_VERSION,
        "value": 1.6,
        "acceptance": {"accepted_per_step": 1.6},
        "adaptive": {"goodput_ratio": 1.02},
        "itl": {"p99_s": 0.004},
        "overhead": {"fraction": 0.003},
    }
    spec_regressed = {
        **spec_base,
        # Acceptance nearly halved: past the 20% threshold.
        "value": 0.9,
        "acceptance": {"accepted_per_step": 0.9},
    }
    cv_base = {
        "metric": "convoy_ttft_speedup",
        "schema_version": CONVOY_SCHEMA_VERSION,
        "value": 4.0,
        "interleave": {"ttft_ratio": 4.0, "mixed_itl_p99_s": 0.05},
        "stalls": {"mixed_convoy_s_per_req": 0.0},
        "starvation": {"max_defer_observed": 2},
    }
    cv_regressed = {
        **cv_base,
        # The convoy came back: TTFT speedup down 70%, past 25%.
        "value": 1.2,
        "interleave": {"ttft_ratio": 1.2, "mixed_itl_p99_s": 0.05},
    }
    identical = compare_rounds(base, dict(base), kind="CHAOS")
    regression = compare_rounds(base, regressed, kind="CHAOS")
    mismatch = compare_rounds(base, other_kind)
    bb_identical = compare_rounds(bb_base, dict(bb_base), kind="BLACKBOX")
    bb_regression = compare_rounds(bb_base, bb_regressed, kind="BLACKBOX")
    bb_mismatch = compare_rounds(bb_base, base)
    t_identical = compare_rounds(tier_base, dict(tier_base), kind="TIER")
    t_regression = compare_rounds(tier_base, tier_regressed, kind="TIER")
    t_mismatch = compare_rounds(tier_base, base)
    a_identical = compare_rounds(agg_base, dict(agg_base), kind="AGG")
    a_regression = compare_rounds(agg_base, agg_regressed, kind="AGG")
    a_mismatch = compare_rounds(agg_base, base)
    s_identical = compare_rounds(spec_base, dict(spec_base), kind="SPEC")
    s_regression = compare_rounds(spec_base, spec_regressed, kind="SPEC")
    s_mismatch = compare_rounds(spec_base, base)
    c_identical = compare_rounds(cv_base, dict(cv_base), kind="CONVOY")
    c_regression = compare_rounds(cv_base, cv_regressed, kind="CONVOY")
    c_mismatch = compare_rounds(cv_base, base)
    return {
        "identical_clean": identical["status"] == "clean"
        and bb_identical["status"] == "clean"
        and t_identical["status"] == "clean"
        and a_identical["status"] == "clean"
        and s_identical["status"] == "clean"
        and c_identical["status"] == "clean",
        "regression_flagged": regression["status"] == "regression"
        and "repair.converge_s" in regression["regressions"]
        and bb_regression["status"] == "regression"
        and "value" in bb_regression["regressions"]
        and t_regression["status"] == "regression"
        and "cold_start.corrupt_served" in t_regression["regressions"]
        and a_regression["status"] == "regression"
        and "value" in a_regression["regressions"]
        and s_regression["status"] == "regression"
        and "acceptance.accepted_per_step" in s_regression["regressions"]
        and c_regression["status"] == "regression"
        and "interleave.ttft_ratio" in c_regression["regressions"],
        "mismatch_detected": mismatch["status"] == "schema_mismatch"
        and bb_mismatch["status"] == "schema_mismatch"
        and t_mismatch["status"] == "schema_mismatch"
        and a_mismatch["status"] == "schema_mismatch"
        and s_mismatch["status"] == "schema_mismatch"
        and c_mismatch["status"] == "schema_mismatch",
        "kinds_covered": ["CHAOS", "BLACKBOX", "TIER", "AGG", "SPEC", "CONVOY"],
        "regressions_seen": regression["regressions"]
        + bb_regression["regressions"]
        + t_regression["regressions"]
        + a_regression["regressions"]
        + s_regression["regressions"]
        + c_regression["regressions"],
    }
