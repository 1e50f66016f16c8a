"""The port stands alone: importing every module of ``radixmesh_tpu_torch``
and everything ``chip_smoke.py`` imports pulls in neither ``jax``, the JAX
package nor ``ml_dtypes`` (absent on the card's machine: the disk tier
encodes bf16 from torch's own bit patterns), nor ``yaml`` (PyYAML is not on
the card's machine either: ``config.load_config`` imports it only when it
reads a file, and reads JSON without it), nor ``safetensors``,
``transformers`` or ``tokenizers`` (the port reads and writes safetensors
itself, and imports ``transformers`` only when an HF tokenizer directory
is loaded); entry points default to CUDA and raise
without it; the launcher refuses no flag since ``--weight-quant`` was
ported (it reaches the engine), and parses the SLO, history and black-box
flags down to the frontend's arguments."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import radixmesh_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(radixmesh_tpu_torch.__path__, "radixmesh_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # noqa: F401  (module import only; main() is not run)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "radixmesh_tpu" or m.startswith("radixmesh_tpu.") or m in ("ml_dtypes", "yaml")
             or m.split(".")[0] in ("safetensors", "transformers", "tokenizers"))
print(len(mods), bad, " ".join(mods))
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_jax_package():
    r = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    n_mods = int(r.stdout.split()[0])
    assert n_mods >= 20, r.stdout
    walked = set(r.stdout.split())
    assert {"radixmesh_tpu_torch.engine.waves", "radixmesh_tpu_torch.obs.spec_ledger",
            "radixmesh_tpu_torch.obs.attribution", "radixmesh_tpu_torch.cache.host_cache",
            "radixmesh_tpu_torch.cache.kv_transfer", "radixmesh_tpu_torch.cache.kv_tier",
            "radixmesh_tpu_torch.models.hf_io", "radixmesh_tpu_torch.models.qwen2",
            "radixmesh_tpu_torch.server.tokenizer", "radixmesh_tpu_torch.obs.metrics",
            "radixmesh_tpu_torch.obs.trace_plane", "radixmesh_tpu_torch.obs.tracing",
            "radixmesh_tpu_torch.obs.token_timeline", "radixmesh_tpu_torch.obs.step_plane",
            "radixmesh_tpu_torch.obs.fleet_plane", "radixmesh_tpu_torch.obs.timeseries",
            "radixmesh_tpu_torch.obs.blackbox", "radixmesh_tpu_torch.slo.control",
            "radixmesh_tpu_torch.slo.runner", "radixmesh_tpu_torch.policy.retry",
            "radixmesh_tpu_torch.entry", "radixmesh_tpu_torch.engine.disagg",
            "radixmesh_tpu_torch.comm.communicator", "radixmesh_tpu_torch.comm.inproc",
            "radixmesh_tpu_torch.comm.tcp_py", "radixmesh_tpu_torch.ops.wquant",
            "radixmesh_tpu_torch.config", "radixmesh_tpu_torch.utils.sync",
            "radixmesh_tpu_torch.cache.oplog", "radixmesh_tpu_torch.cache.mesh_values",
            "radixmesh_tpu_torch.cache.sharding", "radixmesh_tpu_torch.cache.rebalance",
            "radixmesh_tpu_torch.cache.mesh_cache", "radixmesh_tpu_torch.router.consistent_hash",
            "radixmesh_tpu_torch.router.cache_aware_router", "radixmesh_tpu_torch.policy.conflict",
            "radixmesh_tpu_torch.policy.hierarchy", "radixmesh_tpu_torch.policy.sync_algo",
            "radixmesh_tpu_torch.policy.topology", "radixmesh_tpu_torch.policy.lifecycle",
            "radixmesh_tpu_torch.comm.faults", "radixmesh_tpu_torch.comm.tcp_native",
            "radixmesh_tpu_torch.server.recovery", "radixmesh_tpu_torch.router.front_door",
            "radixmesh_tpu_torch.cache.repair_plane", "radixmesh_tpu_torch.obs.aggregator",
            "radixmesh_tpu_torch.obs.doctor", "radixmesh_tpu_torch.doctor",
            "radixmesh_tpu_torch.parallel.sharding", "radixmesh_tpu_torch.parallel.multihost",
            "radixmesh_tpu_torch.parallel.collectives",
            "radixmesh_tpu_torch.parallel.ring_attention",
            "radixmesh_tpu_torch.parallel.ulysses", "radixmesh_tpu_torch.parallel.pipeline",
            "radixmesh_tpu_torch.parallel.pp_serving",
            "radixmesh_tpu_torch.parallel.kv_transfer", "radixmesh_tpu_torch.parallel.train",
            "radixmesh_tpu_torch.checkpoint", "radixmesh_tpu_torch.workload",
            "radixmesh_tpu_torch.analysis", "radixmesh_tpu_torch.analysis.core",
            "radixmesh_tpu_torch.analysis.callgraph", "radixmesh_tpu_torch.analysis.lock_order",
            "radixmesh_tpu_torch.analysis.single_writer", "radixmesh_tpu_torch.analysis.hot_path",
            "radixmesh_tpu_torch.analysis.wire_kinds", "radixmesh_tpu_torch.analysis.metrics_vocab",
            "radixmesh_tpu_torch.analysis.thread_roots", "radixmesh_tpu_torch.analysis.guarded_by",
            "radixmesh_tpu_torch.analysis.protocol", "radixmesh_tpu_torch.analysis.controls",
            "radixmesh_tpu_torch.analysis.report", "radixmesh_tpu_torch.meshcheck",
            "radixmesh_tpu_torch.reports", "radixmesh_tpu_torch.scripts.specbench",
            "radixmesh_tpu_torch.scripts.convoybench", "radixmesh_tpu_torch.scripts.kvflowbench",
            "radixmesh_tpu_torch.scripts.tierbench", "radixmesh_tpu_torch.scripts.obsbench",
            "radixmesh_tpu_torch.scripts.blackboxbench", "radixmesh_tpu_torch.scripts.aggbench",
            "radixmesh_tpu_torch.scripts.fleetbench", "radixmesh_tpu_torch.scripts.chaosbench",
            "radixmesh_tpu_torch.scripts.rebalancebench", "radixmesh_tpu_torch.scripts.benchdiff",
            "radixmesh_tpu_torch.scripts.soak", "radixmesh_tpu_torch.scripts.ringbench",
            "radixmesh_tpu_torch.scripts.ringscale"} <= walked, r.stdout


_PARALLEL_PROBE = """
import sys
import radixmesh_tpu_torch.parallel, radixmesh_tpu_torch.models.llama
import radixmesh_tpu_torch.ops.attention, radixmesh_tpu_torch.parallel.train
import radixmesh_tpu_torch.checkpoint
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "radixmesh_tpu" or m.startswith("radixmesh_tpu.") or m == "ml_dtypes")
assert not bad, bad
"""


def test_parallel_package_stands_alone():
    """``radixmesh_tpu_torch/parallel/`` (with the model's tp seams, the
    sharded attention wrappers, the train step and the checkpoint module)
    imports no ``jax``, no JAX package module and
    no ``ml_dtypes``, in a process of its own and in its source text."""
    import ast

    r = subprocess.run([sys.executable, "-c", _PARALLEL_PROBE], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    files = sorted((ROOT / "radixmesh_tpu_torch" / "parallel").glob("*.py"))
    assert {f.stem for f in files} >= {"__init__", "sharding", "multihost", "collectives",
                                       "ring_attention", "ulysses", "pipeline", "pp_serving",
                                       "kv_transfer", "train"}
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "radixmesh_tpu", "ml_dtypes"), (f.name, n)


def test_report_plane_and_command_lines_import_no_jax_and_no_bench():
    """``reports.py`` and every module under ``scripts/`` import neither
    ``jax``, the JAX package, ``ml_dtypes`` nor ``bench.py`` (whose builders
    import the JAX package), in their source text."""
    import ast

    files = [ROOT / "radixmesh_tpu_torch" / "reports.py",
             *sorted((ROOT / "radixmesh_tpu_torch" / "scripts").glob("*.py"))]
    assert len(files) >= 15, files
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "radixmesh_tpu", "ml_dtypes", "bench"), (f.name, n)


def _code_of(path: pathlib.Path, names: tuple[str, ...] | None = None) -> str:
    """The module's AST without docstrings, with every ``radixmesh_tpu``
    name read as ``radixmesh_tpu_torch``: the code, not its prose. With
    ``names``, only those top-level definitions, in that order."""
    import ast
    import re

    tree = ast.parse(re.sub(r"\bradixmesh_tpu\b", "radixmesh_tpu_torch", path.read_text()))
    if names is not None:
        defs = {getattr(n, "name", None): n for n in tree.body}
        tree.body = [defs[n] for n in names]
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("module", ["policy/retry.py", "server/recovery.py", "router/front_door.py",
                                    "cache/repair_plane.py", "policy/lifecycle.py", "obs/aggregator.py",
                                    "obs/doctor.py", "analysis/lock_order.py",
                                    "analysis/single_writer.py", "analysis/wire_kinds.py",
                                    "analysis/metrics_vocab.py", "analysis/guarded_by.py",
                                    "analysis/protocol.py"])
def test_copied_fleet_modules_differ_from_the_jax_files_only_in_imports(module):
    assert _code_of(ROOT / "radixmesh_tpu_torch" / module) == _code_of(ROOT / "radixmesh_tpu" / module)


def _shared_top_level(kind):
    import ast

    def names(path):
        return {getattr(n, "name", None) for n in ast.parse(path.read_text()).body if isinstance(n, kind)}

    return sorted(names(ROOT / "radixmesh_tpu_torch" / "reports.py") & names(ROOT / "bench.py"))


def test_report_plane_functions_are_bench_py_code():
    """Every function ``reports.py`` shares with ``bench.py`` (the validators,
    builders and the benchdiff sentinel) is ``bench.py``'s code but for its
    imports (``radixmesh_tpu`` read as ``radixmesh_tpu_torch``)."""
    import ast

    shared = tuple(_shared_top_level(ast.FunctionDef))
    assert len(shared) >= 33 and {"validate_doctor", "build_tier_report", "compare_rounds",
                                  "benchdiff_selfcheck", "artifact_kind"} <= set(shared), shared
    assert _code_of(ROOT / "radixmesh_tpu_torch" / "reports.py", shared) == _code_of(ROOT / "bench.py", shared)


def test_report_plane_constants_equal_bench_py():
    """Every schema constant of ``bench.py`` (field tuples, versions, floors,
    the benchdiff rule tables) is in ``reports.py`` with ``bench.py``'s
    value; the ANALYSIS ones in ``analysis/report.py``, whose schema
    ``reports.py`` re-exports."""
    import bench

    from radixmesh_tpu_torch import reports
    from radixmesh_tpu_torch.analysis import report as analysis_report

    consts = [n for n in vars(bench) if n.isupper() and not n.startswith("_")
              and n.split("_")[0] in ("RINGBENCH", "RINGSCALE", "FLEET", "CHAOS", "OBS", "KVFLOW", "ANALYSIS",
                                      "DOCTOR", "BLACKBOX", "REBALANCE", "TIER", "AGG", "SPEC", "CONVOY",
                                      "BENCHDIFF", "COMPARE")]
    assert len(consts) > 100
    for name in consts:
        home = analysis_report if name.startswith("ANALYSIS_") else reports
        assert getattr(home, name) == getattr(bench, name), name
    assert reports._METRIC_KINDS == bench._METRIC_KINDS
    assert reports._ZERO_BASELINE_FLOOR == bench._ZERO_BASELINE_FLOOR


_GENERATORS = ("synth_text", "_Conversation", "MultiTurnWorkload", "TextMultiTurnWorkload",
               "OverloadWorkload")


def test_workload_generators_are_the_jax_code():
    """The traffic generators are the JAX package's numpy code, unchanged (and
    their word stock the same words): the same seed gives the same prompts
    and arrivals in both packages."""
    from radixmesh_tpu import workload as jw
    from radixmesh_tpu_torch import workload as pw

    assert _code_of(ROOT / "radixmesh_tpu_torch" / "workload.py", _GENERATORS) == \
        _code_of(ROOT / "radixmesh_tpu" / "workload.py", _GENERATORS)
    assert pw._WORDS == jw._WORDS


@pytest.mark.parametrize("scenario", ["run_spec_workload", "run_convoy_workload", "run_kvflow_workload",
                                      "run_tier_workload", "run_doctor_workload"])
def test_workload_scenarios_default_to_cuda_and_raise_without_it(scenario, monkeypatch):
    from radixmesh_tpu_torch import workload

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        getattr(workload, scenario)()


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from radixmesh_tpu_torch.engine.engine import Engine
    from radixmesh_tpu_torch.models.llama import ModelConfig, init_params
    from radixmesh_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    params = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        resolve_device("cuda:0")
    eng = Engine(cfg, params, device="cpu", num_slots=256, page_size=4, max_batch=2)
    out = eng.generate([np.arange(1, 12).tolist()])
    assert len(out[0]) == 16


class _Reached(Exception):
    pass


@pytest.mark.parametrize("flag", ["--weight-quant"])
def test_launcher_refuses_unported_flags(flag, monkeypatch, capsys):
    """No flag is refused since ``--weight-quant`` was ported: it reaches the
    engine's ``weight_quant``, and a value other than int8 is refused."""
    import radixmesh_tpu_torch.engine.engine as engine_mod
    from radixmesh_tpu_torch.launch import _NOT_PORTED_FLAGS, main

    assert _NOT_PORTED_FLAGS == ()
    seen = {}

    def engine(cfg, params, **kw):
        seen.update(kw)
        raise _Reached

    monkeypatch.setattr(engine_mod, "Engine", engine)
    with pytest.raises(_Reached):
        main(["serve", "--model", "llama3-tiny", "--device", "cpu", flag, "int8"])
    assert seen["weight_quant"] == "int8"
    with pytest.raises(SystemExit) as e:
        main(["serve", "--model", "llama3-tiny", flag, "int4"])
    assert e.value.code == 2
    assert "invalid choice" in capsys.readouterr().err


# Each flag this launcher took over from the refusal list, with what
# ``ServingFrontend`` must receive for it (the JAX launcher's parsing).
_PORTED_FLAGS = {
    "--slo": (["--slo"], lambda kw: kw["slo"] is not None and kw["slo"].tenants == {}),
    "--slo-ttft-ms": (["--slo-ttft-ms", "1500"],
                      lambda kw: kw["slo"].default_ttft_slo_s == 1.5),
    "--slo-tenant": (["--slo-tenant", "a=3", "--slo-tenant", "c=1:2000"],
                     lambda kw: {n: (t.weight, t.rate_tokens_per_s) for n, t in kw["slo"].tenants.items()}
                     == {"a": (3.0, 0.0), "c": (1.0, 2000.0)}),
    "--telemetry-history-interval": (["--telemetry-history-interval", "0.25"],
                                     lambda kw: kw["history_interval_s"] == 0.25 and kw["slo"] is None),
    "--blackbox-dir": (["--blackbox-dir", "/bb"],
                       lambda kw: kw["blackbox_dir"] == "/bb" and kw["blackbox_watchdog_s"] == 10.0
                       and kw["history_interval_s"] == 1.0),
    "--blackbox-watchdog": (["--blackbox-dir", "/bb", "--blackbox-watchdog", "4"],
                            lambda kw: kw["blackbox_watchdog_s"] == 4.0),
}


@pytest.mark.parametrize("flag", sorted(_PORTED_FLAGS))
def test_launcher_passes_ported_flags_to_the_frontend(flag, monkeypatch):
    import radixmesh_tpu_torch.server.http_frontend as hf
    from radixmesh_tpu_torch.launch import _NOT_PORTED_FLAGS, main

    assert flag not in _NOT_PORTED_FLAGS
    seen = {}

    def frontend(engine, **kw):
        seen.update(kw)
        raise _Reached

    monkeypatch.setattr(hf, "ServingFrontend", frontend)
    argv, ok = _PORTED_FLAGS[flag]
    with pytest.raises(_Reached):
        main(["serve", "--model", "llama3-tiny", "--device", "cpu", "--kv-slots", "256", *argv])
    assert ok(seen), seen


def test_launcher_parses_kv_quant_int8():
    from radixmesh_tpu_torch.launch import parse_args

    args = parse_args(["serve", "--kv-quant", "int8", "--device", "cpu"])
    assert (args.kv_quant, args.device, args.cmd) == ("int8", "cpu", "serve")
    assert parse_args(["serve"]).kv_quant is None


def test_launcher_parses_the_schedule_flags():
    from radixmesh_tpu_torch.launch import parse_args

    args = parse_args([
        "serve", "--device", "cpu", "--decode-steps-per-launch", "4", "--prefill-inline-budget", "64",
        "--prefill-inline-max-defer", "3", "--paged-min-batch", "2", "--spec-decode-tokens", "4",
        "--spec-adaptive",
    ])
    assert (args.decode_steps_per_launch, args.prefill_inline_budget, args.prefill_inline_max_defer,
            args.paged_min_batch, args.spec_decode_tokens, args.spec_adaptive) == (4, 64, 3, 2, 4, True)
    d = parse_args(["serve"])
    assert (d.decode_steps_per_launch, d.prefill_inline_budget, d.prefill_inline_max_defer,
            d.paged_min_batch, d.spec_decode_tokens, d.spec_adaptive) == (1, 0, 2, 0, 0, False)


def test_launcher_parses_the_tier_flags():
    from radixmesh_tpu_torch.launch import _NOT_PORTED_FLAGS, parse_args

    tier_flags = ("--host-cache-slots", "--kv-transfer-async", "--kv-transfer-chunk",
                  "--kv-transfer-min-restore", "--kv-tier-dir", "--kv-tier-capacity-gb")
    assert not set(tier_flags) & set(_NOT_PORTED_FLAGS)
    args = parse_args([
        "serve", "--device", "cpu", "--host-cache-slots", "4096", "--kv-transfer-async",
        "--kv-transfer-chunk", "64", "--kv-transfer-min-restore", "32", "--kv-tier-dir", "/d",
        "--kv-tier-capacity-gb", "2.5",
    ])
    assert (args.host_cache_slots, args.kv_transfer_async, args.kv_transfer_chunk,
            args.kv_transfer_min_restore, args.kv_tier_dir, args.kv_tier_capacity_gb) == (
        4096, True, 64, 32, "/d", 2.5)
    d = parse_args(["serve"])
    assert (d.host_cache_slots, d.kv_transfer_async, d.kv_transfer_chunk,
            d.kv_transfer_min_restore, d.kv_tier_dir, d.kv_tier_capacity_gb) == (
        0, False, None, None, None, None)


def test_launcher_parses_the_replay_and_observability_flags():
    from radixmesh_tpu_torch.launch import _NOT_PORTED_FLAGS, parse_args

    flags = ("--stream-publish", "--step-accounting", "--peak-tflops", "--profile-dir",
             "--trace-capacity", "--trace-sample", "--trace-dir", "--token-timeline-capacity",
             "--token-stall-threshold-ms")
    assert not set(flags) & set(_NOT_PORTED_FLAGS)
    args = parse_args([
        "serve", "--device", "cpu", "--stream-publish", "8", "--step-accounting",
        "--peak-tflops", "989", "--profile-dir", "/p", "--trace-capacity", "64",
        "--trace-sample", "0.5", "--trace-dir", "/t", "--token-timeline-capacity", "0",
        "--token-stall-threshold-ms", "20",
    ])
    assert (args.stream_publish, args.step_accounting, args.peak_tflops, args.profile_dir,
            args.trace_capacity, args.trace_sample, args.trace_dir,
            args.token_timeline_capacity, args.token_stall_threshold_ms) == (
        8, True, 989.0, "/p", 64, 0.5, "/t", 0, 20.0)
    d = parse_args(["serve"])
    assert (d.stream_publish, d.step_accounting, d.peak_tflops, d.profile_dir, d.trace_capacity,
            d.trace_sample, d.trace_dir, d.token_timeline_capacity,
            d.token_stall_threshold_ms) == (None, False, None, None, 8192, None, None, 4096, 50.0)


def test_launcher_parses_weights_and_tokenizer():
    from radixmesh_tpu_torch.launch import _NOT_PORTED_FLAGS, parse_args

    assert not {"--weights", "--tokenizer"} & set(_NOT_PORTED_FLAGS)
    args = parse_args(["serve", "--model", "qwen2-7b", "--weights", "/ckpt", "--tokenizer", "byte"])
    assert (args.model, args.weights, args.tokenizer) == ("qwen2-7b", "/ckpt", "byte")
    d = parse_args(["serve"])
    assert (d.weights, d.tokenizer) == (None, None)


def test_launcher_serves_a_checkpoint_with_text(tmp_path):
    """``serve --weights DIR --tokenizer byte --device cpu``: the launcher
    loads a checkpoint written by ``save_hf_state_dict`` and answers
    ``text`` with ``text``; a repeat hits the prefix cache."""
    import json
    import socket
    import time
    import urllib.request

    from radixmesh_tpu_torch.models import get_config
    from radixmesh_tpu_torch.models.convert import hf_state_dict
    from radixmesh_tpu_torch.models.hf_io import save_hf_state_dict
    from radixmesh_tpu_torch.models.llama import init_params

    cfg = get_config("qwen2-tiny")
    params = init_params(cfg, seed=2, device="cpu")
    params["layers"]["bk"].normal_(generator=torch.Generator().manual_seed(2))
    save_hf_state_dict(hf_state_dict(cfg, params), str(tmp_path / "ck"), max_shard_bytes=1 << 18)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    log = open(tmp_path / "serve.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "radixmesh_tpu_torch.launch", "serve", "--model", "qwen2-tiny",
         "--device", "cpu", "--kv-slots", "512", "--page-size", "4", "--http-port", str(port),
         "--weights", str(tmp_path / "ck"), "--tokenizer", "byte"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)

    def post(body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        deadline = time.monotonic() + 90
        while True:
            assert proc.poll() is None, (tmp_path / "serve.log").read_text()
            assert time.monotonic() < deadline, (tmp_path / "serve.log").read_text()
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2).close()
                break
            except OSError:
                time.sleep(0.2)
        body = {"text": "a prompt long enough to share a page", "max_tokens": 4, "stop_token_ids": []}
        first, again = post(body), post(body)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        log.close()
    assert isinstance(first["text"], str) and len(first["output_ids"]) == 4
    assert again["cached_tokens"] > 0 and again["output_ids"] == first["output_ids"]


def test_launcher_multihost_dryrun_needs_a_backend_and_the_card(monkeypatch, capsys):
    """``multihost-dryrun`` takes the JAX launcher's flags plus a required
    ``--backend`` (never chosen silently) and runs on the card unless
    ``--device cpu`` is given: without CUDA it raises before joining a job."""
    from radixmesh_tpu_torch.launch import main, parse_args

    base = ["multihost-dryrun", "--coordinator", "127.0.0.1:1", "--num-processes", "2", "--process-id", "0"]
    with pytest.raises(SystemExit):
        parse_args(base)
    assert "--backend" in capsys.readouterr().err
    args = parse_args(base + ["--local-devices", "2", "--mesh", "1,1,2", "--backend", "gloo"])
    assert (args.local_devices, args.mesh, args.backend, args.device) == (2, "1,1,2", "gloo", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        main(base + ["--backend", "nccl"])
