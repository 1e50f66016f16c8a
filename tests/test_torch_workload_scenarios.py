"""The port's speculative-decoding and prefill-convoy acceptance scenarios
(``workload.run_spec_workload``, ``workload.run_convoy_workload``) against
the JAX package's, on the CPU at the same seed and reduced arguments: the
verdicts that depend on neither the wall clock nor the weights' random
numbers hold and equal the JAX report's, and every port report carries the
fields the JAX package's artifact schema (``bench.SPEC_*_FIELDS``,
``bench.CONVOY_*_FIELDS``) names. The JAX reports are computed once per
module. Wall-clock verdicts (``no_worse``, ``under_budget``, the TTFT
ratios, ITL percentiles) are not asserted: they flip on the JAX package
itself under load. The port's weights are its own draw, so tokens are
compared only within the port (``outputs_match`` in float32)."""

import pytest
import torch
from _torch_cli import hold_report, run_cli
from _torch_twin import fresh_port_globals, missing_artifact_fields

from radixmesh_tpu_torch import workload as pw
from radixmesh_tpu_torch.models.llama import ModelConfig

torch.set_num_threads(1)  # the suite runs in parallel worker processes

CONVOY_KW = dict(seed=0, reps=1)


@pytest.fixture(scope="module")
def spec():
    from radixmesh_tpu import workload as jw

    ref = jw.run_spec_workload(seed=0)
    with fresh_port_globals():
        return {"jax": ref, "port": pw.run_spec_workload(seed=0, device="cpu")}


@pytest.fixture(scope="module")
def convoy():
    from radixmesh_tpu import workload as jw

    toy_f32 = ModelConfig(vocab_size=256, hidden=64, n_layers=2, n_heads=2, n_kv_heads=2, head_dim=32,
                          intermediate=128, max_seq_len=1024, dtype=torch.float32)
    ref = jw.run_convoy_workload(**CONVOY_KW)
    with fresh_port_globals():
        return {"jax": ref, "port": pw.run_convoy_workload(**CONVOY_KW, device="cpu"),
                "port f32": pw.run_convoy_workload(**CONVOY_KW, cfg=toy_f32, device="cpu")}


def test_spec_conserves_drafts_and_detects_the_seeded_stall(spec):
    port, ref = spec["port"], spec["jax"]
    acc = port["acceptance"]
    assert acc["conserved"] is True and ref["acceptance"]["conserved"] is True
    assert acc["proposed"] == acc["accepted"] + acc["rejected"] > 0
    for axis in ("by_shape", "by_source"):
        cells = acc[axis].values()
        assert sum(c["proposed"] for c in cells) == acc["proposed"], axis
        assert all(c["proposed"] == c["accepted"] + c["rejected"] for c in cells), axis
    # The same prompt shapes and draft sources are exercised (the counts
    # differ with the weights).
    assert set(acc["by_shape"]) == set(ref["acceptance"]["by_shape"])
    assert set(acc["by_source"]) == set(ref["acceptance"]["by_source"])
    assert port["itl"]["seeded_cause"] == ref["itl"]["seeded_cause"] == "scheduler_wait"
    assert port["itl"]["seeded_detected"] is True and ref["itl"]["seeded_detected"] is True
    assert port["requests"] == ref["requests"]
    assert port["adaptive"]["gamma_base"] == ref["adaptive"]["gamma_base"]
    assert port["overhead"]["tokens"] == ref["overhead"]["tokens"]


def test_spec_report_has_the_artifact_fields(spec):
    sections = {"acceptance": "ACCEPTANCE", "itl": "ITL", "adaptive": "ADAPTIVE", "overhead": "OVERHEAD"}
    assert not missing_artifact_fields(spec["port"], "SPEC", sections, spec["jax"])


def test_convoy_starvation_bound_and_sweep_dispatch(convoy):
    ref = convoy["jax"]
    for tag in ("port", "port f32"):
        port = convoy[tag]
        st = port["starvation"]
        assert st["bounded"] is True and ref["starvation"]["bounded"] is True, tag
        assert st["max_step_gap"] <= st["max_defer_bound"] == ref["starvation"]["max_defer_bound"]
        assert st["skew"] == ref["starvation"]["skew"]
        keys = ("batch", "bucket", "paged_selected")
        assert [{k: e[k] for k in keys} for e in port["crossover"]["sweep"]] == \
            [{k: e[k] for k in keys} for e in ref["crossover"]["sweep"]], tag
        assert port["crossover"]["small_batch_ok"] == ref["crossover"]["small_batch_ok"]
        # The paged leg agrees with the dense leg on each batch's inputs.
        assert port["crossover"]["outputs_agree"] is True, tag
        assert all(e["max_abs_err"] <= pw.SWEEP_ATOL for e in port["crossover"]["sweep"]), tag
        assert port["interleave"]["reps"] == ref["interleave"]["reps"] == 1


def test_convoy_float32_arms_emit_the_same_tokens(convoy):
    """The legacy and mixed-wave arms on identical schedules: token for token
    alike in float32 (the JAX package holds this in float32 only)."""
    inter = convoy["port f32"]["interleave"]
    assert inter["outputs_match"] is True
    assert inter["waves"]["counts"]["mixed"] > 0


def test_convoy_report_has_the_artifact_fields(convoy):
    sections = {"interleave": "INTERLEAVE", "stalls": "STALL", "starvation": "STARVATION",
                "crossover": "CROSSOVER"}
    for tag in ("port", "port f32"):
        assert not missing_artifact_fields(convoy[tag], "CONVOY", sections, convoy["jax"]), tag


def test_specbench_builds_and_validates_the_spec_report(spec, monkeypatch, tmp_path, capsys):
    """``radixmesh_tpu_torch.scripts.specbench`` over the fixture's run:
    the toy model on the CPU, its flags passed through, the SPEC report
    valid for both packages' validators."""
    from radixmesh_tpu_torch.scripts import specbench

    rc, report, kw = run_cli(monkeypatch, tmp_path, capsys, specbench, "run_spec_workload", spec["port"],
                             ["--device", "cpu", "--model", "toy", "--gamma", "3"])
    assert kw == dict(seed=0, gamma=3, overhead_tokens=1000, cfg=None, device="cpu")
    assert report["metric"] == "spec_accepted_tokens_per_step"
    hold_report("spec", rc, report)


def test_convoybench_builds_and_validates_the_convoy_report(convoy, monkeypatch, tmp_path, capsys):
    """``radixmesh_tpu_torch.scripts.convoybench`` over the fixture's float32
    run: the default model (Llama-3-8B's widths, 2 layers) is float32; the
    CONVOY report is complete for both validators (its crossover timings
    are the run's own wall-clock verdicts, not held on the CPU)."""
    from radixmesh_tpu_torch.scripts import convoybench

    rc, report, kw = run_cli(monkeypatch, tmp_path, capsys, convoybench, "run_convoy_workload", convoy["port f32"],
                             ["--device", "cpu", "--reps", "1"])
    cfg = kw.pop("cfg")
    assert (cfg.n_layers, cfg.dtype, cfg.hidden, cfg.head_dim) == (2, torch.float32, 4096, 128)
    assert kw == dict(seed=0, inline_budget=32, max_defer=2, reps=1, device="cpu")
    assert report["metric"] == "convoy_ttft_speedup"
    hold_report("convoy", rc, report)
