"""The port's artifact command lines (``radixmesh_tpu_torch/scripts/``, and
``python -m radixmesh_tpu_torch.doctor --workload``) as a caller meets them:
each one that builds engines runs on the card unless ``--device cpu`` is
given and raises without one; none writes over a JAX package artifact
(``<KIND>_r{N}.json``), refusing the name with exit 2 before anything runs;
``--write-artifact`` names the port's file ``<KIND>_torch_r{N}.json``, one
round past every other plane's recorded artifact of either package; and
the HTTP soak runs end to end on the toy model on the CPU."""

import json

import pytest
import torch

from radixmesh_tpu_torch import doctor, reports
from radixmesh_tpu_torch.scripts import (aggbench, blackboxbench, chaosbench, convoybench, fleetbench, kvflowbench,
                                         obsbench, rebalancebench, ringbench, ringscale, soak, specbench, tierbench)

ENGINE_CLIS = {"specbench": specbench, "convoybench": convoybench, "kvflowbench": kvflowbench,
               "tierbench": tierbench, "obsbench": obsbench, "blackboxbench": blackboxbench,
               "aggbench": aggbench, "soak": soak}
KINDS = {**{name: (mod, name.removesuffix("bench").upper()) for name, mod in ENGINE_CLIS.items()},
         "fleetbench": (fleetbench, "FLEET"), "chaosbench": (chaosbench, "CHAOS"),
         "rebalancebench": (rebalancebench, "REBALANCE"), "ringbench": (ringbench, "RINGBENCH"),
         "ringscale": (ringscale, "RINGSCALE")}


@pytest.mark.parametrize("name", sorted(ENGINE_CLIS) + ["doctor --workload"])
def test_engine_command_lines_default_to_cuda_and_raise_without_it(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, argv = ((doctor.main, ["--workload"]) if name == "doctor --workload"
                  else (ENGINE_CLIS[name].main, ["--seconds", "1"] if name == "soak" else []))
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        main(argv)


@pytest.mark.parametrize("name", sorted(KINDS))
def test_an_out_naming_a_jax_artifact_is_refused(name, tmp_path, capsys, monkeypatch):
    mod, kind = KINDS[name]
    # Nothing may run: every scenario and sweep entry point raises here.
    for attr in ("run", "run_paired", "run_ring", "run_ring_sim", "run_ring_procs", "run_soak"):
        if hasattr(mod, attr):
            monkeypatch.setattr(mod, attr, lambda *a, **k: pytest.fail("ran before refusing"))
    out = tmp_path / f"{kind}_r07.json"
    assert mod.main(["--out", str(out)]) == 2
    assert f"JAX package's {kind} artifact" in capsys.readouterr().err
    assert not out.exists()


def test_artifact_rounds_count_both_packages_and_never_name_a_jax_file(tmp_path):
    for name in ("CHAOS_r08.json", "SPEC_r18.json", "SPEC_torch_r21.json", "TIER_torch_r20.json",
                 "notes_r99.json"):
        (tmp_path / name).write_text("{}")
    # SPEC rides the highest OTHER plane's round, the port's TIER_torch_r20.
    assert reports.artifact_round("SPEC", str(tmp_path)) == 21
    assert reports.artifact_path("SPEC", str(tmp_path)).endswith("SPEC_torch_r21.json")
    assert reports.artifact_round("TIER", str(tmp_path)) == 22
    assert reports.artifact_round("DOCTOR", str(tmp_path)) == 22
    assert reports.jax_artifact("x/CHAOS_r08.json") and reports.jax_artifact("BENCH_FULL_r05.json")
    assert not reports.jax_artifact("CHAOS_torch_r08.json") and not reports.jax_artifact("chaos.json")


def test_write_artifact_writes_the_ports_round_file(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(reports, "_REPO_ROOT", str(tmp_path))
    (tmp_path / "CONVOY_r19.json").write_text("{}")
    monkeypatch.setattr(specbench, "run_spec_workload", lambda **kw: {"stub": True})
    monkeypatch.setattr(reports, "build_spec_report", lambda res: {"metric": "spec_accepted_tokens_per_step"})
    monkeypatch.setattr(reports, "validate_spec", lambda report: [])
    assert specbench.main(["--device", "cpu", "--model", "toy", "--write-artifact"]) == 0
    assert "specbench: wrote SPEC_torch_r20.json" in capsys.readouterr().err
    assert json.loads((tmp_path / "SPEC_torch_r20.json").read_text()) == {"metric": "spec_accepted_tokens_per_step"}


def test_soak_serves_the_toy_model_over_http_on_the_cpu(tmp_path, capsys):
    """``radixmesh_tpu_torch.scripts.soak`` for 3 s: two clients' multi-turn
    conversations through the port's ``ServingFrontend``, none failed, and
    every turn after the first hits the prefix cache."""
    out = tmp_path / "soak.json"
    rc = soak.main(["--seconds", "3", "--clients", "2", "--conversations", "2", "--gen-len", "4",
                    "--device", "cpu", "--model", "toy", "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == 0 and report["errors"] == 0
    assert report["metric"] == "soak_requests" and report["value"] > 4 and report["generated_tokens"] > 0
    assert report["hit_rate"] > 0.3
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
