"""The artifact schemas over the port: the cases of
``tests/test_bench_artifacts.py``, run against ``radixmesh_tpu_torch.reports``
(``bench.py``'s validators, builders and benchdiff sentinel, copied). Cases
that reach the JAX package's headline bench (``TestNonEvidentialMarking``:
``bench._emit`` is not ported) or run one of its scripts are dropped; those
that run a script get a twin here that drives the port's command line:
``TestBenchdiffCLI`` (``radixmesh_tpu_torch.scripts.benchdiff``, the same
pinned exit codes) and the ringbench emitter's shape
(``radixmesh_tpu_torch.scripts.ringbench.run_paired``)."""

import json

import pytest
from _torch_twin import load_twin

from radixmesh_tpu_torch import reports
from radixmesh_tpu_torch.scripts import benchdiff, ringbench

load_twin("test_bench_artifacts", globals(),
          subs=(("import bench\n", "from radixmesh_tpu_torch import reports as bench\n"),),
          drop=("TestRingbenchSchema.test_run_paired_shape_matches_schema", "TestNonEvidentialMarking",
                "TestBenchdiffCLI"))


def test_run_paired_shape_matches_schema(monkeypatch):
    """The port's emitter and the validators agree: a paired report built
    by the port's ``run_paired`` (the 6-process runs patched with canned
    sections) passes the port's validator and the JAX package's."""
    import bench as jax_bench

    sections = iter([_run_section(16), _run_section(1)])  # noqa: F821 (the twin's)
    monkeypatch.setattr(ringbench, "run", lambda *a, **k: next(sections))
    report = ringbench.run_paired(400, 200, 5000)
    assert report["schema_version"] == reports.RINGBENCH_SCHEMA_VERSION
    assert "schema_violation" not in report
    assert reports.validate_ringbench(report) == [] == jax_bench.validate_ringbench(report)
    assert report["vs_round3_wire"] == pytest.approx(2092 / 864, abs=1e-3)


class TestBenchdiffCLI:
    """The port's benchdiff keeps the pinned exit codes: 0 clean / 1
    regression / 2 schema mismatch or an unreadable file."""

    def _run(self, tmp_path, capsys, old, new, *flags, old_name="CHAOS_r01.json",
             new_name="CHAOS_r02.json"):
        a, b = tmp_path / old_name, tmp_path / new_name
        a.write_text(json.dumps(old))
        b.write_text(json.dumps(new))
        rc = benchdiff.main([str(a), str(b), *flags])
        return rc, capsys.readouterr().out

    def _chaos(self, **over) -> dict:
        base = {"metric": "chaos_heal_converge_s", "schema_version": reports.CHAOS_SCHEMA_VERSION, "value": 0.4,
                "crash": {"resurrection_hit_ratio": 0.95}, "repair": {"converge_s": 0.4}}
        base.update(over)
        return base

    def test_identical_pair_exits_0(self, tmp_path, capsys):
        rc, out = self._run(tmp_path, capsys, self._chaos(), self._chaos())
        assert rc == reports.BENCHDIFF_EXIT_CLEAN, out
        assert "CLEAN" in out

    def test_regression_exits_1_and_names_the_metric(self, tmp_path, capsys):
        rc, out = self._run(tmp_path, capsys, self._chaos(), self._chaos(value=2.0, repair={"converge_s": 2.0}))
        assert rc == reports.BENCHDIFF_EXIT_REGRESSION
        assert "repair.converge_s" in out

    def test_cross_kind_exits_2(self, tmp_path, capsys):
        obs = {"metric": "obs_stitched_node_tracks", "schema_version": 1, "value": 6}
        rc, _ = self._run(tmp_path, capsys, self._chaos(), obs, new_name="OBS_r02.json")
        assert rc == reports.BENCHDIFF_EXIT_MISMATCH

    def test_unreadable_input_exits_2(self, tmp_path, capsys):
        a = tmp_path / "CHAOS_r01.json"
        a.write_text("{not json")
        assert benchdiff.main([str(a), str(a)]) == reports.BENCHDIFF_EXIT_MISMATCH
        assert "cannot read artifact" in capsys.readouterr().err

    def test_strict_flag_zeroes_thresholds(self, tmp_path, capsys):
        slightly = self._chaos(value=0.41, repair={"converge_s": 0.41})
        assert self._run(tmp_path, capsys, self._chaos(), slightly)[0] == reports.BENCHDIFF_EXIT_CLEAN
        assert self._run(tmp_path, capsys, self._chaos(), slightly, "--strict")[0] == \
            reports.BENCHDIFF_EXIT_REGRESSION

    def test_json_output_carries_the_full_diff(self, tmp_path, capsys):
        _, out = self._run(tmp_path, capsys, self._chaos(), self._chaos(value=2.0, repair={"converge_s": 2.0}),
                           "--json")
        out = json.loads(out)
        assert out["status"] == "regression"
        assert any(r["verdict"] == "regression" for r in out["rows"])

    def test_real_checked_in_pair_diffs(self, capsys):
        """The port's benchdiff reads the JAX package's checked-in trajectory:
        the two BENCH_FULL rounds compare without a schema refusal."""
        import os

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        rc = benchdiff.main([os.path.join(repo, "BENCH_FULL_r04.json"), os.path.join(repo, "BENCH_FULL_r05.json")])
        assert rc in (reports.BENCHDIFF_EXIT_CLEAN, reports.BENCHDIFF_EXIT_REGRESSION), capsys.readouterr().out

    def test_port_artifact_names_read_by_metric(self, tmp_path, capsys):
        """``<KIND>_torch_r{N}.json`` is not a JAX round name: the kind comes
        from the pinned metric, and two port rounds diff like JAX ones."""
        rc, out = self._run(tmp_path, capsys, self._chaos(), self._chaos(), old_name="CHAOS_torch_r22.json",
                            new_name="CHAOS_torch_r23.json")
        assert rc == reports.BENCHDIFF_EXIT_CLEAN and "kind=CHAOS" in out
