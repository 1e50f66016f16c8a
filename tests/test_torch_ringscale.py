"""The port's ring-scale sweep (``radixmesh_tpu_torch.scripts.ringscale``):
the cases of ``tests/test_ringscale.py`` run against it (each sweep in a
subprocess of its own, as there), and a small ringbench run
(``radixmesh_tpu_torch.scripts.ringbench``: two 6-process rings over the
port's native transport) whose paired report passes the port's validator
and the JAX package's."""

import json

from _torch_twin import load_twin

load_twin("test_ringscale", globals(), subs=((
    'sys.path.insert(0, {scripts!r})\nimport jax\njax.config.update("jax_platforms", "cpu")\n'
    "from ringscale import run_ring\n",
    "from radixmesh_tpu_torch.scripts.ringscale import run_ring\n"),))


def test_small_ringbench_report_passes_both_validators(tmp_path, capsys):
    import bench

    from radixmesh_tpu_torch import reports
    from radixmesh_tpu_torch.scripts import ringbench

    out = tmp_path / "ringbench.json"
    rc = ringbench.main(["--inserts", "12", "--laps", "8", "--routes", "200", "--key-len", "32", "--page-size", "16",
                         "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == 0, report
    assert reports.validate_ringbench(report) == [] == bench.validate_ringbench(report)
    paged, token = report["page_granular"], report["token_granular_baseline"]
    assert (paged["page_size"], token["page_size"]) == (16, 1)
    assert paged["wire_bytes_per_insert"] < token["wire_bytes_per_insert"]
    assert report["value"] > 0 and paged["lap_latency"]["n"] == 8 and paged["route"]["n"] == 200
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
