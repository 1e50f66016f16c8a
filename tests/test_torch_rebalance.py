"""``cache/rebalance.py`` in the port: the cases of ``tests/test_rebalance.py``,
run against ``radixmesh_tpu_torch``, ``TestRebalanceStormQuick`` included (it
drives the port's ``workload._chaos_rebalance_phase``) and
``TestMeshcheckOnPlane``, which runs the port's meshcheck
(``radixmesh_tpu_torch.analysis``) over the plane's files; then the
rebalance phase on a starved host (fault C12) and the REBALANCE command
line end to end."""

import contextlib
import json
import time

import numpy as np
from _torch_twin import load_twin

load_twin("test_rebalance", globals())


@contextlib.contextmanager
def _quick_gate_cluster():
    """``small_cluster``'s mesh (4 prefill, 2 decode, 2 routers, rf 2, heat
    half-life 0.15 s), as a context so that one test can build two."""
    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
    from radixmesh_tpu_torch.comm.inproc import InprocHub
    from radixmesh_tpu_torch.config import MeshConfig, NodeRole

    InprocHub.reset_default()
    prefill, decode, routers = ["tp0", "tp1", "tp2", "tp3"], ["td0", "td1"], ["tr0", "tr1"]
    nodes = [MeshCache(MeshConfig(prefill_nodes=prefill, decode_nodes=decode, router_nodes=routers,
                                  local_addr=addr, protocol="inproc", tick_interval_s=0.05, gc_interval_s=60.0,
                                  failure_timeout_s=60.0, replication_factor=2, heat_half_life_s=0.15),
                       pool=None).start()
             for addr in prefill + decode + routers]
    try:
        for n in nodes:
            assert n.wait_ready(timeout=20)
        yield ([n for n in nodes if n.role is not NodeRole.ROUTER],
               [n for n in nodes if n.role is NodeRole.ROUTER])
    finally:
        for n in nodes:
            n.close()
        InprocHub.reset_default()


def _quick_gate_phase() -> dict:
    from radixmesh_tpu_torch.workload import _chaos_rebalance_phase

    with _quick_gate_cluster() as (ring, routers):
        return _chaos_rebalance_phase(ring=ring, router_mesh=routers[0],
                                      by_addr={n.cfg.local_addr: n for n in ring}, rng=np.random.default_rng(0),
                                      wait_for=wait_for, key_len=12, zipf_keys=12, zipf_inserts=90,  # noqa: F821
                                      wave_s=0.3, settle_s=0.4, mid_requests=12, timeout_s=15.0)


def test_rebalance_phase_reads_the_same_skew_on_a_starved_host(monkeypatch):
    """C12: the storm's heat decayed on the wall clock, so a host too
    loaded to serve a 0.3 s wave in 0.3 s (each request 10 ms late here,
    the waves ~1 s against the 0.15 s half-life) read only each wave's
    last requests, and ``skew_dropped`` flipped. The port's phase decays
    the heat on its request-paced clock and reads it once every rank's
    summary is folded: wave 1's skew reads as on a free host, and the
    skew drops."""
    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache

    free = _quick_gate_phase()
    insert = MeshCache.insert

    def late_insert(self, *args, **kwargs):
        time.sleep(0.01)
        return insert(self, *args, **kwargs)

    monkeypatch.setattr(MeshCache, "insert", late_insert)
    starved = _quick_gate_phase()
    assert starved["skew_before"] == free["skew_before"], (starved, free)
    assert starved["skew_dropped"] and starved["skew_after"] < starved["skew_before"], starved
    assert starved["failed_mid_move"] == 0 and starved["overrides_converged"], starved


def test_rebalancebench_report_embeds_the_ports_meshcheck(tmp_path, capsys):
    """``radixmesh_tpu_torch.scripts.rebalancebench`` end to end (the chaos
    scenario's rebalance and router-kill phases on an rf 2 mesh, then the
    port's meshcheck over the plane's files): the REBALANCE report embeds 0
    findings, both packages' validators read it alike, and the command
    line's exit code follows them."""
    from _torch_cli import hold_report

    from radixmesh_tpu_torch.scripts import rebalancebench

    out = tmp_path / "rebalance.json"
    rc = rebalancebench.main(["--out", str(out)])
    report = json.loads(out.read_text())
    assert report["meshcheck"]["clean"] is True and report["meshcheck"]["findings"] == 0
    assert report["rebalance"]["performed"] and report["router_kill"]["performed"]
    assert report["rebalance"]["failed_mid_move"] == 0 and report["router_kill"]["failed"] == 0
    hold_report("rebalance", rc, report)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
