"""The port's black box (``radixmesh_tpu_torch/obs/blackbox.py``) held
against the JAX package's: the doctor-free cases of
``tests/test_blackbox.py`` on both packages (atomic segments with disjoint
sequence ranges, a simulated hard kill leaving complete segments only, the
prior boot's dump rotated at start, finals with every section, with and
without a mesh doctor, each trigger its own final, the watchdog
firing once on a stalled sampler and staying quiet on a live one, the
loader's refusals); each package's ``load_blackbox`` reads the other
package's dump with equal results, and the two dump directories of the
same operations hold the same files; and the port's frontend flushes on
``POST /admin/blackbox`` and on close, with a segment at every sample and
its doctor's report in the final."""

import json
import os
import time
import urllib.request

import pytest
import torch

from radixmesh_tpu.obs import blackbox as jbb
from radixmesh_tpu.obs import doctor as jdoctor
from radixmesh_tpu.obs import metrics as jmetrics
from radixmesh_tpu.obs import timeseries as jts
from radixmesh_tpu_torch.obs import blackbox as tbb
from radixmesh_tpu_torch.obs import doctor as tdoctor
from radixmesh_tpu_torch.obs import metrics as tmetrics
from radixmesh_tpu_torch.obs import timeseries as tts

torch.set_num_threads(1)  # the suite runs in parallel worker processes

PKGS = {"jax": (jbb, jts, jmetrics), "torch": (tbb, tts, tmetrics)}


@pytest.fixture(autouse=True)
def fresh_registries():
    old = (jmetrics.set_registry(jmetrics.Registry()), tmetrics.set_registry(tmetrics.Registry()))
    yield
    jmetrics.set_registry(old[0])
    tmetrics.set_registry(old[1])


def _history(pkg, **kw):
    kw.setdefault("interval_s", 1.0)
    kw.setdefault("capacity", 64)
    return PKGS[pkg][1].TelemetryHistory(**kw)


def _counter(pkg):
    return PKGS[pkg][2].get_registry().counter("radixmesh_test_total", "t")


@pytest.mark.parametrize("pkg", sorted(PKGS))
class TestBlackBoxCases:
    def test_segment_cadence_and_atomic_files(self, pkg, tmp_path):
        bbm = PKGS[pkg][0]
        c = _counter(pkg)
        h = _history(pkg)
        bb = bbm.BlackBox(str(tmp_path), history=h, node="n0", segment_every=3)
        for t in range(9):
            c.inc()
            h.sample(t=float(t))
        assert bb.stats()["segments"] == 3
        segs = sorted(f for f in os.listdir(bb.dir) if f.startswith("segment-"))
        assert segs == [f"segment-{i:06d}.json" for i in range(3)]
        for f in segs:
            with open(os.path.join(bb.dir, f)) as fh:
                seg = json.load(fh)
            assert seg["schema_version"] == bbm.BLACKBOX_SCHEMA_VERSION and seg["kind"] == "segment"
        assert not [f for f in os.listdir(bb.dir) if ".tmp." in f]
        pts = bbm.load_blackbox(str(tmp_path))["series"]["radixmesh_test_total"]
        assert [p[0] for p in pts] == list(range(9))  # no dupes, no holes

    def test_hard_kill_leaves_complete_segments_and_restart_rotates(self, pkg, tmp_path):
        bbm = PKGS[pkg][0]
        c = _counter(pkg)
        h = _history(pkg)
        bb = bbm.BlackBox(str(tmp_path), history=h, node="n0", segment_every=2)
        for t in range(5):
            c.inc()
            h.sample(t=float(t))
        bb.close()  # no flush: the kill -9 simulation
        dump = bbm.load_blackbox(str(tmp_path))
        assert (dump["unclean"], dump["segments"], dump["finals"], dump["last_seq"]) == (True, 2, 0, 3)
        h2 = _history(pkg)
        bb2 = bbm.BlackBox(str(tmp_path), history=h2, node="n0", segment_every=2)
        for t in range(3):
            c.inc()
            h2.sample(t=float(t))
        bb2.flush("sigterm")
        bb2.close()
        old = bbm.load_blackbox(os.path.join(bb2.dir, "prior-000"))
        assert (old["unclean"], old["segments"], old["last_seq"]) == (True, 2, 3)
        new = bbm.load_blackbox(str(tmp_path))
        assert (new["unclean"], new["segments"], new["finals"]) == (False, 1, 1)

    def test_final_sections_without_a_doctor(self, pkg, tmp_path):
        bbm, _, metrics = PKGS[pkg]
        _counter(pkg).inc()
        h = _history(pkg)

        class FakeRecorder:
            def export_spans(self):
                return {"node": "n0", "spans": [], "dropped": 0}

        class FakeAttr:
            def report(self):
                return {"phases": {}, "recent": []}

        bb = bbm.BlackBox(str(tmp_path), history=h, doctor=None, recorder=FakeRecorder(),
                          attributor_fn=lambda: FakeAttr(),
                          state_fn=lambda: {"engine": {"name": "x"}}, node="n0")
        h.sample(t=0.0)
        res = bb.flush("admin")
        with open(res["path"]) as fh:
            final = json.load(fh)
        assert final["kind"] == "final" and final["cause"] == "admin"
        assert final["history"]["series"] and final["spans"]["node"] == "n0"
        assert final["waterfall"]["phases"] == {} and final["state"]["engine"]["name"] == "x"
        assert "doctor" not in final
        snap = metrics.get_registry().snapshot()
        assert snap['radixmesh_blackbox_flushes_total{cause="admin"}'] == 1.0
        assert snap["radixmesh_blackbox_bytes_total"] > 0

    def test_final_sections_with_the_mesh_doctor(self, pkg, tmp_path):
        """Each package's ``MeshDoctor`` over the history: its report is the
        final's ``doctor`` section, the same in both packages."""
        bbm = PKGS[pkg][0]
        doctor_mod = jdoctor if pkg == "jax" else tdoctor
        _counter(pkg).inc()
        h = _history(pkg)
        doc = doctor_mod.MeshDoctor(history=h)
        bb = bbm.BlackBox(str(tmp_path), history=h, doctor=doc, node="n0")
        h.sample(t=0.0)
        with open(bb.flush("admin")["path"]) as fh:
            final = json.load(fh)
        assert final["doctor"] == {"findings": [], "healthy": True,
                                   "rules_checked": ["tier_thrash", "goodput_regression"],
                                   "inputs": {"mesh": False, "engine": False, "slo": False,
                                              "attribution": False, "history": True,
                                              "aggregator": False}}

    def test_each_trigger_writes_its_own_final(self, pkg, tmp_path):
        bbm = PKGS[pkg][0]
        c = _counter(pkg)
        h = _history(pkg)
        bb = bbm.BlackBox(str(tmp_path), history=h, node="n0")
        c.inc()
        h.sample(t=0.0)
        bb.flush("admin")
        c.inc()
        h.sample(t=1.0)
        bb.flush("shutdown")
        dump = bbm.load_blackbox(str(tmp_path))
        assert (dump["finals"], dump["causes"], dump["unclean"]) == (2, ["admin", "shutdown"], False)
        assert dump["series"]["radixmesh_test_total"][-1][2] == 2.0

    def test_stalled_sampler_flushes_once(self, pkg, tmp_path):
        bbm = PKGS[pkg][0]
        h = _history(pkg, interval_s=0.005)
        h.sample(t=0.0)  # one heartbeat, then silence
        bb = bbm.BlackBox(str(tmp_path), history=h, node="n0", watchdog_timeout_s=0.05)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not bb.stats()["flushes"]:
            time.sleep(0.01)
        assert bb.stats()["flush_causes"] == ["watchdog"]
        time.sleep(0.15)
        assert bb.stats()["flushes"] == 1
        bb.close()

    def test_live_sampler_keeps_watchdog_quiet(self, pkg, tmp_path):
        bbm = PKGS[pkg][0]
        h = _history(pkg, interval_s=0.01, capacity=32)
        bb = bbm.BlackBox(str(tmp_path), history=h, node="n0", watchdog_timeout_s=1.0)
        h.start()
        try:
            time.sleep(0.1)
            assert bb.stats()["flushes"] == 0
        finally:
            h.close()
            bb.close()

    def test_loader_refusals_and_node_dir(self, pkg, tmp_path):
        bbm = PKGS[pkg][0]
        with pytest.raises(ValueError):
            bbm.load_blackbox(str(tmp_path))
        h = _history(pkg)
        bb = bbm.BlackBox(str(tmp_path / "a"), history=h, node="p@0")
        assert bbm.load_blackbox(str(tmp_path / "a"))["unclean"] is True  # manifest only
        _counter(pkg).inc()
        h.sample(t=0.0)
        bb.flush("admin")
        assert bbm.load_blackbox(str(tmp_path / "a"))["series"] == bbm.load_blackbox(bb.dir)["series"]
        path = os.path.join(bb.dir, "MANIFEST.json")
        with open(path) as fh:
            manifest = json.load(fh)
        manifest["schema_version"] = bbm.BLACKBOX_SCHEMA_VERSION + 1
        with open(path, "w") as fh:
            json.dump(manifest, fh)
        with pytest.raises(ValueError):
            bbm.load_blackbox(str(tmp_path / "a"))


def _write_dump(pkg, out_dir, kill: bool) -> None:
    """The same operations through one package: 7 samples, a segment every
    2, then a hard kill or an admin flush."""
    bbm = PKGS[pkg][0]
    c = _counter(pkg)
    g = PKGS[pkg][2].get_registry().gauge("radixmesh_test_flag", "t", ("tenant",))
    h = _history(pkg, capacity=16)
    bb = bbm.BlackBox(str(out_dir), history=h, node="n0", segment_every=2)
    for t in range(7):
        c.inc(t)
        g.labels(tenant=f"t{t % 2}").set(float(t))
        h.sample(t=100.0 + t)
    if not kill:
        bb.flush("admin")
    bb.close()


_CLOCK_KEYS = ("wall", "wall_offset", "created_wall", "pid", "sample_seconds_total")
# Series that depend on the process or its clock: the sampler's measured
# cost, and the bytes written (the digits of the wall-clock anchors).
_CLOCK_SERIES = ("radixmesh_history_sample_seconds", "radixmesh_blackbox_bytes_total")


def _comparable(dump: dict) -> dict:
    """A loaded dump without what depends on the process or its clock."""
    out = {k: v for k, v in dump.items() if k not in ("manifest", "final", "wall_offset")}
    out["series"] = {n: p for n, p in dump["series"].items() if not n.startswith(_CLOCK_SERIES)}
    out["manifest"] = {k: v for k, v in dump["manifest"].items() if k not in _CLOCK_KEYS}
    return out


@pytest.mark.parametrize("kill", [True, False], ids=["kill", "flush"])
def test_each_package_loads_the_others_dump(tmp_path, kill):
    for pkg in ("jax", "torch"):
        _write_dump(pkg, tmp_path / pkg, kill)
    loads = {(writer, reader): PKGS[reader][0].load_blackbox(str(tmp_path / writer))
             for writer in ("jax", "torch") for reader in ("jax", "torch")}
    # Either reader, the same result on the same dump.
    for writer in ("jax", "torch"):
        assert loads[(writer, "torch")] == loads[(writer, "jax")]
    # The two writers' dumps hold the same story.
    assert _comparable(loads[("torch", "torch")]) == _comparable(loads[("jax", "jax")])
    want = loads[("jax", "jax")]
    assert want["unclean"] is kill and want["segments"] == 3
    # File by file: the same names, and the same segments byte for byte
    # but for the process's wall-clock anchor.
    jdir, tdir = (str(tmp_path / p / "n0") for p in ("jax", "torch"))
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in sorted(os.listdir(jdir)):
        if name.startswith("segment-"):
            with open(os.path.join(jdir, name)) as a, open(os.path.join(tdir, name)) as b:
                ja, tb = json.load(a), json.load(b)
            ja.pop("wall_offset"), tb.pop("wall_offset")
            for seg in (ja, tb):
                seg["series"] = {n: s for n, s in seg["series"].items()
                                 if not n.startswith(_CLOCK_SERIES)}
            assert tb == ja, name


def test_frontend_segments_every_sample_and_flushes(tmp_path):
    from radixmesh_tpu_torch.engine.engine import Engine
    from radixmesh_tpu_torch.models.llama import ModelConfig, init_params
    from radixmesh_tpu_torch.server.http_frontend import ServingFrontend

    cfg = ModelConfig.tiny().replace(dtype=torch.float32)
    eng = Engine(cfg, init_params(cfg, seed=2, device="cpu"), num_slots=128, page_size=4, max_batch=1,
                 device="cpu", name="bb-http")
    fe = ServingFrontend(eng, port=0, history_interval_s=0.02, blackbox_dir=str(tmp_path),
                         blackbox_watchdog_s=5.0)
    try:
        deadline = time.monotonic() + 10
        while fe.blackbox.stats()["segments"] < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert fe.blackbox.stats()["segments"] >= 3
        req = urllib.request.Request(f"http://127.0.0.1:{fe.port}/admin/blackbox", data=b"{}")
        with urllib.request.urlopen(req, timeout=30) as r:
            res = json.loads(r.read())
        assert res["flushed"] and res["cause"] == "admin" and os.path.isfile(res["path"])
        with open(res["path"]) as fh:
            final = json.load(fh)
        assert final["state"]["engine"]["name"] == "bb-http" and final["doctor"]["inputs"]["engine"]
        assert "spec_misconfigured" in final["doctor"]["rules_checked"]
        assert "waterfall" in final and "spans" in final
    finally:
        fe.close(drain_s=0.0)
    dump = jbb.load_blackbox(str(tmp_path))  # the JAX loader reads the port's dump
    assert dump["causes"] == ["admin", "shutdown"] and not dump["unclean"]
    seqs = sorted({p[0] for pts in dump["series"].values() for p in pts})
    assert seqs == list(range(len(seqs)))  # every sample landed
    assert dump["manifest"]["segment_every"] == 1
