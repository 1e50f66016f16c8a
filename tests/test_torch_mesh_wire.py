"""The cache mesh's wire is the JAX package's, byte for byte.

Every encoder of the wire, fed the same seeded inputs in both packages,
gives the same bytes, and each package decodes the other's bytes to equal
objects: ``oplog.serialize`` for every ``OplogType`` under each emit
version, ``patched_ttl`` and ``patched_frame``, ``encode_view``,
``encode_shard_summary``, ``encode_overrides`` and ``NodeDigest`` (its
116 bytes: the 108-byte fixed struct and the 8-byte float32 tail). A ring
of one JAX ``MeshCache`` and two port ``MeshCache`` s over ``tcp-py`` on
localhost converges on one tree. A JSON config means the same to both
packages' ``load_config``, and the port reads it without PyYAML."""

import json
import socket
import sys
import time
from contextlib import contextmanager

import numpy as np
import pytest

import radixmesh_tpu.cache.oplog as j_oplog
import radixmesh_tpu_torch.cache.oplog as t_oplog
from radixmesh_tpu import config as j_config
from radixmesh_tpu.cache import rebalance as j_rebalance
from radixmesh_tpu.cache import sharding as j_sharding
from radixmesh_tpu.obs import fleet_plane as j_fleet
from radixmesh_tpu.policy import topology as j_topology
from radixmesh_tpu_torch import config as t_config
from radixmesh_tpu_torch.cache import rebalance as t_rebalance
from radixmesh_tpu_torch.cache import sharding as t_sharding
from radixmesh_tpu_torch.obs import fleet_plane as t_fleet
from radixmesh_tpu_torch.policy import topology as t_topology

_GC_KINDS = {"GC_QUERY", "GC_EXEC", "GC_VOTE"}


@contextmanager
def _emit(version):
    old = (j_oplog.emit_version(), t_oplog.emit_version())
    j_oplog.set_emit_version(version)
    t_oplog.set_emit_version(version)
    try:
        yield
    finally:
        j_oplog.set_emit_version(old[0])
        t_oplog.set_emit_version(old[1])


def _oplog_fields(kind: str, version: int, seed: int) -> dict:
    """Seeded fields of one frame; v3 frames also carry a page size, the
    spine bit and a trace id."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    big = bool(rng.integers(0, 2))  # ids above 2^24 force the int32 arrays
    hi = 1 << 30 if big else 1 << 20
    fields = dict(
        origin_rank=int(rng.integers(0, 64)),
        logic_id=int(rng.integers(0, 1 << 40)),
        ttl=int(rng.integers(-1, 12)),
        key=rng.integers(0, hi, n).astype(np.int32),
        value=rng.integers(0, hi, n).astype(np.int32),
        value_rank=int(rng.integers(-1, 64)),
        ts=float(rng.random() * 1e9) if version >= 2 else 0.0,
    )
    if kind in _GC_KINDS:
        fields["gc"] = [
            (rng.integers(0, 512, int(rng.integers(1, 9))).astype(np.int32),
             int(rng.integers(0, 8)), int(rng.integers(1, 5)))
            for _ in range(int(rng.integers(1, 4)))
        ]
    if version == 3:
        fields["page"] = int(rng.choice([1, 4, 16]))
        fields["spine"] = bool(rng.integers(0, 2))
        fields["trace_id"] = int(rng.integers(0, 1 << 63))
    return fields


def _oplog(mod, kind: str, fields: dict):
    f = dict(fields)
    gc = [mod.GCEntry(key=k.copy(), value_rank=r, agree=a) for k, r, a in f.pop("gc", [])]
    return mod.Oplog(op_type=mod.OplogType[kind], gc=gc,
                     **{k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in f.items()})


def _assert_same_oplog(a, b):
    """Field equality across packages (each package's ``__eq__`` checks
    its own class)."""
    assert int(a.op_type) == int(b.op_type)
    for name in ("origin_rank", "logic_id", "ttl", "value_rank", "ts", "page", "spine", "trace_id"):
        assert getattr(a, name) == getattr(b, name), name
    np.testing.assert_array_equal(a.key, b.key)
    np.testing.assert_array_equal(a.value, b.value)
    assert [(g.key.tolist(), g.value_rank, g.agree) for g in a.gc] == [
        (g.key.tolist(), g.value_rank, g.agree) for g in b.gc
    ]


def test_both_packages_know_the_same_kinds():
    assert [(k.name, int(k)) for k in j_oplog.OplogType] == [(k.name, int(k)) for k in t_oplog.OplogType]
    assert j_oplog.EXTENSION_KINDS == t_oplog.EXTENSION_KINDS


@pytest.mark.parametrize("version", [1, 2, 3])
@pytest.mark.parametrize("kind", [k.name for k in j_oplog.OplogType])
def test_oplog_bytes_identical_and_cross_decoded(kind, version):
    for seed in range(4):
        fields = _oplog_fields(kind, version, seed * 131 + int(j_oplog.OplogType[kind]))
        with _emit(version):
            jb = j_oplog.serialize(_oplog(j_oplog, kind, fields))
            tb = t_oplog.serialize(_oplog(t_oplog, kind, fields))
        assert jb == tb
        assert jb[1] == version
        _assert_same_oplog(t_oplog.deserialize(jb), j_oplog.deserialize(tb))
        _assert_same_oplog(t_oplog.deserialize(jb), _oplog(t_oplog, kind, fields))


@pytest.mark.parametrize("version", [1, 2, 3])
def test_patched_ttl_and_frame_identical(version):
    fields = _oplog_fields("INSERT", version, 5)
    with _emit(version):
        frame = j_oplog.serialize(_oplog(j_oplog, "INSERT", fields))
    for ttl in (-1, 0, 7, 1 << 20):
        assert j_oplog.patched_ttl(frame, ttl) == t_oplog.patched_ttl(frame, ttl)
    patches = [dict(ttl=3)]
    if version == 3:
        patches += [dict(spine=True), dict(spine=False, value_rank=9), dict(ttl=1, spine=True, value_rank=0)]
    for kw in patches:
        got = t_oplog.patched_frame(frame, **kw)
        assert got == j_oplog.patched_frame(frame, **kw)
        _assert_same_oplog(t_oplog.deserialize(got), j_oplog.deserialize(got))
    if version != 3:
        for mod in (j_oplog, t_oplog):
            with pytest.raises(ValueError, match="v3 frame"):
                mod.patched_frame(frame, spine=True)


@pytest.mark.parametrize("seed", range(4))
def test_encode_view_identical(seed):
    rng = np.random.default_rng(seed)
    alive = tuple(sorted(int(r) for r in rng.choice(200, int(rng.integers(1, 40)), replace=False)))
    epoch = int(rng.integers(0, 1 << 30))
    jv = j_topology.encode_view(j_topology.TopologyView(epoch=epoch, alive=alive))
    tv = t_topology.encode_view(t_topology.TopologyView(epoch=epoch, alive=alive))
    assert jv.tobytes() == tv.tobytes()
    for dec in (j_topology.decode_view(tv), t_topology.decode_view(jv)):
        assert (dec.epoch, dec.alive) == (epoch, alive)


@pytest.mark.parametrize("with_loads", [False, True], ids=["no_heat", "heat"])
@pytest.mark.parametrize("seed", range(3))
def test_encode_shard_summary_identical(seed, with_loads):
    rng = np.random.default_rng(seed)
    shards = {
        int(sid): (int(rng.integers(0, 1 << 63)),
                   [(int(rng.integers(0, 1 << 63)), int(rng.integers(1, 4096)))
                    for _ in range(int(rng.integers(0, 6)))])
        for sid in rng.choice(j_sharding.NUM_SHARDS, int(rng.integers(1, 12)), replace=False)
    }
    loads = {sid: float(rng.random() * 1e4) for sid in shards} if with_loads else None
    origin = int(rng.integers(0, 32))
    ja = j_sharding.encode_shard_summary(origin, shards, loads)
    ta = t_sharding.encode_shard_summary(origin, shards, loads)
    assert ja.tobytes() == ta.tobytes()
    assert t_sharding.decode_shard_summary(ja) == j_sharding.decode_shard_summary(ta)


@pytest.mark.parametrize("seed", range(3))
def test_encode_overrides_identical(seed):
    rng = np.random.default_rng(seed)
    moves = {int(s): tuple(int(r) for r in rng.choice(16, int(rng.integers(1, 4)), replace=False))
             for s in rng.choice(j_sharding.NUM_SHARDS, int(rng.integers(0, 10)), replace=False)}
    epoch, version = int(rng.integers(0, 1000)), int(rng.integers(0, 1000))
    ja = j_rebalance.encode_overrides(j_rebalance.ShardOverrides(epoch, version, moves))
    ta = t_rebalance.encode_overrides(t_rebalance.ShardOverrides(epoch, version, moves))
    assert ja.tobytes() == ta.tobytes()
    for dec in (t_rebalance.decode_overrides(ja), j_rebalance.decode_overrides(ta)):
        assert (dec.epoch, dec.version, dec.moves) == (epoch, version, moves)


@pytest.mark.parametrize("seed", range(4))
def test_node_digest_identical(seed):
    rng = np.random.default_rng(seed)
    f = dict(
        rank=int(rng.integers(0, 64)), role=str(rng.choice(["prefill", "decode", "router"])),
        seq=int(rng.integers(0, 1 << 40)), ts=float(rng.random() * 1e9),
        epoch=int(rng.integers(0, 1 << 20)), fingerprint=int(rng.integers(0, 1 << 63)),
        tree_tokens=int(rng.integers(0, 1 << 40)), cache_hit_rate=float(rng.random()),
        pool_fill=float(rng.random()), host_fill=float(rng.random()),
        batch_occupancy=float(rng.random()), decode_ewma_s=float(rng.random() * 0.1),
        waiting=int(rng.integers(0, 1000)), decode_steps=int(rng.integers(0, 1 << 40)),
        replication_lag_s=float(np.float32(rng.random())), slo_tier=int(rng.integers(0, 4)),
        evictions=tuple(int(x) for x in rng.integers(0, 1 << 30, 4)),
        interval_s=float(np.float32(rng.random() * 5)),
        lifecycle=str(rng.choice(["bootstrapping", "active", "draining", "left"])),
    )
    ja = j_fleet.NodeDigest(**f).encode()
    ta = t_fleet.NodeDigest(**f).encode()
    assert ja.tobytes() == ta.tobytes()
    assert ta.nbytes == ja.nbytes <= t_fleet.DIGEST_BYTE_BUDGET
    assert t_fleet.NodeDigest.decode(ja).as_dict() == j_fleet.NodeDigest.decode(ta).as_dict()


_CONFIG = {
    "prefill_nodes": ["127.0.0.1:51000", "127.0.0.1:51001"], "decode_nodes": ["127.0.0.1:51002"],
    "router_nodes": ["127.0.0.1:51003"], "local_addr": "127.0.0.1:51001", "protocol": "tcp",
    "page_size": 16, "replication_factor": 2, "tick_interval_s": 0.5,
    "model": {"name": "llama3-8b"},
}


def test_json_config_reads_alike_and_without_pyyaml(tmp_path, monkeypatch):
    path = tmp_path / "node.json"
    path.write_text(json.dumps(_CONFIG))
    want = j_config.load_config(str(path))
    got = t_config.load_config(str(path))
    assert (got.global_rank, got.local_role.value, got.num_total) == (want.global_rank, want.local_role.value, want.num_total)
    plain = {k: v for k, v in vars(want).items() if not hasattr(v, "value")}
    assert {k: v for k, v in vars(got).items() if k in plain} == plain
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml now raises ImportError
    bare = t_config.load_config(str(path))
    assert (bare.global_rank, bare.page_size, bare.replication_factor, bare.model) == (
        want.global_rank, want.page_size, want.replication_factor, want.model)
    yml = tmp_path / "node.yaml"
    yml.write_text("prefill_nodes: [a]\nlocal_addr: a\n")
    with pytest.raises(ValueError, match="must be JSON"):
        t_config.load_config(str(yml))


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _tree_entries(tree):
    """(full key, origin rank) of every node under the root."""
    out = set()
    stack = [(tree.root, ())]
    while stack:
        node, path = stack.pop()
        for child in node.children.values():
            key = path + tuple(int(t) for t in child.key)
            out.add((key, int(child.value.rank)))
            stack.append((child, key))
    return out


def test_mixed_ring_converges():
    """One JAX node and two port nodes on one ring over ``tcp-py``: inserts
    made at each converge on every replica, with the same keys and origin
    ranks and the same tree fingerprint."""
    from radixmesh_tpu.cache.mesh_cache import MeshCache as JMesh
    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache as TMesh

    addrs = [f"127.0.0.1:{p}" for p in _free_ports(3)]
    prefill, decode = addrs[:2], addrs[2:]

    def cfg(mod, addr):
        return mod.MeshConfig(prefill_nodes=prefill, decode_nodes=decode, router_nodes=[],
                              local_addr=addr, protocol="tcp-py", tick_interval_s=0.05,
                              gc_interval_s=30.0, page_size=4)

    nodes = [TMesh(cfg(t_config, addrs[0]), pool=None).start(),
             JMesh(cfg(j_config, addrs[1]), pool=None).start(),
             TMesh(cfg(t_config, addrs[2]), pool=None).start()]
    try:
        for n in nodes:
            assert n.wait_ready(timeout=30)
        rng = np.random.default_rng(0)
        shared = rng.integers(0, 1 << 20, 8).astype(np.int32)
        want_keys = []
        for i, n in enumerate(nodes):
            for j in range(3):
                key = np.concatenate([shared, rng.integers(0, 1 << 20, 4 * (j + 1)).astype(np.int32)])
                n.insert(key, np.arange(len(key), dtype=np.int32), advertise=True)
                want_keys.append(key)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            entries = [_tree_entries(n.tree) for n in nodes]
            if entries[0] == entries[1] == entries[2] and all(
                all(n.match_prefix(k).length == len(k) for k in want_keys) for n in nodes
            ):
                break
            time.sleep(0.05)
        entries = [_tree_entries(n.tree) for n in nodes]
        assert entries[0] == entries[1] == entries[2]
        assert len({n.tree.fingerprint_ for n in nodes}) == 1
        for n in nodes:
            for k in want_keys:
                assert n.match_prefix(k).length == len(k)
        # Every origin rank shows up: each node's inserts reached the others.
        assert {r for _, r in entries[0]} == {0, 1, 2}
    finally:
        for n in nodes:
            n.close()


# -- the repair plane, LEAVE and the lifecycle digest -------------------------

from radixmesh_tpu.cache import radix_tree as j_tree  # noqa: E402
from radixmesh_tpu.cache import repair_plane as j_repair  # noqa: E402
from radixmesh_tpu_torch.cache import radix_tree as t_tree  # noqa: E402
from radixmesh_tpu_torch.cache import repair_plane as t_repair  # noqa: E402


def _seeded_trees(seed):
    """The same seeded inserts into a JAX and a port radix tree."""
    rng = np.random.default_rng(seed)
    trees = (j_tree.RadixTree(page_size=1), t_tree.RadixTree(page_size=1))
    for _ in range(int(rng.integers(5, 40))):
        key = rng.integers(1, 1 << 20, int(rng.integers(1, 24))).astype(np.int32)
        for t in trees:
            t.insert(key, np.arange(len(key), dtype=np.int32))
    return rng, trees


@pytest.mark.parametrize("seed", range(4))
def test_repair_probe_and_summary_bytes_identical(seed):
    """A probe and both summaries built from the same tree in each package
    are the same bytes, and each package decodes the other's."""
    rng, (jt, tt) = _seeded_trees(seed)
    jvec, tvec = jt.fingerprint_buckets(), tt.fingerprint_buckets()
    assert jvec.tobytes() == tvec.tobytes()
    ja, ta = j_repair.encode_probe(jvec), t_repair.encode_probe(tvec)
    assert ja.tobytes() == ta.tobytes()
    assert (t_repair.decode_probe(ja) == j_repair.decode_probe(ta)).all()
    buckets = sorted(int(b) for b in rng.choice(j_tree.FP_BUCKETS, int(rng.integers(1, 9)), replace=False))
    jh = [jt.path_hash(n) for n in jt.nodes_touching_buckets(buckets)]
    th = [tt.path_hash(n) for n in tt.nodes_touching_buckets(buckets)]
    assert jh == th
    for reply in (False, True):
        ja = j_repair.encode_summary(jvec, buckets, jh, reply=reply)
        ta = t_repair.encode_summary(tvec, buckets, th, reply=reply)
        assert ja.tobytes() == ta.tobytes()
        jd, td = t_repair.decode_summary(ja), j_repair.decode_summary(ta)
        assert (jd[0] == td[0]).all() and jd[1:] == td[1:]


@pytest.mark.parametrize("seed", range(3))
def test_shard_repair_bytes_identical(seed):
    """The owner-scoped probe and the session summary that selects the
    entries a push re-emits."""
    rng = np.random.default_rng(seed)
    sids = rng.choice(j_sharding.NUM_SHARDS, int(rng.integers(1, 12)), replace=False)
    pairs = [(int(s), int(rng.integers(0, 1 << 63))) for s in sids]
    hashes = {int(h) for h in rng.integers(0, 1 << 63, int(rng.integers(0, 30)), dtype=np.int64)}
    ja, ta = j_repair.encode_shard_probe(pairs), t_repair.encode_shard_probe(pairs)
    assert ja.tobytes() == ta.tobytes()
    assert t_repair.decode_shard_probe(ja) == j_repair.decode_shard_probe(ta)
    for reply in (False, True):
        ja = j_repair.encode_shard_session_summary(pairs, hashes, reply)
        ta = t_repair.encode_shard_session_summary(pairs, hashes, reply)
        assert ja.tobytes() == ta.tobytes()
        assert t_repair.decode_shard_session_summary(ja) == j_repair.decode_shard_session_summary(ta)


@pytest.mark.parametrize("kind", ["REPAIR_PROBE", "REPAIR_SUMMARY", "LEAVE"])
@pytest.mark.parametrize("seed", range(3))
def test_repair_and_leave_frames_identical(kind, seed):
    """A whole frame as ``MeshCache.send_repair`` and the LEAVE
    announcement build it (a LEAVE carries the leaver's exclusion view)."""
    rng, (jt, tt) = _seeded_trees(seed)
    if kind == "LEAVE":
        alive = tuple(sorted(int(r) for r in rng.choice(16, int(rng.integers(1, 8)), replace=False)))
        epoch = int(rng.integers(0, 1 << 20))
        jv = j_topology.encode_view(j_topology.TopologyView(epoch=epoch, alive=alive))
        tv = t_topology.encode_view(t_topology.TopologyView(epoch=epoch, alive=alive))
    elif kind == "REPAIR_PROBE":
        jv, tv = j_repair.encode_probe(jt.fingerprint_buckets()), t_repair.encode_probe(tt.fingerprint_buckets())
    else:
        jv = j_repair.encode_summary(jt.fingerprint_buckets(), [1, 5], [7, 9], reply=True)
        tv = t_repair.encode_summary(tt.fingerprint_buckets(), [1, 5], [7, 9], reply=True)
    fields = dict(origin_rank=int(rng.integers(0, 64)), logic_id=int(rng.integers(0, 1 << 40)),
                  ttl=int(rng.integers(1, 8)), value_rank=int(rng.integers(0, 64)), ts=float(rng.random() * 1e9))
    jb = j_oplog.serialize(j_oplog.Oplog(op_type=j_oplog.OplogType[kind], value=np.asarray(jv, np.int32), **fields))
    tb = t_oplog.serialize(t_oplog.Oplog(op_type=t_oplog.OplogType[kind], value=np.asarray(tv, np.int32), **fields))
    assert bytes(jb) == bytes(tb)
    back = t_oplog.deserialize(jb)
    assert back.op_type is t_oplog.OplogType[kind] and bytes(back.value.tobytes()) == bytes(np.asarray(jv, np.int32).tobytes())


@pytest.mark.parametrize("state", ["bootstrapping", "active", "draining", "left"])
def test_lifecycle_digest_bytes_identical(state):
    rng = np.random.default_rng(len(state))
    f = dict(rank=int(rng.integers(0, 64)), role="prefill", seq=int(rng.integers(1, 1 << 30)),
             ts=float(rng.random() * 1e9), epoch=3, fingerprint=int(rng.integers(0, 1 << 63)),
             tree_tokens=int(rng.integers(0, 1 << 30)), cache_hit_rate=0.5, pool_fill=0.25, host_fill=0.0,
             batch_occupancy=0.75, decode_ewma_s=0.02, waiting=3, decode_steps=99,
             slo_tier=int(rng.integers(0, 4)), lifecycle=state)
    ja, ta = j_fleet.NodeDigest(**f).encode(), t_fleet.NodeDigest(**f).encode()
    assert ja.tobytes() == ta.tobytes()
    assert t_fleet.NodeDigest.decode(ja).lifecycle == j_fleet.NodeDigest.decode(ta).lifecycle == state


# -- a mixed in-process ring with both repair planes and both routers ---------


@pytest.fixture(scope="module")
def mixed_ring():
    """Port prefill ``mp0``, JAX prefill ``mp1``, port decode ``md0``, a JAX
    router ``mr0`` and a port router ``mr1`` on ONE in-process hub (the
    port's hub is pointed at the JAX package's), each with its own
    package's repair plane and, on the ring nodes, fleet plane."""
    from radixmesh_tpu.cache.mesh_cache import MeshCache as JMesh
    from radixmesh_tpu.comm import inproc as j_inproc
    from radixmesh_tpu.obs.fleet_plane import FleetPlane as JFleetPlane
    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache as TMesh
    from radixmesh_tpu_torch.comm import inproc as t_inproc
    from radixmesh_tpu_torch.obs.fleet_plane import FleetPlane as TFleetPlane

    j_inproc.InprocHub.reset_default()
    t_inproc.InprocHub.reset_default()
    t_inproc.InprocHub._default = j_inproc.InprocHub.default()
    prefill, decode, routers = ["mp0", "mp1"], ["md0"], ["mr0", "mr1"]
    jax_side = {"mp1", "mr0"}
    nodes, planes, repairs = [], [], []
    try:
        for addr in prefill + decode + routers:
            mod = j_config if addr in jax_side else t_config
            cfg = mod.MeshConfig(prefill_nodes=prefill, decode_nodes=decode, router_nodes=routers,
                                 local_addr=addr, protocol="inproc", tick_interval_s=0.05,
                                 gc_interval_s=60.0, failure_timeout_s=60.0)
            nodes.append((JMesh if addr in jax_side else TMesh)(cfg, pool=None).start())
        for n in nodes:
            assert n.wait_ready(timeout=20)
        for n in nodes:
            jaxn = n.cfg.local_addr in jax_side
            rp = j_repair if jaxn else t_repair
            repairs.append(rp.RepairPlane(n, rp.RepairConfig(interval_s=0.05, age_threshold_s=0.2,
                                                            backoff_base_s=0.2, backoff_max_s=2.0), seed=0))
            if n.cfg.local_addr not in routers:
                planes.append((JFleetPlane if jaxn else TFleetPlane)(n, interval_s=0.1))
        yield nodes, planes, repairs
    finally:
        for r in repairs:
            r.close()
        for p in planes:
            p.close()
        for n in nodes:
            n.close()
        t_inproc.InprocHub._default = None
        j_inproc.InprocHub.reset_default()


def _converge(nodes, planes, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for p in planes:
            p.publish_once()
        if len({n.tree.fingerprint_ for n in nodes}) == 1:
            return True
        time.sleep(0.05)
    return False


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mixed_ring_repairs_a_dropped_insert(mixed_ring, writer):
    """An INSERT applied only on one replica (the dropped-frame stand-in),
    once on the JAX prefill node and once on the port's: the repair session
    between the two packages pushes it to every replica, routers too."""
    from radixmesh_tpu.cache.mesh_values import PrefillValue as JValue
    from radixmesh_tpu_torch.cache.mesh_values import PrefillValue as TValue

    nodes, planes, repairs = mixed_ring
    for r in repairs:
        if r._thread is None:
            r.start()
    nodes[0].insert(np.array([1, 2, 3], np.int32), np.arange(3, dtype=np.int32))
    assert _converge(nodes, planes)
    src = nodes[1] if writer == "jax" else nodes[0]
    key = np.array([40, 41, 42, 43], np.int32) + (0 if writer == "jax" else 100)
    pushed_before = sum(r.stats()["keys_pushed"] for r in repairs if (r.mesh is src))
    with src._lock:
        src._mesh_insert(key, (JValue if writer == "jax" else TValue)(np.arange(4, dtype=np.int32), src.rank))
    assert len({n.tree.fingerprint_ for n in nodes}) > 1
    assert _converge(nodes, planes), "the mixed ring never repaired the dropped insert"
    for n in nodes:
        assert n.tree.match_prefix(key, split_partial=False).length == len(key), n.cfg.local_addr
    # The replica that held the one-sided entry pushed it: a JAX plane in
    # one case, the port's in the other.
    assert sum(r.stats()["keys_pushed"] for r in repairs if r.mesh is src) > pushed_before


def test_mixed_routers_route_alike(mixed_ring):
    """The JAX router and the port's, over their replicas of the same
    replicated tree, give the same ``RouteResult`` for hits and misses."""
    from radixmesh_tpu.router.cache_aware_router import CacheAwareRouter as JRouter
    from radixmesh_tpu_torch.router.cache_aware_router import CacheAwareRouter as TRouter

    nodes, planes, _ = mixed_ring
    rng = np.random.default_rng(5)
    keys = [rng.integers(1, 1 << 20, int(rng.integers(8, 40))).astype(np.int32) for _ in range(12)]
    for i, k in enumerate(keys[:8]):
        nodes[i % 3].insert(k, np.arange(len(k), dtype=np.int32))
    assert _converge(nodes, planes)
    jr, tr = JRouter(nodes[3], nodes[3].cfg), TRouter(nodes[4], nodes[4].cfg)
    jr.finish_warm_up()
    tr.finish_warm_up()
    fields = ("prefill_addr", "decode_addr", "prefill_cache_hit", "decode_cache_hit", "match_len")
    for k in keys + [np.concatenate([keys[0], [7, 7]]).astype(np.int32)]:
        a, b = jr.cache_aware_route(k.tolist()), tr.cache_aware_route(k.tolist())
        assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields]
    assert sum(tr.cache_aware_route(k.tolist()).prefill_cache_hit for k in keys[:8]) >= 1
