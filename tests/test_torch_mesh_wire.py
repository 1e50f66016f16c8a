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
