"""Ring-scale sweep: flat ring vs hierarchical (groups + spine) as N grows.

The reference's open question ("better topo if nodes over some number
(like 50?)") — answered with a LIVE
implementation (``policy/hierarchy.py``, ``topology: hier``) rather than
analysis alone. This drives real MeshCache nodes over the threaded
``tcp-py`` loopback transport (per-link sockets + per-connection reader
threads, so group rings progress concurrently — the single-worker inproc
hub would serialize exactly the parallelism the hierarchy exists to
create) and measures, for each N and each topology:

- **propagation latency** p50/p99: one insert → visible on EVERY node
  (the metric both topologies can be compared on; the flat ring's origin
  lap ≈ propagation, the hierarchy's group lap is not);
- **convergence time / throughput** for a flood of inserts from one
  writer;
- **ring bytes per insert** (total frames × frame size): the hierarchy
  trades a slightly higher frame count (leaders see spine + group
  copies) for an O(sqrt N) serial critical path.

The port's copy (``scripts/ringscale.py`` of the JAX package) over the
port's ``MeshCache``, transports, ``policy.hierarchy`` and
``cache.rebalance.ShardOverrides``; host code alone. Writes
``RINGSCALE_torch_r{N}.json`` (or ``--out``, which may not name a JAX
artifact), validated against ``reports.validate_ringscale``: exit 1 on a
schema violation; the crossover analysis lives in ARCHITECTURE.md
§ring-scale.

Usage: python -m radixmesh_tpu_torch.scripts.ringscale [--sizes 6,12,25,50] [--inserts 40]
"""
# meshcheck: file-ok[sleep-audit] a benchmark harness: it emulates per-hop
# wire latency and polls for propagation by wall clock, on no serving
# thread.

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

import numpy as np

from radixmesh_tpu_torch import reports
from radixmesh_tpu_torch.scripts._cli import refuse_jax_out

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KEY_LEN = 64
PAGE = 16


def _free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _frame_model(
    topology: str, n_nodes: int, group_size: int, rf: int = 0
) -> tuple[int, int]:
    """(frame_bytes, frames_per_insert) — the analytic wire model BOTH
    sweep modes report and tests/test_ringscale.py pins against the
    measured send counters. Flat = N sends (the lap-RETURN hop to the
    origin is a real frame); hier = one full lap per group (return hops
    included; injected copies die at their injector) + one spine lap.
    Sharded (rf > 0, cache/sharding.py): one point-to-point frame per
    non-origin owner — ≤ rf regardless of N, the whole point (the
    measured counter reports the exact per-key owner overlap with the
    writer)."""
    from radixmesh_tpu_torch.cache.oplog import Oplog, OplogType, serialize
    from radixmesh_tpu_torch.policy.hierarchy import HierPlan

    frame = len(serialize(Oplog(
        op_type=OplogType.INSERT, origin_rank=0, logic_id=1,
        ttl=n_nodes, key=np.arange(KEY_LEN, dtype=np.int32),
        value=np.arange(KEY_LEN // PAGE, dtype=np.int32), value_rank=0,
        page=PAGE,
    )))
    if rf > 0:
        frames = min(rf, n_nodes - 1)
    elif topology == "hier":
        plan = HierPlan(n_nodes, group_size)
        alive = range(n_nodes)
        frames = sum(
            len(plan.group_alive(g, alive))
            for g in plan.nonempty_groups(alive)
        ) + plan.spine_ttl(alive)
    else:
        frames = n_nodes
    return frame, frames


def run_ring(
    n_nodes: int,
    n_inserts: int,
    n_probes: int,
    topology: str,
    hop_delay_ms: float = 0.0,
    rf: int = 0,
) -> dict:
    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
    from radixmesh_tpu_torch.config import MeshConfig
    from radixmesh_tpu_torch.policy.hierarchy import auto_group_size

    prefill = [f"127.0.0.1:{p}" for p in _free_ports(n_nodes)]
    nodes: list[MeshCache] = []
    group_size = auto_group_size(n_nodes) if topology == "hier" else 0
    try:
        for addr in prefill:
            cfg = MeshConfig(
                prefill_nodes=prefill,
                decode_nodes=[],
                router_nodes=[],
                local_addr=addr,
                protocol="tcp-py",
                topology=topology,
                group_size=group_size,
                replication_factor=rf,
                # Out of the measured window (like the tick), so send
                # counters observe only data frames.
                shard_summary_interval_s=3600.0,
                # One tick origination (the ticker's immediate first tick
                # satisfies the barrier), then none during the measured
                # phases — so the send counters observe only data frames.
                # The interval must exceed the WHOLE sweep budget (300 s
                # subprocess timeout + startup), not just the expected
                # runtime: a slow CI run crossing a tick boundary would add
                # TICK sends to the counters and flake the exact-equality
                # assertions in tests/test_ringscale.py.
                tick_interval_s=3600.0,
                gc_interval_s=600.0,
                failure_timeout_s=600.0,  # many threads contend; no false deaths
                page_size=PAGE,
            )
            node = MeshCache(cfg, pool=None)
            if hop_delay_ms > 0:
                # Emulate DCN store-and-forward wire latency: delay each
                # link's delivery on its per-connection reader thread
                # (sleeps release the GIL, so independent links — and
                # therefore the hierarchy's concurrent group laps — truly
                # overlap, which loopback's ~50 µs hops would mask).
                def delayed(data, _n=node, _d=hop_delay_ms / 1e3):
                    time.sleep(_d)
                    return MeshCache.oplog_received(_n, data)

                node.oplog_received = delayed
            nodes.append(node)
        t0 = time.monotonic()
        for n in nodes:
            n.start()
        for n in nodes:
            assert n.wait_ready(timeout=120), f"N={n_nodes}/{topology}: barrier"
        startup_s = time.monotonic() - t0

        # Writer = the worst-placed node: the LAST member of group 0 in
        # hier mode (its op must walk to the leader before the spine), a
        # plain member in flat mode — same rank either way for fairness.
        writer = nodes[min(group_size, n_nodes) - 1 if topology == "hier" else 0]
        rng = np.random.default_rng(7)

        def replicas_of(key) -> list[MeshCache]:
            """The nodes that must end up holding ``key``: everyone on a
            full replica; the key's owner set under sharding (delivery-
            to-owners is the contract being measured)."""
            if rf <= 0:
                return [n for n in nodes if n is not writer]
            return [
                nodes[r]
                for r in writer.owner_ranks(key)
                if nodes[r] is not writer
            ]

        # Propagation latency: insert one key, spin until every replica
        # that MUST hold it does (all nodes full-replica; the owner set
        # sharded — "propagation to owners"). Converged nodes drop from
        # the poll set.
        probes: list[float] = []
        for i in range(n_probes):
            key = rng.integers(1, 50000, size=KEY_LEN).tolist()
            t = time.monotonic()
            writer.insert(key, np.arange(KEY_LEN, dtype=np.int32) + i * KEY_LEN)
            waiting = replicas_of(key)
            deadline = t + 60
            while waiting:
                waiting = [
                    n for n in waiting if n.match_prefix(key).length < KEY_LEN
                ]
                if not waiting:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"N={n_nodes}/{topology}: probe {i} never propagated"
                    )
                time.sleep(0.0002)
            probes.append(time.monotonic() - t)

        # Convergence: one writer floods, clock stops when every key's
        # replica set holds it (full replica: FIFO per path ⇒ the last
        # key covers all; sharded: owner sets differ per key, so every
        # key is polled). Send counters are sampled around this phase so
        # frames-per-insert is MEASURED wire traffic, not the analytic
        # model restated.
        sent0 = sum(n.metrics["oplogs_sent"] for n in nodes)
        keys = rng.integers(1, 50000, size=(n_inserts, KEY_LEN))
        t0 = time.monotonic()
        for i, key in enumerate(keys):
            writer.insert(
                key.tolist(),
                np.arange(KEY_LEN, dtype=np.int32) + (n_probes + i) * KEY_LEN,
            )
        if rf <= 0:
            pending = {-1: [n for n in nodes if n is not writer]}
            check_keys = {-1: keys[-1].tolist()}
        else:
            check_keys = {i: k.tolist() for i, k in enumerate(keys)}
            pending = {i: replicas_of(k) for i, k in check_keys.items()}
        deadline = time.monotonic() + 300
        while any(pending.values()):
            for i, nds in list(pending.items()):
                if nds:
                    pending[i] = [
                        n for n in nds
                        if n.match_prefix(check_keys[i]).length < KEY_LEN
                    ]
            if any(pending.values()):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"N={n_nodes}/{topology} never converged")
                time.sleep(0.005)
        converge_s = time.monotonic() - t0
        sent = sum(n.metrics["oplogs_sent"] for n in nodes) - sent0

        frame, frames = _frame_model(topology, n_nodes, group_size, rf)
        a = np.asarray(probes)
        measured = round(sent / n_inserts, 2)
        return {
            "n_nodes": n_nodes,
            "topology": topology,
            "rf": rf,
            "mode": "threads+tcp-py",
            "hop_delay_ms": hop_delay_ms,
            "group_size": group_size or None,
            "startup_s": round(startup_s, 2),
            "prop_p50_ms": round(float(np.percentile(a, 50)) * 1e3, 2),
            "prop_p99_ms": round(float(np.percentile(a, 99)) * 1e3, 2),
            "converge_s": round(converge_s, 3),
            "inserts": n_inserts,
            "inserts_per_s": round(n_inserts / converge_s, 1),
            "frame_bytes": frame,
            "frames_per_insert": frames,
            "measured_frames_per_insert": measured,
            "ring_bytes_per_insert": (
                round(frame * measured) if rf > 0 else frame * frames
            ),
        }
    finally:
        for n in nodes:
            try:
                n.close()
            except Exception:  # noqa: BLE001 — teardown must not mask results
                pass


# ---------------------------------------------------------------------------
# Simulated-transport mode: the 100/200-node ceiling. A 200-node tcp-py
# ring is ~1000 threads + ~400 sockets of pure GIL contention — the wire
# NUMBERS it would produce (frames × real serialized frame bytes) are a
# pure function of the delivery topology, so the top sweep sizes run the
# REAL product code (MeshCache.insert → _broadcast_data → real oplog
# serialization → real ownership walk → real oplog_received apply path)
# over a direct in-memory delivery pump instead of sockets/threads.
# Measured per-insert frames/bytes are exact; propagation is MODELED as
# hop_delay × serial hop count (ring: N-1 store-and-forward hops to
# reach the last replica; sharded: 1 — owner deliveries are parallel
# point-to-point sends) and the rows say so ("mode": "sim").
# ---------------------------------------------------------------------------


def run_ring_sim(
    n_nodes: int,
    n_inserts: int,
    topology: str = "ring",
    hop_delay_ms: float = 1.0,
    rf: int = 0,
    overrides: bool = False,
    boosted_shards: int = 8,
) -> dict:
    """``overrides=True`` (rf>0 only): before measuring, the writer
    adopts a :class:`ShardOverrides` boosting ``boosted_shards`` shards
    with one extra owner each and the ring converges on it — the deferred
    measurement: owner-propagation at scale WITH an active override map,
    where every insert pays the override-aware derivation plus the
    boosted shards' wider fan-out. The override adoption itself happens
    before the frame counters reset, so bytes-per-insert stays an
    insert cost, not a gossip echo."""
    from collections import deque

    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
    from radixmesh_tpu_torch.config import MeshConfig

    if topology != "ring":
        raise ValueError("sim mode models the flat ring and sharded modes")
    prefill = [f"sim{i}" for i in range(n_nodes)]
    stats = {"frames": 0, "bytes": 0}
    pending: deque = deque()
    nodes: list[MeshCache] = []
    for addr in prefill:
        cfg = MeshConfig(
            prefill_nodes=prefill,
            decode_nodes=[],
            router_nodes=[],
            local_addr=addr,
            protocol="inproc",
            replication_factor=rf,
            page_size=PAGE,
        )
        nodes.append(MeshCache(cfg, pool=None))
    t0 = time.monotonic()
    # Never start()ed: no threads, no transports. Delivery is patched at
    # the two product seams every frame passes — the ring sender enqueue
    # (_send_bytes) and the owner-lane enqueue (_enqueue_owner) — so
    # serialization, ownership walks, TTL patching, and the apply path
    # all run the real code.
    for idx, node in enumerate(nodes):

        def ring_send(data, control=False, dest="ring", _i=idx):
            stats["frames"] += 1
            stats["bytes"] += len(data)
            pending.append(((_i + 1) % n_nodes, data))

        def owner_send(rank, data, _i=idx):
            stats["frames"] += 1
            stats["bytes"] += len(data)
            pending.append((rank, data))

        node._send_bytes = ring_send
        node._enqueue_owner = owner_send

    def pump() -> None:
        while pending:
            rank, data = pending.popleft()
            nodes[rank].oplog_received(data)

    rng = np.random.default_rng(7)
    keys = rng.integers(1, 50000, size=(n_inserts, KEY_LEN))
    writer = nodes[0]
    rf_boost = 0
    if overrides:
        if rf <= 0:
            raise ValueError("overrides require a sharded mesh (rf > 0)")
        from radixmesh_tpu_torch.cache.rebalance import ShardOverrides

        moves = {}
        for sid in range(boosted_shards):
            base = writer.base_owners_of(sid)
            extra = next(
                (r for r in range(n_nodes) if r not in base), None
            )
            if extra is not None:
                moves[sid] = tuple(base) + (extra,)
        # meshcheck: ok[single-writer-overrides] the sweep stands in for the
        # rebalance plane's decider: one map, adopted at one writer and
        # spread by the plane's own gossip.
        ovr = ShardOverrides(writer.view.epoch, 1, moves)
        if not writer.adopt_overrides(ovr):
            raise RuntimeError("override adoption refused in sim")
        pump()  # converge the REBALANCE gossip before measuring
        for node in nodes:
            if len(node.overrides) != len(moves):
                raise RuntimeError(
                    f"rank {node.rank} did not adopt the overrides"
                )
        rf_boost = 1
        # The adoption gossip must not pollute the per-insert numbers.
        stats["frames"] = 0
        stats["bytes"] = 0
        t0 = time.monotonic()
    serial_s: list[float] = []
    for i, key in enumerate(keys):
        ti = time.monotonic()
        writer.insert(
            key.tolist(), np.arange(KEY_LEN, dtype=np.int32) + i * KEY_LEN
        )
        serial_s.append(time.monotonic() - ti)
    pump()
    wall_s = time.monotonic() - t0
    # Every replica that must hold every key does (real apply path).
    for i, key in enumerate(keys):
        k = key.tolist()
        replicas = (
            [n for n in nodes if n is not writer]
            if rf <= 0
            else [nodes[r] for r in writer.owner_ranks(k) if r != 0]
        )
        for n in replicas:
            if n.match_prefix(k).length != KEY_LEN:
                raise RuntimeError(
                    f"sim N={n_nodes} rf={rf}: key {i} missing on rank {n.rank}"
                )
    for n in nodes:
        n.close()
    frame, frames = _frame_model("ring", n_nodes, 0, rf)
    measured = round(stats["frames"] / n_inserts, 2)
    # Modeled propagation: serial store-and-forward hops to the LAST
    # replica (ring) vs one parallel point-to-point hop (sharded).
    hops = 1 if rf > 0 else max(1, n_nodes - 1)
    prop_ms = round(hop_delay_ms * hops, 2)
    ser = np.asarray(serial_s)
    return {
        "n_nodes": n_nodes,
        "topology": "ring",
        "rf": rf,
        "mode": "sim",
        "hop_delay_ms": hop_delay_ms,
        "group_size": None,
        "startup_s": 0.0,
        "prop_p50_ms": prop_ms,
        "prop_p99_ms": prop_ms,
        "converge_s": round(wall_s, 3),
        "inserts": n_inserts,
        "inserts_per_s": round(n_inserts / max(wall_s, 1e-9), 1),
        "frame_bytes": frame,
        "frames_per_insert": frames,
        "measured_frames_per_insert": measured,
        "ring_bytes_per_insert": round(stats["bytes"] / n_inserts),
        # Writer-side serial cost per insert (ownership walk + one
        # serialization + per-owner enqueue) — the component an active
        # override map actually grows; modeled hop latency cannot see it.
        "writer_serial_p50_ms": round(float(np.percentile(ser, 50)) * 1e3, 4),
        "writer_serial_p99_ms": round(float(np.percentile(ser, 99)) * 1e3, 4),
        "overrides_active": bool(overrides),
        "boosted_shards": int(boosted_shards) if overrides else 0,
        "rf_boost": rf_boost,
    }


# ---------------------------------------------------------------------------
# OS-process mode: every node its own python
# PROCESS over the NATIVE C++ transport (protocol "tcp") — the threaded
# in-process sweep above is GIL-confounded at N=50, so the hierarchy
# answer to the reference's README.md:57 question needs process-isolated
# confirmation. The parent drives nodes over per-node control sockets
# (JSON lines): insert / probe / metrics / quit. Each child runs this
# module (``--node``) with the repo root on its PYTHONPATH.
# ---------------------------------------------------------------------------


def _node_main(argv: list[str]) -> int:
    """Child entry: one MeshCache node + a control socket."""
    spec = json.loads(argv[0])
    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
    from radixmesh_tpu_torch.config import MeshConfig

    cfg = MeshConfig(
        prefill_nodes=spec["addrs"],
        decode_nodes=[],
        router_nodes=[],
        local_addr=spec["addrs"][spec["rank"]],
        protocol="tcp",  # the native C++ transport
        topology=spec["topology"],
        group_size=spec["group_size"],
        tick_interval_s=3600.0,  # above the whole sweep budget (see above)
        gc_interval_s=3600.0,
        failure_timeout_s=3600.0,
        page_size=PAGE,
    )
    node = MeshCache(cfg, pool=None)
    delay = spec["hop_delay_ms"] / 1e3
    if delay > 0:
        # Emulate DCN store-and-forward latency on each link's delivery
        # (the native reader thread sleeps, exactly like the threaded
        # sweep's per-connection wrapper — comparable numbers).
        orig = node.oplog_received

        def delayed(data):
            time.sleep(delay)
            return orig(data)

        node.oplog_received = delayed
    node.start()

    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", spec["control_port"]))
    srv.listen(1)
    conn, _ = srv.accept()
    fh = conn.makefile("rw")
    for line in fh:
        req = json.loads(line)
        cmd = req["cmd"]
        if cmd == "quit":
            fh.write("{}\n")
            fh.flush()
            break
        if cmd == "insert":
            base = int(req["value_base"])
            node.insert(
                req["key"],
                np.arange(len(req["key"]), dtype=np.int32) + base,
            )
            resp = {}
        elif cmd == "probe":
            resp = {"len": int(node.match_prefix(req["key"]).length)}
        elif cmd == "metrics":
            resp = {"sent": int(node.metrics["oplogs_sent"])}
        else:
            resp = {"error": f"unknown cmd {cmd}"}
        fh.write(json.dumps(resp) + "\n")
        fh.flush()
    try:
        node.close()
    finally:
        conn.close()
        srv.close()
    return 0


class _NodeProc:
    """Parent-side handle: spawned child + its control channel."""

    def __init__(self, spec: dict, env: dict):
        import subprocess

        self.proc = subprocess.Popen(
            [sys.executable, "-m", "radixmesh_tpu_torch.scripts.ringscale", "--node",
             json.dumps(spec)],
            env=env,
        )
        self.port = spec["control_port"]
        self._fh = None

    def connect(self, deadline: float) -> None:
        while True:
            try:
                s = socket.create_connection(("127.0.0.1", self.port), 1.0)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"node :{self.port} never accepted")
                if self.proc.poll() is not None:
                    raise RuntimeError(
                        f"node :{self.port} exited rc={self.proc.returncode}"
                    )
                time.sleep(0.1)
        self._fh = s.makefile("rw")

    def rpc(self, **req) -> dict:
        self._fh.write(json.dumps(req) + "\n")
        self._fh.flush()
        return json.loads(self._fh.readline())

    def stop(self) -> None:
        try:
            if self._fh is not None:
                self.rpc(cmd="quit")
        except Exception:  # noqa: BLE001 — teardown must not mask results
            pass
        try:
            self.proc.terminate()
            self.proc.wait(timeout=10)
        except Exception:  # noqa: BLE001
            self.proc.kill()


def _child_env() -> dict:
    """Child environment: the repo root first on PYTHONPATH."""
    env = dict(os.environ)
    parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    parts.insert(0, _REPO_ROOT)
    env["PYTHONPATH"] = os.pathsep.join(parts)
    return env


def run_ring_procs(
    n_nodes: int,
    n_inserts: int,
    n_probes: int,
    topology: str,
    hop_delay_ms: float = 1.0,
) -> dict:
    from radixmesh_tpu_torch.comm.tcp_native import load_native_lib
    from radixmesh_tpu_torch.policy.hierarchy import auto_group_size

    load_native_lib()  # build the .so once; children must not race g++
    group_size = auto_group_size(n_nodes) if topology == "hier" else 0
    ports = _free_ports(2 * n_nodes)
    addrs = [f"127.0.0.1:{p}" for p in ports[:n_nodes]]
    env = _child_env()
    t0 = time.monotonic()
    nodes = [
        _NodeProc(
            {
                "rank": r,
                "addrs": addrs,
                "topology": topology,
                "group_size": group_size,
                "control_port": ports[n_nodes + r],
                "hop_delay_ms": hop_delay_ms,
            },
            env,
        )
        for r in range(n_nodes)
    ]
    rng = np.random.default_rng(1234 + n_nodes)
    try:
        deadline = time.monotonic() + 60 + 3 * n_nodes
        for nd in nodes:
            nd.connect(deadline)
        startup_s = time.monotonic() - t0

        def wait_propagated(key: list[int], budget: float) -> None:
            waiting = list(range(1, n_nodes))
            end = time.monotonic() + budget
            while waiting:
                waiting = [
                    r for r in waiting
                    if nodes[r].rpc(cmd="probe", key=key)["len"] < KEY_LEN
                ]
                if waiting and time.monotonic() > end:
                    raise TimeoutError(
                        f"N={n_nodes}/{topology}/procs: key never propagated "
                        f"to {waiting[:5]}"
                    )
                # Yield the (single) core between poll rounds: a poll storm
                # of N sequential RPCs would otherwise preempt the very
                # forwarding it is trying to observe.
                if waiting:
                    time.sleep(0.002)

        probes: list[float] = []
        for i in range(n_probes):
            key = rng.integers(1, 50000, size=KEY_LEN).tolist()
            t = time.monotonic()
            nodes[0].rpc(cmd="insert", key=key, value_base=i * KEY_LEN)
            wait_propagated(key, 120)
            probes.append(time.monotonic() - t)

        sent0 = sum(nd.rpc(cmd="metrics")["sent"] for nd in nodes)
        keys = rng.integers(1, 50000, size=(n_inserts, KEY_LEN))
        t0 = time.monotonic()
        for i, key in enumerate(keys):
            nodes[0].rpc(
                cmd="insert", key=key.tolist(),
                value_base=(n_probes + i) * KEY_LEN,
            )
        wait_propagated(keys[-1].tolist(), 300)
        converge_s = time.monotonic() - t0
        sent = sum(nd.rpc(cmd="metrics")["sent"] for nd in nodes) - sent0

        frame, frames = _frame_model(topology, n_nodes, group_size)
        a = np.asarray(probes)
        return {
            "n_nodes": n_nodes,
            "topology": topology,
            "mode": "procs+native",
            "hop_delay_ms": hop_delay_ms,
            "group_size": group_size or None,
            "startup_s": round(startup_s, 2),
            "prop_p50_ms": round(float(np.percentile(a, 50)) * 1e3, 2),
            "prop_p99_ms": round(float(np.percentile(a, 99)) * 1e3, 2),
            "converge_s": round(converge_s, 3),
            "inserts": n_inserts,
            "inserts_per_s": round(n_inserts / converge_s, 1),
            "frame_bytes": frame,
            "frames_per_insert": frames,
            "measured_frames_per_insert": round(sent / n_inserts, 2),
            "ring_bytes_per_insert": frame * frames,
        }
    finally:
        for nd in nodes:
            nd.stop()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="ringscale", description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="12,50,100,200")
    ap.add_argument("--inserts", type=int, default=40)
    ap.add_argument("--probes", type=int, default=30)
    ap.add_argument(
        "--hop-delays", default="1",
        help="comma-separated per-hop wire latencies (ms) to emulate; 0 = raw loopback",
    )
    ap.add_argument(
        "--rfs", default="0,3",
        help="comma-separated replication factors to sweep; 0 = full "
        "replica (the old ring), N = prefix-ownership sharding with N "
        "owners per shard (cache/sharding.py)",
    )
    ap.add_argument(
        "--sim-threshold", type=int, default=30,
        help="sizes ABOVE this run in simulated-transport mode (real "
        "product delivery/serialization code over an in-memory pump; "
        "modeled propagation) — a 200-node tcp-py ring is ~1000 threads "
        "of GIL contention, not a measurement",
    )
    ap.add_argument(
        "--hier", action="store_true",
        help="also sweep topology=hier at rf=0 (the earlier comparison "
        "rows; live sizes only)",
    )
    ap.add_argument(
        "--procs", action="store_true",
        help="one OS process per node over the native C++ transport "
        "(live sizes only, rf=0)",
    )
    ap.add_argument(
        "--overrides", action="store_true",
        help="also measure the LARGEST sim size at each rf>0 with an "
        "adopted ShardOverrides map (8 boosted shards, +1 owner each) — "
        "the RINGSCALE v3 row: owner propagation under active "
        "rebalancer overrides (a deferred measurement)",
    )
    ap.add_argument("--node", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.node is not None:
        return _node_main([args.node])
    if refuse_jax_out("ringscale", "RINGSCALE", args.out):
        return 2
    sizes = [int(s) for s in args.sizes.split(",")]
    delays = [float(d) for d in args.hop_delays.split(",")]
    rfs = [int(r) for r in args.rfs.split(",")]
    results = []
    for delay in delays:
        for rf in rfs:
            for n in sizes:
                if n > args.sim_threshold:
                    r = run_ring_sim(
                        n, args.inserts, hop_delay_ms=delay, rf=rf
                    )
                elif args.procs and rf == 0:
                    r = run_ring_procs(n, args.inserts, args.probes, "ring", delay)
                    r.setdefault("rf", 0)
                else:
                    r = run_ring(n, args.inserts, args.probes, "ring", delay, rf=rf)
                print(json.dumps(r), file=sys.stderr, flush=True)
                results.append(r)
            if args.overrides and rf > 0:
                sim_sizes = [s for s in sizes if s > args.sim_threshold]
                if sim_sizes:
                    r = run_ring_sim(
                        max(sim_sizes), args.inserts, hop_delay_ms=delay,
                        rf=rf, overrides=True,
                    )
                    print(json.dumps(r), file=sys.stderr, flush=True)
                    results.append(r)
        if args.hier:
            for n in [s for s in sizes if s <= args.sim_threshold]:
                r = run_ring(n, args.inserts, args.probes, "hier", delay)
                print(json.dumps(r), file=sys.stderr, flush=True)
                results.append(r)
    # The headline the sharded plane exists for: bytes-per-insert vs N,
    # per rf (flat under sharding; linear full-replica).
    flatness = {}
    for rf in rfs:
        rows = sorted(
            (r for r in results if r.get("rf", 0) == rf),
            key=lambda r: r["n_nodes"],
        )
        if len(rows) >= 2:
            lo, hi = rows[0], rows[-1]
            flatness[f"rf{rf}"] = {
                f"N{lo['n_nodes']}_bytes": lo["ring_bytes_per_insert"],
                f"N{hi['n_nodes']}_bytes": hi["ring_bytes_per_insert"],
                "growth": round(
                    hi["ring_bytes_per_insert"]
                    / max(1, lo["ring_bytes_per_insert"]),
                    2,
                ),
            }
    has_overrides = any(r.get("overrides_active") for r in results)
    report = {
        # v3 = at least one owner-propagation-under-overrides row
        # (reports.validate_ringscale gates it); override-less sweeps
        # keep emitting the v2 shape.
        "schema_version": 3 if has_overrides else 2,
        "metric": "ring_scale_sweep",
        "mode": "mixed:live+sim" if any(
            r.get("mode") == "sim" for r in results
        ) else ("procs+native" if args.procs else "threads+tcp-py"),
        "sizes": sizes,
        "hop_delays_ms": delays,
        "rfs": rfs,
        "sim_threshold": args.sim_threshold,
        "results": results,
        "bytes_per_insert_growth": flatness,
        "note": (
            "full replication (rf=0) pays O(N) frames per insert and "
            "O(N)-hop propagation; prefix-ownership sharding "
            "(cache/sharding.py, rf>0) delivers each insert point-to-"
            "point to <= rf owners per serving role — bytes-per-insert "
            "flat in N, propagation-to-owners one parallel hop. Sizes "
            "above sim_threshold run the real delivery/serialization "
            "code over an in-memory pump with MODELED hop latency "
            "(mode: sim) — see ARCHITECTURE.md 'Sharded replication'"
        ),
    }
    reports.checked(report, reports.validate_ringscale)
    line = json.dumps(report)
    print(line, flush=True)
    out = args.out or reports.artifact_path("RINGSCALE")
    with open(out, "w") as fh:
        fh.write(line + "\n")
    return 1 if "schema_violation" in report else 0


if __name__ == "__main__":
    sys.exit(main())
