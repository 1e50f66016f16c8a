"""Timed benchmark of the distributed layer — the ring the project is
named for (correctness artifacts existed, perf artifacts did not).

Topology: the reference's 6-process localhost pattern (3 prefill +
2 decode + 1 router) over the **native C++ TCP transport**.
The reference's own benchmark does 10 random inserts with no timers;
this one measures:

- **insert replication throughput**: every prefill/decode node inserts
  ``--inserts`` random keys flat out; the clock stops when every node
  holds every other node's keys (convergence, not just ingest).
- **oplog ring lap latency** p50/p99: origin -> full lap back to origin,
  via the ``MeshCache.on_lap_complete`` instrumentation seam.
- **router route() throughput + latency** on the replicated rank-only
  tree (hits and hash-ring-fallback misses, ``router/cache_aware_router.py``).

The port's copy (``scripts/ringbench.py`` of the JAX package) over the
port's ``MeshCache``, ``CacheAwareRouter`` and native transport
(``radixmesh_tpu_torch/comm/tcp_native.py``); host code alone.

Prints ONE JSON line on stdout, validated against
``reports.validate_ringbench``; ``--out FILE`` additionally writes it to a
file (the port's round artifact is ``RINGBENCH_torch_r{N}.json``; an
``--out`` naming a JAX artifact is refused, exit 2).

Usage::

    python -m radixmesh_tpu_torch.scripts.ringbench [--inserts 400] [--laps 200] [--routes 5000]
"""

# meshcheck: file-ok[sleep-audit] a benchmark harness: its workers poll for
# convergence between timed phases, on no serving thread.

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import queue as queue_mod
import socket
import sys
import time

import numpy as np

from radixmesh_tpu_torch import reports
from radixmesh_tpu_torch.scripts._cli import refuse_jax_out

KEY_LEN = 16  # default tokens per key (a short ShareGPT-turn tail)


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


def _rank_keys(rank: int, n: int, key_len: int, vocab: int = 50000) -> np.ndarray:
    """The n keys node ``rank`` inserts — deterministic, so every node can
    enumerate the full expected key set and detect its own convergence."""
    rng = np.random.default_rng(1000 + rank)
    return rng.integers(1, vocab, size=(n, key_len)).astype(np.int64)


def _percentiles(samples: list[float]) -> dict:
    a = np.asarray(samples)
    return {
        "p50_ms": round(float(np.percentile(a, 50)) * 1e3, 3),
        "p99_ms": round(float(np.percentile(a, 99)) * 1e3, 3),
        "mean_ms": round(float(a.mean()) * 1e3, 3),
        "n": len(samples),
    }


def _worker(local_addr, prefill, decode, router, n_inserts, n_laps,
            n_routes, key_len, page, barrier, resq, errq):
    try:
        from radixmesh_tpu_torch.cache.mesh_cache import MeshCache
        from radixmesh_tpu_torch.config import MeshConfig, NodeRole
        from radixmesh_tpu_torch.router.cache_aware_router import CacheAwareRouter

        cfg = MeshConfig(
            prefill_nodes=prefill,
            decode_nodes=decode,
            router_nodes=router,
            local_addr=local_addr,
            protocol="tcp",  # the native C++ transport
            tick_interval_s=1.0,
            gc_interval_s=600.0,  # GC off the wire during the timed run
            page_size=page,
            # 6 CPU-contended processes flat-out: a starved transport
            # thread must not read as a dead peer mid-benchmark.
            failure_timeout_s=120.0,
        )
        node = MeshCache(cfg).start()
        assert node.wait_ready(timeout=60), "startup tick barrier timed out"
        n_writers = len(prefill) + len(decode)
        out: dict = {"addr": local_addr, "role": node.role.name,
                     "rank": node.rank}
        barrier.wait(timeout=60)

        # --- phase A: replication throughput --------------------------
        t0 = time.monotonic()
        if node.role is not NodeRole.ROUTER:
            keys = _rank_keys(node.rank, n_inserts, key_len)
            for i, key in enumerate(keys):
                # Contiguous page-aligned runs (key_len is a page
                # multiple), the paged allocator's shape.
                node.insert(
                    key.tolist(),
                    np.arange(i * key_len, (i + 1) * key_len,
                              dtype=np.int32),
                )
            out["ingest_s"] = time.monotonic() - t0
            # Convergence: per-origin delivery is FIFO (TCP chain, each
            # hop applies before forwarding), so holding a writer's LAST
            # key means holding them all — poll 1 key per writer, then
            # verify the full set once (no hot polling loop starving the
            # transport threads of the GIL).
            expected = [
                _rank_keys(r, n_inserts, key_len) for r in range(n_writers)
            ]
            deadline = time.monotonic() + 300
            for rank_keys in expected:
                last = rank_keys[-1].tolist()
                while node.match_prefix(last).length < key_len:
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"rank {node.rank} never converged"
                        )
                    time.sleep(0.01)
            out["converge_s"] = time.monotonic() - t0
            for rank_keys in expected:
                for key in rank_keys:
                    got = node.match_prefix(key.tolist()).length
                    assert got == key_len, (
                        f"rank {node.rank}: converged marker present but "
                        f"a key is missing ({got}/{key_len} tokens)"
                    )
        barrier.wait(timeout=600)

        # --- phase B: ring lap latency (prefill rank 0 originates) ----
        if node.role is NodeRole.PREFILL and node.rank == 0:
            laps: list[float] = []
            lapq: "queue_mod.Queue[tuple[float, tuple]]" = queue_mod.Queue()
            # Completions are PAIRED BY KEY: phase A's final oplogs can
            # still be circling when this callback installs (the barrier
            # releases on key presence, not lap completion), so an
            # arrival-order pairing would mis-time the whole run on one
            # stale completion.
            node.on_lap_complete = lambda op: lapq.put(
                (time.monotonic(), tuple(int(x) for x in op.key))
            )
            rng = np.random.default_rng(9)
            for i in range(n_laps):
                key = rng.integers(1, 50000, size=key_len).tolist()
                t = time.monotonic()
                node.insert(
                    key,
                    np.arange(key_len, dtype=np.int32) + i * key_len,
                )
                want = tuple(key)
                deadline = time.monotonic() + 30
                while True:
                    done_t, done_key = lapq.get(
                        timeout=max(0.0, deadline - time.monotonic())
                    )
                    if done_key == want:
                        laps.append(done_t - t)
                        break  # stale phase-A/GC completions: discarded
            node.on_lap_complete = None
            out["lap_latency"] = _percentiles(laps)
        barrier.wait(timeout=120)

        # --- phase C: router route() throughput -----------------------
        if node.role is NodeRole.ROUTER:
            r = CacheAwareRouter(node, cfg)
            r.finish_warm_up()
            known = _rank_keys(0, n_inserts, key_len)
            rng = np.random.default_rng(5)
            # Half hits (known keys + a fresh suffix, the serving shape),
            # half misses (novel keys -> consistent-hash fallback path).
            probes = []
            for i in range(n_routes):
                if i % 2 == 0:
                    base = known[rng.integers(0, len(known))]
                    probes.append(
                        np.concatenate(
                            [base, rng.integers(1, 50000, size=8)]
                        ).tolist()
                    )
                else:
                    probes.append(
                        rng.integers(1, 50000, size=key_len + 8).tolist()
                    )
            lat: list[float] = []
            t0 = time.monotonic()
            for p in probes:
                t = time.monotonic()
                r.cache_aware_route(p)
                lat.append(time.monotonic() - t)
            total = time.monotonic() - t0
            out["route"] = {
                "routes_per_s": round(n_routes / total, 1),
                **_percentiles(lat),
            }
        barrier.wait(timeout=120)
        node.close()
        resq.put(out)
    except Exception as e:  # noqa: BLE001 — forward every failure to the parent
        errq.put(f"{local_addr}: {type(e).__name__}: {e}")
        sys.exit(1)


def _wire_bytes_per_insert(key_len: int, page: int) -> int:
    """Serialized INSERT frame size at this granularity (what each ring
    hop actually ships)."""
    from radixmesh_tpu_torch.cache.oplog import Oplog, OplogType, serialize

    key = np.arange(key_len, dtype=np.int32)
    value = (
        np.arange(key_len // page, dtype=np.int32)
        if page > 1
        else np.arange(key_len, dtype=np.int32)
    )
    return len(serialize(Oplog(
        op_type=OplogType.INSERT, origin_rank=0, logic_id=1, ttl=5,
        key=key, value=value, value_rank=0, page=page,
    )))


def run(n_inserts: int, n_laps: int, n_routes: int, key_len: int = KEY_LEN,
        page: int = 1) -> dict:
    if key_len % max(page, 1):
        raise SystemExit(f"--key-len {key_len} must be a multiple of "
                         f"--page-size {page}")
    ports = _free_ports(6)
    prefill = [f"127.0.0.1:{p}" for p in ports[:3]]
    decode = [f"127.0.0.1:{p}" for p in ports[3:5]]
    router = [f"127.0.0.1:{p}" for p in ports[5:]]
    ctx = mp.get_context("spawn")
    barrier = ctx.Barrier(6)
    resq = ctx.Queue()
    errq = ctx.Queue()
    procs = [
        ctx.Process(
            target=_worker,
            args=(addr, prefill, decode, router, n_inserts, n_laps,
                  n_routes, key_len, page, barrier, resq, errq),
        )
        for addr in prefill + decode + router
    ]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=900)
    errors = []
    while not errq.empty():
        # meshcheck: ok[timeout-audit] the workers have exited (joined
        # above): empty() said an item is queued, so get() returns it.
        errors.append(errq.get())
    for p in procs:
        if p.is_alive():
            p.terminate()
            errors.append("worker still alive at timeout")
    if errors or any(p.exitcode != 0 for p in procs):
        return {
            "metric": "ring_insert_throughput",
            "value": None,
            "error": "; ".join(errors)
            or f"exit codes {[p.exitcode for p in procs]}",
        }
    results = []
    while not resq.empty():
        # meshcheck: ok[timeout-audit] as for errq: the workers have exited
        # and empty() said an item is queued.
        results.append(resq.get())
    writers = [r for r in results if r["role"] != "ROUTER"]
    n_writers = len(writers)
    total_inserts = n_inserts * n_writers
    # Throughput clock: slowest node's ingest-to-full-convergence span —
    # the ring is only as replicated as its last member.
    converge = max(r["converge_s"] for r in writers)
    lap = next(r["lap_latency"] for r in results if "lap_latency" in r)
    route = next(r["route"] for r in results if "route" in r)
    return {
        "metric": "ring_insert_throughput",
        "value": round(total_inserts / converge, 1),
        "unit": "inserts/s (ingested+converged, 5 writers, 6 procs)",
        "transport": "native-cpp-tcp",
        "topology": "3 prefill + 2 decode + 1 router (localhost)",
        "inserts_per_writer": n_inserts,
        "key_len_tokens": key_len,
        "page_size": page,
        "wire_bytes_per_insert": _wire_bytes_per_insert(key_len, page),
        "ingest_s_max": round(max(r["ingest_s"] for r in writers), 3),
        "converge_s_max": round(converge, 3),
        # Each insert is applied on every other ring node + the router.
        "oplog_applies_per_s": round(
            total_inserts * n_writers / converge, 1
        ),
        "lap_latency": lap,
        "route": route,
        "wall_s": round(time.monotonic() - t0, 1),
    }


def run_paired(n_inserts: int, n_laps: int, n_routes: int,
               key_len: int = 256, page: int = 16) -> dict:
    """The round artifact: BOTH configurations — page-granular wire (the
    headline) and the token-granular baseline — on identical keys, plus
    their ratios, in the stable schema pinned by ``reports.py``
    (``RINGBENCH_SCHEMA_VERSION``, the JAX package's ``bench.py``'s).
    Every field is emitted every round; consumers may rely on the pinned
    set."""
    paged = run(n_inserts, n_laps, n_routes, key_len, page)
    if paged.get("value") is None:
        return paged
    token = run(n_inserts, n_laps, n_routes, key_len, 1)
    if token.get("value") is None:
        return token
    report = {
        "schema_version": reports.RINGBENCH_SCHEMA_VERSION,
        "metric": "ring_insert_throughput",
        "value": paged["value"],
        "unit": paged["unit"],
        "workload": f"{key_len}-token keys (ShareGPT-prompt scale), "
                    f"{n_inserts}/writer",
        "page_granular": paged,
        "token_granular_baseline": token,
        "bytes_per_insert_ratio": round(
            token["wire_bytes_per_insert"] / paged["wire_bytes_per_insert"],
            3,
        ),
        "inserts_per_s_ratio": round(paged["value"] / token["value"], 3),
        # Top-level lap latency mirrors the headline (page-granular)
        # config so dashboards can read one stable path.
        "lap_latency": paged["lap_latency"],
        "round3_wire_bytes_per_insert": reports.RINGBENCH_ROUND3_WIRE_BYTES,
        "vs_round3_wire": round(
            reports.RINGBENCH_ROUND3_WIRE_BYTES
            / paged["wire_bytes_per_insert"],
            3,
        ),
    }
    missing = reports.validate_ringbench(report)
    if missing:
        # A schema violation is a bug in THIS script — fail loudly
        # instead of silently drifting the artifact again.
        report["schema_violation"] = missing
    return report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="ringbench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--inserts", type=int, default=400,
                    help="keys inserted per writer node (5 writers)")
    ap.add_argument("--laps", type=int, default=200,
                    help="lap-latency samples")
    ap.add_argument("--routes", type=int, default=5000,
                    help="router route() calls")
    ap.add_argument("--key-len", type=int, default=256,
                    help="tokens per inserted key")
    ap.add_argument("--page-size", type=int, default=16,
                    help="mesh replication granularity of the headline "
                         "config (the baseline config always runs at 1)")
    ap.add_argument("--single", action="store_true",
                    help="one configuration only (quick checks) — NOT the "
                         "round-artifact schema")
    ap.add_argument("--out", default=None, help="also write JSON here")
    args = ap.parse_args(argv)
    if refuse_jax_out("ringbench", "RINGBENCH", args.out):
        return 2
    if args.single:
        report = run(args.inserts, args.laps, args.routes, args.key_len,
                     args.page_size)
    else:
        report = run_paired(args.inserts, args.laps, args.routes,
                            args.key_len, args.page_size)
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    ok = report.get("value") is not None and not report.get("schema_violation")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
