"""What each rank of a ``tests/_torch_ranks.RankGroup`` runs for the CPU tests
of the KV tiers, the async plane, the disaggregated handoff and a pool-bound
mesh replica on an engine over several ranks. torch, numpy and the port
only: the JAX references are computed in the test process.

Plans are ``(dp, sp, tp, pp)`` tuples (``_torch_parallel_cases.mesh_of``); a
rank outside the plan's mesh returns None. Tier setups: ``host`` (the host
tier alone), ``disk`` (host + disk, which arms the plane; every pass
destages at watermark 0, so spills run) and ``plane`` (host + the plane).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.engine.request import RequestState, SamplingParams
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.parallel import collective_stats, reset_collective_stats
from tests._torch_parallel_cases import mesh_of

TIERS = {
    "none": {},
    "host": dict(host_cache_slots=1024),
    "disk": dict(host_cache_slots=1024, kv_tier_watermark=0.0, kv_tier_destage_interval_s=0.0),
    "plane": dict(host_cache_slots=1024, kv_transfer_async=True),
}


def tier_kw(tier: str, root: str | None) -> dict:
    kw = dict(TIERS[tier])
    if tier == "disk":
        kw["kv_tier_dir"] = root
    return kw


def _stats(engine) -> dict:
    st = dataclasses.asdict(engine.stats)
    st.pop("ttft_s")
    return st


def _counters(engine) -> dict:
    tree = engine.tree
    host = tree.stats() if hasattr(tree, "host") else {}
    out = {k: host.get(k, 0) for k in ("backup_tokens", "restore_tokens", "host_evicted_tokens",
                                       "writeback_sweeps")}
    if engine._kv_tier is not None:
        disk = engine._kv_tier.stats()
        out.update(spilled_tokens=disk["spilled_tokens"], disk_extents=engine._kv_tier.extents)
    if engine.kv_transfer is not None:
        out["plane_restored_tokens"] = engine.kv_transfer.restored_tokens
    return out


def _engine(np_params, cfg, plan, kw):
    mesh = mesh_of(plan)
    if mesh is None:
        return None
    return Engine(cfg, params_from_jax(np_params, cfg, "cpu"), device="cpu", device_mesh=mesh, **kw)


def serve_tiers(np_params: dict, cfg, plan: tuple, runs: list, engine_kw: dict, tier: str,
                root: str | None = None, drain: bool = False):
    """An engine on the plan's mesh with a tier setup over ``runs`` (one
    ``generate`` each); with ``drain``, the working set is pushed to the
    extents afterwards. Returns the tokens, stats, tier counters, the
    tally of collectives and the agreement's passes."""
    eng = _engine(np_params, cfg, plan, {**engine_kw, **tier_kw(tier, root)})
    if eng is None:
        return None
    reset_collective_stats()
    tokens = [eng.generate(prompts, SamplingParams(**skw)) for prompts, skw in runs]
    out = {"tokens": tokens, "stats": _stats(eng), "counters": _counters(eng),
           "collectives": collective_stats(), "passes": None if eng._sync is None else eng._sync.passes,
           "resurrected": {k: v for k, v in eng.resurrected.items() if k != "keys"}}
    if drain:
        eng.drain_flush_hot()
        out["drain"] = eng.drain_flush_disk()
        out["extents"] = sorted(os.listdir(eng._kv_tier.dir))
    eng.close()
    return out


def resurrect(np_params: dict, cfg, plan: tuple, engine_kw: dict, root: str, corrupt: str | None = None):
    """A fresh engine on ``root``'s extents (after ``serve_tiers(...,
    drain=True)``); ``corrupt``: an extent name this rank (engine index 1)
    flips a byte of first. Returns the resurrection and the surviving
    extents of this rank."""
    mesh = mesh_of(plan)
    if mesh is None:
        return None
    if corrupt is not None and mesh.engine_index == 1:
        path = os.path.join(root, "rank1", corrupt)
        raw = bytearray(open(path, "rb").read())
        raw[-1] ^= 0xFF
        open(path, "wb").write(bytes(raw))
    eng = _engine(np_params, cfg, plan, {**engine_kw, **tier_kw("disk", root)})
    eng._kv_tier.drain_retired()
    res = {k: (v if k != "keys" else [list(map(int, key)) for key in v]) for k, v in eng.resurrected.items()}
    out = {"resurrected": res, "extents": sorted(n for n in os.listdir(eng._kv_tier.dir) if n.endswith(".kv"))}
    eng.close()
    return out


def refused(np_params: dict, cfg, plan: tuple, engine_kw: dict) -> str:
    try:
        eng = _engine(np_params, cfg, plan, engine_kw)
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    if eng is None:
        return None
    eng.close()
    return "no error"


def agreement_late_rank(np_params: dict, cfg, plan: tuple, runs: list, engine_kw: dict, late: int):
    """Host tier + plane, where engine rank 1's plane reports its landed
    copies ``late`` pumps late (a test-only delay, this call only). Returns
    per request the agreement pass at which its parked restore resumed,
    the tokens and the passes that reported nothing landed here."""
    eng = _engine(np_params, cfg, plan, {**engine_kw, **TIERS["plane"]})
    if eng is None:
        return None
    plane, sync = eng.kv_transfer, eng._sync
    held = {"left": late if eng.device_mesh.engine_index == 1 else 0, "held": 0}
    report = plane.sync_local

    def late_report():
        vec = report()
        if held["left"] > 0 and vec[0] > 0:
            held["left"] -= 1
            held["held"] += 1
            return [0] * len(vec)  # as if no copy had landed here yet
        return vec

    plane.sync_local = late_report
    resumed = []
    finish = eng._pump_kv_transfer

    def pump():
        before = {r.rid for r, _ in eng._restoring}
        finish()
        after = {r.rid for r, _ in eng._restoring}
        resumed.extend(sync.passes for _ in before - after)

    eng._pump_kv_transfer = pump
    tokens = [eng.generate(prompts, SamplingParams(**skw)) for prompts, skw in runs]
    eng.close()
    return {"tokens": tokens, "resumed_at": resumed, "held": held["held"], "stats": _stats(eng)}


def prefetch_hint(np_params: dict, cfg, plan: tuple, runs: list, engine_kw: dict, hint: list):
    """Host tier + plane: after ``runs``, the leader's plane takes a prefetch
    hint for ``hint`` (a prefix the runs evicted to the host tier); every
    rank converts it at the next pass and restores it ahead of any request.
    (The runs' prefixes are flushed to the host first: a hint never evicts.)
    Then ``hint`` is served. Returns the hint outcomes, the tokens restored
    and the cached tokens of the last request."""
    eng = _engine(np_params, cfg, plan, {**engine_kw, **TIERS["plane"]})
    if eng is None:
        return None
    for prompts, skw in runs:
        eng.generate(prompts, SamplingParams(**skw))
    eng.drain_flush_hot()  # everything to the host tier: room for the hint
    plane = eng.kv_transfer
    if eng.device_mesh.engine_index == 0:
        plane.note_hint(np.asarray(hint, np.int32))
    before = plane.restored_tokens
    while eng.has_work():
        eng.step()
    restored = plane.restored_tokens - before
    cached = eng.stats.cached_tokens
    tokens = eng.generate([hint], SamplingParams(**runs[0][1]))
    out = {"outcomes": dict(plane.hint_outcomes), "restored": restored, "tokens": tokens,
           "hit": eng.stats.cached_tokens - cached}
    eng.close()
    return out


# -- the disaggregated handoff ----------------------------------------------


def prefill_packet(np_params: dict, cfg, plan: tuple | None, prompt: list, sampling: dict, kw: dict,
                   stream: int = 0):
    """A ``PrefillWorker`` on the plan's mesh (one device for None): the
    leader's packed packet (or, with ``stream``, its streamed chunks),
    None elsewhere; the gathered bytes on every rank."""
    from radixmesh_tpu_torch.engine.disagg import PrefillWorker, pack_handoff

    mesh = None if plan is None else mesh_of(plan)
    if plan is not None and mesh is None:
        return None
    pw = PrefillWorker(cfg, params_from_jax(np_params, cfg, "cpu"), device="cpu", device_mesh=mesh, **kw)
    if stream:
        # The chunks ship from a plane's handoff lane (on the leader only).
        import time

        from radixmesh_tpu_torch.cache.kv_transfer import KVTransferPlane

        plane, sent = KVTransferPlane(), []
        n = pw.prefill_handoff_stream(prompt, SamplingParams(**sampling), send=sent.append,
                                      chunk_tokens=stream, plane=plane)
        want = n if mesh is None or mesh.engine_index == 0 else 0
        deadline = time.monotonic() + 30
        while len(sent) < want and time.monotonic() < deadline:
            time.sleep(0.01)
        plane.close()
        return {"chunks": sent, "n": n, "gather_bytes": pw.gather_bytes}
    pkt = pw.prefill_handoff(prompt, SamplingParams(**sampling))
    return {"packet": None if pkt is None else pack_handoff(pkt), "gather_bytes": pw.gather_bytes}


def decode_packets(np_params: dict, cfg, plan: tuple, packets: list, kw: dict, stage_layers: int = 0):
    """A ``DecodeWorker`` over an engine on the plan's mesh: the leader takes
    ``packets`` in (as a transport would hand them over), every rank runs
    it to the end. Returns the tokens of every request on every rank and
    the pool's free slots."""
    from radixmesh_tpu_torch.engine.disagg import DecodeWorker

    mesh = mesh_of(plan)
    if mesh is None:
        return None
    eng = Engine(cfg, params_from_jax(np_params, cfg, "cpu"), device="cpu", device_mesh=mesh, **kw)
    dw = DecodeWorker(eng, stage_layers=stage_layers)
    made = []
    make = dw._make_request

    def record(pkt):
        req = make(pkt)
        made.append(req)
        return req

    dw._make_request = record
    if mesh.engine_index == 0:
        for data in packets:
            dw._on_packet(data)
    reset_collective_stats()
    dw.run_until_drained()
    assert all(r.state is RequestState.FINISHED for r in made)
    return {"tokens": [r.generated for r in made], "free_slots": eng.pool.free_slots,
            "collectives": collective_stats(), "stats": _stats(eng)}


# -- a pool-bound mesh replica ------------------------------------------------


def mesh_pool(np_params: dict, cfg, plan: tuple, prompt: list, sampling: dict, kw: dict,
              addrs: list):
    """Engine rank 0 holds a pool-bound ``MeshCache`` replica (inproc ring
    with a second, single-device serving node in the same process); both
    serve ``prompt``. Then the replica frees slots through its pool (the
    proxy), which every rank applies at the next pass. Returns the tokens,
    each rank's free slots and the slot balance."""
    from radixmesh_tpu_torch.cache.kv_pool import PagedKVPool
    from radixmesh_tpu_torch.cache.mesh_cache import MeshCache, MeshConfig

    mesh = mesh_of(plan)
    if mesh is None:
        return None
    params = params_from_jax(np_params, cfg, "cpu")
    L, H = cfg.n_layers // mesh.size("pp"), cfg.n_kv_heads // mesh.size("tp")
    pool = PagedKVPool(num_slots=kw["num_slots"], num_layers=L, num_kv_heads=H, head_dim=cfg.head_dim,
                       page_size=kw["page_size"], dtype=cfg.dtype, device="cpu")
    leader = mesh.engine_index == 0
    nodes = []
    replica = None
    if leader:
        for i, addr in enumerate(addrs):
            mcfg = MeshConfig(prefill_nodes=addrs[:1], decode_nodes=addrs[1:], router_nodes=[],
                              local_addr=addr, protocol="inproc", tick_interval_s=0.05, gc_interval_s=30.0)
            node_pool = pool if i == 0 else PagedKVPool(
                num_slots=kw["num_slots"], num_layers=cfg.n_layers, num_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, page_size=kw["page_size"], dtype=cfg.dtype, device="cpu")
            nodes.append(MeshCache(mcfg, pool=node_pool).start())
        for n in nodes:
            assert n.wait_ready(timeout=10)
        replica = nodes[0]
    eng = Engine(cfg, params, device="cpu", device_mesh=mesh, pool=pool, mesh=replica, **kw)
    out = {"proxy": type(replica.pool).__name__ if leader else None, "bound": eng._mesh_proxy is not None}
    greedy = SamplingParams(**sampling)
    out["tokens"] = eng.generate([prompt], greedy)
    if leader:
        other = Engine(cfg, params, device="cpu", pool=nodes[1].pool, mesh=nodes[1], **kw)
        out["other_tokens"] = other.generate([prompt], greedy)
        # Both replicas hold the prompt's prefix after the ring settles.
        import time

        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and nodes[1].tree.match_prefix(np.asarray(prompt, np.int32)).length == 0:
            time.sleep(0.05)
    # A free through the replica's pool: slots taken alike on every rank,
    # queued on the leader, applied on every rank at the next pass.
    taken = eng.pool.alloc(2 * kw["page_size"])
    if leader:
        replica.pool.free(taken)
    before = eng.pool.free_slots
    eng.has_work()  # the pass boundary
    eng.step()
    tree_tokens = eng.tree.evictable_size_ + eng.tree.protected_size_
    out.update(freed=eng.pool.free_slots - before, free_slots=eng.pool.free_slots,
               balance=eng.pool.free_slots + tree_tokens + kw["page_size"] == kw["num_slots"])
    for n in nodes:
        n.close()
    return out
