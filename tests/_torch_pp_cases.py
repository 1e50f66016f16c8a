"""What each rank of a ``tests/_torch_ranks.RankGroup`` runs for the CPU tests
of the port's pipeline, pipeline-parallel serving and device handoff
(``tests/test_torch_pipeline.py``, ``test_torch_pp_serving.py``,
``test_torch_ici_handoff.py``). torch, numpy and the port only: the JAX
references are computed in the test process.

Plans are ``(dp, sp, tp, pp)`` tuples (``_torch_parallel_cases.mesh_of``);
a rank outside the plan's mesh returns None. Pools and logits come back
whole: each rank's stage and head shard gathered over tp and pp.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from radixmesh_tpu_torch.engine.disagg import DecodeWorker, IciHandoff, PrefillWorker
from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.engine.request import SamplingParams
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import Llama, stage_layers
from radixmesh_tpu_torch.obs import metrics
from radixmesh_tpu_torch.parallel import (
    all_gather,
    collective_stats,
    make_kv_page_transfer,
    pipeline_forward,
    pp_decode_multi,
    pp_forward_chunk,
    reset_collective_stats,
    stage_params,
)
from tests._torch_parallel_cases import _stats, mesh_of


def _stage_slice(mesh, cfg, a):
    """This rank's block ``[:, L/pp, Hkv/tp, ...]`` of a whole pool (or
    scales) ``a``."""
    lo, hi = stage_layers(cfg, mesh)
    tp, i = mesh.size("tp"), mesh.index("tp")
    h = a.shape[2] // tp
    return torch.as_tensor(np.ascontiguousarray(a[:, lo:hi, i * h:(i + 1) * h]))


def _whole(mesh, t):
    """A stage's pool block gathered back to the whole pool."""
    return all_gather(all_gather(t, mesh, "tp", dim=2), mesh, "pp", dim=1).numpy()


def _stage_model(np_params, cfg, mesh):
    return Llama(cfg, params_from_jax(np_params, cfg, "cpu", mesh=mesh), mesh=mesh)


# -- the pipelined forward ----------------------------------------------------


def pipeline_logits(np_params: dict, cfg, plan: tuple, n_micro: int, tokens: np.ndarray):
    """``pipeline_forward`` over this rank's stage of the whole tree
    (``stage_params``), and the p2p tally of the call."""
    mesh = mesh_of(plan)
    if mesh is None:
        return None
    params = stage_params(params_from_jax(np_params, cfg, "cpu"), mesh.size("pp"), mesh)
    reset_collective_stats()
    logits = pipeline_forward(params, cfg, torch.as_tensor(tokens), mesh, n_micro)
    return {"logits": logits.numpy(), "collectives": collective_stats()}


# -- pipeline-parallel serving ----------------------------------------------


def pp_chunk(np_params: dict, cfg, plan: tuple, n_micro: int, toks, pos, pool0, slots, pt, kvlen,
             page_size: int, scale0=None):
    """``pp_forward_chunk`` on this rank's stage over its block of ``pool0``:
    the logits and the whole pool after it (and the scales of an int8
    pool)."""
    mesh = mesh_of(plan)
    if mesh is None:
        return None
    model = _stage_model(np_params, cfg, mesh)
    pool = _stage_slice(mesh, cfg, pool0)
    scale = None if scale0 is None else _stage_slice(mesh, cfg, scale0)
    t = torch.as_tensor
    logits = pp_forward_chunk(model, t(toks), t(pos), pool, t(slots), t(pt), t(kvlen),
                              page_size=page_size, n_micro=n_micro, kv_scale=scale)
    return {"logits": logits.numpy(), "pool": _whole(mesh, pool),
            "scale": None if scale is None else _whole(mesh, scale)}


def pp_multi(np_params: dict, cfg, plan: tuple, tokens, pool0, pt, lengths, k: int, page_size: int,
             scale0=None):
    """``pp_decode_multi`` (greedy) on this rank's stage over its block of
    ``pool0``: the sampled tokens and the whole pool after it."""
    mesh = mesh_of(plan)
    if mesh is None:
        return None
    model = _stage_model(np_params, cfg, mesh)
    pool = _stage_slice(mesh, cfg, pool0)
    scale = None if scale0 is None else _stage_slice(mesh, cfg, scale0)
    B = len(tokens)
    t = torch.as_tensor
    got = pp_decode_multi(model, t(tokens), pool, t(pt), t(lengths), torch.Generator().manual_seed(0),
                          np.zeros(B, np.float32), np.ones(B, np.float32), page_size=page_size,
                          k_steps=k, kv_scale=scale)
    return {"tokens": got.numpy(), "pool": _whole(mesh, pool),
            "scale": None if scale is None else _whole(mesh, scale)}


def storm(np_params: dict, cfg, plan: tuple, seed: int, engine_kw: dict):
    """The JAX ``TestPPStorm`` script on this rank's engine: every rank draws
    the same decisions from ``seed``. Returns each request's state, output
    and sampling, the pool balance and the stats."""
    mesh = mesh_of(plan)
    if mesh is None:
        return None
    eng = Engine(cfg, params_from_jax(np_params, cfg, "cpu"), device="cpu", device_mesh=mesh, **engine_kw)
    rng = np.random.default_rng(seed)
    live, done = [], []
    for _ in range(40):
        roll = rng.random()
        if roll < 0.35 and len(live) < 8:
            n = int(rng.integers(3, 24))
            prompt = rng.integers(1, cfg.vocab_size, n).tolist()
            temp = 0.0 if rng.random() < 0.7 else 0.8
            live.append(eng.add_request(prompt, SamplingParams(
                temperature=temp, max_new_tokens=int(rng.integers(2, 10)))))
        elif roll < 0.45 and live:
            eng.cancel(live[int(rng.integers(0, len(live)))].rid)
        elif eng.has_work():
            eng.step()
        still = []
        for r in live:
            (done if r.state.value == "finished" else still).append(r)
        live = still
    while eng.has_work():
        eng.step()
    done.extend(live)
    return {"requests": [(r.state.value, bool(r.cancelled), list(r.output_tokens),
                          r.sampling.max_new_tokens) for r in done],
            "balance": (eng.pool.free_slots, eng.tree.total_size(), eng.pool.num_slots),
            "stats": _stats(eng)}


def host_tier(np_params: dict, cfg, plan: tuple, prompts: list, engine_kw: dict):
    """The JAX ``test_pp_engine_host_cache_tier`` script on this rank's
    engine, with a fresh registry: cached tokens, the hicache backup and
    restore counters, and the tokens of each run."""
    mesh = mesh_of(plan)
    if mesh is None:
        return None
    old = metrics.get_registry()
    metrics.set_registry(metrics.Registry())
    try:
        eng = Engine(cfg, params_from_jax(np_params, cfg, "cpu"), device="cpu", device_mesh=mesh,
                     **engine_kw)
        outs = [eng.generate([p], max_steps=30) for p in prompts]
        snap = metrics.get_registry().snapshot()
        return {"tokens": outs, "cached": eng.stats.cached_tokens,
                "arena_layers": eng.tree.host._arena.shape[2],
                "backup": snap.get("radixmesh_hicache_backup_tokens_total", 0),
                "restore": snap.get("radixmesh_hicache_restore_tokens_total", 0),
                "stats": _stats(eng)}
    finally:
        metrics.set_registry(old)


# -- the device handoff -------------------------------------------------------


def page_transfer(plan: tuple, axis: str, perm: list, blocks: np.ndarray):
    """``make_kv_page_transfer`` over ``axis``: rank ``i`` of the axis passes
    ``blocks[i]``."""
    mesh = mesh_of(plan)
    if mesh is None:
        return None
    fn = make_kv_page_transfer(mesh, axis, perm)
    return fn(torch.as_tensor(blocks[mesh.index(axis)])).numpy()


def ici_handoff(np_params: dict, cfg, plan: tuple, axis: str, src: int, dst: int, prompt: list,
                new_tokens: int, page_size: int, kv_quant=None):
    """Rank ``src`` of ``axis`` prefills ``prompt`` as a ``PrefillWorker``
    (``device_kv=True``), :meth:`IciHandoff.move` carries the packet to rank
    ``dst``, which decodes it as a ``DecodeWorker``. The source returns its
    packet's KV, the destination the moved KV and its tokens, every other
    rank what ``move`` gave it."""
    mesh = mesh_of(plan)
    if mesh is None:
        return None
    params = params_from_jax(np_params, cfg, "cpu")
    kw = dict(num_slots=512, page_size=page_size, max_batch=2, device="cpu", kv_quant=kv_quant)
    i = mesh.index(axis)
    chan = IciHandoff(mesh, axis, src, dst, page_size=page_size, device="cpu")
    sampling = SamplingParams(temperature=0.0, max_new_tokens=new_tokens)
    pkt = None
    if i == src:
        pkt = PrefillWorker(cfg, params, **kw).prefill_handoff(prompt, sampling, device_kv=True)
    reset_collective_stats()
    moved = chan.move(pkt)
    out = {"index": i, "moved": moved is not None, "p2p": collective_stats().get("p2p")}
    if i == src:
        out["kv"] = pkt.kv.numpy()
        out["scale"] = None if pkt.kv_scale is None else pkt.kv_scale.numpy()
    if moved is not None:
        out["kv"] = moved.kv.numpy()
        out["scale"] = None if moved.kv_scale is None else moved.kv_scale.numpy()
        out["packet"] = {f.name: getattr(moved, f.name) for f in dataclasses.fields(moved)
                         if f.name not in ("kv", "kv_scale", "sampling", "prompt")}
        out["prompt"] = np.asarray(moved.prompt).tolist()
        dw = DecodeWorker(Engine(cfg, params, **kw))
        req = dw.submit(moved)
        dw.run_until_drained()
        out["tokens"] = req.output_tokens
    return out
