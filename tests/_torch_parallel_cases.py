"""What each rank of a ``tests/_torch_ranks.RankGroup`` runs for the CPU tests
of the port's tensor- and sequence-parallel paths. torch, numpy and the port
only: the JAX references are computed in the test process.

Every function takes plain picklable arguments (numpy arrays, configs, a
plan as a ``(dp, sp, tp)`` or ``(dp, sp, tp, pp)`` tuple) and returns numpy
or plain Python. A rank
outside the plan's mesh returns None. Meshes are built once per plan and
process (every rank builds them in the same order, as torch requires).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.engine.request import SamplingParams
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import Llama, param_logical_axes
from radixmesh_tpu_torch.parallel import (
    MeshPlan,
    all_gather,
    collective_stats,
    global_mesh,
    make_mesh,
    reset_collective_stats,
    ring_self_attention,
    shard_params,
    ulysses_self_attention,
)

_MESHES: dict = {}


def mesh_of(plan: tuple):
    if plan not in _MESHES:
        _MESHES[plan] = make_mesh(MeshPlan(*plan[:3], pp=plan[3] if len(plan) > 3 else 1))
    return _MESHES[plan]


# -- meshes and sharding -----------------------------------------------------


def mesh_layout(plan: tuple):
    mesh = mesh_of(plan)
    if mesh is None:
        return None
    return {"shape": mesh.shape, "coords": mesh.coords,
            "lines": {a: list(v) for a, v in mesh.lines.items()}, "backend": mesh.backend}


def mesh_refused(plan: tuple) -> str:
    try:
        make_mesh(MeshPlan(*plan))
    except ValueError as e:
        return str(e)
    return "no error"


def batch_block(plan: tuple, x: np.ndarray):
    """This rank's ``[B/dp, S/sp]`` block of a token batch."""
    from radixmesh_tpu_torch.parallel import shard_batch

    mesh = mesh_of(plan)
    return None if mesh is None else shard_batch(torch.as_tensor(x), mesh).numpy()


def global_mesh_layout():
    mesh = global_mesh()
    return {"shape": mesh.shape, "coords": mesh.coords}


def shard_shapes(np_params: dict, cfg, plan: tuple):
    mesh = mesh_of(plan)
    if mesh is None:
        return None
    params = params_from_jax(np_params, cfg, "cpu", mesh=mesh)

    def shapes(t):
        return {k: shapes(v) for k, v in t.items()} if isinstance(t, dict) else tuple(t.shape)

    return shapes(params)


def tp_prefill_logits(np_params: dict, cfg, plan: tuple, tokens: np.ndarray):
    """Dense prefill logits of ``tokens`` through a tp-sharded model built
    by ``shard_params`` over the full converted tree."""
    mesh = mesh_of(plan)
    if mesh is None:
        return None
    full = params_from_jax(np_params, cfg, "cpu")
    model = Llama(cfg, shard_params(full, param_logical_axes(cfg, full), mesh), mesh=mesh)
    B, S = tokens.shape
    t = torch.as_tensor(tokens)
    pos = torch.arange(S)[None].expand(B, S)
    empty = torch.zeros((cfg.n_layers, B, 0, model.n_kv_heads, cfg.head_dim), dtype=cfg.dtype)
    logits, _, _ = model.prefill_forward(t, pos, empty, empty, torch.zeros(B, dtype=torch.long))
    return logits.numpy()


def sp_prefill(np_params: dict, cfg, plan: tuple, tokens: np.ndarray, logits_at=None):
    """``prefill_forward_sp`` over the plan's sp axis (tp composes): the
    blocks' logits and K/V gathered back to whole sequences."""
    mesh = mesh_of(plan)
    if mesh is None:
        return None
    params = params_from_jax(np_params, cfg, "cpu", mesh=mesh)
    model = Llama(cfg, params, mesh=mesh)
    B, S = tokens.shape
    pos = torch.arange(S)[None].expand(B, S)
    at = None if logits_at is None else torch.as_tensor(logits_at)
    logits, k, v = model.prefill_forward_sp(torch.as_tensor(tokens), pos, logits_at=at)
    if at is None:
        logits = all_gather(logits, mesh, "sp", dim=1)
    k = all_gather(all_gather(k, mesh, "sp", dim=2), mesh, "tp", dim=3)
    v = all_gather(all_gather(v, mesh, "sp", dim=2), mesh, "tp", dim=3)
    return {"logits": logits.numpy(), "k": k.numpy(), "v": v.numpy()}


# -- sequence-parallel attention --------------------------------------------


def ring(plan: tuple, q, k, v, score_bytes: int | None = None):
    """``ring_self_attention``; ``score_bytes`` bounds its score blocks for
    the call (a few kv heads at a time)."""
    import importlib

    ring_mod = importlib.import_module("radixmesh_tpu_torch.parallel.ring_attention")
    mesh = mesh_of(plan)
    if mesh is None:
        return None
    t = [torch.as_tensor(x) for x in (q, k, v)]
    saved = ring_mod._SCORE_BYTES
    ring_mod._SCORE_BYTES = score_bytes or saved
    try:
        return ring_self_attention(*t, mesh).numpy()
    finally:
        ring_mod._SCORE_BYTES = saved


def ulysses(plan: tuple, q, k, v):
    mesh = mesh_of(plan)
    if mesh is None:
        return None
    t = [torch.as_tensor(x) for x in (q, k, v)]
    try:
        return ulysses_self_attention(*t, mesh).numpy()
    except ValueError as e:
        return f"ValueError: {e}"


# -- the sharded kernel wrappers ---------------------------------------------


def sharded_kernels(plan: tuple, q, kv, pt, lens, layer, chunk):
    """The three sharded wrappers on this rank's head shard of the inputs
    (plain versions on the CPU), outputs gathered over tp."""
    from radixmesh_tpu_torch.ops.attention import (
        paged_attention_pool_kernel_sharded,
        paged_chunk_attention_kernel_sharded,
        paged_decode_fused_sharded,
    )

    mesh = mesh_of(plan)
    if mesh is None:
        return None
    tp, i = mesh.size("tp"), mesh.index("tp")
    hq, hkv = q.shape[1] // tp, kv.shape[2] // tp
    q_l = torch.as_tensor(q[:, i * hq:(i + 1) * hq]).contiguous()
    kv_l = torch.as_tensor(kv[:, :, i * hkv:(i + 1) * hkv]).contiguous()
    pt_t, len_t = torch.as_tensor(pt), torch.as_tensor(lens)
    pool = paged_attention_pool_kernel_sharded(q_l, kv_l, pt_t, len_t, layer)
    cq, ck, cv, prior, kvlen = (torch.as_tensor(x) for x in chunk)
    cq_l = cq[:, :, i * hq:(i + 1) * hq].contiguous()
    ck_l = ck[:, :, i * hkv:(i + 1) * hkv].contiguous()
    cv_l = cv[:, :, i * hkv:(i + 1) * hkv].contiguous()
    ch = paged_chunk_attention_kernel_sharded(cq_l, ck_l, cv_l, kv_l, pt_t, prior, kvlen, layer)
    kn = ck[:, 0, i * hkv:(i + 1) * hkv].contiguous()
    vn = cv[:, 0, i * hkv:(i + 1) * hkv].contiguous()
    slots = pt_t[:, 0].long() * kv.shape[4]  # each row's first slot
    dec = paged_decode_fused_sharded(q_l, kn, vn, kv_l, slots.to(torch.int32), pt_t, len_t, layer)
    return {"pool": all_gather(pool, mesh, "tp", dim=1).numpy(),
            "chunk": all_gather(ch, mesh, "tp", dim=2).numpy(),
            "decode": all_gather(dec, mesh, "tp", dim=1).numpy(),
            "pool_after": all_gather(kv_l, mesh, "tp", dim=2).numpy()}


# -- serving -----------------------------------------------------------------


def _stats(engine) -> dict:
    st = dataclasses.asdict(engine.stats)
    st.pop("ttft_s")  # wall clock
    return st


def serve(np_params: dict | None, cfg, plan: tuple | None, runs: list, engine_kw: dict,
          seed_init: int | None = None, paged: bool = False):
    """An engine (on the plan's mesh, or single-device for ``plan`` None)
    over ``runs``: each ``(prompts, sampling kwargs)`` is one ``generate``.
    ``paged``: the CUDA decode policy on the CPU (the paged legs, with the
    plain versions), for the duration of the call. Returns the tokens per
    run, the stats, the first-token logit rows and the collective tally."""
    import radixmesh_tpu_torch.engine.engine as engine_mod
    import radixmesh_tpu_torch.ops.attention as attention_mod

    saved = (attention_mod.default_use_kernel, engine_mod.default_use_kernel)
    if paged:
        attention_mod.default_use_kernel = engine_mod.default_use_kernel = lambda h, d: True
    try:
        return _serve(np_params, cfg, plan, runs, engine_kw, seed_init)
    finally:
        attention_mod.default_use_kernel, engine_mod.default_use_kernel = saved


def _serve(np_params, cfg, plan, runs, engine_kw, seed_init):
    mesh = None
    if plan is not None:
        mesh = mesh_of(plan)
        if mesh is None:
            return None
    if np_params is not None:
        params = params_from_jax(np_params, cfg, "cpu")
    else:
        from radixmesh_tpu_torch.models.llama import init_params

        params = init_params(cfg, seed_init, "cpu")
    eng = Engine(cfg, params, device="cpu", device_mesh=mesh, **engine_kw)
    firsts = []
    eng.on_first_logits = lambda req, row: firsts.append(row.float().numpy().copy())
    reset_collective_stats()
    tokens = [eng.generate(prompts, SamplingParams(**skw)) for prompts, skw in runs]
    return {"tokens": tokens, "stats": _stats(eng), "first_logits": firsts,
            "collectives": collective_stats(), "pool_heads": eng.pool.num_kv_heads}


def serve_refused(cfg, plan: tuple, engine_kw: dict) -> str:
    mesh = mesh_of(plan)
    if mesh is None:
        return None
    from radixmesh_tpu_torch.models.llama import init_params

    try:
        Engine(cfg, init_params(cfg, 0, "cpu"), device="cpu", device_mesh=mesh, **engine_kw)
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"
