"""What each rank of a ``tests/_torch_ranks.RankGroup`` runs for the CPU tests
of the port's training and checkpoint paths (``tests/test_torch_train.py``,
the pipeline train twins of ``test_torch_pipeline.py``, the tree snapshot
twin of ``test_torch_pp_serving.py``). torch, numpy and the port only: the
JAX references are computed in the test process.

Plans are ``(dp, sp, tp, pp)`` tuples (``_torch_parallel_cases.mesh_of``);
a rank outside the plan's mesh returns None. Trees come back whole: each
leaf gathered over the mesh axes that shard it, so every rank of a mesh
returns the same tree when its replicated leaves agree.
"""

from __future__ import annotations

import numpy as np
import torch

from radixmesh_tpu_torch.checkpoint import load_tree, save_tree
from radixmesh_tpu_torch.engine.engine import Engine
from radixmesh_tpu_torch.engine.request import SamplingParams
from radixmesh_tpu_torch.models.convert import params_from_jax
from radixmesh_tpu_torch.models.llama import param_logical_axes
from radixmesh_tpu_torch.parallel import all_gather
from radixmesh_tpu_torch.parallel.pipeline import make_pp_train_step
from radixmesh_tpu_torch.parallel.sharding import SERVING_RULES, logical_to_spec
from radixmesh_tpu_torch.parallel.train import (
    adamw,
    global_grad_norm,
    make_train_state,
    make_train_step,
)
from tests._torch_parallel_cases import mesh_of

OPTIMIZERS = {"sgd": lambda ps: torch.optim.SGD(ps, lr=1e-2), "adamw": adamw}


def whole_tree(tree: dict, cfg, mesh) -> dict:
    """``tree`` (this rank's shards) as numpy, each leaf all-gathered along
    every dimension a mesh axis shards."""
    axes = param_logical_axes(cfg, tree)

    def walk(t, ax):
        if isinstance(t, dict):
            return {k: walk(v, ax[k]) for k, v in t.items()}
        t = t.detach()
        for dim, axis in enumerate(logical_to_spec(ax, SERVING_RULES)):
            if axis is not None and mesh is not None and mesh.size(axis) > 1:
                t = all_gather(t, mesh, axis, dim)
        return t.float().numpy()

    return walk(tree, axes)


def train_steps(np_params: dict, cfg, plan: tuple, tokens: np.ndarray, opt: str, steps: int,
                n_micro: int | None = None):
    """``steps`` train steps of the plan's mesh on ``tokens`` (through the
    pipeline under pp, ``n_micro`` microbatches), the state built from the
    whole tree: the losses, the global gradient norm after the last step
    and the whole trained tree."""
    mesh = mesh_of(plan)
    if mesh is None:
        return None
    cfg_params = params_from_jax(np_params, cfg, "cpu")
    optimizer = OPTIMIZERS[opt]
    state = make_train_state(cfg, mesh=mesh, optimizer=optimizer, device="cpu", params=cfg_params)
    if mesh.size("pp") > 1:
        step = make_pp_train_step(cfg, mesh, optimizer, n_micro)
    else:
        step = make_train_step(cfg, mesh, optimizer)
    losses = []
    for _ in range(steps):
        state, loss = step(state, torch.as_tensor(tokens))
        losses.append(float(loss))
    return {"losses": losses, "grad_norm": global_grad_norm(state.params), "step": state.step,
            "whole": whole_tree(state.params.param_tree(), cfg, mesh)}


def pp_tree_snapshot(np_params: dict, cfg, plan: tuple, prompt: list, path: str, engine_kw: dict):
    """The twin of ``test_pp_serving.py::test_pp_engine_tree_snapshot_restore``
    on this rank: serve ``prompt``, snapshot the tree and the pool, restore
    into a fresh engine on the same mesh, serve the prompt grown by two
    tokens (a hit) and the prompt again."""
    mesh = mesh_of(plan)
    if mesh is None:
        return None
    greedy = SamplingParams(temperature=0.0, max_new_tokens=6)
    params = params_from_jax(np_params, cfg, "cpu")
    eng = Engine(cfg, params, device="cpu", device_mesh=mesh, **engine_kw)
    out1 = eng.generate([prompt], greedy)[0]
    save_tree(path, eng.tree, pool=eng.pool, mesh=mesh)
    eng2 = Engine(cfg, params, device="cpu", device_mesh=mesh, **engine_kw)
    restored = load_tree(path, eng2.tree, pool=eng2.pool, mesh=mesh)
    cached0 = eng2.stats.cached_tokens
    out2 = eng2.generate([prompt + [7, 8]], greedy)[0]
    cached = eng2.stats.cached_tokens - cached0
    out3 = eng2.generate([prompt], greedy)[0]
    return {"out1": out1, "out2": out2, "out3": out3, "cached": cached, "restored": restored}
