"""The process mesh over ``(dp, pp, sp, tp)`` and the logical-axis sharding
rules (the JAX package's ``parallel/sharding.py``, with the pipeline axis of
its ``parallel/pp_serving.py``).

The JAX package is single-controller: one process drives every device and
XLA inserts the collectives. The port runs one process per device over
``torch.distributed``, every rank running the same program on its own
shards, with every collective written out (``parallel/collectives.py``):

- :class:`MeshPlan` factorizes the rank count over ``(dp, sp, tp)`` with the
  JAX ``auto`` rule (8 → (1, 2, 4), 4 → (1, 1, 4), 16 → (2, 2, 4)); the
  pipeline axis ``pp`` is a keyword field (default 1) that ``auto`` never
  picks.
- :func:`make_mesh` builds a :class:`ProcessMesh`: rank ``r`` sits at
  ``(dp, pp, sp, tp) = unravel(r, (dp, pp, sp, tp))``, so ``tp`` is
  innermost (the ranks of one tp group are consecutive, the same host's
  devices), and the mesh holds one process group per axis through this
  rank, and one over the ranks of this rank's engine: those that share its
  dp index (``pp × sp × tp`` ranks, which run one engine between them; the
  step agreement of ``parallel/step_sync.py`` runs over it).
- ``LOGICAL_RULES`` and :func:`logical_to_spec` are the JAX package's: tp
  shards ``q_heads``, ``kv_heads``, ``ffn`` and ``vocab`` (Megatron layout:
  column-parallel ``wq``/``wk``/``wv``/``w_gate``/``w_up``, row-parallel
  ``wo``/``w_down``, a vocab-parallel embedding and head), everything else
  replicates. ``SERVING_RULES`` adds the pipeline's: the ``layer`` axis over
  pp, each stage a contiguous block of ``L/pp`` layers (the JAX
  ``pp_layer_specs``). :func:`shard_params` slices each leaf to this rank's
  shard by ``SERVING_RULES``.
- :func:`batch_sharding` is the rule for token batches ``[B, S, ...]``:
  batch over dp, sequence over sp; :func:`shard_batch` takes this rank's
  block.

A shard is a plain tensor: the kernels take local tensors, so no DTensor
wraps them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "AXES",
    "LOGICAL_RULES",
    "SERVING_RULES",
    "MeshPlan",
    "ProcessMesh",
    "make_mesh",
    "logical_to_spec",
    "shard_leaf",
    "shard_params",
    "batch_sharding",
    "shard_batch",
]

# Mesh axes, outermost first (tp innermost).
AXES = ("dp", "pp", "sp", "tp")

# Logical axis name -> mesh axis (None = replicated along that axis), the
# JAX package's: the layer axis stays whole.
LOGICAL_RULES: dict[str, str | None] = {
    "vocab": "tp",
    "q_heads": "tp",
    "kv_heads": "tp",
    "ffn": "tp",
    "embed": None,
    "layer": None,
}
# What a rank holds: the layer axis over the pipeline stages as well.
SERVING_RULES: dict[str, str | None] = {**LOGICAL_RULES, "layer": "pp"}


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Factorization of the rank count over (dp, pp, sp, tp); ``pp`` is
    keyword-only, so ``MeshPlan(1, 2, 4)`` stays (dp, sp, tp)."""

    dp: int = 1
    sp: int = 1
    tp: int = 1
    pp: int = dataclasses.field(default=1, kw_only=True)

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.sp * self.tp

    @classmethod
    def auto(cls, n_devices: int, max_tp: int = 4) -> "MeshPlan":
        """Default factorization: tp first (the most bandwidth-hungry axis),
        then sp, then dp — 8 -> (dp=1, sp=2, tp=4), 4 -> (1, 1, 4),
        16 -> (2, 2, 4). ``max_tp`` caps head sharding (kv heads must stay
        divisible)."""
        tp = math.gcd(n_devices, max_tp)
        rest = n_devices // tp
        sp = 2 if rest % 2 == 0 else 1
        dp = rest // sp
        return cls(dp=dp, sp=sp, tp=tp)


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh:
    """This rank's view of a ``(dp, pp, sp, tp)`` process mesh: its coordinates,
    and per axis the process group of the ranks that differ from it only
    along that axis (None where the axis has one rank, or where the mesh has
    no process group at all: a one-rank mesh in a process that never called
    ``init_process_group``)."""

    plan: MeshPlan
    rank: int
    coords: tuple[int, int, int, int]
    backend: str | None
    groups: dict
    lines: dict  # axis -> global ranks along the axis through this rank

    @property
    def shape(self) -> dict:
        """Axis sizes, as the JAX ``Mesh.shape``."""
        return {a: getattr(self.plan, a) for a in AXES}

    def size(self, axis: str) -> int:
        return getattr(self.plan, axis)

    def index(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    def group(self, axis: str):
        return self.groups[axis]

    def peer(self, axis: str, i: int) -> int:
        """Global rank of index ``i`` along ``axis`` through this rank."""
        return self.lines[axis][i % self.size(axis)]

    @property
    def engine_size(self) -> int:
        """Ranks that run one engine: every rank with this rank's dp index."""
        return self.plan.pp * self.plan.sp * self.plan.tp

    @property
    def engine_index(self) -> int:
        """This rank's place among its engine's ranks (0 is the leader)."""
        _, pp, sp, tp = self.coords
        return (pp * self.plan.sp + sp) * self.plan.tp + tp

    def engine_group(self):
        """The process group of this rank's engine (None for one rank, or
        without a process group)."""
        return self.groups.get("engine")

    def engine_leader(self) -> int:
        """Global rank of this engine's leader (pp, sp and tp index 0)."""
        return self.lines["engine"][0] if self.lines.get("engine") else self.rank

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"backend={self.backend})")


def make_mesh(plan: MeshPlan | None = None) -> ProcessMesh | None:
    """A ``(dp, pp, sp, tp)`` mesh over the first ``plan.n_devices`` ranks of the
    default process group (all of them when ``plan`` is None: the ``auto``
    factorization). Every rank of the group must call it, in the same order
    as its other group constructions; a rank outside the plan gets None.
    Without a process group only a one-rank plan is possible."""
    if not dist.is_available() or not dist.is_initialized():
        world, rank, backend = 1, 0, None
    else:
        world, rank, backend = dist.get_world_size(), dist.get_rank(), dist.get_backend()
    if plan is None:
        plan = MeshPlan.auto(world)
    if plan.n_devices > world:
        raise ValueError(f"mesh plan {plan} needs {plan.n_devices} processes, have {world}")
    sizes = tuple(getattr(plan, a) for a in AXES)
    grid = np.arange(plan.n_devices).reshape(sizes)
    groups, lines = {}, {}
    for i, axis in enumerate(AXES):
        all_lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i]).tolist()
        mine = next((ln for ln in all_lines if rank in ln), None)
        lines[axis] = tuple(mine) if mine is not None else ()
        group = None
        if backend is not None and sizes[i] > 1:
            # Every rank creates every group, in one order (torch requires it).
            group, _ = dist.new_subgroups_by_enumeration(all_lines)
        groups[axis] = group
    # The ranks of one engine: one line per dp index over (pp, sp, tp).
    engine_lines = grid.reshape(sizes[0], -1).tolist()
    mine = next((ln for ln in engine_lines if rank in ln), None)
    lines["engine"] = tuple(mine) if mine is not None else ()
    groups["engine"] = None
    if backend is not None and len(engine_lines[0]) > 1:
        groups["engine"], _ = dist.new_subgroups_by_enumeration(engine_lines)
    if rank >= plan.n_devices:
        return None
    coords = tuple(int(c) for c in np.unravel_index(rank, sizes))
    return ProcessMesh(plan=plan, rank=rank, coords=coords, backend=backend, groups=groups,
                       lines=lines)


def logical_to_spec(axes: tuple, rules: dict = LOGICAL_RULES) -> tuple:
    """("layer", "embed", "q_heads") -> (None, None, "tp"): the mesh axis of
    each dimension (the JAX ``PartitionSpec``'s entries); with
    ``SERVING_RULES`` the layer axis maps to "pp"."""
    return tuple(rules.get(name) for name in axes)


def shard_leaf(t, axes: tuple, mesh: ProcessMesh | None):
    """This rank's block of one leaf ``t`` (a tensor or a numpy array) whose
    dimensions carry the logical ``axes``: each dimension mapped to a mesh
    axis of ``n`` ranks (``SERVING_RULES``) is cut into ``n`` equal blocks
    and this rank's is kept (a copy, so the full leaf can be freed). A
    dimension that does not divide raises, naming it."""
    if mesh is None:
        return t
    spec = logical_to_spec(axes, SERVING_RULES)
    if len(spec) != t.ndim:
        raise ValueError(f"leaf of shape {tuple(t.shape)} has logical axes {axes}")
    out = t
    for dim, mesh_axis in enumerate(spec):
        if mesh_axis is None or mesh.size(mesh_axis) == 1:
            continue
        n, i = mesh.size(mesh_axis), mesh.index(mesh_axis)
        if t.shape[dim] % n:
            raise ValueError(f"logical axis {axes[dim]!r} of size {t.shape[dim]} does not divide "
                             f"{mesh_axis}={n}")
        w = t.shape[dim] // n
        out = out[(slice(None),) * dim + (slice(i * w, (i + 1) * w),)]
    if out is t:
        return t
    if isinstance(out, torch.Tensor):
        return out.clone(memory_format=torch.contiguous_format)
    return np.ascontiguousarray(out)


def shard_params(params: Any, logical_axes: Any, mesh: ProcessMesh | None) -> Any:
    """Slice an unsharded param tree to this rank's shards: the tree of
    ``logical_axes`` (``models.llama.param_logical_axes(cfg, params)``)
    names every leaf's dimensions."""
    if isinstance(logical_axes, dict):
        return {k: shard_params(params[k], logical_axes[k], mesh) for k in params}
    return shard_leaf(params, logical_axes, mesh)


def batch_sharding(mesh: ProcessMesh, ndim: int = 2) -> tuple:
    """Token batches [B, S, ...]: batch over dp, sequence over sp (the mesh
    axis of each dimension)."""
    return ("dp", "sp") + (None,) * (ndim - 2)


def shard_batch(x: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """This rank's ``[B/dp, S/sp, ...]`` block of a token batch, by
    :func:`batch_sharding`."""
    for dim, axis in enumerate(batch_sharding(mesh, x.ndim)):
        if axis is None or mesh.size(axis) == 1:
            continue
        n = mesh.size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"batch dim {dim} of size {x.shape[dim]} does not divide {axis}={n}")
        w = x.shape[dim] // n
        x = x.narrow(dim, mesh.index(axis) * w, w)
    return x
