"""Pipeline parallelism: layer stages over a ``pp`` mesh axis (the JAX
package's ``parallel/pipeline.py``).

The JAX package reshapes the stacked layer axis ``[L, ...]`` into ``[pp,
L/pp, ...]`` and runs a GPipe schedule inside one ``shard_map``: every tick
each device runs its stage and ``ppermute``s the activation to its
successor, ``n_micro + pp - 1`` ticks in lockstep, warm-up and drain ticks
computing garbage. The port runs one process per stage, so a stage is a
program of its own and the schedule is real:

- Stage 0 embeds microbatch ``m`` (``B / n_micro`` rows), runs its layers
  and sends the ``[mb, S, H]`` activation to stage 1 with
  :func:`~radixmesh_tpu_torch.parallel.collectives.pipe_shift`; the send is
  in flight while it starts microbatch ``m + 1``. A later stage receives,
  runs its layers and sends on. Stages overlap because they are separate
  processes; nothing computes a warm-up or drain tick.
- The last stage keeps the finished activations and broadcasts them over
  pp in the model dtype (:func:`gpipe`); every rank applies the final norm
  and the LM head itself (the head is on every stage, as the embedding is).

:func:`pipeline_forward` is the training-shaped forward the JAX module
holds: causal self-attention without a KV cache, by the plain attention
(``ops.attention.attend_prefill``, as the JAX body is ``jnp``), so it runs
no kernel. :func:`gpipe` is also the schedule of the serving path
(``parallel/pp_serving.py``).

Not ported yet: ``make_pp_train_step`` (training, ``ROADMAP.md`` A6).
"""

from __future__ import annotations

import torch

from radixmesh_tpu_torch.ops.attention import attend_prefill
from radixmesh_tpu_torch.ops.norm import rms_norm
from radixmesh_tpu_torch.parallel.collectives import broadcast, pipe_shift
from radixmesh_tpu_torch.parallel.sharding import MeshPlan, ProcessMesh, make_mesh

__all__ = [
    "make_pp_mesh",
    "stage_params",
    "gpipe",
    "pipeline_forward",
    "make_pp_train_step",
]


def make_pp_mesh(pp: int) -> ProcessMesh | None:
    """A ``pp``-stage mesh over the first ``pp`` ranks of the process group
    (``make_mesh(MeshPlan(pp=pp))``: every rank of the group calls it; a
    rank outside gets None)."""
    return make_mesh(MeshPlan(pp=pp))


def stage_params(params: dict, pp: int, mesh: ProcessMesh | None = None) -> dict:
    """Split the stacked layer axis over ``pp`` stages. Without ``mesh`` every
    layer leaf becomes ``[pp, L/pp, ...]`` (the JAX layout); with ``mesh``
    this rank keeps its stage's ``[L/pp, ...]`` block. Non-layer leaves are
    kept as they are. ``L`` must divide by ``pp``."""
    L = params["layers"]["wq"].shape[0]
    if L % pp:
        raise ValueError(f"n_layers={L} not divisible by pp={pp}")
    out = dict(params)
    if mesh is None:
        out["layers"] = {k: v.reshape(pp, L // pp, *v.shape[1:]) for k, v in params["layers"].items()}
        return out
    if mesh.size("pp") != pp:
        raise ValueError(f"pp={pp} but the mesh has pp={mesh.size('pp')}")
    n = L // pp
    s = mesh.index("pp")
    out["layers"] = {k: v[s * n:(s + 1) * n].clone() for k, v in params["layers"].items()}
    return out


def gpipe(mesh: ProcessMesh, n_micro: int, batch: int, like: torch.Tensor, first, stage) -> torch.Tensor:
    """The GPipe schedule over ``mesh``'s pp axis for a batch of ``batch`` rows
    in ``n_micro`` microbatches of ``mb`` rows: stage 0 feeds
    ``first(rows)`` (a slice of the batch) into ``stage(h, rows)``; every
    later stage receives the previous stage's output, a tensor like
    ``like [mb, ...]``, and runs ``stage`` on it; each stage sends its
    output on. Returns the last stage's outputs ``[batch, ...]``
    concatenated, broadcast from the last stage to every rank of the pp
    line."""
    pp, s = mesh.size("pp"), mesh.index("pp")
    if batch % n_micro:
        raise ValueError(f"batch {batch} not divisible by n_micro={n_micro}")
    mb = batch // n_micro
    outs, sends = [], []
    for m in range(n_micro):
        rows = slice(m * mb, (m + 1) * mb)
        h = first(rows) if s == 0 else pipe_shift([], mesh, "pp", [like]).wait()[0]
        h = stage(h, rows)
        if s < pp - 1:
            sends.append(pipe_shift([h], mesh, "pp"))
        else:
            outs.append(h)
    for x in sends:
        x.wait()
    hidden = torch.cat(outs) if outs else like.new_empty((batch, *like.shape[1:]))
    return broadcast(hidden, mesh, "pp", pp - 1)


def _block(model, l: int, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """One transformer block of ``model`` (stage-local layer ``l``), causal
    self-attention with no KV cache: ``prefill_forward``'s layer with an
    empty prefix."""
    cfg = model.cfg
    h = rms_norm(x, model.layers["attn_norm"][l], cfg.rms_eps)
    q, k, v = model._qkv(l, h)
    q, k = model._rope(q, positions), model._rope(k, positions)
    kv_end = torch.full((x.shape[0],), x.shape[1], dtype=torch.long, device=x.device)
    attn = attend_prefill(q, k, v, positions, kv_end)
    return model._attn_out_mlp(l, x, attn)


@torch.inference_mode()
def pipeline_forward(params_pp: dict, cfg, tokens: torch.Tensor, mesh: ProcessMesh,
                     n_micro: int) -> torch.Tensor:
    """Causal-LM logits through the layer pipeline. ``params_pp`` is this
    rank's stage (``stage_params(params, pp, mesh)``, or
    ``init_params(..., mesh=mesh)``); ``tokens [B, S]`` is the same on every
    rank and ``B`` divides into ``n_micro`` microbatches. Returns float32
    logits ``[B, S, V]`` on every rank of the pp line."""
    from radixmesh_tpu_torch.models.llama import Llama  # models import this package

    model = Llama(cfg, params_pp, mesh=mesh)
    B, S = tokens.shape
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    positions = torch.arange(S, device=tokens.device)[None].expand(B // n_micro, S)

    def stage(h, rows):
        for l in range(model.n_layers):
            h = _block(model, l, h, positions)
        return h

    like = torch.empty((B // n_micro, S, cfg.hidden), dtype=cfg.dtype, device=model.embed.device)
    hidden = gpipe(mesh, n_micro, B, like, lambda rows: model._embed(tokens[rows]), stage)
    return model._logits(hidden)


def make_pp_train_step(cfg, mesh: ProcessMesh, optimizer, n_micro: int):
    """Training through the pipeline: not ported yet (``ROADMAP.md`` A6)."""
    raise NotImplementedError("make_pp_train_step (training through the pipeline) is not ported yet "
                              "(ROADMAP.md A6)")
