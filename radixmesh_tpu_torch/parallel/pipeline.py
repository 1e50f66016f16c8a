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
(``Llama.train_layers``: ``ops.attention.attend_prefill``, as the JAX body
is ``jnp``), so it runs no kernel. :func:`gpipe` is also the schedule of the
serving path (``parallel/pp_serving.py``).

:func:`make_pp_train_step` trains through the same schedule. Where JAX
differentiates its ``shard_map`` (the transpose of a ``ppermute`` is the
opposite shift), the port runs the backward schedule itself: the loss is
computed on every rank from the broadcast hidden state, so the last stage
keeps one copy of its gradient (``collectives.broadcast_from``), runs the
backward of its layers and sends each microbatch's input gradient to the
previous stage, last microbatch first; every other stage receives its
output gradient from the next, runs its backward and sends on. The
embedding's lookup gradient exists on stage 0 only and the LM head's (the
tied head's too) on every stage alike, so the lookup part is summed over pp
and the head's part added once: the replicated leaves stay equal on every
stage.
"""

from __future__ import annotations

import torch

from radixmesh_tpu_torch.parallel.collectives import all_reduce, broadcast_from, p2p, pipe_shift
from radixmesh_tpu_torch.parallel.sharding import MeshPlan, ProcessMesh, make_mesh, shard_batch

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
    line (under autograd, the last stage's copy carries the gradient:
    ``broadcast_from``)."""
    pp, s = mesh.size("pp"), mesh.index("pp")
    if batch % n_micro:
        raise ValueError(f"batch {batch} not divisible by n_micro={n_micro}")
    mb = batch // n_micro
    outs, sends = [], []
    for m in range(n_micro):
        rows = slice(m * mb, (m + 1) * mb)
        # meshcheck: ok[hotpath-blocking] under pp the stage-to-stage shift IS the engine's step
        # (Engine.step reaches it through pp_forward_chunk and pp_decode_step); the wait is
        # bounded by the process group's timeout (init_multihost(timeout_s=),
        # parallel/multihost.py): an unmatched collective ends in an error, never a hang. No
        # timeout= here: on NCCL it would turn the stream-side wait into a host-blocking one.
        h = first(rows) if s == 0 else pipe_shift([], mesh, "pp", [like]).wait()[0]
        h = stage(h, rows)
        if s < pp - 1:
            sends.append(pipe_shift([h], mesh, "pp"))
        else:
            outs.append(h)
    for x in sends:
        # meshcheck: ok[hotpath-blocking] the microbatches' sends, waited once per pipeline
        # step; each wait is bounded by the process group's timeout (init_multihost(timeout_s=),
        # parallel/multihost.py): an unmatched collective ends in an error, never a hang. No
        # timeout= here: on NCCL it would turn the stream-side wait into a host-blocking one.
        x.wait()
    hidden = torch.cat(outs) if outs else like.new_empty((batch, *like.shape[1:]))
    return broadcast_from(hidden, mesh, "pp", pp - 1)


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
        return model.train_layers(h, positions)

    like = torch.empty((B // n_micro, S, cfg.hidden), dtype=cfg.dtype, device=model.embed.device)
    hidden = gpipe(mesh, n_micro, B, like, lambda rows: model._embed(tokens[rows]), stage)
    return model._logits(hidden)


def make_pp_train_step(cfg, mesh: ProcessMesh, optimizer, n_micro: int):
    """``step(state, tokens) -> (state, loss)`` training through the
    pipeline (the JAX ``make_pp_train_step``): ``state`` is a
    ``parallel.train.TrainState`` whose model is this rank's stage
    (``make_train_state(cfg, seed, mesh, optimizer)``, or its ``params=``
    of the whole tree), ``tokens [B, S]`` the same on every rank; the
    loss is the mean next-token NLL over ``tokens[:, 1:]``, on every rank.
    ``optimizer`` (a callable from parameters to a ``torch.optim``
    optimizer) builds the state's optimizer when it has none. The forward
    is :func:`gpipe` over ``n_micro`` microbatches, the backward the reverse
    schedule (module docstring). tp composes (each stage's ranks hold their
    shards); dp splits the batch and sums the gradients; sp is refused: the
    stage layers attend over whole sequences, as the JAX pipeline does."""
    from radixmesh_tpu_torch.parallel.train import mean_nll, sync_grads  # train imports this module

    if mesh.size("sp") > 1:
        raise ValueError(f"make_pp_train_step: sp={mesh.size('sp')} under pp is not supported (the stage "
                         "layers attend over whole sequences)")
    pp, s = mesh.size("pp"), mesh.index("pp")

    def step(state, tokens):
        model = state.params
        if model.cfg != cfg:
            raise ValueError("the train state's model has another config than this step's")
        opt = state.opt_state if state.opt_state is not None else optimizer(list(model.parameters()))
        opt.zero_grad(set_to_none=True)
        dev = model.embed.device
        tokens = torch.as_tensor(tokens, device=dev)
        inputs, targets = shard_batch(tokens[:, :-1], mesh), shard_batch(tokens[:, 1:], mesh)
        count = (tokens.shape[0]) * (tokens.shape[1] - 1)
        B, S = inputs.shape
        if B % n_micro:
            raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
        positions = torch.arange(S, device=dev)[None].expand(B // n_micro, S)
        ins, outs = [], []

        def stage(h, rows):
            if s > 0:
                h.requires_grad_(True)  # a received activation: its gradient goes back
            ins.append(h)
            outs.append(model.train_layers(h, positions))
            return outs[-1]

        like = torch.empty((B // n_micro, S, cfg.hidden), dtype=cfg.dtype, device=dev)
        hidden = gpipe(mesh, n_micro, B, like, lambda rows: model._embed(inputs[rows]), stage)
        loss = mean_nll(model._logits(hidden), targets, count, mesh)
        loss.backward()  # the head's gradients on every stage; the last stage's layers too
        head = model.embed.grad  # the tied head's part (None without a tie), equal on every stage
        model.embed.grad = None
        sends = []
        for m in reversed(range(n_micro)):
            if s < pp - 1:
                # meshcheck: ok[timeout-audit] the backward pass's gradient receive is bounded
                # by the process group's timeout (init_multihost(timeout_s=),
                # parallel/multihost.py): an unmatched collective ends in an error, never a
                # hang. No timeout= here: on NCCL it would turn the stream-side wait into a
                # host-blocking one.
                g = p2p(mesh, "pp", recv_like=[outs[m]], frm=s + 1).wait()[0]
                torch.autograd.backward(outs[m], g)
            if s > 0:
                sends.append(p2p(mesh, "pp", [ins[m].grad], s - 1))
        for x in sends:
            # meshcheck: ok[timeout-audit] the backward pass's gradient sends are bounded by the
            # process group's timeout (init_multihost(timeout_s=), parallel/multihost.py): an
            # unmatched collective ends in an error, never a hang. No timeout= here: on NCCL it
            # would turn the stream-side wait into a host-blocking one.
            x.wait()
        lookup = model.embed.grad if model.embed.grad is not None else torch.zeros_like(model.embed)
        lookup = all_reduce(lookup, mesh, "pp")
        model.embed.grad = lookup if head is None else lookup + head
        sync_grads(model, mesh, ("dp",))
        opt.step()
        return state._replace(opt_state=opt, step=state.step + 1), loss.detach()

    return step
