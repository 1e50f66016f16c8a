"""Causal-LM training step over the ``(dp, pp, sp, tp)`` process mesh (the JAX
package's ``parallel/train.py``).

The JAX step is one ``jit`` over a GSPMD mesh: XLA derives the backward and
every collective from the sharding annotations. The port runs one process
per device, so every gradient that crosses a rank is written out:

- tp: the model's differentiable seams (``models/llama.py``): Megatron's
  copy-to-tp before each column-parallel product and the vocab-parallel head,
  reduce-from-tp after each row-parallel product and the vocab-parallel
  embedding, the head's all-gather keeping each rank's slice of the
  gradient.
- sp: each rank holds ``S/sp`` positions of the batch (``shard_batch``, the
  JAX step's ``P("dp", "sp")``); its queries attend over K and V gathered
  along the sequence (``gather_seq``: the backward reduce-scatters) at
  their absolute positions.
- dp and sp: each rank's loss is its tokens' NLL over the global token
  count, summed over dp and sp (``reduce_from``: the gradient passes
  through), and after the backward the gradients are summed over dp and
  sp in buckets (:func:`sync_grads`). So the loss and the gradients are
  those of the global mean, and the replicated leaves (the norms; the
  embedding and head where tp = 1) are the same on every rank after the
  step.

Training attends with the plain ``attend_prefill``, as the JAX training path
does (``prefill_forward``'s einsums): it launches no kernel.

The optimizer is a callable from parameters to a ``torch.optim`` optimizer
(the dryrun's is ``torch.optim.AdamW(lr=1e-3, weight_decay=1e-4)``: optax's
``adamw`` defaults, whose decay is not torch's 1e-2). The JAX module's
``opt_state_sharding`` has no counterpart: a torch optimizer keeps its
state beside each parameter, which is this rank's shard.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from radixmesh_tpu_torch.models.llama import (
    Llama,
    ModelConfig,
    init_params,
    param_logical_axes,
)
from radixmesh_tpu_torch.parallel.collectives import all_reduce, all_reduce_coalesced, reduce_from
from radixmesh_tpu_torch.parallel.sharding import SERVING_RULES, logical_to_spec, shard_batch, shard_params
from radixmesh_tpu_torch.utils.device import resolve_device

__all__ = [
    "TrainState",
    "trainable",
    "causal_lm_loss",
    "mean_nll",
    "sync_grads",
    "global_grad_norm",
    "make_train_state",
    "make_train_step",
    "adamw",
    "run_dryrun_train_step",
]


class TrainState(NamedTuple):
    """``params``: the trainable :class:`Llama` (its parameters are this
    rank's shards), ``opt_state``: the ``torch.optim`` optimizer over them
    (it holds its state), ``step``: steps taken."""

    params: Llama
    opt_state: Any
    step: int


def trainable(model: Llama) -> Llama:
    """Make ``model``'s leaves trainable (``requires_grad``). A W8A16 tree is
    refused: its int8 leaves have nothing to differentiate."""
    if model.weight_quant is not None:
        raise ValueError(f"training needs floating-point weights; this model holds W8A16 "
                         f"({model.weight_quant}) weights")
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def mean_nll(logits: torch.Tensor, targets: torch.Tensor, count: int, mesh) -> torch.Tensor:
    """``sum(-log softmax(logits)[targets]) / count`` in float32, summed over
    dp and sp: with ``count`` the global number of targets, the global mean
    on every rank, each rank's gradient that of its own tokens' share."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(-1, targets[..., None]).sum() / count
    for axis in ("dp", "sp"):
        loss = reduce_from(loss, mesh, axis)
    return loss


def causal_lm_loss(model: Llama, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over ``tokens [B, S]`` (the whole batch,
    the same on every rank). Inputs and targets are sliced before this
    rank's block is taken (batch over dp, the ``S - 1`` positions over sp);
    the loss is the global mean on every rank."""
    mesh = model.mesh
    tokens = torch.as_tensor(tokens, device=model.embed.device)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    B, S = inputs.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    if mesh is not None:
        inputs, targets, positions = (shard_batch(t, mesh) for t in (inputs, targets, positions))
    return mean_nll(model.train_forward(inputs, positions), targets, B * S, mesh)


def sync_grads(model: Llama, mesh, axes=("dp", "sp")) -> None:
    """Sum every parameter's gradient over each of ``axes`` (bucketed
    all-reduces); a parameter without a gradient counts as zeros."""
    if mesh is None or all(mesh.size(a) == 1 for a in axes):
        return
    grads = []
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    for axis in axes:
        all_reduce_coalesced(grads, mesh, axis)


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _leaves(tree: dict, axes: dict):
    for name, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, axes[name])
        else:
            yield v, axes[name]


def global_grad_norm(model: Llama) -> float:
    """The L2 norm of the whole model's gradient after a step's reduction,
    the same on every rank: each leaf's square sum, summed over the mesh
    axes that shard it (tp, pp) and counted once where it is replicated."""
    mesh = model.mesh
    tree = model.param_tree()
    sums: dict[tuple, torch.Tensor] = {}
    for leaf, axes in _leaves(tree, param_logical_axes(model.cfg, tree)):
        spread = tuple(sorted({a for a in logical_to_spec(axes, SERVING_RULES)
                               if a is not None and mesh is not None and mesh.size(a) > 1}))
        if leaf.grad is not None:
            # float64 square sums in slices: no float64 copy of a whole leaf.
            for part in leaf.grad.reshape(-1).split(1 << 24):
                sums[spread] = sums.get(spread, 0) + part.double().square().sum()
    total = 0.0
    for spread in sorted(sums):
        v = sums[spread]
        for axis in spread:
            v = all_reduce(v, mesh, axis)
        total += float(v)
    return math.sqrt(total)


def make_train_state(cfg: ModelConfig, seed: int = 0, mesh=None, optimizer=None, *, device=None,
                     params: dict | None = None) -> TrainState:
    """This rank's trainable model and its optimizer. The params are drawn by
    the port's seeded ``init_params`` (each rank keeps its shard of the same
    draw) unless ``params`` is given: the whole tree, of which this rank
    keeps its ``shard_params`` shards (copied, so the caller's tree is never
    trained in place). ``optimizer``:
    a callable from parameters to a ``torch.optim`` optimizer (None: the
    step builds it). ``device``: CUDA unless ``"cpu"`` is asked for."""
    device = resolve_device(device)
    shard_mesh = mesh if mesh is not None and (mesh.size("tp") > 1 or mesh.size("pp") > 1) else None
    if params is None:
        params = init_params(cfg, seed, device, mesh=mesh)
    else:
        params = shard_params(params, param_logical_axes(cfg, params), shard_mesh)
        params = _tree_map(lambda t: torch.as_tensor(t).to(device=device, copy=True), params)
    model = trainable(Llama(cfg, params, mesh=mesh))
    return TrainState(model, None if optimizer is None else optimizer(list(model.parameters())), 0)


def make_train_step(cfg: ModelConfig, mesh, optimizer):
    """``step(state, tokens) -> (state, loss)``: the loss of the whole batch
    ``tokens [B, S]`` (the same on every rank), its backward, the gradients
    summed over dp and sp, one optimizer step; ``loss`` is the global mean
    (a detached scalar tensor). ``optimizer`` builds the state's optimizer
    when it has none. Under pp use ``pipeline.make_pp_train_step``."""
    if mesh is not None and mesh.size("pp") > 1:
        raise ValueError("make_train_step runs whole models; a pp mesh trains through "
                         "parallel.pipeline.make_pp_train_step")

    def step(state: TrainState, tokens):
        model = state.params
        if model.cfg != cfg:
            raise ValueError("the train state's model has another config than this step's")
        opt = state.opt_state if state.opt_state is not None else optimizer(list(model.parameters()))
        opt.zero_grad(set_to_none=True)
        loss = causal_lm_loss(model, tokens)
        loss.backward()
        sync_grads(model, mesh)
        opt.step()
        return state._replace(opt_state=opt, step=state.step + 1), loss.detach()

    return step


def adamw(params) -> torch.optim.AdamW:
    """The dryrun's optimizer: optax ``adamw(1e-3)``'s settings (b1 0.9, b2
    0.999, eps 1e-8, weight decay 1e-4) in ``torch.optim.AdamW``, one
    parameter at a time (``foreach=False``: the stacked tree has a dozen
    leaves, and the multi-tensor path holds a temporary of every leaf at
    once)."""
    return torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4, foreach=False)


def run_dryrun_train_step(mesh, device=None) -> float:
    """ONE sharded train step on tiny shapes over ``mesh`` (the JAX
    package's, with the port's seeded weights): the body of ``launch.py
    multihost-dryrun``, so an in-process run and a multi-process run over
    the same mesh factorization give the same loss."""
    cfg = ModelConfig.tiny()
    size = (lambda a: 1) if mesh is None else mesh.size
    tp = size("tp")
    # tiny() has 2 kv heads; wider tp needs every shard non-empty.
    cfg = cfg.replace(n_heads=max(4, tp), n_kv_heads=max(2, tp), intermediate=max(256, 2 * tp))
    state = make_train_state(cfg, 0, mesh, adamw, device=device)
    step = make_train_step(cfg, mesh, adamw)
    batch = max(2, size("dp") * 2)
    seq = max(16, size("sp") * 8) + 1
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, seq)))
    _, loss = step(state, tokens)
    return float(loss)
