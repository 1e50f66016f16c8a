"""Pipeline-parallel serving: prefill chunks and decode steps over a
``(pp, tp)`` process mesh (the JAX package's ``parallel/pp_serving.py``).

As in the JAX package, the engine's scheduler, radix tree, page tables and
publish logic run unchanged: pp shards the layer axis of the param tree
and of the KV pool, tp the head and ffn axes. Each rank is one process and
holds one stage (``models.llama.Llama`` on a mesh with pp > 1: ``L/pp``
layers, their tp shards, and the embedding, final norm and head: what
``parallel.sharding.shard_params`` keeps of a whole tree, the JAX
``shard_params_pp``) and a
pool ``[2, L/pp, Hkv/tp, slots, D]`` (int8 scales ``[2, L/pp, Hkv/tp,
slots]``), indexed by the stage-local layer.

- :func:`pp_forward_chunk`: one prefill chunk (group prefill, speculative
  verify, mixed waves) through the GPipe schedule of
  ``parallel/pipeline.gpipe``: stage ``s`` receives ``[mb, C, H]`` from
  ``s - 1``, runs its layers (``Llama._chunk_layers``: B2, the chunk kernel,
  per layer over the stage's pool, the chunk's K/V written as the
  single-device ``prefill_chunk_paged`` writes them) and sends the result
  to ``s + 1``. The stages are separate processes, so microbatches overlap
  with no warm-up or drain ticks, and no write needs the JAX scratch-slot
  redirection: a stage writes exactly its microbatch rows' slots (padded
  rows' slots are the scratch page's).
- Logits: the last stage broadcasts its final hidden state ``[B, C, H]`` in
  the model dtype over pp and every rank applies the final norm and head,
  as the JAX code replicates the last stage's hidden state over pp and
  head-projects on every device. At B = 8, C = 512 and Llama-3-8B widths
  that moves 33.5 MB where float32 logits would move 2.1 GB, and every rank
  gets bit-equal logits from the same product, which keeps the ranks' host
  state (tree, allocator, waves) in step.
- :func:`pp_decode_step`: one decode step the same way, each stage's
  per-layer write-and-attend being B1 (``paged_decode_fused``, as the
  port's single-device decode step; the JAX engine sends this step through
  the chunk path at C = 1).
- :func:`pp_decode_multi`: ``k`` fused decode steps with ``n_micro = pp``
  rotating microbatches. Stage 0 embeds a microbatch's token, every stage
  runs B1 per layer, the last stage samples and sends the token back to
  stage 0, which feeds it to the same microbatch's next step. Sampling on
  the last stage uses a ``torch.Generator`` seeded from a draw that every
  rank makes on the caller's generator, so the ranks' generators stay in
  step. It returns ``sampled [k, B]`` on every rank (the single-device
  ``decode_multi`` contract).

Transport: the mesh's backend (``parallel/collectives.py``): nccl moves
device memory; under gloo (the tests, and ranks sharing one card) every
inter-stage tensor goes through pinned host memory.
"""

from __future__ import annotations

import torch

from radixmesh_tpu_torch.ops.sampling import any_stochastic, sample_stochastic, sampling_tensors
from radixmesh_tpu_torch.parallel.collectives import broadcast, p2p, pipe_shift
from radixmesh_tpu_torch.parallel.pipeline import gpipe
from radixmesh_tpu_torch.parallel.sharding import MeshPlan, ProcessMesh, make_mesh

__all__ = [
    "make_pp_serving_mesh",
    "pp_forward_chunk",
    "pp_decode_step",
    "pp_decode_multi",
]


def make_pp_serving_mesh(pp: int, tp: int = 1) -> ProcessMesh | None:
    """A ``(pp, tp)`` mesh over the first ``pp * tp`` ranks (tp innermost: its
    two all-reduces per block are the bandwidth-hungry traffic)."""
    return make_mesh(MeshPlan(tp=tp, pp=pp))


def _stage_mesh(model) -> ProcessMesh:
    if not model._pp:
        raise ValueError("pipeline-parallel serving needs a model built on a mesh with pp > 1")
    return model.mesh


@torch.inference_mode()
def pp_forward_chunk(
    model,  # models.llama.Llama, one pipeline stage
    tokens: torch.Tensor,  # [B, C] chunk tokens
    positions: torch.Tensor,  # [B, C] absolute positions
    kv_pool: torch.Tensor,  # [2, L/pp, Hkv/tp, num_slots, D]: this stage's, written in place
    slots: torch.Tensor,  # [B, C] pool slot per chunk token (pad → scratch)
    page_table: torch.Tensor,  # [B, max_pages] int32
    kv_lengths: torch.Tensor,  # [B] int32 context valid after this chunk
    *,
    page_size: int = 16,
    n_micro: int = 1,
    kv_scale: torch.Tensor | None = None,  # [2, L/pp, Hkv/tp, num_slots] int8 pool
) -> torch.Tensor:
    """``Llama.prefill_chunk_paged`` through the layer pipeline: float32
    logits ``[B, C, V]`` on every rank; each stage's pool (and int8 scales)
    gets the chunk's K/V of its layers at ``slots``."""
    mesh = _stage_mesh(model)
    B, C = tokens.shape
    like = torch.empty((B // n_micro, C, model.cfg.hidden), dtype=model.cfg.dtype,
                       device=kv_pool.device)

    def stage(h, r):
        return model._chunk_layers(h, positions[r], kv_pool, slots[r], page_table[r], kv_lengths[r],
                                   page_size, kv_scale)

    hidden = gpipe(mesh, n_micro, B, like, lambda r: model._embed(tokens[r]), stage)
    return model._logits(hidden)


@torch.inference_mode()
def pp_decode_step(
    model,  # models.llama.Llama, one pipeline stage
    tokens: torch.Tensor,  # [B] current token per row
    kv_pool: torch.Tensor,  # [2, L/pp, Hkv/tp, num_slots, D]: this stage's, written in place
    slots: torch.Tensor,  # [B] int32 pool slot for this token's K/V
    page_table: torch.Tensor,  # [B, max_pages] int32
    lengths: torch.Tensor,  # [B] int32 context length incl. this token
    *,
    page_size: int = 16,
    n_micro: int = 1,
    kv_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """``Llama.decode_step`` through the layer pipeline: float32 logits
    ``[B, V]`` on every rank."""
    mesh = _stage_mesh(model)
    B = tokens.shape[0]
    like = torch.empty((B // n_micro, 1, model.cfg.hidden), dtype=model.cfg.dtype,
                       device=kv_pool.device)

    def stage(h, r):
        return model._decode_layers(h, kv_pool, slots[r], page_table[r], lengths[r], page_size, kv_scale)

    hidden = gpipe(mesh, n_micro, B, like, lambda r: model._embed(tokens[r])[:, None, :], stage)
    return model._logits(hidden)[:, 0]


@torch.inference_mode()
def pp_decode_multi(
    model,  # models.llama.Llama, one pipeline stage
    tokens: torch.Tensor,  # [B] current token per row
    kv_pool: torch.Tensor,  # [2, L/pp, Hkv/tp, num_slots, D]: this stage's, written in place
    page_table: torch.Tensor,  # [B, max_pages] int32, pages provisioned k ahead
    lengths: torch.Tensor,  # [B] int32 context incl. the first fed token
    generator: torch.Generator | None,
    temperatures,  # [B] host array
    top_ps,  # [B]
    page_size: int = 16,
    k_steps: int = 8,
    kv_scale: torch.Tensor | None = None,
    top_ks=0,  # [B] (0 = off)
) -> torch.Tensor:
    """``Llama.decode_multi`` through the layer pipeline (module docstring):
    ``n_micro = pp`` microbatches rotate through the stages, the last stage
    samples and returns each token to stage 0. Returns the sampled tokens
    ``[k, B]`` (int64) on every rank of the pp line."""
    mesh = _stage_mesh(model)
    pp, s = mesh.size("pp"), mesh.index("pp")
    last = pp - 1
    B = tokens.shape[0]
    if B % pp:
        raise ValueError(f"batch {B} must divide into n_micro=pp={pp}")
    mb = B // pp
    dev = kv_pool.device
    lengths = lengths.to(torch.int32)
    pt = page_table.long()
    rows = torch.arange(mb, device=dev)
    stochastic = any_stochastic(temperatures)
    sampler = None
    if stochastic:
        params = sampling_tensors((B,), dev, temperatures, top_ks, top_ps)
        # Every rank draws the seed, so every rank's generator advances alike.
        gen_dev = dev if generator is None else generator.device
        seed = int(torch.randint(0, 2**62, (1,), generator=generator, device=gen_dev).item())
        if s == last:
            sampler = torch.Generator(device=dev).manual_seed(seed)
    out = torch.zeros((k_steps, B), dtype=torch.long, device=dev)
    act_like = torch.empty((mb, 1, model.cfg.hidden), dtype=model.cfg.dtype, device=dev)
    tok_like = torch.empty((mb,), dtype=torch.long, device=dev)
    sends = []
    for i in range(k_steps):
        for m in range(pp):
            r = slice(m * mb, (m + 1) * mb)
            lens = lengths[r] + i
            pos = (lens - 1).long()
            slots = (pt[r][rows, pos // page_size] * page_size + pos % page_size).to(torch.int32)
            if s > 0:
                # meshcheck: ok[hotpath-blocking] under pp this shift IS the engine's multi-step
                # decode (Engine.step -> pp_decode_multi); the wait is bounded by the process
                # group's timeout (init_multihost(timeout_s=), parallel/multihost.py): an
                # unmatched collective ends in an error, never a hang. No timeout= here: on NCCL
                # it would turn the stream-side wait into a host-blocking one.
                x = pipe_shift([], mesh, "pp", [act_like]).wait()[0]
            else:
                # meshcheck: ok[hotpath-blocking] the sampled token's return to stage 0 is part
                # of the pipelined decode step; the wait is bounded by the process group's
                # timeout (init_multihost(timeout_s=), parallel/multihost.py): an unmatched
                # collective ends in an error, never a hang. No timeout= here: on NCCL it would
                # turn the stream-side wait into a host-blocking one.
                # Step 0 feeds the caller's token; later steps the token the
                # last stage sampled for this microbatch.
                tok = tokens[r] if i == 0 else p2p(mesh, "pp", recv_like=[tok_like], frm=last).wait()[0]
                x = model._embed(tok)[:, None, :]
            x = model._decode_layers(x, kv_pool, slots, page_table[r], lens, page_size, kv_scale)
            if s < last:
                sends.append(pipe_shift([x], mesh, "pp"))
                continue
            logits = model._logits(x)[:, 0]
            tok = (sample_stochastic(logits, sampler, *(p[r] for p in params)) if stochastic
                   else logits.argmax(-1))
            out[i, r] = tok
            if i < k_steps - 1:
                sends.append(p2p(mesh, "pp", [tok], to=0))
    for x in sends:
        # meshcheck: ok[hotpath-blocking] the step's sends, waited once per multi-step decode;
        # each wait is bounded by the process group's timeout (init_multihost(timeout_s=),
        # parallel/multihost.py): an unmatched collective ends in an error, never a hang. No
        # timeout= here: on NCCL it would turn the stream-side wait into a host-blocking one.
        x.wait()
    return broadcast(out, mesh, "pp", last)
