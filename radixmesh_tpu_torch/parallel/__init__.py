"""Multi-device serving: the process mesh, sharded params, explicit
collectives and the sequence-parallel attention (the JAX package's
``parallel/``, its serving half: tensor parallelism, sequence-parallel
prefill and the multi-process bootstrap).

- ``sharding`` — :class:`MeshPlan`, the ``(dp, pp, sp, tp)``
  :class:`ProcessMesh` with one process group per axis and one per engine,
  the logical-axis rules and :func:`shard_params`.
- ``multihost`` — :func:`init_multihost` (``torch.distributed`` with an
  explicit backend) and :func:`global_mesh`.
- ``collectives`` — all-reduce, all-gather, all-to-all and the ring shift
  over one mesh axis (gloo moves host memory, nccl device memory), and their
  differentiable counterparts for training (``copy_to``, ``reduce_from``,
  ``gather_from``, ``gather_seq``, ``broadcast_from``).
- ``ring_attention`` and ``ulysses`` — the two sequence-parallel
  attentions.
- ``pipeline`` — the GPipe schedule over the ``pp`` axis (one process per
  stage), the pipelined forward and ``make_pp_train_step``, training through
  the schedule and back.
- ``train`` — the causal-LM train step over the ``(dp, sp, tp)`` mesh
  (``make_train_state``, ``make_train_step``, ``run_dryrun_train_step``;
  import it as ``parallel.train``: it imports the model, which imports this
  package).
- ``pp_serving`` — pipeline-parallel serving: prefill chunks, decode steps
  and fused k-step decode over a ``(pp, tp)`` mesh.
- ``kv_transfer`` — KV-page blocks between the ranks of one axis (the
  device handoff, ``engine/disagg.IciHandoff``).
- ``step_sync`` — the step agreement of an engine over several ranks: with
  the async KV plane, the disk tier, a ``DecodeWorker`` or a pool-bound mesh
  replica bound, the ranks agree once per scheduler pass (one small
  all-reduce over the engine's group, ``ProcessMesh.engine_group``) on which
  copies landed and which spills committed everywhere, on the leader's
  cadences and clock, and on the packets, hints and replica frees the
  leader took in; :class:`MeshPoolProxy` is the pool such a replica sees.
  The disk tier keeps one directory per rank (``cache/kv_tier.
  rank_tier_dir``: the rank's shard extents beside a manifest of the mesh
  shape).
"""

from radixmesh_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce,
    all_to_all,
    broadcast,
    broadcast_from,
    collective_stats,
    copy_to,
    gather_from,
    gather_seq,
    p2p,
    permute,
    pipe_shift,
    reduce_from,
    reset_collective_stats,
    ring_shift,
)
from radixmesh_tpu_torch.parallel.kv_transfer import make_kv_page_transfer, prefill_to_decode_perm
from radixmesh_tpu_torch.parallel.multihost import MultihostInfo, global_mesh, init_multihost
from radixmesh_tpu_torch.parallel.pipeline import (
    gpipe,
    make_pp_mesh,
    make_pp_train_step,
    pipeline_forward,
    stage_params,
)
from radixmesh_tpu_torch.parallel.pp_serving import (
    make_pp_serving_mesh,
    pp_decode_multi,
    pp_decode_step,
    pp_forward_chunk,
)
from radixmesh_tpu_torch.parallel.ring_attention import ring_attention, ring_self_attention
from radixmesh_tpu_torch.parallel.step_sync import MeshPoolProxy, StepSync
from radixmesh_tpu_torch.parallel.sharding import (
    LOGICAL_RULES,
    SERVING_RULES,
    MeshPlan,
    ProcessMesh,
    batch_sharding,
    logical_to_spec,
    make_mesh,
    shard_batch,
    shard_params,
)
from radixmesh_tpu_torch.parallel.ulysses import ulysses_attention, ulysses_self_attention

__all__ = [
    "LOGICAL_RULES",
    "SERVING_RULES",
    "MeshPlan",
    "ProcessMesh",
    "make_mesh",
    "logical_to_spec",
    "shard_params",
    "batch_sharding",
    "shard_batch",
    "MultihostInfo",
    "init_multihost",
    "global_mesh",
    "all_reduce",
    "all_gather",
    "all_to_all",
    "ring_shift",
    "p2p",
    "pipe_shift",
    "permute",
    "broadcast",
    "copy_to",
    "reduce_from",
    "gather_from",
    "gather_seq",
    "broadcast_from",
    "collective_stats",
    "reset_collective_stats",
    "ring_attention",
    "ring_self_attention",
    "ulysses_attention",
    "ulysses_self_attention",
    "make_pp_mesh",
    "stage_params",
    "gpipe",
    "pipeline_forward",
    "make_pp_train_step",
    "make_pp_serving_mesh",
    "pp_forward_chunk",
    "pp_decode_step",
    "pp_decode_multi",
    "make_kv_page_transfer",
    "prefill_to_decode_perm",
    "StepSync",
    "MeshPoolProxy",
]
