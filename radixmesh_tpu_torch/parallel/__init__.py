"""Multi-device serving: the process mesh, sharded params, explicit
collectives and the sequence-parallel attention (the JAX package's
``parallel/``, its serving half: tensor parallelism, sequence-parallel
prefill and the multi-process bootstrap).

- ``sharding`` — :class:`MeshPlan`, the ``(dp, sp, tp)`` :class:`ProcessMesh`
  with one process group per axis, the logical-axis rules and
  :func:`shard_params`.
- ``multihost`` — :func:`init_multihost` (``torch.distributed`` with an
  explicit backend) and :func:`global_mesh`.
- ``collectives`` — all-reduce, all-gather, all-to-all and the ring shift
  over one mesh axis (gloo moves host memory, nccl device memory).
- ``ring_attention`` and ``ulysses`` — the two sequence-parallel
  attentions.

Not ported yet (``ROADMAP.md``): the pipeline (``pipeline``,
``pp_serving``) and the device handoff (``kv_transfer``) wait for A5b,
training (``train``) for A6.
"""

from radixmesh_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce,
    all_to_all,
    collective_stats,
    reset_collective_stats,
    ring_shift,
)
from radixmesh_tpu_torch.parallel.multihost import MultihostInfo, global_mesh, init_multihost
from radixmesh_tpu_torch.parallel.ring_attention import ring_attention, ring_self_attention
from radixmesh_tpu_torch.parallel.sharding import (
    LOGICAL_RULES,
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
    "collective_stats",
    "reset_collective_stats",
    "ring_attention",
    "ring_self_attention",
    "ulysses_attention",
    "ulysses_self_attention",
]
