"""Multi-process initialization: ``torch.distributed`` glue (the JAX
package's ``parallel/multihost.py``).

The JAX package joins one ``jax.distributed`` process per host, each
driving that host's chips. The port runs one process per device, so a
"host" here is a block of ``local_device_count`` consecutive ranks. The
backend is an explicit argument and is logged, never chosen silently:

- ``nccl`` when every rank has a card of its own (rank ``r`` takes card
  ``r % local_device_count``);
- ``gloo`` on the CPU (the tests), and when several ranks share one card,
  which NCCL refuses; its collectives then move through host memory
  (``parallel/collectives.py``).

Nothing on a machine tells a process of its cluster: the caller gives the
coordinator (``host:port``, ``tcp://host:port`` or ``file:///path``, a
``FileStore``), the process count and this process's id.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass

import torch
import torch.distributed as dist

from radixmesh_tpu_torch.utils.logging import get_logger

__all__ = ["MultihostInfo", "init_multihost", "global_mesh", "BACKENDS"]

BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True)
class MultihostInfo:
    process_index: int
    process_count: int
    local_devices: int  # ranks per host
    global_devices: int  # ranks in all (one device each)
    backend: str


_INFO: MultihostInfo | None = None


def init_multihost(
    coordinator: str,
    num_processes: int,
    process_id: int,
    local_device_count: int | None = None,
    *,
    backend: str,
    timeout_s: float = 300.0,
) -> MultihostInfo:
    """Join this process into the job as rank ``process_id`` of
    ``num_processes`` and return the topology. ``local_device_count`` is
    the number of ranks (devices) per host, all of them when None (one
    host). Every collective of the job times out after ``timeout_s``: a
    rank whose host decisions drift leaves a collective unmatched, and that
    must end as an error, not a hang."""
    global _INFO
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    local = num_processes if local_device_count is None else int(local_device_count)
    if local <= 0 or num_processes % local:
        raise ValueError(f"local_device_count={local} must divide num_processes={num_processes}")
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if backend == "nccl":
        torch.cuda.set_device(process_id % local)
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    get_logger("parallel").info(
        "init_multihost: rank %d of %d, backend %s, %d rank(s) per host", process_id,
        num_processes, backend, local,
    )
    _INFO = MultihostInfo(
        process_index=dist.get_rank(), process_count=dist.get_world_size(),
        local_devices=local, global_devices=dist.get_world_size(), backend=backend,
    )
    return _INFO


def global_mesh(plan=None):
    """A process mesh over every rank of the job. The default plan keeps the
    host boundary on the dp axis: sp and tp factorize ONE host's ranks (the
    per-layer collectives stay inside a host) and dp multiplies across
    hosts. Ranks are host-contiguous and dp is the outermost mesh axis, so
    each host's ranks land in their own dp rows."""
    from radixmesh_tpu_torch.parallel.sharding import MeshPlan, make_mesh

    if plan is None:
        if _INFO is None:
            raise RuntimeError("global_mesh() needs init_multihost() first (or an explicit plan)")
        local = MeshPlan.auto(_INFO.local_devices)
        hosts = _INFO.process_count // _INFO.local_devices
        plan = MeshPlan(dp=hosts * local.dp, sp=local.sp, tp=local.tp)
    return make_mesh(plan)
