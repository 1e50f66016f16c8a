from radixmesh_tpu_torch.policy.conflict import NodeRankConflictResolver
from radixmesh_tpu_torch.policy.lifecycle import (
    AutoscalePolicy,
    LifecyclePlane,
    LifecycleState,
)
from radixmesh_tpu_torch.policy.sync_algo import BaseSyncAlgo, RingSyncAlgo, TopoResult, get_sync_algo

__all__ = [
    "NodeRankConflictResolver",
    "AutoscalePolicy",
    "LifecyclePlane",
    "LifecycleState",
    "BaseSyncAlgo",
    "RingSyncAlgo",
    "TopoResult",
    "get_sync_algo",
]
