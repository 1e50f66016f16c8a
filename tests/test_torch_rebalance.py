"""``cache/rebalance.py`` in the port: the cases of ``tests/test_rebalance.py``,
run against ``radixmesh_tpu_torch``. Two wait for modules the port does
not have yet (ROADMAP.md, queue A7b): the storm drives the JAX package's
``workload.py`` chaos phase, and the static check runs its ``analysis/``
(meshcheck) over the module."""

from _torch_twin import load_twin

load_twin(
    "test_rebalance",
    globals(),
    drop=("TestRebalanceStormQuick", "TestMeshcheckOnPlane"),
)
