"""``cache/rebalance.py`` in the port: the cases of ``tests/test_rebalance.py``,
run against ``radixmesh_tpu_torch``, ``TestRebalanceStormQuick`` included (it
drives the port's ``workload._chaos_rebalance_phase``). Dropped:
``TestMeshcheckOnPlane``, which runs the JAX package's ``analysis/``
(meshcheck) over the module; the port's meshcheck is the next item of
ROADMAP.md's queue A7b."""

from _torch_twin import load_twin

load_twin("test_rebalance", globals(), drop=("TestMeshcheckOnPlane",))
