"""``cache/rebalance.py`` in the port: the cases of ``tests/test_rebalance.py``,
run against ``radixmesh_tpu_torch``, ``TestRebalanceStormQuick`` included (it
drives the port's ``workload._chaos_rebalance_phase``) and
``TestMeshcheckOnPlane``, which runs the port's meshcheck
(``radixmesh_tpu_torch.analysis``) over the plane's files."""

from _torch_twin import load_twin

load_twin("test_rebalance", globals())
