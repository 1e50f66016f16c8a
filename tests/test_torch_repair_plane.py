"""``cache/repair_plane.py`` in the port: the cases of
``tests/test_repair_plane.py``, run against ``radixmesh_tpu_torch``,
``TestChaosAcceptance`` included: it drives the port's
``workload.run_chaos_workload``."""

from _torch_twin import load_twin

load_twin("test_repair_plane", globals())
