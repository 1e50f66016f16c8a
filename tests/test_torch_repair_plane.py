"""``cache/repair_plane.py`` in the port: the cases of
``tests/test_repair_plane.py``, run against ``radixmesh_tpu_torch``.

Dropped: ``TestChaosAcceptance``. It drives ``workload.run_chaos_workload``,
the JAX package's bench harness, which the port has not taken over yet
(ROADMAP.md, queue A7b), and its "resumed ... served" gate fails now and
then on the JAX package alone."""

from _torch_twin import load_twin

load_twin("test_repair_plane", globals(), drop=("TestChaosAcceptance",))
