"""Crash detection, graceful leave, rejoin and routing around the dead in
the port's mesh: every case of ``tests/test_failover.py``, run against
``radixmesh_tpu_torch``. None is dropped."""

from _torch_twin import load_twin

load_twin("test_failover", globals())
