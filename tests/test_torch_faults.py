"""The fault-injection plane (``comm/faults.py``) in the port: the cases of
``tests/test_faults.py``, run against ``radixmesh_tpu_torch``.
``TestMeshUnderChaos`` is left out: it fills a live node's send queue
while the node's sender thread drains it, so whether the next send is
dropped is a race (the JAX case is a known flake of the suite). The
queue-full accounting it reads is the JAX code, copied."""

from _torch_twin import load_twin

load_twin("test_faults", globals(), drop=("TestMeshUnderChaos",))
