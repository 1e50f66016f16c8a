"""``policy/`` (conflict resolution, ring sync) in the port: every case of
``tests/test_policy.py``, run against ``radixmesh_tpu_torch``."""

from _torch_twin import load_twin

load_twin("test_policy", globals())
