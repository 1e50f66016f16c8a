"""``router/consistent_hash.py`` in the port: every case of
``tests/test_consistent_hash.py``, run against ``radixmesh_tpu_torch``."""

from _torch_twin import load_twin

load_twin("test_consistent_hash", globals())
