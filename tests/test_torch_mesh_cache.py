"""``cache/mesh_cache.py`` in the port: every case of
``tests/test_mesh_cache.py``, run against ``radixmesh_tpu_torch`` with the
port's pool on the CPU."""

from _torch_twin import load_twin

load_twin("test_mesh_cache", globals())
