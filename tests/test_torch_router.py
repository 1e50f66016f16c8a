"""``router/cache_aware_router.py`` in the port: every case of
``tests/test_router.py``, run against ``radixmesh_tpu_torch`` with the
port's pool on the CPU."""

from _torch_twin import load_twin

load_twin("test_router", globals())
