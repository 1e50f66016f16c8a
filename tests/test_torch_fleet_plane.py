"""``obs/fleet_plane.py`` in the port: every case of
``tests/test_fleet_plane.py``, run against ``radixmesh_tpu_torch``."""

from _torch_twin import load_twin

load_twin("test_fleet_plane", globals())
