"""``config.py`` in the port: every case of ``tests/test_config.py``, run
against ``radixmesh_tpu_torch`` (YAML through PyYAML, which this machine
has; the JSON path without it is in ``test_torch_mesh_wire.py``)."""

from _torch_twin import load_twin

load_twin("test_config", globals())
