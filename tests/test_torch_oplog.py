"""The oplog wire (``cache/oplog.py``) in the port: every case of
``tests/test_oplog.py``, run against ``radixmesh_tpu_torch``."""

from _torch_twin import load_twin

load_twin("test_oplog", globals())
