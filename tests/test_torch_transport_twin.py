"""The transports in the port: every case of ``tests/test_comm.py`` (the
in-process hub, the native C++ transport, ``tcp-py`` and the two TCP
transports' wire compatibility), run against ``radixmesh_tpu_torch``."""

from _torch_twin import load_twin

load_twin("test_comm", globals())
