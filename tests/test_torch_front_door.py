"""``router/front_door.py`` in the port: every case of
``tests/test_front_door.py``, run against ``radixmesh_tpu_torch``. None is
dropped: the front door is host code with injectable clocks."""

from _torch_twin import load_twin

load_twin("test_front_door", globals())
