"""``obs/doctor.py`` in the port: the cases of ``tests/test_doctor.py`` (every
rule seeded positive and vacuous, the burn-rate tracker, the post-mortem
rules), run against ``radixmesh_tpu_torch``."""

from _torch_twin import load_twin

load_twin("test_doctor", globals())
