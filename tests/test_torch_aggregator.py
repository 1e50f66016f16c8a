"""``obs/aggregator.py`` in the port: the cases of ``tests/test_aggregator.py``
(merged quantiles, cursor pulls across a peer restart, exemplars, the fleet
doctor rules over the fleet store), run against ``radixmesh_tpu_torch``."""

from _torch_twin import load_twin

load_twin("test_aggregator", globals())
