"""``cache/sharding.py`` in the port: every case of ``tests/test_sharding.py``,
run against ``radixmesh_tpu_torch``, the repair plane's shard cases
(``TestRepairShardWire``, ``test_owner_scoped_repair_heals_diverged_shard``)
included."""

from _torch_twin import load_twin

load_twin("test_sharding", globals())
