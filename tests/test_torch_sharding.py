"""``cache/sharding.py`` in the port: the cases of ``tests/test_sharding.py``,
run against ``radixmesh_tpu_torch``. The three that drive the repair plane
(``cache/repair_plane.py``) wait for it (ROADMAP.md, queue A3)."""

from _torch_twin import load_twin

load_twin(
    "test_sharding",
    globals(),
    drop=(
        "TestRepairShardWire",
        "TestShardedMeshLive.test_owner_scoped_repair_heals_diverged_shard",
    ),
)
