"""The mesh doctor's ``tier_thrash`` rule in the port: the doctor cases of
``tests/test_kv_tier.py`` (``TestTierThrashRule`` over a fake tier's move
ring and its post-mortem variant over recorded counters, and the
post-mortem baseline case of ``TestReviewHardening``), run against
``radixmesh_tpu_torch``. The file's other cases have their twins in
``test_torch_kv_tier.py``."""

from _torch_twin import load_twin

load_twin("test_kv_tier", globals(), drop=(
    "TestExtentFormat", "TestTierWalk", "TestEngineTier", "TestTierWorkloadAcceptance",
    "TestReviewHardeningRound2", "TestReviewHardening.test_stale_retired_ref_never_deletes_live_extent",
    "TestReviewHardening.test_transient_restore_failure_keeps_extent_attached",
    "TestReviewHardening.test_advertised_value_never_pool_freed",
))
