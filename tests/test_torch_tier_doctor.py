"""The mesh doctor's ``tier_thrash`` rule in the port, and the tier's
acceptance workload: the doctor cases of ``tests/test_kv_tier.py``
(``TestTierThrashRule`` over a fake tier's move ring and its post-mortem
variant over recorded counters, and the post-mortem baseline case of
``TestReviewHardening``) and ``TestTierWorkloadAcceptance`` (the port's
``workload.run_tier_workload`` on the CPU, its report through the JAX
package's ``bench.build_tier_report``/``validate_tier``), run against
``radixmesh_tpu_torch``. The file's other cases have their twins in
``test_torch_kv_tier.py``."""

from _torch_twin import load_twin

load_twin("test_kv_tier", globals(), subs=(
    ("n_streams=3, seed=1,", "n_streams=3, seed=1, device=\"cpu\","),
), drop=(
    "TestExtentFormat", "TestTierWalk", "TestEngineTier",
    "TestReviewHardeningRound2", "TestReviewHardening.test_stale_retired_ref_never_deletes_live_extent",
    "TestReviewHardening.test_transient_restore_failure_keeps_extent_attached",
    "TestReviewHardening.test_advertised_value_never_pool_freed",
))
