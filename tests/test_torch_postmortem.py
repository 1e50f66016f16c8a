"""Post-mortem doctoring in the port: the doctor cases of
``tests/test_blackbox.py`` (a final's ``doctor`` section, a broken doctor
losing only its own section, and every post-mortem rule over recorded
series: node crashes, hot shards, lag, burn), run against
``radixmesh_tpu_torch``. The file's doctor-free cases run on both packages
in ``test_torch_blackbox.py``."""

from _torch_twin import load_twin

load_twin("test_blackbox", globals(), drop=(
    "TestSegments", "TestWatchdog", "TestLoader",
    "TestFlush.test_each_trigger_writes_its_own_final_newest_wins",
))
