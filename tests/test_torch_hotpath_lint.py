"""The hot-path lint over the port: ``tests/test_hotpath_lint.py``'s cases,
run against ``radixmesh_tpu_torch.analysis`` over ``radixmesh_tpu_torch/``
(the staging boundary, with the port's torch device-sync vocabulary, and
the serving call graph's reach). Every case reads the process's one cached
``check_tree()``."""

from _torch_twin import load_twin

load_twin("test_hotpath_lint", globals())
