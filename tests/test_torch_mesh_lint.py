"""The mesh wire-discipline lint over the port: ``tests/test_mesh_lint.py``'s
cases, run against ``radixmesh_tpu_torch.analysis`` over
``radixmesh_tpu_torch/`` (send seam, extension kinds, bounded waits, the
single writers, the concurrency plane). Every case reads the process's one
cached ``check_tree()``; the runtime wire cases run on the port's oplog."""

from _torch_twin import load_twin

load_twin("test_mesh_lint", globals())
