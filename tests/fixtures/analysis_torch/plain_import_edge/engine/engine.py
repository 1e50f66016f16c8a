"""Seeded hot-path sleeps reached only through modules imported by name:
the name-shaped call graph must follow ``alias.f()`` into the module."""

import radixmesh_tpu_torch.utils.pacing as pacing
from radixmesh_tpu_torch.utils import drain


class Engine:
    def step(self):
        pacing.settle()
        drain.flush()
