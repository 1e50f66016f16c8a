"""Overload control plane: SLO-aware admission, per-tenant weighted
fairness, deadline shedding and graceful degradation, the layer between
``server/http_frontend.py`` and ``engine/engine.py`` (this package's copy
of the JAX package's ``slo/``).

- :mod:`radixmesh_tpu_torch.slo.control`: the policy state machine
  (engine-agnostic, deterministic under an injected clock).
- :mod:`radixmesh_tpu_torch.slo.runner`: :class:`SLORunner`, the control
  plane wired around the engine runner's thread.
"""

from radixmesh_tpu_torch.slo.control import (
    AdmissionDecision,
    OverloadController,
    RequestShed,
    SLOConfig,
    TenantConfig,
)


def __getattr__(name):
    # SLORunner imports server.http_frontend (for EngineRunner), which
    # itself imports slo.control: loading the runner lazily keeps this
    # package importable from either side of that seam.
    if name == "SLORunner":
        from radixmesh_tpu_torch.slo.runner import SLORunner

        return SLORunner
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AdmissionDecision",
    "OverloadController",
    "RequestShed",
    "SLOConfig",
    "SLORunner",
    "TenantConfig",
]
