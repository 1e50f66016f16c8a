"""Observability: the metrics registry, profiler tracing, the request-flight
tracing plane, the fleet telemetry plane (gossiped node digests, radix-tree
convergence audit, health scoring), step accounting, the telemetry history,
crash-surviving black-box dumps, and over them the fleet aggregator
(``obs/aggregator.py``) and the mesh doctor (``obs/doctor.py``). The same
names as the JAX package's ``obs``."""

from radixmesh_tpu_torch.obs.blackbox import BlackBox, load_blackbox
from radixmesh_tpu_torch.obs.fleet_plane import (
    FleetConfig,
    FleetPlane,
    FleetView,
    NodeDigest,
)
from radixmesh_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    get_registry,
    set_registry,
)
from radixmesh_tpu_torch.obs.step_plane import StepAccounting
from radixmesh_tpu_torch.obs.timeseries import TelemetryHistory
from radixmesh_tpu_torch.obs.trace_plane import (
    FlightRecorder,
    Span,
    TraceContext,
    configure,
    get_recorder,
    new_trace_id,
    set_recorder,
    stitch_traces,
    write_trace,
)
from radixmesh_tpu_torch.obs.tracing import annotate, profile, recorded, timed

__all__ = [
    "FleetConfig",
    "FleetPlane",
    "FleetView",
    "NodeDigest",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "get_registry",
    "set_registry",
    "FlightRecorder",
    "Span",
    "TraceContext",
    "configure",
    "get_recorder",
    "set_recorder",
    "write_trace",
    "new_trace_id",
    "stitch_traces",
    "StepAccounting",
    "TelemetryHistory",
    "BlackBox",
    "load_blackbox",
    "annotate",
    "profile",
    "recorded",
    "timed",
]
