"""Serving engine (the JAX package's ``engine/``): continuous batching over
the radix prefix cache (``engine.py``), and disaggregated prefill→decode
serving with KV handoff (``disagg.py``)."""

from radixmesh_tpu_torch.engine.disagg import (
    DecodeWorker,
    HandoffPacket,
    PrefillWorker,
    pack_handoff,
    unpack_handoff,
)
from radixmesh_tpu_torch.engine.engine import Engine, EngineStats
from radixmesh_tpu_torch.engine.request import Request, RequestState, SamplingParams

__all__ = [
    "Engine",
    "EngineStats",
    "Request",
    "RequestState",
    "SamplingParams",
    "PrefillWorker",
    "DecodeWorker",
    "HandoffPacket",
    "pack_handoff",
    "unpack_handoff",
]
