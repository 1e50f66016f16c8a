"""Request-class keys shared by the engine's per-shape counters (the
port's copy of ``shape_bucket`` from the JAX package's
``obs/attribution.py``; the critical-path attribution around it is not
ported)."""

from __future__ import annotations

__all__ = ["shape_bucket"]


def shape_bucket(prompt_tokens: int, floor: int = 32) -> str:
    """Pow2 prompt-length bucket label ("p128" = 65..128 tokens): the
    request-class key of the engine's speculative counters and the
    speculation ledger."""
    n = max(1, int(prompt_tokens))
    b = floor
    while b < n and b < 1 << 20:
        b <<= 1
    return f"p{b}"
