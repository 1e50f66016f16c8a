"""Int8 KV-cache quantization (the JAX package's ``ops/quant.py``).

Symmetric per-(token, head) scaling over the head_dim axis: ``scale =
max(amax, 1e-8) / 127`` and ``q = round(x / scale)``, rounding half to even,
clipped to ±127. Every step is one IEEE float32 operation in the same order
as the jnp version (no multiplication by a reciprocal), so the int8 payload
and the scale are bit-exact with it on the same float32 input. The decode
kernel (``ops/csrc/paged_decode.cuh``) quantizes the current row the same
way in registers.
"""

from __future__ import annotations

import torch

__all__ = [
    "quantize_kv",
    "dequantize_kv",
    "quantize_for_store",
    "KV_QUANT_DTYPES",
]

KV_QUANT_DTYPES = {"int8": torch.int8}

# Zero vectors quantize against this floor instead of dividing by zero;
# their int8 payload is all-zero either way.
_EPS = 1e-8


def quantize_kv(x: torch.Tensor, dim: int = -1) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along ``dim`` (the head_dim axis).

    Returns ``(q, scale)``: ``q`` int8 shaped like ``x``, ``scale`` float32
    shaped like ``x`` without ``dim``; ``x ≈ q * scale``."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim).clamp_min(_EPS)
    # Tensor by tensor: PyTorch divides a CUDA tensor by a Python scalar as
    # a product with the scalar's reciprocal, which can differ in the last
    # bit from the IEEE quotient.
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.round(xf / scale.unsqueeze(dim)).clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`, in float32."""
    return q.float() * scale.unsqueeze(dim)


def quantize_for_store(k: torch.Tensor, v: torch.Tensor):
    """Quantize new K/V now and hand back the dequantized copy to attend, so
    a chunk sees exactly what any later read of the pool will see.

    Returns ``(k_int, v_int, k_scale, v_scale, k_deq, v_deq)``."""
    k_int, k_sc = quantize_kv(k)
    v_int, v_sc = quantize_kv(v)
    return k_int, v_int, k_sc, v_sc, dequantize_kv(k_int, k_sc), dequantize_kv(v_int, v_sc)
