"""Rotary position embeddings with Llama-3 frequency scaling (the JAX
package's ``ops/rope.py``).

K is stored in the paged pool already rotated: the rotation depends only
on a token's absolute position, which is immutable for a cached prefix —
what makes radix prefix reuse sound for RoPE models.
"""

from __future__ import annotations

import math

import torch

__all__ = ["rope_frequencies", "apply_rope"]


def rope_frequencies(
    head_dim: int,
    theta: float = 500000.0,
    llama3_scaling: dict | tuple | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Inverse frequencies ``[head_dim // 2]`` in float32, optionally with
    the Llama-3.x NTK-by-parts rescale. ``llama3_scaling`` may be a dict or
    a tuple of ``(key, value)`` pairs (the form ``ModelConfig`` stores)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    inv = 1.0 / (theta ** exponent)
    if isinstance(llama3_scaling, tuple):
        llama3_scaling = dict(llama3_scaling)
    if llama3_scaling:
        factor = llama3_scaling.get("factor", 8.0)
        low = llama3_scaling.get("low_freq_factor", 1.0)
        high = llama3_scaling.get("high_freq_factor", 4.0)
        orig = llama3_scaling.get("original_max_position_embeddings", 8192)
        wavelen = 2.0 * math.pi / inv
        smooth = (orig / wavelen - low) / (high - low)
        inv = torch.where(
            wavelen > orig / low,
            inv / factor,
            torch.where(
                wavelen < orig / high,
                inv,
                (1.0 - smooth) * inv / factor + smooth * inv,
            ),
        )
    return inv


def apply_rope(
    x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor
) -> torch.Tensor:
    """Rotate ``x`` ([..., seq, heads, head_dim]) by absolute ``positions``
    ([..., seq]) — the rotate-half convention, float32 inside."""
    angles = positions[..., :, None].float() * inv_freq
    cos = torch.cos(angles)[..., :, None, :]  # [..., seq, 1, dim/2]
    sin = torch.sin(angles)[..., :, None, :]
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
