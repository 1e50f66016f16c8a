"""RMSNorm, computed in float32 whatever the input dtype and cast back
(the JAX package's ``ops/norm.py::rms_norm``)."""

from __future__ import annotations

import torch

__all__ = ["rms_norm"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    normed = x32 * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * weight.float()).to(x.dtype)
