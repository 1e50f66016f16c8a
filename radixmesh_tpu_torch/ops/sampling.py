"""Token sampling: greedy / temperature / top-k / top-p (the JAX package's
``ops/sampling.py::sample_tokens``).

Greedy rows are exact (``argmax``, first index on ties, like ``jnp.argmax``).
Stochastic rows draw from the same filtered distribution on an explicit
``torch.Generator``; the draws cannot equal JAX's threefry bits, so tests
compare distributions. ``spec_verify_sample`` is not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["sample_tokens"]


def _filtered_logits(
    logits: torch.Tensor,
    temperature: torch.Tensor,  # [...] per row
    top_p: torch.Tensor,  # [...]
    top_k: torch.Tensor,  # [...] int (0 = off)
) -> torch.Tensor:
    """Temperature-scaled logits with top-k/top-p masking (-inf outside the
    nucleus). One ascending sort serves both filters, as in the JAX
    version: the per-row kth threshold is a gather on it, and its reverse
    is the descending view top-p walks."""
    scaled = logits.float() / temperature.clamp_min(1e-6)[..., None]
    V = scaled.shape[-1]
    k_eff = torch.where(top_k > 0, top_k.clamp(1, V), torch.full_like(top_k, V))
    asc, _ = torch.sort(scaled, dim=-1)
    kth = torch.gather(asc, -1, (V - k_eff)[..., None].long())
    neg_inf = torch.tensor(float("-inf"), device=scaled.device)
    scaled = torch.where(scaled < kth, neg_inf, scaled)
    # top-p: keep the smallest set with cumulative probability >= top_p,
    # always including the argmax (sorted position 0).
    sorted_logits = torch.where(asc < kth, neg_inf, asc).flip(-1)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    cutoff = (cum - probs) >= top_p[..., None]
    cutoff[..., 0] = False
    sorted_filtered = torch.where(cutoff, neg_inf, sorted_logits)
    pos_inf = torch.tensor(float("inf"), device=scaled.device)
    threshold = torch.where(
        torch.isfinite(sorted_filtered), sorted_filtered, pos_inf
    ).amin(dim=-1, keepdim=True)
    return torch.where(scaled < threshold, neg_inf, scaled)


def sample_tokens(
    logits: torch.Tensor,  # [..., vocab]
    generator: torch.Generator | None = None,
    temperature: float | torch.Tensor = 0.0,
    top_k: int | torch.Tensor = 0,
    top_p: float | torch.Tensor = 1.0,
) -> torch.Tensor:
    """One token id (int64) per row of ``logits``. ``temperature == 0`` is
    greedy; the per-row arguments may be scalars or tensors of shape
    ``logits.shape[:-1]``. When every row is greedy no random draw is
    made, so the generator's stream does not advance."""
    dev = logits.device
    shape = logits.shape[:-1]
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=dev).expand(shape)
    greedy = torch.argmax(logits, dim=-1)
    if not bool((temperature > 0).any()):
        return greedy
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev).expand(shape)
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=dev).expand(shape)
    probs = torch.softmax(_filtered_logits(logits, temperature, top_p, top_k), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    sampled = torch.multinomial(flat, 1, generator=generator).reshape(shape)
    return torch.where(temperature <= 0.0, greedy, sampled)
