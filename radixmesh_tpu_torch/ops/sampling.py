"""Token sampling: greedy / temperature / top-k / top-p, and exact
speculative verification (the JAX package's ``ops/sampling.py``:
``sample_tokens`` and ``spec_verify_sample``).

Greedy rows are exact (``argmax``, first index on ties, like ``jnp.argmax``).
Stochastic rows draw from the same filtered distribution on an explicit
``torch.Generator``; the draws cannot equal JAX's threefry bits, so tests
compare distributions. Both functions are plain PyTorch on either device:
the JAX package computes them in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "any_stochastic", "sample_tokens", "sample_stochastic", "sampling_tensors", "spec_verify_sample",
]


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


def any_stochastic(temperature) -> bool:
    """Whether any row samples. A host value (float, numpy array) is read
    on the host; a device tensor costs a device-to-host sync."""
    if isinstance(temperature, torch.Tensor):
        return bool((temperature > 0).any())
    return bool(np.any(np.asarray(temperature) > 0))


def sample_tokens(
    logits: torch.Tensor,  # [..., vocab]
    generator: torch.Generator | None = None,
    temperature: float | np.ndarray | torch.Tensor = 0.0,
    top_k: int | np.ndarray | torch.Tensor = 0,
    top_p: float | np.ndarray | torch.Tensor = 1.0,
) -> torch.Tensor:
    """One token id (int64) per row of ``logits``. ``temperature == 0`` is
    greedy; the per-row arguments may be scalars, numpy arrays or tensors
    of shape ``logits.shape[:-1]``. When every row is greedy no random draw
    is made, so the generator's stream does not advance; a host-side
    ``temperature`` decides that without a device sync."""
    if not any_stochastic(temperature):
        return torch.argmax(logits, dim=-1)
    params = sampling_tensors(logits.shape[:-1], logits.device, temperature, top_k, top_p)
    return sample_stochastic(logits, generator, *params)


def sampling_tensors(shape, device, temperature, top_k, top_p):
    """``(temperature, top_k, top_p)`` as tensors of ``shape`` on
    ``device`` (made once, reused by every step of a multi-step launch)."""
    return (
        torch.as_tensor(temperature, dtype=torch.float32, device=device).expand(shape),
        torch.as_tensor(top_k, dtype=torch.int64, device=device).expand(shape),
        torch.as_tensor(top_p, dtype=torch.float32, device=device).expand(shape),
    )


def sample_stochastic(
    logits: torch.Tensor,
    generator: torch.Generator | None,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
) -> torch.Tensor:
    """``sample_tokens`` for a batch with some stochastic row, on tensors
    from ``sampling_tensors``: greedy rows keep their argmax, the others
    draw from the filtered distribution."""
    greedy = torch.argmax(logits, dim=-1)
    probs = torch.softmax(_filtered_logits(logits, temperature, top_p, top_k), dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    sampled = torch.multinomial(flat, 1, generator=generator).reshape(greedy.shape)
    return torch.where(temperature <= 0.0, greedy, sampled)


def _categorical(log_weights: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """One index per row of ``log_weights [B, V]`` drawn with probability
    proportional to ``exp(log_weights)`` (the exponential-race form of the
    Gumbel-max trick; rows may hold -inf). No device sync, no validity
    check; an all -inf row returns 0."""
    e = torch.empty_like(log_weights).exponential_(generator=generator)
    return torch.argmax(log_weights - torch.log(e), dim=-1)


def spec_verify_sample(
    logits: torch.Tensor,  # [B, C, V] verify-pass logits (C = gamma + 1)
    drafts: torch.Tensor,  # [B, C-1] draft token per position (pad arbitrary)
    draft_len: torch.Tensor,  # [B] real draft tokens per row (0..C-1)
    generator: torch.Generator | None,
    temperature: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    top_k: torch.Tensor | int = 0,  # [B] (0 = off)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact speculative verification against a point-mass draft.

    Position ``i``'s target ``p_i`` is the filtered distribution plain
    decode samples from. Draft ``d_i`` is accepted with probability
    ``p_i(d_i)``; the first rejection at ``a`` emits one token from the
    residual (``p_a`` without ``d_a``'s mass, renormalized) and full
    acceptance emits from ``p_gamma``, so the emitted sequence is
    distributed exactly as step-by-step sampling. Greedy rows (temperature
    0) take the longest argmax-matching prefix and the argmax after it.

    Returns ``(accept_len [B], bonus [B])``, int64: rows emit
    ``drafts[:accept_len]`` then ``bonus``. Draws come from ``generator``
    (never bit-equal to the JAX package's threefry draws).
    """
    B, C, V = logits.shape
    dev = logits.device
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=dev)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev)
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=dev).expand(B)
    drafts = drafts.long()
    draft_len = draft_len.long()
    greedy_row = temperature <= 0.0
    filtered = _filtered_logits(
        logits, temperature[:, None].expand(B, C), top_p[:, None].expand(B, C),
        top_k[:, None].expand(B, C),
    )
    probs = torch.softmax(filtered, dim=-1)  # [B, C, V]
    greedy_tok = torch.argmax(logits, dim=-1)  # [B, C]

    pos = torch.arange(C - 1, device=dev)
    p_draft = torch.gather(probs[:, : C - 1], -1, drafts[..., None])[..., 0]
    accept_prob = torch.where(
        greedy_row[:, None], (greedy_tok[:, : C - 1] == drafts).float(), p_draft
    )
    u = torch.rand((B, C - 1), generator=generator, device=dev)
    ok = (u < accept_prob) & (pos[None, :] < draft_len[:, None])
    accept_len = torch.cumprod(ok.long(), dim=1).sum(dim=1)  # longest accepted prefix

    rows = torch.arange(B, device=dev)
    p_a = probs[rows, accept_len]  # [B, V]
    d_a = torch.gather(drafts, 1, accept_len.clamp(max=max(C - 2, 0))[:, None])[:, 0]
    rejected = accept_len < draft_len
    residual = torch.where(
        rejected[:, None] & (torch.arange(V, device=dev)[None, :] == d_a[:, None]), 0.0, p_a
    )
    logres = torch.where(
        residual > 0.0, torch.log(residual.clamp_min(1e-30)), float("-inf")
    )
    sampled_bonus = _categorical(logres, generator)
    greedy_bonus = torch.gather(greedy_tok, 1, accept_len[:, None])[:, 0]
    bonus = torch.where(greedy_row, greedy_bonus, sampled_bonus)
    return accept_len, bonus
