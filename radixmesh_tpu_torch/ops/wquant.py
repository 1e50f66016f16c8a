"""Weight-only int8 quantization, W8A16 (the JAX package's
``ops/wquant.py``).

Symmetric per-output-channel scales over each weight's contraction axis,
``scale[o] = max(amax_i |w[i, o]|, 1e-8) / 127``, applied after the
product: ``y = (x @ w_int8.to(x.dtype)) * s`` (``models/llama.py``), which
is exact for per-output-channel scaling and keeps the product's operands in
the model dtype. Embeddings quantize per row (the vocab axis), which serves
both the gather (``embed[tok] * s[tok]``) and the tied LM head (``x @
embed.T * s``) with one scale vector.

Layout: a quantized leaf keeps its name and shape (dtype int8) and gains a
float32 sibling ``<name>_s`` in the same level of the tree, shaped like the
weight without its contraction axis.

- :func:`quantize_weight` and :func:`quantize_params` work on torch tensors,
  on any device. A stacked ``[L, in, out]`` leaf is quantized one layer at a
  time and the embedding and LM head in blocks, so the float32 scratch
  stays a slab, not a model: on the card the peak is the input tree plus
  the int8 tree plus one slab.
- :func:`random_w8_params` builds a model directly in W8A16 form on the
  host with numpy, one layer at a time, from the JAX function's
  ``np.random.default_rng(seed)`` draws in the same order, so its int8
  leaves and scales equal the JAX function's for the same config and seed.
  Its norm and bias leaves are float32 numpy arrays (the JAX function makes
  them in the model dtype through ``ml_dtypes``); ``Llama`` casts them to
  the model dtype at load. Load the tree with
  ``models.convert.params_from_jax``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "quantize_weight",
    "quantize_params",
    "random_w8_params",
    "LAYER_QUANT_WEIGHTS",
]

# The per-layer dense weights that are quantized ([L, in, out]); norms and
# biases stay in the model dtype.
LAYER_QUANT_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

_EPS = 1e-8
# Rows (or columns) of the embedding and LM head quantized per block.
_BLOCK = 8192


def quantize_weight(w: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of ``w`` along the contraction ``axis``.

    Returns ``(q int8 shaped like w, scale float32 shaped like w without
    axis)`` with ``w ≈ q * scale`` broadcast over ``axis``. The scale is an
    IEEE quotient by 127 (a tensor divisor: PyTorch multiplies a CUDA
    tensor by the reciprocal of a Python scalar), as eager jnp computes
    it."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis).clamp_min(_EPS)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.round(wf / scale.unsqueeze(axis)).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _quantize_blocked(w: torch.Tensor, axis: int, along: int, block: int):
    """:func:`quantize_weight` over blocks of ``w`` along dim ``along`` (not
    ``axis``): the same result, with one block's float32 scratch."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s_shape = list(w.shape)
    del s_shape[axis]
    s = torch.empty(s_shape, dtype=torch.float32, device=w.device)
    s_along = along if along < axis else along - 1
    for lo in range(0, w.shape[along], block):
        n = min(block, w.shape[along] - lo)
        qb, sb = quantize_weight(w.narrow(along, lo, n), axis)
        q.narrow(along, lo, n).copy_(qb)
        s.narrow(s_along, lo, n).copy_(sb)
        del qb, sb
    return q, s


def quantize_params(params: dict) -> dict:
    """A new param tree with the dense weights int8-quantized and
    ``<name>_s`` scale leaves added (module docstring). Leaves that are
    already int8 pass through, so it is idempotent. The input tree is not
    modified."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in LAYER_QUANT_WEIGHTS:
        w = layers.get(name)
        if w is None or w.dtype == torch.int8:
            continue
        # [L, in, out]: contraction over the middle axis, one layer at a time.
        layers[name], layers[name + "_s"] = _quantize_blocked(w, axis=1, along=0, block=1)
    out["layers"] = layers
    if params["embed"].dtype != torch.int8:
        # [V, H], per-row scales (the gather and the tied LM head).
        out["embed"], out["embed_s"] = _quantize_blocked(params["embed"], axis=1, along=0,
                                                         block=_BLOCK)
    if params.get("lm_head") is not None and params["lm_head"].dtype != torch.int8:
        # [H, V], contraction over H.
        out["lm_head"], out["lm_head_s"] = _quantize_blocked(params["lm_head"], axis=0, along=1,
                                                             block=_BLOCK)
    return out


def _np_quant(w: np.ndarray, axis: int) -> tuple[np.ndarray, np.ndarray]:
    amax = np.abs(w).max(axis=axis)
    scale = np.maximum(amax, _EPS) / 127.0
    q = np.clip(np.round(w / np.expand_dims(scale, axis)), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def random_w8_params(cfg, seed: int = 0) -> dict:
    """Random weights directly in W8A16 form, on the host, one layer at a
    time (the largest transient is one float32 layer slab): the JAX
    function's ``1/sqrt(fan_in)`` normal init from the same
    ``np.random.default_rng(seed)`` draws. numpy leaves; norms at one and
    biases at zero, float32 (module docstring)."""
    rng = np.random.default_rng(seed)
    L, H = cfg.n_layers, cfg.hidden
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim

    def stacked(in_dim: int, out_dim: int):
        qs = np.empty((L, in_dim, out_dim), np.int8)
        ss = np.empty((L, out_dim), np.float32)
        for i in range(L):
            w = rng.standard_normal((in_dim, out_dim), dtype=np.float32)
            w *= 1.0 / np.sqrt(in_dim)
            qs[i], ss[i] = _np_quant(w, axis=0)
        return qs, ss

    layers: dict = {
        "attn_norm": np.ones((L, H), np.float32),
        "mlp_norm": np.ones((L, H), np.float32),
    }
    dims = {
        "wq": (H, qd), "wk": (H, kvd), "wv": (H, kvd), "wo": (qd, H),
        "w_gate": (H, cfg.intermediate), "w_up": (H, cfg.intermediate),
        "w_down": (cfg.intermediate, H),
    }
    for name, (i_dim, o_dim) in dims.items():
        layers[name], layers[name + "_s"] = stacked(i_dim, o_dim)
    if cfg.qkv_bias:
        layers["bq"] = np.zeros((L, qd), np.float32)
        layers["bk"] = np.zeros((L, kvd), np.float32)
        layers["bv"] = np.zeros((L, kvd), np.float32)
    emb = rng.standard_normal((cfg.vocab_size, H), dtype=np.float32)
    emb *= 1.0 / np.sqrt(H)
    eq, es = _np_quant(emb, axis=1)  # per-row (vocab) scales
    params = {
        "embed": eq,
        "embed_s": es,
        "final_norm": np.ones((H,), np.float32),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        head = rng.standard_normal((H, cfg.vocab_size), dtype=np.float32)
        head *= 1.0 / np.sqrt(H)
        params["lm_head"], params["lm_head_s"] = _np_quant(head, axis=0)
    return params
