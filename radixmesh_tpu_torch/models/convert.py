"""The JAX package's param tree, as numpy arrays, into the port's weights.

The port keeps the JAX orientation leaf for leaf (``models/llama.py``), so
conversion is a dtype and device move. bf16 leaves arrive as ml_dtypes
``bfloat16`` arrays, which ``torch.from_numpy`` rejects; they are read
through float32, and bf16 → f32 → bf16 is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from radixmesh_tpu_torch.models.llama import LAYER_PARAMS, ModelConfig, param_shapes
from radixmesh_tpu_torch.utils.device import resolve_device

__all__ = ["params_from_jax"]


def _leaf(x, shape, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.array(x, dtype=np.float32)  # a writable copy for torch
    if a.shape != tuple(shape):
        raise ValueError(f"leaf shape {a.shape} != expected {tuple(shape)}")
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def params_from_jax(np_tree: dict, cfg: ModelConfig, device=None) -> dict:
    """``np_tree``: the JAX ``init_params``/checkpoint tree with numpy (or
    array-like) leaves. Returns the port's param dict in ``cfg.dtype`` on
    ``device`` (CUDA unless ``"cpu"`` is asked for). W8A16 trees
    (``<name>_s`` scale leaves) and Qwen2 biases are refused: neither is
    ported yet."""
    if cfg.qkv_bias:
        raise NotImplementedError("qkv_bias (Qwen2) is not ported yet")
    if any(k.endswith("_s") for k in np_tree) or any(
        k.endswith("_s") for k in np_tree["layers"]
    ):
        raise NotImplementedError("W8A16 weights are not ported yet")
    device = resolve_device(device)
    shapes = param_shapes(cfg)
    out = {
        name: _leaf(np_tree[name], shapes[name], cfg.dtype, device)
        for name in shapes
        if name != "layers"
    }
    out["layers"] = {
        name: _leaf(np_tree["layers"][name], shapes["layers"][name], cfg.dtype, device)
        for name in LAYER_PARAMS
    }
    return out
