"""Weights from outside into the port's param dict, and back out.

- ``params_from_jax``: the JAX package's param tree, as numpy arrays. The
  port keeps the JAX orientation leaf for leaf (``models/llama.py``), so
  conversion is a dtype and device move. bf16 leaves arrive as ml_dtypes
  ``bfloat16`` arrays, which ``torch.from_numpy`` rejects; they are read
  through float32, and bf16 → f32 → bf16 is exact. W8A16 trees keep their
  int8 leaves and float32 ``<name>_s`` scales.
- ``convert_hf_state_dict``: a HuggingFace Llama/Qwen2 state dict (HF
  names, ``[out, in]`` projections) into the stacked-layer dict, as the JAX
  package's ``convert_hf_state_dict`` does (``radixmesh_tpu/models/llama.py``).
- ``hf_state_dict``: the inverse, the port's params under HF names, for
  ``models/hf_io.save_hf_state_dict``.
"""

from __future__ import annotations

import numpy as np
import torch

from radixmesh_tpu_torch.models.llama import (
    ModelConfig,
    _scale_axes,
    layer_params,
    local_shapes,
    param_logical_axes,
    param_shapes,
    w8_scale_shapes,
)
from radixmesh_tpu_torch.parallel.sharding import shard_leaf
from radixmesh_tpu_torch.utils.device import resolve_device

__all__ = ["params_from_jax", "convert_hf_state_dict", "hf_state_dict"]


def _leaf(x, shape, dtype: torch.dtype, device) -> torch.Tensor:
    """One leaf as a tensor of ``dtype`` on ``device``; int8 leaves (W8A16
    weights) stay int8."""
    np_dtype = np.int8 if np.asarray(x).dtype == np.int8 else np.float32
    a = np.array(x, dtype=np_dtype)  # a writable copy for torch
    if a.shape != tuple(shape):
        raise ValueError(f"leaf shape {a.shape} != expected {tuple(shape)}")
    t = torch.from_numpy(a)
    return t.to(device=device, dtype=torch.int8 if np_dtype == np.int8 else dtype)


def params_from_jax(np_tree: dict, cfg: ModelConfig, device=None, mesh=None) -> dict:
    """``np_tree``: the JAX ``init_params``/checkpoint tree with numpy (or
    array-like) leaves, Qwen2's ``bq``/``bk``/``bv`` included. Returns the
    port's param dict in ``cfg.dtype`` on ``device`` (CUDA unless ``"cpu"``
    is asked for). A W8A16 tree (the JAX ``quantize_params`` or
    ``random_w8_params``, or the port's ``ops.wquant.random_w8_params``)
    keeps its int8 leaves int8 and carries their ``<name>_s`` scales across
    in float32. ``mesh`` (a ``ProcessMesh``) keeps this rank's shard of each
    leaf, sliced on the host before the move (``param_logical_axes``): under
    pp the stacked layers of this rank's stage (``models.llama.stage_layers``),
    then its tp shard."""
    device = resolve_device(device)
    shard_mesh = mesh if mesh is not None and (mesh.size("tp") > 1 or mesh.size("pp") > 1) else None
    axes = param_logical_axes(cfg)
    shapes = local_shapes(param_shapes(cfg), axes, shard_mesh)
    scale_axes = _scale_axes(cfg)
    scale_shapes = local_shapes(w8_scale_shapes(cfg), scale_axes, shard_mesh)

    def convert(tree, shapes, axes, names):
        out = {}
        for name in names:
            x = shard_leaf(np.asarray(tree[name]), axes[name], shard_mesh)
            out[name] = _leaf(x, shapes[name], cfg.dtype, device)
            if out[name].dtype == torch.int8:
                if name not in scale_shapes:
                    raise ValueError(f"leaf {name} is int8, but only {sorted(scale_shapes)} quantize")
                sx = shard_leaf(np.asarray(tree[name + "_s"]), scale_axes[name], shard_mesh)
                out[name + "_s"] = _leaf(sx, scale_shapes[name], torch.float32, device)
        return out

    out = convert(np_tree, shapes, axes, [name for name in shapes if name != "layers"])
    out["layers"] = convert(np_tree["layers"], shapes["layers"], axes["layers"], layer_params(cfg))
    return out


# HF tensor names: per-layer projections (stored [out, in]), per-layer
# norms and biases (vectors), and the model-level leaves.
_HF_PROJ = {
    "wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
    "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
    "w_gate": "mlp.gate_proj.weight", "w_up": "mlp.up_proj.weight",
    "w_down": "mlp.down_proj.weight",
}
_HF_VEC = {
    "attn_norm": "input_layernorm.weight", "mlp_norm": "post_attention_layernorm.weight",
    "bq": "self_attn.q_proj.bias", "bk": "self_attn.k_proj.bias", "bv": "self_attn.v_proj.bias",
}


def _hf_layer_name(name: str, i: int) -> str:
    return f"model.layers.{i}." + (_HF_PROJ.get(name) or _HF_VEC[name])


def convert_hf_state_dict(cfg: ModelConfig, state: dict, device=None) -> dict:
    """Map a HuggingFace Llama/Qwen2 state dict (HF names, CPU tensors as
    ``models/hf_io.load_hf_state_dict`` returns them) into the port's
    stacked-layer param dict in ``cfg.dtype`` on ``device`` (CUDA unless
    ``"cpu"`` is asked for).

    HF stores projections ``[out, in]``; the port keeps ``[in, out]``. Each
    stacked ``[L, ...]`` leaf is allocated once on the device and filled
    layer by layer (each HF tensor moved as it is, then transposed and cast
    there), so host memory never holds a stacked copy. A float32 tensor is
    rounded to bf16 to nearest even, as ``jnp.asarray(..., bfloat16)``
    rounds it, so both packages give bit-equal params. ``qkv_bias`` takes
    the ``q/k/v_proj.bias`` tensors; tied embeddings take no LM head;
    otherwise ``lm_head.weight``, or ``embed.T`` where it is missing. A
    missing tensor raises ``KeyError`` naming it."""
    device = resolve_device(device)
    shapes = param_shapes(cfg)

    def get(name: str, shape) -> torch.Tensor:
        if name not in state:
            raise KeyError(f"checkpoint has no tensor {name!r}")
        t = state[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != expected {tuple(shape)}")
        return t.to(device)

    def into(out: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        out.copy_(t)  # casts on the device: round to nearest even
        return out

    def new(shape) -> torch.Tensor:
        return torch.empty(shape, dtype=cfg.dtype, device=device)

    embed = into(new(shapes["embed"]), get("model.embed_tokens.weight", shapes["embed"]))
    params = {
        "embed": embed,
        "final_norm": into(new(shapes["final_norm"]), get("model.norm.weight", shapes["final_norm"])),
        "layers": {},
    }
    for name in layer_params(cfg):
        shape = shapes["layers"][name]
        leaf = new(shape)
        for i in range(cfg.n_layers):
            hf_shape = shape[1:][::-1] if name in _HF_PROJ else shape[1:]
            t = get(_hf_layer_name(name, i), hf_shape)
            into(leaf[i], t.t() if name in _HF_PROJ else t)
        params["layers"][name] = leaf
    if not cfg.tie_embeddings:
        if "lm_head.weight" in state:
            head = get("lm_head.weight", shapes["lm_head"][::-1]).t()
            params["lm_head"] = into(new(shapes["lm_head"]), head)
        else:
            params["lm_head"] = embed.t().contiguous()
    return params


def hf_state_dict(cfg: ModelConfig, params: dict) -> dict:
    """The port's params under HF names, projections transposed back to
    ``[out, in]`` (views: nothing is copied until a writer reads them), for
    ``save_hf_state_dict``. Inverse of :func:`convert_hf_state_dict`."""
    state = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"]}
    for name in layer_params(cfg):
        for i in range(cfg.n_layers):
            t = params["layers"][name][i]
            state[_hf_layer_name(name, i)] = t.t() if name in _HF_PROJ else t
    if not cfg.tie_embeddings:
        state["lm_head.weight"] = params["lm_head"].t()
    return state

