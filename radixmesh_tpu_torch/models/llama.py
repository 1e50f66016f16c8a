"""Llama-3-family transformer in PyTorch (the JAX package's
``models/llama.py``).

- ``ModelConfig`` carries the same fields, with a torch dtype.
- :class:`Llama` holds the JAX param tree's tensors in the JAX orientation:
  every projection is ``[in, out]`` and applied as ``x @ W``, and per-layer
  weights are stacked on a leading layer axis (``layers.wq`` is
  ``[L, H, Hq*D]``), so the JAX tree converts leaf for leaf
  (``models/convert.py``). With ``qkv_bias`` (the Qwen2 family,
  ``models/qwen2.py``) the layers also hold ``bq [L, Hq*D]``, ``bk`` and
  ``bv [L, Hkv*D]``, added to the projections before RoPE.
- Three forwards, as in the JAX package: ``prefill_forward`` (new tokens
  against an optional right-aligned cached prefix, plain attention),
  ``prefill_chunk_paged`` (one chunk against the paged pool, through the
  chunk kernel) and ``decode_step`` (one token per row, through the fused
  decode kernel). The big products are plain ``torch.matmul``. The LM
  head's product has a float32 output, as the JAX ``_logits`` asks with
  ``preferred_element_type``: on CUDA ``torch.mm(..., out_dtype=float32)``
  over the model-dtype operands, on the CPU a float32 product. The logits
  are never rounded to the model dtype.
- W8A16 weights (``ops/wquant.py``): every projection, the untied LM head
  and the tied one multiply by ``w.to(x.dtype)`` and then by the float32
  per-output-channel scale (``_proj``, ``_logits``), and an int8 embedding
  row is scaled in float32 and cast to the model dtype (``_embed``), as
  the JAX ``_wmm`` and ``_embed_lookup`` do. The widened weight is a
  temporary of one leaf per product; nothing keeps a full-precision copy.
- ``decode_multi`` runs ``k`` decode steps in one call, sampling on the
  device and feeding each token to the next step, with no host sync;
  ``decode_multi_compact`` runs it over a sub-pool gathered from the live
  pages and scatters the pages back once.
- Tensor parallelism (``mesh=`` a ``parallel.sharding.ProcessMesh`` with
  tp > 1; Megatron layout, every collective written out): the model holds
  this rank's shards (``param_logical_axes``), Hq/tp query heads and Hkv/tp
  kv heads. ``_proj`` is column-parallel for ``wq``/``wk``/``wv``/``w_gate``/
  ``w_up``; ``wo`` and ``w_down`` are row-parallel, their partial products
  taken in float32 and summed by one all-reduce each per block
  (``_proj_reduced``); ``_embed`` looks up this rank's vocab rows, zeroes
  the others and all-reduces; ``_logits`` all-gathers the vocab-sharded
  float32 logits, so every rank samples from the same logits. The attention
  calls are the single-device ones on the local heads (no collective). With
  no tp axis every path is the single-device one.
- ``prefill_forward_sp``: sequence-parallel prefill over the mesh's sp axis,
  ring attention between the ranks' sequence blocks.
- Pipeline parallelism (a mesh with pp > 1): the model is one stage. It
  holds the contiguous block of ``n_layers = L/pp`` layers that starts at
  global layer ``layer0`` (and, under tp, their shards), and the embedding,
  final norm and LM head like every stage. Its pool holds the same ``L/pp``
  layers, indexed by the stage-local layer. A stage runs no whole forward
  alone: ``parallel/pp_serving.py`` and ``parallel/pipeline.py`` drive its
  layer bodies (``_chunk_layers``, ``_decode_layers``) between the stages,
  and the whole forwards refuse a stage.
- Training (``parallel/train.py``): ``train_forward`` is causal
  self-attention over a batch with no cached prefix (the JAX
  ``prefill_forward`` with an empty prefix), through the plain
  ``attend_prefill``, as the JAX training path attends; ``train_layers`` is
  its layer loop, which a pipeline stage runs alone. Under autograd the
  tp seams are the differentiable collectives of
  ``parallel/collectives.py``: ``copy_to`` before every column-parallel
  product and the vocab-parallel head (identity forward, all-reduce
  backward), ``reduce_from`` in ``_proj_reduced`` and ``_embed``,
  ``gather_from`` in ``_logits``; under sp each layer gathers K and V over
  the sequence (``gather_seq``). With autograd off (every serving forward
  runs under ``inference_mode``) they are the plain collectives. The
  trainer makes the leaves trainable (``train.trainable``).
- The pool is updated in place where JAX donates it: ``decode_step``'s
  kernel writes each layer's row, and ``prefill_chunk_paged`` writes the
  chunk's K/V into layer ``l`` right after layer ``l``'s attention (the
  chunk kernel reads only pool tokens below ``prior``, so per-layer writes
  are safe; JAX writes once after its layer scan).
- With an int8 pool (``kv_scale [2, L, Hkv, num_slots]`` beside it) the
  chunk quantizes its K/V (``quantize_for_store``), attends the float32
  dequantized copy and writes the int8 payload and scales; the decode
  kernel receives the raw row and quantizes it itself. Either way a layer
  attends exactly what the pool will hold.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from radixmesh_tpu_torch.ops.attention import (
    attend_prefill,
    paged_chunk_attention,
    paged_decode_attention,
)
from radixmesh_tpu_torch.ops.norm import rms_norm
from radixmesh_tpu_torch.ops.quant import quantize_for_store
from radixmesh_tpu_torch.ops.rope import apply_rope, rope_frequencies
from radixmesh_tpu_torch.ops.sampling import any_stochastic, sample_stochastic, sampling_tensors
from radixmesh_tpu_torch.ops.wquant import LAYER_QUANT_WEIGHTS, quantize_weight
from radixmesh_tpu_torch.parallel.collectives import (
    all_reduce,
    copy_to,
    gather_from,
    gather_seq,
    reduce_from,
)
from radixmesh_tpu_torch.parallel.ring_attention import ring_attention
from radixmesh_tpu_torch.parallel.sharding import SERVING_RULES, logical_to_spec, shard_leaf
from radixmesh_tpu_torch.utils.device import resolve_device

__all__ = ["ModelConfig", "Llama", "init_params", "LAYER_PARAMS", "BIAS_PARAMS", "layer_params",
           "w8_scale_shapes", "param_logical_axes", "local_shapes", "stage_layers"]

LAYER_PARAMS = (
    "attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
)
# The QKV biases of configs with ``qkv_bias`` (Qwen2).
BIAS_PARAMS = ("bq", "bk", "bv")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 128256
    hidden: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    head_dim: int = 128
    intermediate: int = 14336
    rope_theta: float = 500000.0
    # Tuple of (key, value) pairs so the config hashes, as in the JAX one.
    rope_scaling: tuple | None = None
    rms_eps: float = 1e-5
    qkv_bias: bool = False  # True for Qwen2
    tie_embeddings: bool = False
    max_seq_len: int = 8192
    dtype: torch.dtype = torch.bfloat16

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def llama3_8b(cls) -> "ModelConfig":
        """Meta-Llama-3-8B: no rope scaling (it arrives with 3.1), the 8k
        window."""
        return cls(rope_scaling=None)

    @classmethod
    def llama3_70b(cls) -> "ModelConfig":
        return cls(
            hidden=8192, n_layers=80, n_heads=64, n_kv_heads=8, head_dim=128,
            intermediate=28672, rope_scaling=None,
        )

    @classmethod
    def llama31_8b(cls) -> "ModelConfig":
        return cls.llama3_8b().replace(
            rope_scaling=(
                ("factor", 8.0),
                ("low_freq_factor", 1.0),
                ("high_freq_factor", 4.0),
                ("original_max_position_embeddings", 8192),
            ),
            max_seq_len=131072,
        )

    @classmethod
    def llama31_70b(cls) -> "ModelConfig":
        return cls.llama3_70b().replace(
            rope_scaling=cls.llama31_8b().rope_scaling, max_seq_len=131072
        )

    @classmethod
    def llama32_1b(cls) -> "ModelConfig":
        return cls(
            vocab_size=128256, hidden=2048, n_layers=16, n_heads=32,
            n_kv_heads=8, head_dim=64, intermediate=8192, tie_embeddings=True,
            rope_scaling=(
                ("factor", 32.0),
                ("low_freq_factor", 1.0),
                ("high_freq_factor", 4.0),
                ("original_max_position_embeddings", 8192),
            ),
            max_seq_len=131072,
        )

    @classmethod
    def llama32_3b(cls) -> "ModelConfig":
        return cls.llama32_1b().replace(
            hidden=3072, n_layers=28, n_heads=24, n_kv_heads=8,
            head_dim=128, intermediate=8192,
        )

    @classmethod
    def tiny(cls) -> "ModelConfig":
        """Test config: same architecture, toy dims."""
        return cls(
            vocab_size=512, hidden=128, n_layers=2, n_heads=4, n_kv_heads=2,
            head_dim=32, intermediate=256, max_seq_len=512,
        )


def layer_params(cfg: ModelConfig) -> tuple[str, ...]:
    """Names of the stacked per-layer leaves of ``cfg``'s param tree."""
    return LAYER_PARAMS + (BIAS_PARAMS if cfg.qkv_bias else ())


def param_shapes(cfg: ModelConfig) -> dict:
    """Leaf shapes of the param tree (JAX orientation)."""
    L, H = cfg.n_layers, cfg.hidden
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    shapes = {
        "embed": (cfg.vocab_size, H),
        "final_norm": (H,),
        "layers": {
            "attn_norm": (L, H),
            "mlp_norm": (L, H),
            "wq": (L, H, qd),
            "wk": (L, H, kvd),
            "wv": (L, H, kvd),
            "wo": (L, qd, H),
            "w_gate": (L, H, cfg.intermediate),
            "w_up": (L, H, cfg.intermediate),
            "w_down": (L, cfg.intermediate, H),
        },
    }
    if cfg.qkv_bias:
        shapes["layers"].update(bq=(L, qd), bk=(L, kvd), bv=(L, kvd))
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (H, cfg.vocab_size)
    return shapes


def w8_scale_shapes(cfg: ModelConfig) -> dict:
    """Shape of the float32 scale ``<name>_s`` of each leaf a W8A16 tree
    may hold as int8 (``ops/wquant.py``): the weight's shape without its
    contraction axis."""
    shapes = param_shapes(cfg)
    ls = shapes["layers"]
    out = {name: (ls[name][0], ls[name][2]) for name in LAYER_QUANT_WEIGHTS}
    out["embed"] = (cfg.vocab_size,)
    if not cfg.tie_embeddings:
        out["lm_head"] = (cfg.vocab_size,)
    return out


def param_logical_axes(cfg: ModelConfig, params: dict | None = None) -> dict:
    """Logical axis names per parameter, mapped to mesh axes by
    ``parallel/sharding.py`` (tp shards "q_heads"/"kv_heads"/"ffn"/"vocab",
    everything else replicates), the JAX package's. Pass ``params`` to also
    cover the ``<name>_s`` scale leaves of W8A16 weights: each scale shards
    like its weight's output (last) axis, the embedding's and the LM head's
    along the vocabulary."""
    axes = {
        "embed": ("vocab", "embed"),
        "final_norm": ("embed",),
        "layers": {
            "attn_norm": ("layer", "embed"),
            "mlp_norm": ("layer", "embed"),
            "wq": ("layer", "embed", "q_heads"),
            "wk": ("layer", "embed", "kv_heads"),
            "wv": ("layer", "embed", "kv_heads"),
            "wo": ("layer", "q_heads", "embed"),
            "w_gate": ("layer", "embed", "ffn"),
            "w_up": ("layer", "embed", "ffn"),
            "w_down": ("layer", "ffn", "embed"),
        },
    }
    if cfg.qkv_bias:
        axes["layers"]["bq"] = ("layer", "q_heads")
        axes["layers"]["bk"] = ("layer", "kv_heads")
        axes["layers"]["bv"] = ("layer", "kv_heads")
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    if params is not None:
        for name in list(axes["layers"]):
            if name + "_s" in params.get("layers", {}):
                axes["layers"][name + "_s"] = ("layer", axes["layers"][name][-1])
        if "embed_s" in params:
            axes["embed_s"] = ("vocab",)
        if "lm_head_s" in params:
            axes["lm_head_s"] = ("vocab",)
    return axes


def _scale_axes(cfg: ModelConfig) -> dict:
    """Logical axes of every W8A16 scale ``w8_scale_shapes`` names."""
    la = param_logical_axes(cfg)["layers"]
    out = {name: ("layer", la[name][-1]) for name in LAYER_QUANT_WEIGHTS}
    out["embed"] = ("vocab",)
    if not cfg.tie_embeddings:
        out["lm_head"] = ("vocab",)
    return out


def local_shapes(shapes: dict, axes: dict, mesh) -> dict:
    """``shapes`` with every dimension that a mesh axis shards divided by
    that axis's size: the shapes of one rank's shards. A dimension that does
    not divide raises, naming it."""
    if isinstance(shapes, dict):
        return {k: local_shapes(v, axes[k], mesh) for k, v in shapes.items()}
    if mesh is None:
        return tuple(shapes)
    out = []
    for n, mesh_axis, name in zip(shapes, logical_to_spec(axes, SERVING_RULES), axes):
        size = 1 if mesh_axis is None else mesh.size(mesh_axis)
        if n % size:
            raise ValueError(f"logical axis {name!r} of size {n} does not divide {mesh_axis}={size}")
        out.append(n // size)
    return tuple(out)


def stage_layers(cfg: ModelConfig, mesh) -> tuple[int, int]:
    """``(first, end)``: the global layers this rank's pipeline stage holds,
    the contiguous block ``[s·L/pp, (s+1)·L/pp)`` of stage ``s`` (all of them
    without a pp axis)."""
    pp = 1 if mesh is None else mesh.size("pp")
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers={cfg.n_layers} is not divisible by pp={pp}")
    n = cfg.n_layers // pp
    s = 0 if mesh is None else mesh.index("pp")
    return s * n, (s + 1) * n


def init_params(
    cfg: ModelConfig, seed: int = 0, device: torch.device | str | None = None, *, mesh=None,
    weight_quant: str | None = None,
) -> dict:
    """Random weights from a seeded ``torch.Generator``: the JAX package's
    ``init_params`` scheme (normal scaled by 1/sqrt(fan_in), norms at one)
    with other random numbers. Stacked tensors are drawn one layer at a
    time, so the float32 scratch stays one layer's worth. QKV biases
    (``qkv_bias``) start at zero, as in the JAX package. ``device``: CUDA
    unless ``"cpu"`` is asked for (``resolve_device``).

    ``mesh`` (a ``ProcessMesh``) keeps only this rank's shard of each layer
    as it is drawn (``param_logical_axes``): every rank draws the same
    numbers and holds its part, so ranks and a single-device model share
    weights without any rank holding the whole tree. Under pp a rank draws
    every layer (the generator stays in step) and keeps its stage's block
    (``stage_layers``), so its layers are bit-equal to the same layers of
    the single-device draw. ``weight_quant="int8"`` quantizes each drawn
    layer whole, before it is sliced (W8A16, equal to
    ``ops.wquant.quantize_params`` of the unsharded tree, then sharded)."""
    device = resolve_device(device)
    if weight_quant not in (None, "int8"):
        raise ValueError(f"unknown weight quantization {weight_quant!r}")
    gen = torch.Generator(device=device).manual_seed(seed)
    lo, hi = stage_layers(cfg, mesh)
    axes = param_logical_axes(cfg)
    scale_axes = _scale_axes(cfg)
    quant_out: dict = {}

    def dense(name, shape, fan_in, leaf_axes, qaxis):
        """Draw ``shape`` one layer at a time; keep (and maybe quantize)
        this rank's shard. ``qaxis``: the contraction axis of one layer."""
        stacked = len(shape) == 3
        slab_axes = leaf_axes[1:] if stacked else leaf_axes
        lead = (hi - lo,) if stacked else ()
        out = scales = None
        for i in range(shape[0] if stacked else 1):
            m = torch.randn(shape[1:] if stacked else shape, generator=gen, device=device)
            if stacked and not lo <= i < hi:
                continue  # another stage's layer: drawn, so the stream stays in step
            j = i - lo
            m = (m / math.sqrt(fan_in)).to(cfg.dtype)
            if weight_quant is not None:
                m, sc = quantize_weight(m, qaxis)
                sc = shard_leaf(sc, scale_axes[name][1:] if stacked else scale_axes[name], mesh)
                if scales is None:
                    scales = torch.empty(lead + tuple(sc.shape), dtype=torch.float32, device=device)
                (scales[j] if stacked else scales).copy_(sc)
            m = shard_leaf(m, slab_axes, mesh)
            if out is None:
                out = torch.empty(lead + tuple(m.shape), dtype=m.dtype, device=device)
            (out[j] if stacked else out).copy_(m)
            del m
        if scales is not None:
            quant_out[name + "_s"] = scales
        return out

    def const(shape, leaf_axes, value):
        full = torch.full(shape, value, dtype=cfg.dtype, device=device)
        return shard_leaf(full, leaf_axes, mesh)

    shapes = param_shapes(cfg)
    ls, la = shapes["layers"], axes["layers"]
    params = {
        "embed": dense("embed", shapes["embed"], cfg.hidden, axes["embed"], 1),
        "final_norm": const(shapes["final_norm"], axes["final_norm"], 1.0),
        "layers": {
            "attn_norm": const(ls["attn_norm"], la["attn_norm"], 1.0),
            "mlp_norm": const(ls["mlp_norm"], la["mlp_norm"], 1.0),
        },
    }
    for name, fan_in in (("wq", cfg.hidden), ("wk", cfg.hidden), ("wv", cfg.hidden),
                         ("wo", ls["wo"][1]), ("w_gate", cfg.hidden), ("w_up", cfg.hidden),
                         ("w_down", cfg.intermediate)):
        params["layers"][name] = dense(name, ls[name], fan_in, la[name], 0)
    if cfg.qkv_bias:
        for name in BIAS_PARAMS:
            params["layers"][name] = const(ls[name], la[name], 0.0)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense("lm_head", shapes["lm_head"], cfg.hidden, axes["lm_head"], 0)
    for name, sc in quant_out.items():
        (params["layers"] if name[:-2] in ls else params)[name] = sc
    return params


class _MmF32(torch.autograd.Function):
    """``torch.mm(x, w, out_dtype=torch.float32)`` of two operands of one
    lower-precision dtype, with a backward (autograd has no derivative for
    ``mm.dtype``): the float32 gradient is rounded once to the operands'
    dtype, and each operand's gradient is a product in that dtype (float32
    accumulation, rounded once), so no float32 copy of the LM head's
    gradient is made."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = torch.mm(g, w.t()) if ctx.needs_input_grad[0] else None
        gw = torch.mm(x.t(), g) if ctx.needs_input_grad[1] else None
        return gx, gw


def _head_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., H] @ w [H, V]`` with a float32 result that was never
    rounded to ``x.dtype``. On CUDA a bf16 product goes through cuBLAS with
    a float32 output (``torch.mm(..., out_dtype=torch.float32)``, under
    autograd through :class:`_MmF32`); on the CPU, and for float32 operands,
    the operands are widened first (exact: every bf16 value is a float32
    value)."""
    if x.is_cuda and x.dtype != torch.float32:
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            out = _MmF32.apply(x2, w)
        else:
            out = torch.mm(x2, w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


class Llama(nn.Module):
    """Llama over a JAX-oriented param tree. Its weights are frozen
    parameters and every serving forward runs under ``inference_mode``;
    ``parallel/train.py`` makes the leaves trainable and runs
    ``train_forward`` (or, on a pipeline stage, ``train_layers``) under
    autograd.

    A W8A16 tree (``ops/wquant.py``) is taken as it is: its int8 leaves
    stay int8 and their float32 ``<name>_s`` scales stay float32 (each
    checked against its weight's shape); every other leaf is cast to
    ``cfg.dtype``. Each product then dequantizes its weight to the
    activations' dtype, as the JAX ``_wmm`` does (module docstring)."""

    def __init__(self, cfg: ModelConfig, params: dict, mesh=None):
        """``mesh``: a ``ProcessMesh``; with tp > 1 or pp > 1 ``params`` holds
        this rank's shards (``parallel.sharding.shard_params`` or
        ``init_params(mesh=...)``), checked against the local shapes: under
        pp the ``L/pp`` layers of this rank's stage (module docstring). The
        sp axis is read by ``prefill_forward_sp``."""
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        tp = 1 if mesh is None else mesh.size("tp")
        self._tp = tp > 1
        self._pp = mesh is not None and mesh.size("pp") > 1
        # This stage's layers: global [layer0, layer0 + n_layers).
        self.layer0, end = stage_layers(cfg, mesh)
        self.n_layers = end - self.layer0
        for what, n in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                        ("vocab_size", cfg.vocab_size), ("intermediate", cfg.intermediate)):
            if n % tp:
                raise ValueError(f"{what}={n} must divide tp={tp}")
        # This rank's head counts and vocabulary rows.
        self.n_heads = cfg.n_heads // tp
        self.n_kv_heads = cfg.n_kv_heads // tp
        self.vocab_local = cfg.vocab_size // tp
        self.vocab_lo = (0 if mesh is None else mesh.index("tp")) * self.vocab_local
        shard_mesh = mesh if self._tp or self._pp else None
        shapes = local_shapes(param_shapes(cfg), param_logical_axes(cfg), shard_mesh)
        scale_shapes = local_shapes(w8_scale_shapes(cfg), _scale_axes(cfg), shard_mesh)

        def frozen(tree, name, shapes, scales):
            """The leaf as a frozen parameter; an int8 leaf's checked
            float32 scale goes into ``scales``."""
            t = tree[name]
            if tuple(t.shape) != tuple(shapes[name]):
                raise ValueError(f"param {name} shape {tuple(t.shape)} != expected {shapes[name]}")
            if t.dtype != torch.int8:
                return nn.Parameter(t.to(cfg.dtype), requires_grad=False)
            if name not in scale_shapes:
                raise ValueError(f"param {name} is int8, but only {sorted(scale_shapes)} quantize")
            s = tree.get(name + "_s")
            if s is None or tuple(s.shape) != scale_shapes[name]:
                raise ValueError(f"int8 param {name} needs a scale {name}_s of shape "
                                 f"{scale_shapes[name]}, got {None if s is None else tuple(s.shape)}")
            scales[name + "_s"] = nn.Parameter(s.to(torch.float32), requires_grad=False)
            return nn.Parameter(t, requires_grad=False)

        layer_scales, top_scales = {}, {}
        self.layers = nn.ParameterDict(
            {n: frozen(params["layers"], n, shapes["layers"], layer_scales) for n in layer_params(cfg)}
        )
        self.layers.update(layer_scales)
        self.embed = frozen(params, "embed", shapes, top_scales)
        self.final_norm = frozen(params, "final_norm", shapes, top_scales)
        self.lm_head = (
            None if cfg.tie_embeddings else frozen(params, "lm_head", shapes, top_scales)
        )
        self.embed_s = top_scales.get("embed_s")
        self.lm_head_s = top_scales.get("lm_head_s")
        self.register_buffer(
            "inv_freq",
            rope_frequencies(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
                             device=self.embed.device),
            persistent=False,
        )

    @property
    def weight_quant(self) -> str | None:
        """``"int8"`` for a W8A16 model, else None."""
        return "int8" if self.embed.dtype == torch.int8 else None

    def param_tree(self) -> dict:
        """The model's leaves as a param tree (the tensors themselves, not
        copies): what ``ops.wquant.quantize_params`` takes."""
        layers = dict(self.layers.items())
        tree = {"embed": self.embed, "final_norm": self.final_norm, "layers": layers}
        for name in ("lm_head", "embed_s", "lm_head_s"):
            if getattr(self, name) is not None:
                tree[name] = getattr(self, name)
        return tree

    # -- shared pieces ---------------------------------------------------

    def _whole(self, what: str) -> None:
        """Refuse a whole-model forward on a pipeline stage."""
        if self._pp:
            raise ValueError(
                f"{what} needs every layer; this model is pipeline stage "
                f"{self.mesh.index('pp')} of {self.mesh.size('pp')} (layers {self.layer0}.."
                f"{self.layer0 + self.n_layers - 1}): run it through parallel.pp_serving"
            )

    def _qkv(self, l: int, x: torch.Tensor):
        """x [B, S, H] → q [B, S, Hq, D], k/v [B, S, Hkv, D]; with
        ``qkv_bias`` the biases are added before RoPE (every forward passes
        through here)."""
        cfg, lp = self.cfg, self.layers
        B, S = x.shape[:2]
        x = copy_to(x, self.mesh, "tp")
        q = self._proj(x, "wq", l)
        k = self._proj(x, "wk", l)
        v = self._proj(x, "wv", l)
        if cfg.qkv_bias:
            q, k, v = q + lp["bq"][l], k + lp["bk"][l], v + lp["bv"][l]
        return (q.view(B, S, self.n_heads, cfg.head_dim),
                k.view(B, S, self.n_kv_heads, cfg.head_dim),
                v.view(B, S, self.n_kv_heads, cfg.head_dim))

    def _attn_out_mlp(self, l: int, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        """Residual ``wo`` projection of ``attn`` [B, S, Hq, D], then the
        SwiGLU MLP block (under tp: ``wo`` and ``w_down`` row-parallel, one
        all-reduce each)."""
        B, S = x.shape[:2]
        x = x + self._proj_reduced(attn.reshape(B, S, -1), "wo", l)
        h = copy_to(rms_norm(x, self.layers["mlp_norm"][l], self.cfg.rms_eps), self.mesh, "tp")
        gate = F.silu(self._proj(h, "w_gate", l))
        up = self._proj(h, "w_up", l)
        return x + self._proj_reduced(gate * up, "w_down", l)

    def _proj_reduced(self, x: torch.Tensor, name: str, l: int) -> torch.Tensor:
        """A row-parallel projection: without tp, ``_proj``. Under tp each
        rank's partial product (its slice of the contraction) is taken with a
        float32 result (``_head_product``; a W8A16 weight is widened to
        ``x.dtype`` and its scale applied in float32), the partials are
        summed by one all-reduce over tp, and the sum is cast to
        ``x.dtype``."""
        if not self._tp:
            return self._proj(x, name, l)
        w = self.layers[name][l]
        if w.dtype != torch.int8:
            y = _head_product(x, w)
        else:
            y = _head_product(x, w.to(x.dtype)) * self.layers[name + "_s"][l]
        return reduce_from(y, self.mesh, "tp").to(x.dtype)

    def _proj(self, x: torch.Tensor, name: str, l: int) -> torch.Tensor:
        """``x @ layers[name][l]``. An int8 weight (W8A16) is widened to
        ``x.dtype`` for the product and its per-output-channel float32 scale
        applied after it, which promotes the result to float32; it is cast
        back to ``x.dtype``, as the JAX ``_wmm`` does."""
        w = self.layers[name][l]
        if w.dtype != torch.int8:
            return torch.matmul(x, w)
        return (torch.matmul(x, w.to(x.dtype)) * self.layers[name + "_s"][l]).to(x.dtype)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """Embedding gather; an int8 table's rows are multiplied by their
        scales in float32, then cast to the model dtype (the JAX
        ``_embed_lookup``)."""
        if self._tp:
            # Vocab-parallel: this rank's rows, zeros elsewhere, summed.
            local = tokens - self.vocab_lo
            inside = (local >= 0) & (local < self.vocab_local)
            rows = self._embed_rows(torch.where(inside, local, 0))
            rows = torch.where(inside[..., None], rows, 0)
            return reduce_from(rows, self.mesh, "tp")
        return self._embed_rows(tokens)

    def _embed_rows(self, ids: torch.Tensor) -> torch.Tensor:
        if self.embed_s is None:
            return F.embedding(ids, self.embed)
        rows = self.embed[ids].float() * self.embed_s[ids][..., None]
        return rows.to(self.cfg.dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm + LM head, float32 logits from a float32-output
        product (``_head_product``). A W8A16 head widens its int8 weight to
        the model dtype for the product and multiplies by its float32
        scale, as the JAX ``_wmm`` does with ``preferred_element_type``."""
        x = copy_to(rms_norm(x, self.final_norm, self.cfg.rms_eps), self.mesh, "tp")
        if self.cfg.tie_embeddings:
            w, s = self.embed.t(), self.embed_s
        else:
            w, s = self.lm_head, self.lm_head_s
        out = _head_product(x, w) if s is None else _head_product(x, w.to(x.dtype)) * s
        if self._tp:
            # Vocab-parallel head: every rank gets the whole float32 row.
            out = gather_from(out, self.mesh, "tp", dim=-1)
        return out

    def _rope(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return apply_rope(x, positions, self.inv_freq)

    # -- forwards --------------------------------------------------------

    def train_forward(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """The training forward: float32 logits ``[B, S, V]`` of ``tokens
        [B, S]`` at absolute ``positions [B, S]``, causal self-attention
        with no cached prefix (the JAX ``causal_lm_loss``'s
        ``prefill_forward`` over an empty prefix). Under sp the tokens are
        this rank's block of the sequence (``train_layers``)."""
        self._whole("train_forward")
        return self._logits(self.train_layers(self._embed(tokens), positions))

    def train_layers(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """This model's layers (a pipeline stage's ``L/pp``) over ``x [B, S,
        H]`` at ``positions``, causal self-attention through the plain
        ``attend_prefill`` with no KV cache. Under sp ``x`` is this rank's
        block of the sequence: each layer gathers K and V over sp
        (``gather_seq``, whose backward reduce-scatters their gradients) and
        the block's queries attend over every position up to their own.
        Returns the hidden state."""
        cfg = self.cfg
        sp = self.mesh is not None and self.mesh.size("sp") > 1
        for l in range(self.n_layers):
            h = rms_norm(x, self.layers["attn_norm"][l], cfg.rms_eps)
            q, k, v = self._qkv(l, h)
            q, k = self._rope(q, positions), self._rope(k, positions)
            if sp:
                k, v = gather_seq(k, self.mesh, "sp", 1), gather_seq(v, self.mesh, "sp", 1)
            kv_end = torch.full((x.shape[0],), k.shape[1], dtype=torch.long, device=x.device)
            x = self._attn_out_mlp(l, x, attend_prefill(q, k, v, positions, kv_end))
        return x

    @torch.inference_mode()
    def prefill_forward(
        self,
        tokens: torch.Tensor,  # [B, S_new]
        positions: torch.Tensor,  # [B, S_new] absolute positions
        cached_k: torch.Tensor,  # [L, B, P_max, Hkv, D] rotated prefix, RIGHT-aligned
        cached_v: torch.Tensor,
        prefix_lengths: torch.Tensor,  # [B] valid cached tokens (<= P_max)
    ):
        """Prefill new tokens against an optional cached prefix, ragged
        prefixes right-aligned in the ``P_max`` region (front padding is
        masked). Returns ``(logits [B, S, V] f32, new_k [L, B, S, Hkv, D],
        new_v)``; the caller writes new K/V into the pool."""
        self._whole("prefill_forward")
        cfg = self.cfg
        x = self._embed(tokens)
        p_max = cached_k.shape[2]
        s_new = tokens.shape[1]
        pad = p_max - prefix_lengths
        attn_pos = positions + pad[:, None]
        kv_end = torch.full_like(prefix_lengths, p_max + s_new)
        new_k, new_v = [], []
        for l in range(cfg.n_layers):
            h = rms_norm(x, self.layers["attn_norm"][l], cfg.rms_eps)
            q, k, v = self._qkv(l, h)
            q, k = self._rope(q, positions), self._rope(k, positions)
            k_ctx = torch.cat([cached_k[l], k], dim=1)
            v_ctx = torch.cat([cached_v[l], v], dim=1)
            attn = attend_prefill(q, k_ctx, v_ctx, attn_pos, kv_end, kv_start=pad)
            x = self._attn_out_mlp(l, x, attn)
            new_k.append(k)
            new_v.append(v)
        return self._logits(x), torch.stack(new_k), torch.stack(new_v)

    @torch.inference_mode()
    def prefill_chunk_paged(
        self,
        tokens: torch.Tensor,  # [B, C] one chunk (tail-padded)
        positions: torch.Tensor,  # [B, C] absolute positions
        kv_pool: torch.Tensor,  # [2, L, Hkv, num_slots, D] — written in place
        slots: torch.Tensor,  # [B, C] pool slot per chunk token (pad → scratch)
        page_table: torch.Tensor,  # [B, max_pages] int32
        kv_lengths: torch.Tensor,  # [B] int32 context valid after this chunk
        page_size: int = 16,
        kv_scale: torch.Tensor | None = None,  # [2, L, Hkv, num_slots] int8 pool
    ) -> torch.Tensor:
        """One chunk of prefill against the paged pool: prior context
        streams from pool pages through the chunk kernel, the chunk's own
        K/V rides dense. Returns ``logits [B, C, V]`` (f32); the chunk's
        K/V (and for int8 pools its scales) lands in the pool at
        ``slots``."""
        self._whole("prefill_chunk_paged")
        x = self._embed(tokens)
        return self._logits(self._chunk_layers(x, positions, kv_pool, slots, page_table, kv_lengths,
                                               page_size, kv_scale))

    def _chunk_layers(self, x, positions, kv_pool, slots, page_table, kv_lengths, page_size, kv_scale):
        """This model's layers over one chunk's hidden state ``x [B, C, H]``
        (``prefill_chunk_paged``'s arguments; under pp, a stage's layers over
        one microbatch): each layer attends through the chunk kernel and
        writes the chunk's K/V into its pool layer. Returns the hidden
        state."""
        cfg = self.cfg
        L, Hkv, D = self.n_layers, self.n_kv_heads, cfg.head_dim
        num_slots = kv_pool.shape[3]
        P = num_slots // page_size
        kv_pages = kv_pool.view(2, L, Hkv, P, page_size, D)
        scale_pages = None if kv_scale is None else kv_scale.view(2, L, Hkv, P, page_size)
        # Pool tokens BEFORE this chunk. Exhausted rows carry clipped
        # positions; their outputs are discarded and stay finite.
        prior = torch.minimum(positions[:, 0], kv_lengths).to(torch.int32)
        kv_lengths = kv_lengths.to(torch.int32)
        flat_slots = slots.reshape(-1).long()
        B, C = x.shape[:2]
        for l in range(L):
            h = rms_norm(x, self.layers["attn_norm"][l], cfg.rms_eps)
            q, k, v = self._qkv(l, h)
            q, k = self._rope(q, positions), self._rope(k, positions)
            if kv_scale is not None:
                k_st, v_st, k_sc, v_sc, k, v = quantize_for_store(k, v)
            else:
                k, v = k.to(kv_pool.dtype).contiguous(), v.to(kv_pool.dtype).contiguous()
                k_st, v_st = k, v
            attn = paged_chunk_attention(
                q.contiguous(), k, v, kv_pages, page_table, prior, kv_lengths, l, scale_pages
            )
            # In-place chunk write for this layer ([Hkv, B*C, D] at slots).
            kv_pool[0, l][:, flat_slots] = k_st.reshape(B * C, Hkv, D).transpose(0, 1)
            kv_pool[1, l][:, flat_slots] = v_st.reshape(B * C, Hkv, D).transpose(0, 1)
            if kv_scale is not None:
                kv_scale[0, l][:, flat_slots] = k_sc.reshape(B * C, Hkv).transpose(0, 1)
                kv_scale[1, l][:, flat_slots] = v_sc.reshape(B * C, Hkv).transpose(0, 1)
            x = self._attn_out_mlp(l, x, attn)
        return x

    @torch.inference_mode()
    def decode_step(
        self,
        tokens: torch.Tensor,  # [B] current token per row
        kv_pool: torch.Tensor,  # [2, L, Hkv, num_slots, D] — written in place
        slots: torch.Tensor,  # [B] int32 pool slot for this token's K/V
        page_table: torch.Tensor,  # [B, max_pages] int32
        lengths: torch.Tensor,  # [B] int32 context length incl. this token
        page_size: int = 16,
        kv_scale: torch.Tensor | None = None,  # [2, L, Hkv, num_slots] int8 pool
    ) -> torch.Tensor:
        """One decode step for a continuous batch: each layer's fused
        kernel writes this token's K/V (quantized, for int8 pools) into the
        pool and attends over the row's pages. Returns ``logits [B, V]``
        (f32)."""
        self._whole("decode_step")
        x = self._embed(tokens)[:, None, :]  # [B, 1, H]
        x = self._decode_layers(x, kv_pool, slots, page_table, lengths, page_size, kv_scale)
        return self._logits(x)[:, 0]

    def _decode_layers(self, x, kv_pool, slots, page_table, lengths, page_size, kv_scale):
        """This model's layers over one decode token per row, ``x [B, 1, H]``
        (``decode_step``'s arguments; under pp, a stage's layers over one
        microbatch): each layer's decode kernel writes the row's K/V into
        its pool layer and attends. Returns the hidden state."""
        cfg = self.cfg
        L, Hkv, D = self.n_layers, self.n_kv_heads, cfg.head_dim
        num_slots = kv_pool.shape[3]
        P = num_slots // page_size
        kv_pages = kv_pool.view(2, L, Hkv, P, page_size, D)
        scale_pages = None if kv_scale is None else kv_scale.view(2, L, Hkv, P, page_size)
        positions = (lengths.long() - 1)[:, None]  # [B, 1]
        for l in range(L):
            h = rms_norm(x, self.layers["attn_norm"][l], cfg.rms_eps)
            q, k, v = self._qkv(l, h)
            q, k = self._rope(q, positions), self._rope(k, positions)
            # The raw row in the model dtype: the kernel stores it (int8
            # pools: quantizes it first).
            qkv = (q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous())
            attn = paged_decode_attention(
                *qkv, kv_pages, slots, page_table, lengths, l, scale_pages,
            )
            x = self._attn_out_mlp(l, x, attn[:, None])
        return x

    @torch.inference_mode()
    def decode_multi(
        self,
        tokens: torch.Tensor,  # [B] current token per row
        kv_pool: torch.Tensor,  # [2, L, Hkv, num_slots, D] — written in place
        page_table: torch.Tensor,  # [B, max_pages] int32, pages provisioned k ahead
        lengths: torch.Tensor,  # [B] int32 context incl. the first fed token
        generator: torch.Generator | None,
        temperatures,  # [B] host array (a tensor costs one sync to decide greedy)
        top_ps,  # [B]
        page_size: int = 16,
        k_steps: int = 8,
        kv_scale: torch.Tensor | None = None,
        top_ks=0,  # [B] (0 = off)
    ) -> torch.Tensor:
        """``k_steps`` decode steps in one call: step ``i`` feeds the token
        sampled at step ``i - 1`` at position ``lengths + i - 1``, its slot
        derived on the device from the page table, which must cover
        positions ``lengths - 1 .. lengths + k - 2`` of every row. Sampling
        stays on the device, so the host syncs once, on the result: the
        sampled tokens ``[k, B]`` (int64). Stop tokens and budgets are the
        caller's: tokens past a row's stop are surplus. The decode kernel
        runs ``n_layers`` times per step, in stream order, so each step's
        writes land before the next step reads them."""
        self._whole("decode_multi")
        B = tokens.shape[0]
        rows = torch.arange(B, device=tokens.device)
        lengths = lengths.to(torch.int32)
        pt = page_table.long()
        stochastic = any_stochastic(temperatures)
        if stochastic:
            params = sampling_tensors((B,), tokens.device, temperatures, top_ks, top_ps)
        toks, out = tokens, []
        for i in range(k_steps):
            lens = lengths + i
            pos = (lens - 1).long()
            slots = (pt[rows, pos // page_size] * page_size + pos % page_size).to(torch.int32)
            logits = self.decode_step(toks, kv_pool, slots, page_table, lens, page_size, kv_scale)
            toks = sample_stochastic(logits, generator, *params) if stochastic else logits.argmax(-1)
            out.append(toks)
        return torch.stack(out)

    @torch.inference_mode()
    def decode_multi_compact(
        self,
        tokens: torch.Tensor,  # [B]
        kv_pool: torch.Tensor,  # [2, L, Hkv, num_slots, D] — written in place
        compact_pages: torch.Tensor,  # [n_c] unique pool page ids (pad = scratch page)
        page_table_c: torch.Tensor,  # [B, maxp] int32 indices into compact_pages
        lengths: torch.Tensor,  # [B] int32 context incl. the first fed token
        generator: torch.Generator | None,
        temperatures,
        top_ps,
        page_size: int = 16,
        k_steps: int = 8,
        kv_scale: torch.Tensor | None = None,
        top_ks=0,
    ) -> torch.Tensor:
        """``decode_multi`` over a compact working set: the pages named by
        ``compact_pages`` (and their int8 scales) are gathered into a
        sub-pool of ``n_c`` pages, the steps run over it with
        ``page_table_c`` (the decode kernel takes the pool's page count
        from the tensor), and the pages are scattered back once.

        Contract (the JAX package's): ``compact_pages`` entries are unique
        except for padding, which duplicates the engine's scratch page —
        the one page whose contents are never read unmasked, so the
        scatter's duplicate targets may land in any order there and only
        there. ``page_table_c`` maps every row's pages, and inactive rows
        entirely, to compact indices. Returns the sampled tokens
        ``[k, B]``."""
        self._whole("decode_multi_compact")
        cfg = self.cfg
        L, Hkv, D = cfg.n_layers, self.n_kv_heads, cfg.head_dim
        P = kv_pool.shape[3] // page_size
        n_c = compact_pages.shape[0]
        idx = compact_pages.long()
        pages = kv_pool.view(2, L, Hkv, P, page_size, D)
        sub_pool = pages[:, :, :, idx].reshape(2, L, Hkv, n_c * page_size, D)
        sub_scale = scale_pages = None
        if kv_scale is not None:
            scale_pages = kv_scale.view(2, L, Hkv, P, page_size)
            sub_scale = scale_pages[:, :, :, idx].reshape(2, L, Hkv, n_c * page_size)
        sampled = self.decode_multi(
            tokens, sub_pool, page_table_c, lengths, generator, temperatures, top_ps,
            page_size=page_size, k_steps=k_steps, kv_scale=sub_scale, top_ks=top_ks,
        )
        pages[:, :, :, idx] = sub_pool.view(2, L, Hkv, n_c, page_size, D)
        if kv_scale is not None:
            scale_pages[:, :, :, idx] = sub_scale.view(2, L, Hkv, n_c, page_size)
        return sampled

    @torch.inference_mode()
    def prefill_forward_sp(
        self,
        tokens: torch.Tensor,  # [B, S] the whole prompt; S divisible by the sp axis size
        positions: torch.Tensor,  # [B, S]
        mesh=None,
        axis: str = "sp",
        logits_at: torch.Tensor | None = None,  # [B] one position per row, or None
    ):
        """Sequence-parallel prefill (the JAX ``prefill_forward_sp``): rank
        ``i`` of the ``axis`` ranks runs sequence block ``i`` through every
        layer, attention by ring attention between the blocks; everything
        outside attention is token-local. ``mesh`` defaults to the model's
        (tp composes: each rank holds its heads of its block).

        Returns ``(logits, new_k [L, B, S/n, Hkv, D], new_v)``, K/V this
        rank's sequence block (the caller gathers them into the pool).
        Logits are this block's ``[B, S/n, V]`` — unless ``logits_at`` gives
        one position per row: then only those rows reach the LM head (the
        row's owner contributes it through one all-reduce over ``axis``) and
        every rank returns the same ``[B, 1, V]``, so a long prompt never
        materializes S x vocab."""
        self._whole("prefill_forward_sp")
        cfg = self.cfg
        mesh = self.mesh if mesh is None else mesh
        n, i = mesh.size(axis), mesh.index(axis)
        B, S = tokens.shape
        if S % n:
            raise ValueError(f"sequence length {S} does not divide {axis}={n}")
        c = S // n
        tok, pos = tokens[:, i * c:(i + 1) * c], positions[:, i * c:(i + 1) * c]
        x = self._embed(tok)
        new_k, new_v = [], []
        for l in range(cfg.n_layers):
            h = rms_norm(x, self.layers["attn_norm"][l], cfg.rms_eps)
            q, k, v = self._qkv(l, h)
            q, k = self._rope(q, pos), self._rope(k, pos)
            attn = ring_attention(q, k, v, mesh, axis)
            x = self._attn_out_mlp(l, x, attn)
            new_k.append(k)
            new_v.append(v)
        if logits_at is not None:
            local = logits_at.long() - i * c
            mine = (local >= 0) & (local < c)
            rows = x[torch.arange(B, device=x.device), local.clamp(0, c - 1)]
            rows = all_reduce(torch.where(mine[:, None], rows, 0), mesh, axis)
            x = rows[:, None]
        return self._logits(x), torch.stack(new_k), torch.stack(new_v)
