"""Qwen2 model family (the JAX package's ``models/qwen2.py``): the Llama
architecture with QKV biases (``qkv_bias``) and its own dimensions, so the
forwards are ``models/llama.py``'s; only the configs differ. Fields as the
JAX presets, which follow the models' HF configs."""

from __future__ import annotations

from radixmesh_tpu_torch.models.llama import ModelConfig

__all__ = ["qwen2_72b", "qwen2_7b", "qwen25_14b", "qwen25_32b", "qwen2_tiny"]


def qwen2_72b() -> ModelConfig:
    return ModelConfig(
        vocab_size=152064,
        hidden=8192,
        n_layers=80,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        intermediate=29568,
        rope_theta=1000000.0,
        rms_eps=1e-6,
        qkv_bias=True,
        max_seq_len=32768,
    )


def qwen2_7b() -> ModelConfig:
    """Qwen2-7B: 28 query heads over 4 kv heads (GQA group 7)."""
    return ModelConfig(
        vocab_size=152064,
        hidden=3584,
        n_layers=28,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        intermediate=18944,
        rope_theta=1000000.0,
        rms_eps=1e-6,
        qkv_bias=True,
        max_seq_len=32768,
    )


def qwen25_14b() -> ModelConfig:
    """Qwen2.5 shares the Qwen2 architecture (QKV biases, rope theta 1e6).
    Its 14B and 32B sizes use rms_norm_eps 1e-5 in their HF configs, unlike
    the 7B and 72B sizes' 1e-6. GQA group 5."""
    return ModelConfig(
        vocab_size=152064,
        hidden=5120,
        n_layers=48,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        intermediate=13824,
        rope_theta=1000000.0,
        rms_eps=1e-5,
        qkv_bias=True,
        max_seq_len=32768,
    )


def qwen25_32b() -> ModelConfig:
    return qwen25_14b().replace(n_layers=64, intermediate=27648)


def qwen2_tiny() -> ModelConfig:
    """Test config: the Qwen2 architecture at toy dims."""
    return ModelConfig(
        vocab_size=512,
        hidden=128,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        intermediate=256,
        rope_theta=1000000.0,
        rms_eps=1e-6,
        qkv_bias=True,
        max_seq_len=512,
    )
