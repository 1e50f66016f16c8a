from radixmesh_tpu_torch.models.llama import Llama, ModelConfig, init_params

# Llama-3 presets (the Qwen2 presets of the JAX package are not ported yet).
_PRESETS = {
    "llama3-8b": ModelConfig.llama3_8b,
    "llama3-70b": ModelConfig.llama3_70b,
    "llama3.1-8b": ModelConfig.llama31_8b,
    "llama3.1-70b": ModelConfig.llama31_70b,
    "llama3.2-1b": ModelConfig.llama32_1b,
    "llama3.2-3b": ModelConfig.llama32_3b,
    "llama3-tiny": ModelConfig.tiny,
}


def get_config(name: str, **overrides) -> ModelConfig:
    """Named model presets."""
    try:
        cfg = _PRESETS[name]()
    except KeyError:
        raise ValueError(f"unknown model {name!r}; known: {sorted(_PRESETS)}")
    return cfg.replace(**overrides) if overrides else cfg


__all__ = ["Llama", "ModelConfig", "init_params", "get_config"]
