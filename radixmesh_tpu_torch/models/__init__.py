from radixmesh_tpu_torch.models import qwen2
from radixmesh_tpu_torch.models.convert import convert_hf_state_dict
from radixmesh_tpu_torch.models.llama import Llama, ModelConfig, init_params

# The JAX package's presets: Llama-3 and Qwen2.
_PRESETS = {
    "llama3-8b": ModelConfig.llama3_8b,
    "llama3-70b": ModelConfig.llama3_70b,
    "llama3.1-8b": ModelConfig.llama31_8b,
    "llama3.1-70b": ModelConfig.llama31_70b,
    "llama3.2-1b": ModelConfig.llama32_1b,
    "llama3.2-3b": ModelConfig.llama32_3b,
    "llama3-tiny": ModelConfig.tiny,
    "qwen2-72b": qwen2.qwen2_72b,
    "qwen2-7b": qwen2.qwen2_7b,
    "qwen2.5-14b": qwen2.qwen25_14b,
    "qwen2.5-32b": qwen2.qwen25_32b,
    "qwen2-tiny": qwen2.qwen2_tiny,
}


def get_config(name: str, **overrides) -> ModelConfig:
    """Named model presets."""
    try:
        cfg = _PRESETS[name]()
    except KeyError:
        raise ValueError(f"unknown model {name!r}; known: {sorted(_PRESETS)}")
    return cfg.replace(**overrides) if overrides else cfg


__all__ = ["Llama", "ModelConfig", "init_params", "get_config", "convert_hf_state_dict"]
