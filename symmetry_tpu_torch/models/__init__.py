"""Model zoo in PyTorch: the llama-family decoder (llama, mistral, qwen2,
gemma, tied embeddings) over a stacked-layer parameter dict."""

from symmetry_tpu_torch.models.llama import (
    KVCache,
    ModelConfig,
    PRESETS,
    forward,
    init_cache,
    init_params,
    preset,
)

__all__ = [
    "KVCache",
    "ModelConfig",
    "PRESETS",
    "forward",
    "init_cache",
    "init_params",
    "preset",
]
