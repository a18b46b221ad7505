from intel_extension_for_transformers_tpu_torch.neural_chat.chatbot import (
    build_chatbot,
    optimize_model,
)
from intel_extension_for_transformers_tpu_torch.neural_chat.config import (
    GenerationConfig,
    LoadingModelConfig,
    PipelineConfig,
)
from intel_extension_for_transformers_tpu_torch.neural_chat.plugins import plugins

__all__ = [
    "build_chatbot",
    "optimize_model",
    "GenerationConfig",
    "LoadingModelConfig",
    "PipelineConfig",
    "plugins",
]
