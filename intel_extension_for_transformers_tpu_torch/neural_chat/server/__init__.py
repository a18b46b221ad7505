from intel_extension_for_transformers_tpu_torch.neural_chat.server.neuralchat_client import (
    TextChatClientExecutor,
)
from intel_extension_for_transformers_tpu_torch.neural_chat.server.neuralchat_server import (
    ChatApp,
    NeuralChatServerExecutor,
    make_server,
)

__all__ = [
    "ChatApp",
    "NeuralChatServerExecutor",
    "TextChatClientExecutor",
    "make_server",
]
