"""build_chatbot / optimize_model — the chat framework API.

Port of `intel_extension_for_transformers_tpu/neural_chat/chatbot.py`:
adapter dispatch by model name, plugin registration, model loading, and the
latest-error reporting. The retrieval plugin is the port's `RetrievalAgent`,
built from a preloaded `embedder` (or passed prebuilt as `agent`). The other plugins of `KNOWN_PLUGINS`
(cache, safety_checker, memory, ner, image2image, asr, tts) live in the JAX
package's `chat_plugins.py`, which is not ported yet: enabling one raises
`NotImplementedError`. `finetune_model` is not ported yet.
"""

from __future__ import annotations

import logging
from typing import Optional

import intel_extension_for_transformers_tpu_torch.neural_chat.adapters  # noqa: F401 — registers adapters
from intel_extension_for_transformers_tpu_torch.neural_chat.base_model import (
    BaseModel,
    get_model_adapter,
)
from intel_extension_for_transformers_tpu_torch.neural_chat.config import PipelineConfig
from intel_extension_for_transformers_tpu_torch.neural_chat.plugins import plugins
from intel_extension_for_transformers_tpu_torch.utils.error_utils import (
    clear_latest_error,
    set_latest_error,
)
from intel_extension_for_transformers_tpu_torch.utils.errorcode import ErrorCodes

logger = logging.getLogger(__name__)

KNOWN_PLUGINS = (
    "cache",
    "safety_checker",
    "retrieval",
    "memory",
    "ner",
    "image2image",
    "asr",
    "tts",
)


def build_chatbot(config: Optional[PipelineConfig] = None) -> Optional[BaseModel]:
    """Create a chatbot. Returns None and sets the latest error code on
    failure, as the JAX package does."""
    clear_latest_error()
    config = config or PipelineConfig()

    adapter = get_model_adapter(config.model_name_or_path)

    for name, args in (config.plugins or {}).items():
        if name not in KNOWN_PLUGINS:
            set_latest_error(ErrorCodes.ERROR_PLUGIN_NOT_SUPPORTED)
            logger.error("unsupported plugin %r", name)
            return None
        plugin_args = dict(args or {})
        if not plugin_args.pop("enable", True):
            continue
        if name != "retrieval":
            raise NotImplementedError(
                f"the {name!r} plugin (neural_chat/chat_plugins.py) is not ported yet "
                "(ROADMAP queue 1, step 1)"
            )
        _build_retrieval_plugin(plugin_args)

    try:
        adapter.load_model(
            {
                "model_name_or_path": config.model_name_or_path,
                "loading_config": config.loading_config,
                "generation_config": config.generation_config,
            }
        )
    except MemoryError:
        set_latest_error(ErrorCodes.ERROR_OUT_OF_MEMORY)
        return None
    return adapter


def _build_retrieval_plugin(args: dict) -> None:
    """Wire the RAG agent in as the 'retrieval' plugin instance: a prebuilt
    `agent`, or a `RetrievalAgent` over a preloaded `embedder` and the
    remaining arguments."""
    from intel_extension_for_transformers_tpu_torch.retrieval.agent import RetrievalAgent

    agent = args.pop("agent", None)
    if agent is None:
        embedder = args.pop("embedder", None)
        if embedder is None:
            raise NotImplementedError(
                "loading an embedding model by name is not ported yet (ROADMAP queue 1, "
                "step 1): pass a preloaded `embedder` or `agent`"
            )
        agent = RetrievalAgent(embedder, args.pop("input_path", None), **args)
    plugins.setdefault(
        "retrieval", {"enable": True, "class": None, "args": {}, "instance": None}
    )
    plugins["retrieval"]["enable"] = True
    plugins["retrieval"]["instance"] = agent


def optimize_model(model, optimization_config):
    """Quantize `model` in place with `optimization_config`; returns it."""
    from intel_extension_for_transformers_tpu_torch.quantization import quantize_model

    return quantize_model(model, optimization_config).params
