"""BaseModel: the chat inference core with the plugin hook protocol.

Port of `intel_extension_for_transformers_tpu/neural_chat/base_model.py`.
`predict` / `predict_stream` run the plugin pre-hooks (cache → asr →
retrieval → safety), template the prompt per model family, generate with
`generate_stream`, detokenize with `detokenize_stream`, then run the
post-hooks. A model is a (model, model_config, tokenizer) triple whose model
is a `LlamaModel` on its device; `load_model` takes it `preloaded` and
applies `optimization_config` through `quantize_model`.

Not ported yet, and raising `NotImplementedError`: loading a checkpoint
(`from_pretrained`), beam search (`num_beams > 1`), an assistant model
(speculative decoding) and sharding over several cards.
"""

from __future__ import annotations

import logging
from typing import Iterator, List, Optional

import numpy as np

from intel_extension_for_transformers_tpu_torch.neural_chat.config import (
    GenerationConfig,
    LoadingModelConfig,
)
from intel_extension_for_transformers_tpu_torch.neural_chat.plugins import (
    get_plugin_instance,
    is_plugin_enabled,
)
from intel_extension_for_transformers_tpu_torch.neural_chat.prompts import get_conv_template
from intel_extension_for_transformers_tpu_torch.utils.error_utils import set_latest_error
from intel_extension_for_transformers_tpu_torch.utils.errorcode import ErrorCodes

logger = logging.getLogger(__name__)

PRE_HOOK_ORDER = ["cache", "asr", "retrieval", "safety_checker"]
POST_HOOK_ORDER = ["safety_checker", "tts"]


class BaseModel:
    def __init__(self, model_name: str = ""):
        self.model_name = model_name
        self.params = None  # the LlamaModel (the JAX package's params tree)
        self.model_config = None
        self.tokenizer = None
        self.generation_config = GenerationConfig()
        self.conv_template = None

    # -- loading ---------------------------------------------------------
    def load_model(self, kwargs: dict) -> None:
        """kwargs: model_name_or_path, loading_config, generation_config."""
        self.model_name = kwargs.get("model_name_or_path", self.model_name)
        loading: LoadingModelConfig = kwargs.get("loading_config") or LoadingModelConfig()
        self.generation_config = kwargs.get("generation_config") or GenerationConfig()

        if loading.preloaded is None:
            raise NotImplementedError(
                "loading a checkpoint (from_pretrained, hf_convert) is not ported yet "
                "(ROADMAP queue 1, step 1): pass LoadingModelConfig(preloaded=(model, config, tokenizer))"
            )
        if loading.tensor_parallel > 1 or loading.world_size > 1:
            raise NotImplementedError("sharding a chat model is not ported yet (ROADMAP queue 1, step 7)")
        if loading.assistant_model is not None:
            raise NotImplementedError(
                "speculative decoding with an assistant model is not ported yet (ROADMAP queue 1, step 1)"
            )
        self.params, self.model_config, self.tokenizer = loading.preloaded
        if loading.optimization_config is not None:
            self.params = self.optimize(loading.optimization_config)
        self.conv_template = get_conv_template(self.model_name)

    def optimize(self, optimization_config):
        from intel_extension_for_transformers_tpu_torch.quantization import quantize_model

        return quantize_model(self.params, optimization_config).params

    # -- tokenization helpers -------------------------------------------
    def _encode_prompt(self, prompt: str) -> np.ndarray:
        if hasattr(self.tokenizer, "encode"):
            ids = self.tokenizer.encode(prompt)
            if hasattr(ids, "ids"):
                ids = ids.ids
        else:
            ids = self.tokenizer(prompt)["input_ids"]
        return np.asarray([ids], np.int32)

    def _decode(self, ids: List[int]) -> str:
        return self.tokenizer.decode(ids, skip_special_tokens=True)

    @property
    def _eos_id(self) -> Optional[int]:
        return getattr(self.tokenizer, "eos_token_id", None)

    # -- hook runners ----------------------------------------------------
    def _run_pre_hooks(self, query: str):
        """→ (prompt_or_query, early_response_or_None)"""
        for name in PRE_HOOK_ORDER:
            if not is_plugin_enabled(name):
                continue
            inst = get_plugin_instance(name)
            if inst is None or not hasattr(inst, "pre_llm_inference_actions"):
                continue
            result = inst.pre_llm_inference_actions(query)
            if isinstance(result, dict) and result.get("stop_inference"):
                return query, result.get("response", "")
            if isinstance(result, str):
                query = result
        return query, None

    def _run_post_hooks(self, response: str) -> str:
        for name in POST_HOOK_ORDER:
            if not is_plugin_enabled(name):
                continue
            inst = get_plugin_instance(name)
            if inst is not None and hasattr(inst, "post_llm_inference_actions"):
                out = inst.post_llm_inference_actions(response)
                if isinstance(out, str):
                    response = out
        return response

    # -- prediction ------------------------------------------------------
    def prepare_prompt(self, query: str, task: str = "chat") -> str:
        conv = self.conv_template.copy() if self.conv_template else get_conv_template()
        conv.append_message(conv.roles[0], query)
        conv.append_message(conv.roles[1], "")
        return conv.get_prompt()

    def predict(self, query: str, config: Optional[GenerationConfig] = None) -> str:
        return "".join(self.predict_stream(query, config))

    def predict_stream(
        self, query: str, config: Optional[GenerationConfig] = None
    ) -> Iterator[str]:
        config = config or self.generation_config
        prompt, early = self._run_pre_hooks(query)
        if early is not None:
            yield self._run_post_hooks(early)
            return
        # the retrieval plugin returns a full prompt; otherwise apply the template
        if prompt == query:
            prompt = self.prepare_prompt(query, config.task)
        if getattr(config, "num_beams", 1) > 1 and not config.do_sample:
            raise NotImplementedError("beam search is not ported yet (ROADMAP queue 1, step 1)")

        from intel_extension_for_transformers_tpu_torch.models.generation import (
            detokenize_stream,
            generate_stream,
        )

        ids = self._encode_prompt(prompt)
        sampling = config.to_sampling_config(self._eos_id)
        try:
            token_iter = generate_stream(
                self.params, self.model_config, ids, sampling,
                max_cache_length=config.cache_max_length, seed=config.seed,
            )
            pieces = []
            for delta in detokenize_stream(token_iter, self.tokenizer):
                pieces.append(delta)
                yield delta
            if is_plugin_enabled("cache"):
                cache = get_plugin_instance("cache")
                if cache is not None:
                    cache.put(query, "".join(pieces))
            if is_plugin_enabled("memory"):
                mem = get_plugin_instance("memory")
                if mem is not None:
                    mem.add(query, "".join(pieces))
        except Exception:
            set_latest_error(ErrorCodes.ERROR_GENERATION_FAIL)
            logger.exception("generation failed")
            raise


# -- adapter registry -------------------------------------------------------

_MODEL_ADAPTERS: list = []


def register_model_adapter(cls) -> None:
    _MODEL_ADAPTERS.append(cls())


def get_model_adapter(model_name_or_path: str) -> BaseModel:
    low = model_name_or_path.lower()
    for adapter in _MODEL_ADAPTERS:
        if adapter.match(low):
            return type(adapter)(model_name_or_path)
    return BaseModel(model_name_or_path)
