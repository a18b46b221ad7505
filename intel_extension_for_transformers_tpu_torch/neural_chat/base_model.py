"""BaseModel: the chat inference core with the plugin hook protocol.

Port of `intel_extension_for_transformers_tpu/neural_chat/base_model.py`.
`predict` / `predict_stream` run the plugin pre-hooks (cache → asr →
retrieval → safety), template the prompt per model family, generate with
`generate_stream`, detokenize with `detokenize_stream`, then run the
post-hooks. A model is a (model, model_config, tokenizer) triple whose model
is a `LlamaModel` on its device; `load_model` takes it `preloaded`, or loads
an HF Llama-family checkpoint by name or path (`models/auto.py::_load_hf`,
converted by `hf_convert.llama_params_from_hf` onto the card unless
`device` names another, with its HF tokenizer), and applies
`optimization_config` through `quantize_model`.

Generation takes one of three branches, as in the JAX package: beam search
(`num_beams > 1` without sampling; the stream is the final ids),
speculative decoding when the chatbot carries an assistant (draft) model
and no `kv_policy`, else `generate_stream`, with the chatbot's `kv_policy`
(H2O or attention sinks) if set. The assistant comes from
`LoadingModelConfig.assistant_model`: a (model, config) pair, or a
checkpoint name or path loaded like the chat model. Not ported yet, and
raising `NotImplementedError`: sharding over several cards, ROADMAP queue 1
step 7.
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


def chat_device(device: Optional[str]):
    """`PipelineConfig.device` for `resolve_device`: "cuda" (the default)
    and None ask for the card, which raises without one."""
    return None if device in (None, "cuda") else device


class BaseModel:
    def __init__(self, model_name: str = ""):
        self.model_name = model_name
        self.params = None  # the LlamaModel (the JAX package's params tree)
        self.model_config = None
        self.tokenizer = None
        self.generation_config = GenerationConfig()
        self.conv_template = None
        self.kv_policy = None  # an H2OKVPolicy or AttentionSinkKVPolicy for generate_stream
        self.assistant = None  # the (model, config) draft for speculative decoding
        self.spec_k = 4

    # -- loading ---------------------------------------------------------
    def load_model(self, kwargs: dict) -> None:
        """kwargs: model_name_or_path, loading_config, generation_config and
        device (`PipelineConfig.device`, where a checkpoint is loaded)."""
        self.model_name = kwargs.get("model_name_or_path", self.model_name)
        loading: LoadingModelConfig = kwargs.get("loading_config") or LoadingModelConfig()
        self.generation_config = kwargs.get("generation_config") or GenerationConfig()

        if loading.tensor_parallel > 1 or loading.world_size > 1:
            raise NotImplementedError("sharding a chat model is not ported yet (ROADMAP queue 1, step 7)")
        if loading.preloaded is not None:
            self.params, self.model_config, self.tokenizer = loading.preloaded
        else:
            from intel_extension_for_transformers_tpu_torch.models.auto import _load_hf

            self.params, self.model_config = self._load_causal_lm(self.model_name, kwargs.get("device"))
            self.tokenizer = _load_hf(self.model_name, "AutoTokenizer")
        if loading.optimization_config is not None:
            self.params = self.optimize(loading.optimization_config)

        # the speculative-decoding draft: a (model, config) pair, or a checkpoint
        self.spec_k = loading.spec_k
        self.assistant = None
        if isinstance(loading.assistant_model, tuple):
            self.assistant = loading.assistant_model
        elif loading.assistant_model is not None:
            self.assistant = self._load_causal_lm(loading.assistant_model, kwargs.get("device"))
        self.conv_template = get_conv_template(self.model_name)

    @staticmethod
    def _load_causal_lm(name: str, device):
        """An HF Llama-family checkpoint by name or path → (LlamaModel, LlamaConfig)."""
        from intel_extension_for_transformers_tpu_torch.models.auto import _load_hf
        from intel_extension_for_transformers_tpu_torch.models.hf_convert import llama_params_from_hf

        try:
            hf = _load_hf(name, "AutoModelForCausalLM")
        except (OSError, ValueError) as e:
            set_latest_error(ErrorCodes.ERROR_MODEL_NOT_FOUND)
            raise ValueError(f"failed to load model {name!r}: {e}") from e
        return llama_params_from_hf(hf, device=chat_device(device))

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

        from intel_extension_for_transformers_tpu_torch.models.generation import detokenize_stream

        ids = self._encode_prompt(prompt)
        try:
            token_iter = self._token_iter(ids, config)
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

    def _token_iter(self, ids: np.ndarray, config: GenerationConfig) -> Iterator[np.ndarray]:
        """(1,) token ids one at a time: beam search (the final ids), the
        assistant's speculative rounds, or the plain stream (with the
        chatbot's kv_policy)."""
        from intel_extension_for_transformers_tpu_torch.models import generation, speculative

        sampling = config.to_sampling_config(self._eos_id)
        if getattr(config, "num_beams", 1) > 1 and not config.do_sample:
            beam_ids, _ = generation.generate_beam(
                self.params, self.model_config, ids, num_beams=config.num_beams,
                max_new_tokens=config.max_new_tokens, eos_token_id=self._eos_id,
            )
            return (np.asarray([t], np.int32) for t in beam_ids)
        if self.assistant is not None and self.kv_policy is None:
            d_model, d_config = self.assistant
            chunks = speculative.generate_speculative_stream(
                self.params, self.model_config, d_model, d_config, ids, sampling,
                spec_k=self.spec_k, seed=config.seed,
            )
            return (np.asarray([t], np.int32) for chunk in chunks for t in chunk.reshape(-1))
        return generation.generate_stream(
            self.params, self.model_config, ids, sampling,
            max_cache_length=config.cache_max_length, seed=config.seed, kv_policy=self.kv_policy,
        )


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
