from intel_extension_for_transformers_tpu_torch.models.bert import (
    BertConfig,
    BertModel,
    bert_apply,
    bert_config_from_hf,
    bert_encode,
    bert_init_params,
)
from intel_extension_for_transformers_tpu_torch.models.engine import DecodeEngine, EngineRequest
from intel_extension_for_transformers_tpu_torch.models.generation import (
    SamplingConfig,
    generate,
    generate_beam,
    generate_compiled,
    generate_stream,
)
from intel_extension_for_transformers_tpu_torch.models.llama import (
    KVCache,
    LlamaConfig,
    LlamaModel,
    init_kv_cache,
    llama_apply,
    llama_config_from_hf,
    llama_init_params,
)

# the model API and the HF converters pull in quantization and the bridge:
# loaded on first use
_LAZY = {
    "AutoModelForCausalLM": "intel_extension_for_transformers_tpu_torch.models.auto",
    "AutoModel": "intel_extension_for_transformers_tpu_torch.models.auto",
    "OptimizedModel": "intel_extension_for_transformers_tpu_torch.models.auto",
    "CausalLM": "intel_extension_for_transformers_tpu_torch.models.auto",
    "EncoderModel": "intel_extension_for_transformers_tpu_torch.models.auto",
    "llama_params_from_hf": "intel_extension_for_transformers_tpu_torch.models.hf_convert",
    "bert_params_from_hf": "intel_extension_for_transformers_tpu_torch.models.hf_convert",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


__all__ = [
    "BertConfig", "BertModel", "bert_apply", "bert_config_from_hf", "bert_encode", "bert_init_params",
    "KVCache", "LlamaConfig", "LlamaModel", "init_kv_cache", "llama_apply", "llama_config_from_hf",
    "llama_init_params", "DecodeEngine", "EngineRequest", "SamplingConfig", "generate", "generate_beam",
    "generate_compiled", "generate_stream",
    *_LAZY,
]
