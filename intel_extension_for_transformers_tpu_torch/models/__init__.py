from intel_extension_for_transformers_tpu_torch.models.bert import (
    BertConfig,
    BertModel,
    bert_apply,
    bert_encode,
    bert_init_params,
)
from intel_extension_for_transformers_tpu_torch.models.generation import (
    SamplingConfig,
    generate,
    generate_compiled,
    generate_stream,
)
from intel_extension_for_transformers_tpu_torch.models.llama import (
    KVCache,
    LlamaConfig,
    LlamaModel,
    init_kv_cache,
    llama_apply,
    llama_init_params,
)

__all__ = [
    "BertConfig", "BertModel", "bert_apply", "bert_encode", "bert_init_params",
    "KVCache", "LlamaConfig", "LlamaModel", "init_kv_cache", "llama_apply", "llama_init_params",
    "SamplingConfig", "generate", "generate_compiled", "generate_stream",
]
