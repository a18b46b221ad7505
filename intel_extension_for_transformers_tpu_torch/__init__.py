"""PyTorch + CUDA port of the GenAI toolkit, for NVIDIA Hopper (H100).

The JAX package `intel_extension_for_transformers_tpu` is the reference; this
package keeps its module paths and public names, so each function here has a
counterpart of the same name there. Plain tensor code is PyTorch; each kernel
the JAX package wrote in Pallas is a hand-written CUDA kernel under `csrc/`,
built with nvcc at first use (`ops/kernels.py`).

Ported so far: the RAG retrieval path (parse → chunk → INT4 BGE encode →
int4 flat index → rerank → QA prompt), INT4/INT8 Llama generation behind the
chat API and long-window scoring, the IVF index, and the model API
(`AutoModelForCausalLM` / `AutoModel` with `load_in_4bit` / `load_in_8bit`,
`save_low_bit` / `from_pretrained` of a low-bit directory, HF checkpoint
conversion). Every TPU kernel has its CUDA counterpart (K1-K7). Importing the
package imports neither jax, nor the JAX package, nor HF transformers: the
names below load on first use.
"""

__version__ = "0.1.0"

_LAZY = {
    "MixedPrecisionConfig": "intel_extension_for_transformers_tpu_torch.quantization.config",
    "RtnConfig": "intel_extension_for_transformers_tpu_torch.quantization.config",
    "GPTQConfig": "intel_extension_for_transformers_tpu_torch.quantization.config",
    "AwqConfig": "intel_extension_for_transformers_tpu_torch.quantization.config",
    "TeqConfig": "intel_extension_for_transformers_tpu_torch.quantization.config",
    "AutoRoundConfig": "intel_extension_for_transformers_tpu_torch.quantization.config",
    "SmoothQuantConfig": "intel_extension_for_transformers_tpu_torch.quantization.config",
    "StaticQuantConfig": "intel_extension_for_transformers_tpu_torch.quantization.config",
    "DynamicQuantConfig": "intel_extension_for_transformers_tpu_torch.quantization.config",
    "QuantAwareTrainingConfig": "intel_extension_for_transformers_tpu_torch.quantization.config",
    "AutoModelForCausalLM": "intel_extension_for_transformers_tpu_torch.models.auto",
    "AutoModel": "intel_extension_for_transformers_tpu_torch.models.auto",
    "AutoModelForSeq2SeqLM": "intel_extension_for_transformers_tpu_torch.models.auto",
    "OptimizedModel": "intel_extension_for_transformers_tpu_torch.models.auto",
    "build_chatbot": "intel_extension_for_transformers_tpu_torch.neural_chat.chatbot",
    "PipelineConfig": "intel_extension_for_transformers_tpu_torch.neural_chat.config",
    "GenerationConfig": "intel_extension_for_transformers_tpu_torch.neural_chat.config",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
