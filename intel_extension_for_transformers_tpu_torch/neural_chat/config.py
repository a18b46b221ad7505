"""Chat framework configs.

Port of `intel_extension_for_transformers_tpu/neural_chat/config.py`:
`GenerationConfig` (with the JAX defaults: sampling at temperature 0.9,
top-k 40, top-p 0.75, repetition penalty 1.1), `LoadingModelConfig` and
`PipelineConfig`. `optimization_config` takes the port's quantization
configs. The fine-tuning config is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class GenerationConfig:
    max_new_tokens: int = 256
    temperature: float = 0.9
    top_k: int = 40
    top_p: float = 0.75
    do_sample: bool = True
    repetition_penalty: float = 1.1
    num_beams: int = 1
    bad_words_ids: Optional[List[int]] = None
    force_words_ids: Optional[List[int]] = None
    use_hpu_graphs: bool = False  # accepted for API parity; ignored
    cache_max_length: Optional[int] = None
    return_stats: bool = False
    task: str = ""
    seed: int = 0

    def to_sampling_config(self, eos_token_id: Optional[int] = None):
        from intel_extension_for_transformers_tpu_torch.models.generation import SamplingConfig

        return SamplingConfig(
            max_new_tokens=self.max_new_tokens,
            do_sample=self.do_sample,
            temperature=self.temperature,
            top_k=self.top_k,
            top_p=self.top_p,
            repetition_penalty=self.repetition_penalty,
            eos_token_id=eos_token_id,
        )


@dataclass
class LoadingModelConfig:
    """How to materialize the model."""

    optimization_config: Any = None  # quantization config (RtnConfig)
    use_cache: bool = True
    world_size: int = 1  # data-parallel degree
    tensor_parallel: int = 1  # tensor-parallel degree
    cache_dtype: str = "bfloat16"
    # preloaded (model, model_config, tokenizer): a LlamaModel on its device
    preloaded: Optional[tuple] = None
    # speculative-decoding draft: HF name/path or preloaded (model, config)
    assistant_model: Any = None
    spec_k: int = 4  # draft tokens proposed per verification round


@dataclass
class PipelineConfig:
    """What `build_chatbot` consumes."""

    model_name_or_path: str = "meta-llama/Llama-2-7b-chat-hf"
    tokenizer_name_or_path: Optional[str] = None
    device: str = "cuda"
    loading_config: LoadingModelConfig = field(default_factory=LoadingModelConfig)
    generation_config: GenerationConfig = field(default_factory=GenerationConfig)
    plugins: Dict[str, Dict] = field(default_factory=dict)
    task: str = "chat"
