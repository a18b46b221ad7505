"""Config type → apply function (the model registry).

Port of `intel_extension_for_transformers_tpu/models/registry.py`: every
decoder family shares the (model, config, input_ids, cache, attention_mask)
→ (logits, cache) contract, so generation, evaluation and chat stay
architecture-agnostic. The generic decoder (`models/decoder.py`) is not
ported yet.
"""

from __future__ import annotations


def get_apply_fn(config):
    from intel_extension_for_transformers_tpu_torch.models.llama import LlamaConfig, llama_apply

    if isinstance(config, LlamaConfig):
        return llama_apply
    if type(config).__name__ == "DecoderConfig":
        raise NotImplementedError(
            "the generic decoder (models/decoder.py) is not ported yet (ROADMAP queue 1, step 5)"
        )
    raise TypeError(f"no apply fn registered for {type(config).__name__}")
