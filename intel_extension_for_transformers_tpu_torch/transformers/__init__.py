"""Import-path facade: the reference's `...transformers` names, as far as ported.

Port of `intel_extension_for_transformers_tpu/transformers/__init__.py`,
restricted to what the port has:

    from intel_extension_for_transformers_tpu_torch.transformers import (
        AutoModelForCausalLM, BitsAndBytesConfig, RtnConfig)

`BitsAndBytesConfig` is a compatibility constructor: there is no
bitsandbytes here, so building one returns the equivalent RTN config
(`load_in_8bit` → RtnConfig("int8", g128); `load_in_4bit` → RtnConfig of
`bnb_4bit_quant_type`, nf4 by default, g128), which `from_pretrained`
takes as `quantization_config`. The facade's other names (`NLPTrainer`,
`PruningConfig`, `PrunerV2`, `BenchmarkConfig`, `metrics`, `objectives`,
`DynamicLengthConfig`, `Provider`, `AutoModelForSeq2SeqLM`) are not ported
yet (ROADMAP queue 1).
"""

from intel_extension_for_transformers_tpu_torch.models.auto import (
    AutoModel,
    AutoModelForCausalLM,
    OptimizedModel,
)
from intel_extension_for_transformers_tpu_torch.quantization.config import (
    AutoRoundConfig,
    AwqConfig,
    DynamicQuantConfig,
    GPTQConfig,
    MixedPrecisionConfig,
    QuantAwareTrainingConfig,
    RtnConfig,
    SmoothQuantConfig,
    StaticQuantConfig,
    TeqConfig,
)
from intel_extension_for_transformers_tpu_torch.quantization.save_load import WEIGHTS_NAME


class BitsAndBytesConfig:
    """Returns the RTN config equivalent to a bitsandbytes config."""

    def __new__(cls, load_in_4bit: bool = False, load_in_8bit: bool = False,
                bnb_4bit_quant_type: str = "nf4", bnb_4bit_compute_dtype=None,
                bnb_4bit_use_double_quant: bool = False, **_ignored):
        if load_in_8bit:
            return RtnConfig(weight_dtype="int8", group_size=128)
        quant_type = {"nf4": "nf4", "fp4": "fp4"}.get(bnb_4bit_quant_type, "int4")
        return RtnConfig(weight_dtype=quant_type, group_size=128)


__all__ = [
    "WEIGHTS_NAME", "MixedPrecisionConfig", "BitsAndBytesConfig", "SmoothQuantConfig",
    "StaticQuantConfig", "DynamicQuantConfig", "QuantAwareTrainingConfig", "RtnConfig",
    "AwqConfig", "TeqConfig", "GPTQConfig", "AutoRoundConfig", "AutoModelForCausalLM",
    "AutoModel", "OptimizedModel",
]
