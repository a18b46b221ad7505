from intel_extension_for_transformers_tpu_torch.quantization.config import (
    AutoRoundConfig,
    AwqConfig,
    DynamicQuantConfig,
    GPTQConfig,
    MixedPrecisionConfig,
    QuantAwareTrainingConfig,
    QuantizationConfigMixin,
    RtnConfig,
    SmoothQuantConfig,
    StaticQuantConfig,
    TeqConfig,
    config_from_dict,
)
from intel_extension_for_transformers_tpu_torch.quantization.quantize import (
    QuantizedParams,
    default_is_quantizable,
    quantize_model,
)

# save_load goes through the bridge, which imports the models and indexes:
# loaded on first use
_LAZY = {
    "save_low_bit": "intel_extension_for_transformers_tpu_torch.quantization.save_load",
    "load_low_bit": "intel_extension_for_transformers_tpu_torch.quantization.save_load",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


__all__ = [
    "QuantizationConfigMixin",
    "MixedPrecisionConfig",
    "RtnConfig",
    "GPTQConfig",
    "AwqConfig",
    "TeqConfig",
    "AutoRoundConfig",
    "SmoothQuantConfig",
    "StaticQuantConfig",
    "DynamicQuantConfig",
    "QuantAwareTrainingConfig",
    "config_from_dict",
    "QuantizedParams",
    "default_is_quantizable",
    "quantize_model",
    "save_low_bit",
    "load_low_bit",
]
