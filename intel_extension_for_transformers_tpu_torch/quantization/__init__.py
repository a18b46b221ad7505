from intel_extension_for_transformers_tpu_torch.quantization.config import (
    QuantizationConfigMixin,
    RtnConfig,
)
from intel_extension_for_transformers_tpu_torch.quantization.quantize import (
    QuantizedParams,
    default_is_quantizable,
    quantize_model,
)

__all__ = [
    "QuantizationConfigMixin",
    "RtnConfig",
    "QuantizedParams",
    "default_is_quantizable",
    "quantize_model",
]
