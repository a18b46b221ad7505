from intel_extension_for_transformers_tpu_torch.ops.packing import (
    QuantizedTensor,
    dequantize,
    pack_int4,
    quantize_groupwise,
    unpack_int4,
)
from intel_extension_for_transformers_tpu_torch.ops.quant_matmul import (
    WOQLinear,
    woq_linear,
    woq_matmul,
    woq_matmul_ref,
)
from intel_extension_for_transformers_tpu_torch.ops.scan_topk import (
    scan_top2,
    scan_topk_candidates,
)

__all__ = [
    "QuantizedTensor",
    "dequantize",
    "pack_int4",
    "quantize_groupwise",
    "unpack_int4",
    "WOQLinear",
    "woq_linear",
    "woq_matmul",
    "woq_matmul_ref",
    "scan_top2",
    "scan_topk_candidates",
]
