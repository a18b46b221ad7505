"""Quantization configs: the base mixin and RTN.

Port of the part of `intel_extension_for_transformers_tpu/quantization/
config.py` that the RTN path needs, with the same fields and validation.
Serialization (for `save_low_bit`) and the GPTQ, AWQ, TEQ, AutoRound,
SmoothQuant and W8A8 configs are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from intel_extension_for_transformers_tpu_torch.ops.packing import WEIGHT_DTYPES


@dataclass
class QuantizationConfigMixin:
    """Base config: weight dtype, scheme, group size, modules kept in float."""

    compute_dtype: Optional[str] = None
    weight_dtype: str = "int4"
    scale_dtype: str = "float32"
    group_size: int = 128
    scheme: str = "sym"
    # modules kept in high precision, matched by substring against the
    # parameter path ("layers/0/attention/query/kernel")
    modules_to_not_convert: list = field(default_factory=lambda: ["lm_head"])

    quant_method = "base"

    def post_init(self):
        if self.compute_dtype is None:
            self.compute_dtype = "bfloat16"
        if self.compute_dtype not in ("float32", "bfloat16", "float16"):
            raise ValueError(f"unsupported compute_dtype {self.compute_dtype}")
        wd = {"int4_fullrange": "int4", "int4_clip": "int4", "fp4_e2m1_bnb": "fp4"}.get(
            self.weight_dtype, self.weight_dtype
        )
        if wd not in WEIGHT_DTYPES:
            raise ValueError(
                f"unsupported weight_dtype {self.weight_dtype}; have {WEIGHT_DTYPES}"
            )
        self.weight_dtype = wd
        if self.scheme not in ("sym", "asym"):
            raise ValueError(f"scheme must be sym|asym, got {self.scheme}")
        if self.group_size <= 0:
            raise ValueError("group_size must be positive")
        return self


@dataclass
class RtnConfig(QuantizationConfigMixin):
    """Round-to-nearest weight-only quantization."""

    quant_method = "rtn"

    def __post_init__(self):
        self.post_init()
