"""Model-level quantization: swap float linear layers for packed low-bit ones.

Port of the RTN path of `intel_extension_for_transformers_tpu/quantization/
quantize.py`. The JAX package maps a params pytree to a new one whose
eligible leaves are `QuantizedTensor`s; here every eligible `nn.Linear` of
the module is replaced, in place, by a `WOQLinear` holding
`quantize_groupwise(weight.T)`. Eligibility is decided on the same path
strings the JAX package builds ("layers/0/attention/query/kernel"), so both
packages quantize the same layers. GPTQ, AWQ, TEQ, AutoRound and W8A8 are not
ported yet.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch
from torch import nn

from intel_extension_for_transformers_tpu_torch.ops.packing import quantize_groupwise
from intel_extension_for_transformers_tpu_torch.ops.quant_matmul import WOQLinear
from intel_extension_for_transformers_tpu_torch.quantization.config import (
    QuantizationConfigMixin,
    RtnConfig,
)

logger = logging.getLogger(__name__)

# Below this element count a weight stays float: packing overhead dominates
# and tiny layers hurt accuracy.
MIN_QUANT_SIZE = 64 * 64


def default_is_quantizable(path: str, leaf: torch.Tensor) -> bool:
    if leaf.ndim != 2:
        return False
    if leaf.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        return False
    if leaf.numel() < MIN_QUANT_SIZE:
        return False
    # embedding tables are gathered, not matmul'd; skip by name
    if re.search(
        r"embed|embedding|position|pos_emb|token_type|shared|rel_bias", path, re.I
    ):
        return False
    return True


@dataclass
class QuantizedParams:
    """The quantized model + the config that produced it."""

    params: Any
    config: QuantizationConfigMixin
    quantized_paths: list = field(default_factory=list)


def quantize_model(
    model: nn.Module,
    config: QuantizationConfigMixin,
    *,
    is_quantizable: Optional[Callable[[str, Any], bool]] = None,
) -> QuantizedParams:
    """Quantize every eligible linear layer of `model` in place (RTN).

    Returns `QuantizedParams(model, config, quantized_paths)`, as the JAX
    package returns the new params tree.
    """
    if not isinstance(config, RtnConfig):
        raise NotImplementedError(f"{type(config).__name__} is not ported; use RtnConfig")
    is_quantizable = is_quantizable or default_is_quantizable
    skip = tuple(config.modules_to_not_convert or [])
    quantized_paths = []
    # names, not modules: a replaced layer's float weight is freed as its
    # packed copy lands, so the peak stays near the float model's size
    names = [name for name, m in model.named_modules() if isinstance(m, nn.Linear)]
    for name in names:
        linear = model.get_submodule(name)
        p = name.replace(".", "/") + "/kernel"
        if any(s in p for s in skip) or not is_quantizable(p, linear.weight):
            continue
        K = linear.in_features
        gs = min(config.group_size, K)
        bad = K % gs != 0
        if config.weight_dtype != "int8":
            bad = bad or K % 2 != 0 or (K // 2) % gs != 0
        if bad:
            logger.info("skipping %s: K=%d incompatible with group_size=%d", p, K, gs)
            continue
        with torch.no_grad():
            qt = quantize_groupwise(
                linear.weight.T.to(torch.float32),
                weight_dtype=config.weight_dtype,
                scheme=config.scheme,
                group_size=gs,
                scale_dtype=getattr(torch, config.scale_dtype),
            )
            bias = None if linear.bias is None else linear.bias.detach().clone()
        parent_name, _, attr = name.rpartition(".")
        setattr(model.get_submodule(parent_name), attr, WOQLinear(qt, bias))
        quantized_paths.append(p)
    return QuantizedParams(model, config, quantized_paths)
