"""Quantization config family.

Port of `intel_extension_for_transformers_tpu/quantization/config.py`: the
base mixin with its (de)serialization, the `QUANT_METHODS` registry and
`config_from_dict`, and every config dataclass with the same fields,
defaults and validation, so a `quantization_config.json` written by either
package reads back in the other. Only `RtnConfig` has an algorithm in the
port (`quantize_model`); a directory saved by the JAX package from a GPTQ,
AWQ or TEQ model loads all the same, since its leaves are plain packed
weights (and an AWQ/TEQ `pre_scale`, which `woq_matmul` applies).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional

from intel_extension_for_transformers_tpu_torch.ops.packing import WEIGHT_DTYPES

QUANT_METHODS = {}


def _register(name):
    def deco(cls):
        cls.quant_method = name
        QUANT_METHODS[name] = cls
        return cls

    return deco


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

    # a class attribute set by @_register, not a dataclass field
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

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["quant_method"] = self.quant_method
        return d

    def to_json_string(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def to_json_file(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json_string())

    @classmethod
    def from_dict(cls, d: dict) -> "QuantizationConfigMixin":
        d = dict(d)
        d.pop("quant_method", None)
        names = {f.name for f in dataclasses.fields(cls)}
        obj = cls(**{k: v for k, v in d.items() if k in names})
        obj.post_init()
        return obj

    @classmethod
    def from_json_file(cls, path: str) -> "QuantizationConfigMixin":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def config_from_dict(d: dict) -> QuantizationConfigMixin:
    method = d.get("quant_method", "rtn")
    cls = QUANT_METHODS.get(method)
    if cls is None:
        raise ValueError(f"unknown quant_method {method!r}; have {sorted(QUANT_METHODS)}")
    return cls.from_dict(d)


@_register("rtn")
@dataclass
class RtnConfig(QuantizationConfigMixin):
    """Round-to-nearest weight-only quantization."""

    layer_wise: bool = False
    use_double_quant: bool = False
    double_quant_scale_dtype: str = "float32"

    def __post_init__(self):
        self.post_init()


@_register("gptq")
@dataclass
class GPTQConfig(QuantizationConfigMixin):
    """GPTQ second-order weight-only quantization (config only here)."""

    damp_percent: float = 0.01
    blocksize: int = 128
    nsamples: int = 128
    max_input_length: Optional[int] = 2048
    desc_act: bool = False
    static_groups: bool = False
    true_sequential: bool = False
    tokenizer: Any = None

    def __post_init__(self):
        self.post_init()
        if not 0 < self.damp_percent < 1:
            raise ValueError("damp_percent must be in (0, 1)")


@_register("awq")
@dataclass
class AwqConfig(QuantizationConfigMixin):
    """Activation-aware weight-only quantization (config only here)."""

    auto_scale: bool = True
    auto_clip: bool = True
    zero_point: bool = False
    nsamples: int = 128
    tokenizer: Any = None

    def __post_init__(self):
        if self.zero_point:
            self.scheme = "asym"
        self.post_init()


@_register("teq")
@dataclass
class TeqConfig(QuantizationConfigMixin):
    """Trainable equivalent transformation (config only here)."""

    nsamples: int = 128
    train_steps: int = 100
    lr: float = 1e-3
    tokenizer: Any = None

    def __post_init__(self):
        self.post_init()


@_register("autoround")
@dataclass
class AutoRoundConfig(QuantizationConfigMixin):
    """SignRound-style learned rounding (config only here)."""

    nsamples: int = 128
    iters: int = 200
    lr: Optional[float] = None
    minmax_lr: Optional[float] = None
    use_quant_input: bool = True
    tokenizer: Any = None

    def __post_init__(self):
        self.post_init()
        if self.lr is None:
            self.iters = max(self.iters, 1)
            self.lr = 1.0 / self.iters


@_register("smooth_quant")
@dataclass
class SmoothQuantConfig(QuantizationConfigMixin):
    """W8A8 with activation-outlier smoothing (config only here)."""

    alpha: float = 0.5
    nsamples: int = 100
    seq_len: int = 512
    auto_alpha_args: Optional[dict] = None
    shared_criterion: str = "max"
    tokenizer: Any = None

    def __post_init__(self):
        self.weight_dtype = "int8"
        self.act_dtype = "int8"
        self.post_init()
        if not 0 <= self.alpha <= 1:
            raise ValueError("alpha must be in [0, 1]")


@_register("static")
@dataclass
class StaticQuantConfig(QuantizationConfigMixin):
    """Static W8A8 with calibrated activation scales (config only here)."""

    nsamples: int = 100
    act_scheme: str = "sym"
    tokenizer: Any = None

    def __post_init__(self):
        self.weight_dtype = "int8"
        self.post_init()


@_register("dynamic")
@dataclass
class DynamicQuantConfig(QuantizationConfigMixin):
    """Dynamic W8A8: activation scales computed per batch (config only here)."""

    def __post_init__(self):
        self.weight_dtype = "int8"
        self.post_init()


@_register("qat")
@dataclass
class QuantAwareTrainingConfig(QuantizationConfigMixin):
    """Quantization-aware training by fake quantization (config only here)."""

    def __post_init__(self):
        self.post_init()


@_register("mixed_precision")
@dataclass
class MixedPrecisionConfig:
    """Mixed precision: a float dtype for the model's matmul weights."""

    dtype: str = "bfloat16"
    quant_method: str = "mixed_precision"

    def __post_init__(self):
        if self.dtype not in ("bfloat16", "float16", "float32"):
            raise ValueError(f"unsupported mixed-precision dtype {self.dtype}")

    def to_dict(self):
        return {"dtype": self.dtype, "quant_method": self.quant_method}

    @classmethod
    def from_dict(cls, d):
        return cls(dtype=d.get("dtype", "bfloat16"))
