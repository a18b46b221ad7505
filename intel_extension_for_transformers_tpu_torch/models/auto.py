"""Auto-model API: one-call quantized model loading.

Port of `intel_extension_for_transformers_tpu/models/auto.py`.
`CausalLM` and `EncoderModel` are the counterparts of the JAX package's
`TpuCausalLM` and `TpuEncoderModel`: a thin wrapper that carries the model
(a `LlamaModel` or `BertModel` on its device), its config, a tokenizer and
the quantization config, and exposes `__call__`, `generate` /
`generate_stream` or `encode`, and `save_low_bit` / `save_pretrained`.

- `AutoModelForCausalLM.from_pretrained(path_or_name, load_in_8bit=True)`
  resolves the flags as the JAX package does (`load_in_4bit` → RTN int4
  g128, `load_in_8bit` → RTN int8 g128; an explicit config wins), converts
  the HF model (`hf_convert`) and quantizes it (`quantize_model`).
  `from_hf_model` does the same for a model object already built.
- A directory written by `save_low_bit` (either package's: the file names,
  `tpu_model_config.json` among them, are the JAX package's) reloads through
  `from_pretrained(dir)`, `load_low_bit(dir)` or
  `OptimizedModel.from_pretrained(dir)`, without quantizing again.

Every entry point that builds a model runs on the card unless `device`
names another. HF `transformers` is imported only to load a checkpoint or a
tokenizer by name (`_load_hf`, `_load_tokenizer`). `CausalLM.generate(
num_beams=N)` runs beam search (`generation.generate_beam`). Not ported
yet, and raising `NotImplementedError`: the generic decoder families
(ROADMAP queue 1 step 5) and T5 / `AutoModelForSeq2SeqLM` (step 10).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Optional

import numpy as np
import torch

from intel_extension_for_transformers_tpu_torch.models.bert import BertConfig, bert_encode
from intel_extension_for_transformers_tpu_torch.models.generation import (
    SamplingConfig,
    generate_beam,
    generate as _generate,
    generate_stream as _generate_stream,
)
from intel_extension_for_transformers_tpu_torch.models.llama import LlamaConfig, init_kv_cache
from intel_extension_for_transformers_tpu_torch.models.registry import get_apply_fn
from intel_extension_for_transformers_tpu_torch.quantization.config import (
    QuantizationConfigMixin,
    RtnConfig,
)
from intel_extension_for_transformers_tpu_torch.quantization.quantize import (
    QuantizedParams,
    quantize_model,
)
from intel_extension_for_transformers_tpu_torch.quantization.save_load import (
    load_low_bit as _load_low_bit,
    save_low_bit as _save_low_bit,
)

logger = logging.getLogger(__name__)

MODEL_CONFIG_NAME = "tpu_model_config.json"

_ENCODER_TYPES = {"bert", "roberta", "bge", "minilm"}
_SEQ2SEQ_TYPES = {"t5", "mt5"}
# the generic decoder families of the JAX package's converter registry
# (hf_convert._DECODER_CONVERTERS and its aliases)
_GENERIC_TYPES = frozenset({
    "gptj", "gpt_neox", "opt", "bloom", "mpt", "falcon", "phi", "gpt_bigcode", "stablelm",
    "chatglm", "gemma", "baichuan", "qwen", "dolly", "polyglot", "chatglm2", "chatglm3",
    "starcoder",
})


def _not_ported_generic(model_type: str) -> NotImplementedError:
    return NotImplementedError(
        f"model_type {model_type!r} runs on the generic decoder (models/decoder.py), "
        "which is not ported yet (ROADMAP queue 1, step 5)"
    )


def _not_ported_seq2seq() -> NotImplementedError:
    return NotImplementedError("T5 / seq2seq models are not ported yet (ROADMAP queue 1, step 10)")


class _ModelBase:
    """Shared persistence for wrapped models."""

    model_type: str = ""

    def __init__(self, params, config, tokenizer=None, quantization_config=None):
        self.params = params
        self.config = config
        self.tokenizer = tokenizer
        self.quantization_config = quantization_config

    @property
    def device(self) -> torch.device:
        return next(self.params.parameters()).device

    def save_low_bit(self, save_dir: str) -> None:
        """Write the packed weights and the model config to `save_dir`."""
        _save_low_bit(QuantizedParams(self.params, self.quantization_config, []), save_dir)
        with open(os.path.join(save_dir, MODEL_CONFIG_NAME), "w") as f:
            json.dump({"model_type": self.model_type, "config": dataclasses.asdict(self.config)}, f, indent=1)
        if self.tokenizer is not None and hasattr(self.tokenizer, "save_pretrained"):
            try:
                self.tokenizer.save_pretrained(save_dir)
            except Exception:  # the weights are saved; the tokenizer is best effort
                logger.warning("could not save the tokenizer to %s", save_dir, exc_info=True)

    save_pretrained = save_low_bit

    @classmethod
    def _read_model_config(cls, save_dir: str) -> tuple[str, dict]:
        with open(os.path.join(save_dir, MODEL_CONFIG_NAME)) as f:
            d = json.load(f)
        return d["model_type"], d["config"]


class CausalLM(_ModelBase):
    """Llama-family causal LM: model + generate (the JAX package's `TpuCausalLM`)."""

    model_type = "llama"

    def __call__(self, input_ids, cache=None):
        """→ (logits, cache). A fresh cache sized to the prompt if None."""
        ids = torch.as_tensor(np.asarray(input_ids), device=self.device).to(torch.int64)
        if ids.ndim == 1:
            ids = ids[None, :]
        if cache is None:
            cache = init_kv_cache(self.config, ids.shape[0], ids.shape[1], device=self.device)
        return get_apply_fn(self.config)(self.params, self.config, ids, cache)

    def generate(self, input_ids, sampling: Optional[SamplingConfig] = None, **kw) -> np.ndarray:
        if kw.get("num_beams", 1) > 1:
            # HF-style generate(num_beams=N): beam search
            ids, _ = generate_beam(
                self.params, self.config, input_ids,
                num_beams=int(kw["num_beams"]),
                max_new_tokens=int(kw.get("max_new_tokens") or (sampling.max_new_tokens if sampling else 32)),
                length_penalty=float(kw.get("length_penalty", 1.0)),
                eos_token_id=kw.get("eos_token_id"),
            )
            return ids[None]  # (1, n), batch-major as generate returns
        kw.pop("num_beams", None)
        return _generate(self.params, self.config, input_ids, sampling, **kw)

    def generate_stream(self, input_ids, sampling: Optional[SamplingConfig] = None, **kw):
        return _generate_stream(self.params, self.config, input_ids, sampling, **kw)


class EncoderModel(_ModelBase):
    """BERT/BGE-family encoder: model + encode (the JAX package's `TpuEncoderModel`)."""

    model_type = "bert"

    def encode(self, input_ids, attention_mask=None, token_type_ids=None, pooling: str = "cls",
               normalize: bool = True) -> torch.Tensor:
        def dev(a):
            return None if a is None else torch.as_tensor(np.asarray(a), device=self.device)

        with torch.no_grad():
            return bert_encode(self.params, dev(input_ids), dev(attention_mask), dev(token_type_ids),
                               pooling=pooling, normalize=normalize)

    __call__ = encode


def _is_low_bit_dir(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, MODEL_CONFIG_NAME))


def _resolve_quant_config(
    quantization_config, load_in_4bit: bool, load_in_8bit: bool
) -> Optional[QuantizationConfigMixin]:
    """An explicit config wins; else load_in_4bit → RTN int4, load_in_8bit →
    RTN int8, both g128; else None (the model stays float)."""
    if quantization_config is not None:
        return quantization_config
    if load_in_4bit:
        return RtnConfig(weight_dtype="int4", group_size=128)
    if load_in_8bit:
        return RtnConfig(weight_dtype="int8", group_size=128)
    return None


def _load_hf(model_name_or_path: str, cls: str, **hf_kwargs):
    """Load an HF torch checkpoint on the host (needs HF transformers)."""
    import transformers as hf

    return getattr(hf, cls).from_pretrained(model_name_or_path, **hf_kwargs)


def _load_tokenizer(model_name_or_path: str):
    """The HF tokenizer saved beside a model, or None (no transformers, no files)."""
    try:
        import transformers as hf

        return hf.AutoTokenizer.from_pretrained(model_name_or_path)
    except Exception:  # a model loads without its tokenizer, as in the JAX package
        return None


def _llama_config(cfg_dict: dict) -> LlamaConfig:
    """The saved config is `dataclasses.asdict` in JSON: rope_scaling comes
    back as a list, and LlamaConfig holds a tuple."""
    cfg_dict = dict(cfg_dict)
    if cfg_dict.get("rope_scaling") is not None:
        cfg_dict["rope_scaling"] = tuple(cfg_dict["rope_scaling"])
    return LlamaConfig(**cfg_dict)


def _wrap_from_low_bit_dir(path: str, device=None):
    model_type, cfg_dict = _ModelBase._read_model_config(path)
    if model_type in _SEQ2SEQ_TYPES:
        raise _not_ported_seq2seq()
    if model_type in _GENERIC_TYPES:
        raise _not_ported_generic(model_type)
    if model_type in _ENCODER_TYPES:
        wrapper, config = EncoderModel, BertConfig(**cfg_dict)
    else:
        wrapper, config = CausalLM, _llama_config(cfg_dict)
    qp = _load_low_bit(path, config, device=device)
    m = wrapper(qp.params, config, _load_tokenizer(path), qp.config)
    m.model_type = model_type
    return m


def _quantized(wrapper, model, config, quantization_config, load_in_4bit, load_in_8bit, tokenizer):
    qcfg = _resolve_quant_config(quantization_config, load_in_4bit, load_in_8bit)
    if qcfg is not None:
        model = quantize_model(model, qcfg).params
    return wrapper(model, config, tokenizer, qcfg)


class AutoModelForCausalLM:
    """`from_pretrained(..., load_in_8bit=True)` loads and quantizes in one
    call; `load_low_bit` reloads packed weights."""

    @classmethod
    def from_pretrained(
        cls,
        pretrained_model_name_or_path: str,
        quantization_config: Optional[QuantizationConfigMixin] = None,
        load_in_4bit: bool = False,
        load_in_8bit: bool = False,
        calib_inputs=None,
        *,
        device=None,
        **hf_kwargs,
    ) -> CausalLM:
        path = str(pretrained_model_name_or_path)
        if _is_low_bit_dir(path):
            model = _wrap_from_low_bit_dir(path, device)
            if not isinstance(model, CausalLM):
                raise ValueError(f"{path} holds an encoder, use AutoModel")
            return model
        hf_model = _load_hf(path, "AutoModelForCausalLM", **hf_kwargs)
        return cls.from_hf_model(
            hf_model, quantization_config=quantization_config, load_in_4bit=load_in_4bit,
            load_in_8bit=load_in_8bit, tokenizer=_load_tokenizer(path), calib_inputs=calib_inputs,
            device=device,
        )

    @classmethod
    def from_hf_model(
        cls,
        hf_model,
        quantization_config=None,
        load_in_4bit: bool = False,
        load_in_8bit: bool = False,
        tokenizer=None,
        calib_inputs=None,
        *,
        device=None,
    ) -> CausalLM:
        """Convert an HF torch causal LM already built (tests build a tiny one
        from a local config), then quantize it. `calib_inputs` feed the
        calibrated algorithms, which are not ported (ROADMAP queue 1, step
        8): RTN takes none."""
        from intel_extension_for_transformers_tpu_torch.models.hf_convert import llama_params_from_hf

        if hf_model.config.model_type in _GENERIC_TYPES:
            raise _not_ported_generic(hf_model.config.model_type)
        model, config = llama_params_from_hf(hf_model, device=device)
        return _quantized(CausalLM, model, config, quantization_config, load_in_4bit, load_in_8bit, tokenizer)

    @classmethod
    def load_low_bit(cls, save_dir: str, *, device=None) -> CausalLM:
        model = _wrap_from_low_bit_dir(save_dir, device)
        if not isinstance(model, CausalLM):
            raise ValueError(f"{save_dir} holds an encoder, use AutoModel")
        return model


class AutoModel:
    """Encoder loader (BERT / BGE)."""

    @classmethod
    def from_pretrained(
        cls,
        pretrained_model_name_or_path: str,
        quantization_config: Optional[QuantizationConfigMixin] = None,
        load_in_4bit: bool = False,
        load_in_8bit: bool = False,
        *,
        device=None,
        **hf_kwargs,
    ) -> EncoderModel:
        path = str(pretrained_model_name_or_path)
        if _is_low_bit_dir(path):
            model = _wrap_from_low_bit_dir(path, device)
            if not isinstance(model, EncoderModel):
                raise ValueError(f"{path} holds a decoder, use AutoModelForCausalLM")
            return model
        hf_model = _load_hf(path, "AutoModel", **hf_kwargs)
        return cls.from_hf_model(
            hf_model, quantization_config=quantization_config, load_in_4bit=load_in_4bit,
            load_in_8bit=load_in_8bit, tokenizer=_load_tokenizer(path), device=device,
        )

    @classmethod
    def from_hf_model(
        cls,
        hf_model,
        quantization_config=None,
        load_in_4bit: bool = False,
        load_in_8bit: bool = False,
        tokenizer=None,
        calib_inputs=None,
        *,
        device=None,
    ) -> EncoderModel:
        from intel_extension_for_transformers_tpu_torch.models.hf_convert import bert_params_from_hf

        model, config = bert_params_from_hf(hf_model, device=device)
        return _quantized(EncoderModel, model, config, quantization_config, load_in_4bit, load_in_8bit,
                          tokenizer)

    @classmethod
    def load_low_bit(cls, save_dir: str, *, device=None) -> EncoderModel:
        model = _wrap_from_low_bit_dir(save_dir, device)
        if not isinstance(model, EncoderModel):
            raise ValueError(f"{save_dir} holds a decoder, use AutoModelForCausalLM")
        return model


class AutoModelForSeq2SeqLM:
    """T5-family loader: not ported yet (ROADMAP queue 1, step 10)."""

    @classmethod
    def from_pretrained(cls, *args, **kw):
        raise _not_ported_seq2seq()

    from_hf_model = load_low_bit = from_pretrained


class OptimizedModel:
    """Reload of any model saved by `save_low_bit`, decoder or encoder."""

    @classmethod
    def from_pretrained(cls, save_dir: str, *, device=None, **kw):
        if not _is_low_bit_dir(str(save_dir)):
            raise ValueError(f"{save_dir} is not a saved optimized model (missing {MODEL_CONFIG_NAME})")
        return _wrap_from_low_bit_dir(str(save_dir), device)
