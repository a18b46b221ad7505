"""Weight and index bridge from the JAX package's arrays to the port's modules.

The JAX package keeps a model as a params pytree and an index as arrays; the
port keeps them as `nn.Module`s and a `FlatIndex`. The bridge takes the JAX
side's values as numpy (so it needs neither jax nor the JAX package), which
lets tests run both packages on the same weights and the same index:

- `params_from_numpy(tree, config)` → a `BertModel`, or a `CrossEncoder`
  when the tree has a "classifier". The tree is the JAX params tree with
  numpy leaves (nested dicts and lists); a quantized kernel is a dict with
  the `QuantizedTensor` fields (data, scales, zeros, pre_scale as arrays or
  None; weight_dtype, scheme, group_size, K, N).
- `flat_index_state(meta, arrays)` → a `FlatIndex` from the JAX index's
  metadata (the `index.json` fields, plus `capacity`) and arrays (data,
  scales, mean, shadow, rotation, vectors).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

from intel_extension_for_transformers_tpu_torch.models.bert import BertConfig, BertModel
from intel_extension_for_transformers_tpu_torch.ops.packing import QuantizedTensor
from intel_extension_for_transformers_tpu_torch.ops.quant_matmul import WOQLinear
from intel_extension_for_transformers_tpu_torch.retrieval.index import FlatIndex
from intel_extension_for_transformers_tpu_torch.retrieval.reranker import CrossEncoder

_QT_META = ("weight_dtype", "scheme", "group_size", "K", "N")


def _tensor(x, device) -> torch.Tensor:
    x = np.array(x)  # a writable, contiguous copy
    if x.dtype.name == "bfloat16":  # ml_dtypes' bf16, which torch cannot read directly
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


def _linear(kernel, bias, device) -> nn.Module:
    """A JAX dense leaf pair → nn.Linear (kernel is (in, out)) or WOQLinear."""
    b = None if bias is None else _tensor(bias, device)
    if isinstance(kernel, Mapping):
        arrays = {
            f: None if kernel.get(f) is None else _tensor(kernel[f], device)
            for f in ("data", "scales", "zeros", "pre_scale")
        }
        return WOQLinear(QuantizedTensor(**arrays, **{f: kernel[f] for f in _QT_META}), b)
    w = _tensor(kernel, device)
    lin = nn.Linear(w.shape[0], w.shape[1], bias=b is not None, device=device)
    with torch.no_grad():
        lin.weight.copy_(w.T)
        if b is not None:
            lin.bias.copy_(b)
    return lin


def params_from_numpy(tree: Mapping, config: BertConfig, *, device="cpu") -> BertModel:
    """JAX BERT (or cross-encoder) params with numpy leaves → the port's module."""
    cls = CrossEncoder if "classifier" in tree else BertModel
    with torch.device("meta"):
        model = cls(config)
    model.to_empty(device=device)
    with torch.no_grad():
        emb = tree["embeddings"]
        for name, p in model.embeddings.named_parameters():
            p.copy_(_tensor(emb[name], device))
        for layer, lt in zip(model.layers, tree["layers"], strict=True):
            for block_name in ("attention", "mlp"):
                block, bt = getattr(layer, block_name), lt[block_name]
                block.ln_scale.copy_(_tensor(bt["ln_scale"], device))
                block.ln_bias.copy_(_tensor(bt["ln_bias"], device))
                for name, child in list(block.named_children()):
                    setattr(block, name, _linear(bt[name]["kernel"], bt[name]["bias"], device))
    model.pooler = _linear(tree["pooler"]["kernel"], tree["pooler"]["bias"], device)
    if cls is CrossEncoder:
        head = tree["classifier"]
        model.classifier = _linear(head["kernel"], head.get("bias"), device)
    return model.eval()


def flat_index_state(meta: Mapping, arrays: Mapping, *, device="cpu") -> FlatIndex:
    """A JAX `FlatIndex`'s metadata and arrays → the port's `FlatIndex`."""
    return FlatIndex.from_state(dict(meta), dict(arrays), device=device)
