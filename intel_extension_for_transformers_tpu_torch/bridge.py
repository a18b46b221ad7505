"""Weight and index bridge between the JAX package's arrays and the port's modules.

The JAX package keeps a model as a params pytree and an index as arrays; the
port keeps them as `nn.Module`s and a `FlatIndex`. The bridge takes the JAX
side's values as numpy (so it needs neither jax nor the JAX package), which
lets tests run both packages on the same weights and the same index, and
`quantization.save_low_bit` write the JAX package's format:

- `params_from_numpy(tree, config)` → a `BertModel`, or a `CrossEncoder`
  when the tree has a "classifier". The tree is the JAX params tree with
  numpy leaves (nested dicts and lists); a quantized kernel is a dict with
  the `QuantizedTensor` fields (data, scales, zeros, pre_scale as arrays or
  None; weight_dtype, scheme, group_size, K, N, and layout "khalf" or
  "w32", "khalf" when absent).
- `llama_from_numpy(tree, config)` → a `LlamaModel` from the JAX Llama
  params tree in the same form (khalf or w32 kernels; q/k/v biases where
  the tree has them, as Qwen2 checkpoints do).
- `flat_index_state(meta, arrays)` → a `FlatIndex` from the JAX index's
  metadata (the `index.json` fields, plus `capacity`) and arrays (data,
  scales, mean, shadow, rotation, vectors).
- `ivf_index_state(meta, arrays)` → an `IVFIndex` from the JAX IVF index's
  `save()` payload: the `ivf.json` fields and the `ivf.npz` arrays
  (centroids, storage, scales, lo, row_ids, fill), so both sides search the
  same centroids, codes and layout.
- `params_to_numpy(model)` and `llama_to_numpy(model)`: the other way, a
  port module → the JAX params tree with numpy leaves, in the form the two
  loaders above take (a float linear → {"kernel": W.T, "bias"}, a
  `WOQLinear` → its `QuantizedTensor` fields).

A bf16 array is read from ml_dtypes' bf16 or from the 2-byte void (`|V2`)
that `np.savez` writes for it, and written as that 2-byte void, holding the
bf16 bits. The loaders build on the card unless `device` names another.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from intel_extension_for_transformers_tpu_torch.models.bert import BertConfig, BertModel
from intel_extension_for_transformers_tpu_torch.models.llama import LlamaConfig, LlamaModel
from intel_extension_for_transformers_tpu_torch.ops.packing import QuantizedTensor
from intel_extension_for_transformers_tpu_torch.ops.quant_matmul import WOQLinear
from intel_extension_for_transformers_tpu_torch.retrieval.index import FlatIndex
from intel_extension_for_transformers_tpu_torch.retrieval.ivf import IVFIndex
from intel_extension_for_transformers_tpu_torch.retrieval.reranker import CrossEncoder
from intel_extension_for_transformers_tpu_torch.utils.device import resolve_device

_QT_META = ("weight_dtype", "scheme", "group_size", "K", "N")


def _tensor(x, device) -> torch.Tensor:
    x = np.array(x)  # a writable, contiguous copy
    # ml_dtypes' bf16, or the |V2 void np.savez writes for it: torch reads neither
    if x.dtype.name == "bfloat16" or (x.dtype.kind == "V" and x.dtype.itemsize == 2):
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


def _numpy(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    """A tensor → numpy on the host; bf16 as the |V2 void holding its bits."""
    if t is None:
        return None
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _linear(kernel, bias, device) -> nn.Module:
    """A JAX dense leaf pair → nn.Linear (kernel is (in, out)) or WOQLinear,
    in the arrays' own dtypes."""
    b = None if bias is None else _tensor(bias, device)
    if isinstance(kernel, Mapping):
        arrays = {
            f: None if kernel.get(f) is None else _tensor(kernel[f], device)
            for f in ("data", "scales", "zeros", "pre_scale")
        }
        meta = {f: kernel[f] for f in _QT_META}
        return WOQLinear(QuantizedTensor(**arrays, **meta, layout=kernel.get("layout", "khalf")), b)
    w = _tensor(kernel, device)
    with torch.device("meta"):
        lin = nn.Linear(w.shape[0], w.shape[1], bias=b is not None)
    lin.weight = nn.Parameter(w.T.contiguous())
    if b is not None:
        lin.bias = nn.Parameter(b)
    return lin


def _set(module: nn.Module, name: str, array, device) -> None:
    setattr(module, name, nn.Parameter(_tensor(array, device)))


def _built(model: nn.Module) -> nn.Module:
    """Every tensor of `model` came from the tree: none is left on meta."""
    left = [n for n, t in (*model.named_parameters(), *model.named_buffers()) if t.is_meta]
    if left:
        raise ValueError(f"the params tree has no values for {left[:5]}")
    return model.eval()


def params_from_numpy(tree: Mapping, config: BertConfig, *, device=None) -> BertModel:
    """JAX BERT (or cross-encoder) params with numpy leaves → the port's module,
    on the card unless `device` names another. Each tensor keeps its array's
    dtype (the module is built on the meta device and filled from the tree,
    so no float copy is allocated first)."""
    device = resolve_device(device)
    cls = CrossEncoder if "classifier" in tree else BertModel
    with torch.device("meta"):
        model = cls(config)
    emb = tree["embeddings"]
    for name, _ in list(model.embeddings.named_parameters()):
        _set(model.embeddings, name, emb[name], device)
    for layer, lt in zip(model.layers, tree["layers"], strict=True):
        for block_name in ("attention", "mlp"):
            block, bt = getattr(layer, block_name), lt[block_name]
            _set(block, "ln_scale", bt["ln_scale"], device)
            _set(block, "ln_bias", bt["ln_bias"], device)
            for name, _ in list(block.named_children()):
                setattr(block, name, _linear(bt[name]["kernel"], bt[name]["bias"], device))
    model.pooler = _linear(tree["pooler"]["kernel"], tree["pooler"]["bias"], device)
    if cls is CrossEncoder:
        head = tree["classifier"]
        model.classifier = _linear(head["kernel"], head.get("bias"), device)
    return _built(model)


def llama_from_numpy(tree: Mapping, config: LlamaConfig, *, device=None) -> LlamaModel:
    """JAX Llama params with numpy leaves → the port's `LlamaModel`, on the card
    unless `device` names another. Each tensor keeps its array's dtype."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = LlamaModel(config)
    _set(model, "embed_tokens", tree["embed_tokens"], device)
    _set(model, "final_norm", tree["final_norm"], device)
    for layer, lt in zip(model.layers, tree["layers"], strict=True):
        _set(layer, "input_norm", lt["input_norm"], device)
        _set(layer, "post_norm", lt["post_norm"], device)
        for block_name in ("attention", "mlp"):
            block, bt = getattr(layer, block_name), lt[block_name]
            for name, _ in list(block.named_children()):
                setattr(block, name, _linear(bt[name]["kernel"], bt[name].get("bias"), device))
    model.lm_head = _linear(tree["lm_head"]["kernel"], tree["lm_head"].get("bias"), device)
    return _built(model)


def flat_index_state(meta: Mapping, arrays: Mapping, *, device=None) -> FlatIndex:
    """A JAX `FlatIndex`'s metadata and arrays → the port's `FlatIndex`."""
    return FlatIndex.from_state(dict(meta), dict(arrays), device=device)


def ivf_index_state(meta: Mapping, arrays: Mapping, *, device=None) -> IVFIndex:
    """A JAX `IVFIndex`'s `ivf.json` fields and `ivf.npz` arrays → the port's `IVFIndex`."""
    return IVFIndex.from_state(dict(meta), dict(arrays), device=device)


def _linear_to_numpy(layer: nn.Module) -> dict:
    """nn.Linear → {"kernel": W.T (in, out), "bias"?}; WOQLinear → {"kernel":
    its QuantizedTensor fields, "bias"?}. No "bias" key when there is none,
    as the JAX trees have none."""
    if isinstance(layer, WOQLinear):
        qt = layer.qt
        kernel = {f: _numpy(getattr(qt, f)) for f in ("data", "scales", "zeros", "pre_scale")}
        kernel.update({f: getattr(qt, f) for f in _QT_META}, layout=qt.layout)
    else:
        kernel = _numpy(layer.weight.T.contiguous())
    out = {"kernel": kernel}
    if layer.bias is not None:
        out["bias"] = _numpy(layer.bias)
    return out


def params_to_numpy(model: BertModel) -> dict:
    """A `BertModel` or `CrossEncoder` → the JAX BERT params tree with numpy
    leaves (`params_from_numpy` reads it back)."""
    emb = model.embeddings
    tree = {
        "embeddings": {name: _numpy(p) for name, p in emb.named_parameters()},
        "layers": [],
        "pooler": _linear_to_numpy(model.pooler),
    }
    for layer in model.layers:
        lt = {}
        for block_name in ("attention", "mlp"):
            block = getattr(layer, block_name)
            bt = {name: _linear_to_numpy(child) for name, child in block.named_children()}
            bt.update(ln_scale=_numpy(block.ln_scale), ln_bias=_numpy(block.ln_bias))
            lt[block_name] = bt
        tree["layers"].append(lt)
    if isinstance(model, CrossEncoder):
        tree["classifier"] = _linear_to_numpy(model.classifier)
    return tree


def llama_to_numpy(model: LlamaModel) -> dict:
    """A `LlamaModel` → the JAX Llama params tree with numpy leaves
    (`llama_from_numpy` reads it back)."""
    tree = {
        "embed_tokens": _numpy(model.embed_tokens),
        "layers": [],
        "final_norm": _numpy(model.final_norm),
        "lm_head": _linear_to_numpy(model.lm_head),
    }
    for layer in model.layers:
        lt = {"input_norm": _numpy(layer.input_norm), "post_norm": _numpy(layer.post_norm)}
        for block_name in ("attention", "mlp"):
            block = getattr(layer, block_name)
            lt[block_name] = {name: _linear_to_numpy(child) for name, child in block.named_children()}
        tree["layers"].append(lt)
    return tree
