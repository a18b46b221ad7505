"""Packed-weight persistence: save_low_bit / load_low_bit.

Port of `intel_extension_for_transformers_tpu/quantization/save_load.py`, in
its on-disk format, so a directory written by either package loads in the
other:

- `quantized_weights.npz`: one array per param path ("layers/0/attention/q/
  kernel"); a packed weight's fields get `::data`, `::scales`, `::zeros` and
  `::pre_scale` suffixes. bf16 arrays are stored as the 2-byte void (`|V2`)
  that `np.savez` writes for ml_dtypes' bf16, holding the bf16 bits.
- `quantization_config.json`: `format_version`, the quantization `config`,
  `quantized_paths`, `qt_meta` (weight_dtype, scheme, group_size, K, N per
  packed path) and the `treedef` skeleton of the params tree.

The model goes through `bridge.llama_to_numpy` / `params_to_numpy` on the
way out and `bridge.llama_from_numpy` / `params_from_numpy` on the way in.
A weight in the w32 decode layout is written in the khalf layout, which the
format holds (`from_decode_layout` is exact). A W8A8 leaf (`kind: "w8a8"`)
raises: SmoothQuant is not ported yet (ROADMAP queue 1, step 8).
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping, Union

import numpy as np
import torch

from intel_extension_for_transformers_tpu_torch import bridge
from intel_extension_for_transformers_tpu_torch.models.bert import BertConfig, BertModel
from intel_extension_for_transformers_tpu_torch.models.llama import LlamaConfig, LlamaModel
from intel_extension_for_transformers_tpu_torch.ops.packing import (
    QuantizedTensor,
    from_decode_layout,
)
from intel_extension_for_transformers_tpu_torch.quantization.config import config_from_dict
from intel_extension_for_transformers_tpu_torch.quantization.quantize import QuantizedParams
from intel_extension_for_transformers_tpu_torch.utils.device import resolve_device

WEIGHTS_NAME = "quantized_weights.npz"
CONFIG_NAME = "quantization_config.json"
FORMAT_VERSION = 1
_QT_ARRAYS = ("data", "scales", "zeros", "pre_scale")
_QT_META = ("weight_dtype", "scheme", "group_size", "K", "N")


def _is_qt(leaf) -> bool:
    """A packed weight in the bridge's numpy form: its QuantizedTensor fields."""
    return isinstance(leaf, Mapping) and "weight_dtype" in leaf


def _khalf(leaf: Mapping) -> Mapping:
    """A w32 weight's fields → the same weight's khalf fields (exact)."""
    if leaf.get("layout", "khalf") == "khalf":
        return leaf
    qt = QuantizedTensor(**{f: bridge._tensor(leaf[f], "cpu") if leaf[f] is not None else None
                            for f in _QT_ARRAYS},
                         **{f: leaf[f] for f in _QT_META}, layout=leaf["layout"])
    qt = from_decode_layout(qt)
    return {**{f: bridge._numpy(getattr(qt, f)) for f in _QT_ARRAYS},
            **{f: leaf[f] for f in _QT_META}, "layout": "khalf"}


def _walk(tree, prefix: str = ""):
    """(path, leaf) pairs, paths joined with "/" as the JAX package's `_path_str`."""
    if _is_qt(tree) or not isinstance(tree, (Mapping, list, tuple)):
        yield prefix, tree
        return
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    for k, v in items:
        yield from _walk(v, f"{prefix}/{k}" if prefix else str(k))


def _tree_template(tree) -> Any:
    """Nested-dict skeleton with leaf markers (dict/list trees only)."""
    if _is_qt(tree) or not isinstance(tree, (Mapping, list, tuple)):
        return "__leaf__"
    if isinstance(tree, Mapping):
        return {k: _tree_template(v) for k, v in tree.items()}
    return [_tree_template(v) for v in tree]


def model_to_numpy(model: torch.nn.Module) -> dict:
    """A port model → the JAX params tree with numpy leaves."""
    if isinstance(model, LlamaModel):
        return bridge.llama_to_numpy(model)
    if isinstance(model, BertModel):
        return bridge.params_to_numpy(model)
    raise TypeError(f"no params tree for {type(model).__name__}")


def save_low_bit(qparams: QuantizedParams, save_dir: str) -> None:
    """Write `qparams.params` (a port model) and its config to `save_dir`."""
    os.makedirs(save_dir, exist_ok=True)
    tree = model_to_numpy(qparams.params)
    arrays: dict[str, np.ndarray] = {}
    qt_meta: dict[str, dict] = {}
    for path, leaf in _walk(tree):
        if _is_qt(leaf):
            leaf = _khalf(leaf)
            for f in _QT_ARRAYS:
                if leaf[f] is not None:
                    arrays[f"{path}::{f}"] = leaf[f]
            qt_meta[path] = {f: leaf[f] for f in _QT_META}
        else:
            arrays[path] = leaf
    np.savez(os.path.join(save_dir, WEIGHTS_NAME), **arrays)
    cfg = {
        "format_version": FORMAT_VERSION,
        "config": qparams.config.to_dict() if qparams.config is not None else None,
        "quantized_paths": sorted(qt_meta),
        "qt_meta": qt_meta,
        "treedef": _tree_template(tree),
    }
    with open(os.path.join(save_dir, CONFIG_NAME), "w") as f:
        json.dump(cfg, f, indent=2)


def read_low_bit(save_dir: str) -> tuple[dict, dict]:
    """→ (the params tree with numpy leaves, the parsed config json)."""
    with open(os.path.join(save_dir, CONFIG_NAME)) as f:
        cfg = json.load(f)
    qt_meta = cfg["qt_meta"]
    leaves: dict[str, Any] = {}
    parts: dict[str, dict] = {}
    with np.load(os.path.join(save_dir, WEIGHTS_NAME)) as npz:
        for key in npz.files:
            if "::" in key:
                path, part = key.split("::", 1)
                parts.setdefault(path, {})[part] = npz[key]
            else:
                leaves[key] = npz[key]
    for path, p in parts.items():
        m = qt_meta[path]
        if m.get("kind") == "w8a8":
            raise NotImplementedError(
                f"{path} is a W8A8 (SmoothQuant) weight: W8A8 is not ported yet (ROADMAP queue 1, step 8)"
            )
        leaves[path] = {**{f: p.get(f) for f in _QT_ARRAYS}, **{f: m[f] for f in _QT_META},
                        "layout": "khalf"}
    return _fill_template(cfg["treedef"], "", leaves), cfg


def _fill_template(tmpl, prefix: str, leaves: dict):
    if tmpl == "__leaf__":
        return leaves[prefix]
    if isinstance(tmpl, dict):
        return {k: _fill_template(v, f"{prefix}/{k}" if prefix else k, leaves) for k, v in tmpl.items()}
    if isinstance(tmpl, list):
        return [_fill_template(v, f"{prefix}/{i}" if prefix else str(i), leaves) for i, v in enumerate(tmpl)]
    raise ValueError(f"bad template node {tmpl!r}")


def load_low_bit(
    save_dir: str, model_config: Union[LlamaConfig, BertConfig], *, device=None
) -> QuantizedParams:
    """Read `save_dir` into the port's model for `model_config`, on the card
    unless `device` names another. Nothing is quantized again."""
    device = resolve_device(device)
    if isinstance(model_config, LlamaConfig):
        build = bridge.llama_from_numpy
    elif isinstance(model_config, BertConfig):
        build = bridge.params_from_numpy
    else:
        raise TypeError(f"no model for {type(model_config).__name__}")
    tree, cfg = read_low_bit(save_dir)
    model = build(tree, model_config, device=device)
    config = config_from_dict(cfg["config"]) if cfg.get("config") else None
    return QuantizedParams(model, config, list(cfg.get("quantized_paths", [])))
