"""Port parity for low-bit persistence: a directory written by the JAX
package's `save_low_bit` loads in the port and the port's `save_low_bit`
writes it back byte for byte, and the JAX package loads what the port wrote.

Tolerance: none. Arrays are compared bit for bit, key by key; the JSON parts
(`qt_meta`, `quantized_paths`, `config`, `treedef`) as JSON values, since the
JAX package flattens dicts in sorted order and the port in module order, so
the zip bytes differ."""

import json
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intel_extension_for_transformers_tpu.models.llama import LlamaConfig as JLlamaConfig
from intel_extension_for_transformers_tpu.models.llama import llama_init_params
from intel_extension_for_transformers_tpu.ops import packing as jpk
from intel_extension_for_transformers_tpu.quantization import AwqConfig as JAwqConfig
from intel_extension_for_transformers_tpu.quantization import QuantizedParams as JQuantizedParams
from intel_extension_for_transformers_tpu.quantization import RtnConfig as JRtnConfig
from intel_extension_for_transformers_tpu.quantization import load_low_bit as jax_load_low_bit
from intel_extension_for_transformers_tpu.quantization import save_low_bit as jax_save_low_bit
from intel_extension_for_transformers_tpu.quantization.smoothquant import quantize_w8a8
from intel_extension_for_transformers_tpu_torch.models.llama import LlamaConfig
from intel_extension_for_transformers_tpu_torch.ops import packing as tpk
from intel_extension_for_transformers_tpu_torch.ops.quant_matmul import WOQLinear
from intel_extension_for_transformers_tpu_torch.quantization import QuantizedParams, save_load

torch.set_num_threads(1)

TINY = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, intermediate_size=256, max_position_embeddings=128)


def _mixed_tree():
    """A JAX tiny Llama whose layer-0 projections are int4 sym, int8 sym,
    int8 asym and nf4, with an AWQ pre_scale on `up`; layer 1 stays float."""
    params = llama_init_params(jax.random.PRNGKey(0), JLlamaConfig(**TINY))
    att, mlp = params["layers"][0]["attention"], params["layers"][0]["mlp"]
    for blk, name, wd, scheme, g in ((att, "q", "int4", "sym", 32), (att, "k", "int8", "sym", 64),
                                     (att, "v", "int8", "asym", 32), (att, "o", "nf4", "sym", 64),
                                     (mlp, "gate", "int4", "asym", 64), (mlp, "up", "int8", "sym", 128),
                                     (mlp, "down", "int8", "asym", 128)):
        blk[name]["kernel"] = jpk.quantize_groupwise(blk[name]["kernel"], wd, scheme, g)
    pre = jnp.asarray(np.random.default_rng(1).uniform(0.5, 2.0, size=(128,)).astype(np.float32))
    mlp["up"]["kernel"] = replace(mlp["up"]["kernel"], pre_scale=pre)
    return params


def _npz(path):
    with np.load(os.path.join(path, save_load.WEIGHTS_NAME)) as z:
        return {k: z[k] for k in z.files}


def _json(path):
    with open(os.path.join(path, save_load.CONFIG_NAME)) as f:
        return json.load(f)


def _assert_same_dirs(a, b):
    za, zb = _npz(a), _npz(b)
    assert sorted(za) == sorted(zb)
    for k in za:
        assert za[k].dtype.str == zb[k].dtype.str and za[k].shape == zb[k].shape, k
        assert za[k].tobytes() == zb[k].tobytes(), k
    assert _json(a) == _json(b)


@pytest.mark.parametrize("jcfg", [JRtnConfig(weight_dtype="int8", group_size=64),
                                  JAwqConfig(weight_dtype="int4", group_size=32)])
def test_jax_dir_loads_in_the_port_and_writes_back_identically(tmp_path, jcfg):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_save_low_bit(JQuantizedParams(_mixed_tree(), jcfg, []), jax_dir)
    qp = save_load.load_low_bit(jax_dir, LlamaConfig(**TINY), device="cpu")
    assert type(qp.config).__name__ == type(jcfg).__name__ and qp.config.to_dict() == jcfg.to_dict()
    assert len(qp.quantized_paths) == 7
    up = qp.params.layers[0].mlp.up
    assert isinstance(up, WOQLinear) and up.pre_scale is not None
    save_load.save_low_bit(QuantizedParams(qp.params, qp.config, []), port_dir)
    _assert_same_dirs(jax_dir, port_dir)


def test_port_dir_loads_in_jax_bit_for_bit(tmp_path):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    tree = _mixed_tree()
    jax_save_low_bit(JQuantizedParams(tree, JRtnConfig(weight_dtype="int8"), []), jax_dir)
    qp = save_load.load_low_bit(jax_dir, LlamaConfig(**TINY), device="cpu")
    save_load.save_low_bit(qp, port_dir)
    back = jax_load_low_bit(port_dir)
    assert back.quantized_paths == sorted(back.quantized_paths) and len(back.quantized_paths) == 7
    leaves = jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, jpk.QuantizedTensor))
    got = dict(jax.tree_util.tree_leaves_with_path(back.params, is_leaf=lambda x: isinstance(x, jpk.QuantizedTensor)))
    for path, leaf in leaves:
        other = got[path]
        if isinstance(leaf, jpk.QuantizedTensor):
            for f in ("data", "scales", "zeros", "pre_scale"):
                a, b = getattr(leaf, f), getattr(other, f)
                assert (a is None) == (b is None), (path, f)
                if a is not None:
                    assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), (path, f)
            assert (leaf.weight_dtype, leaf.scheme, leaf.group_size, leaf.K, leaf.N) == (
                other.weight_dtype, other.scheme, other.group_size, other.K, other.N)
        else:
            assert np.asarray(leaf).tobytes() == np.asarray(other).tobytes(), path


def test_w32_weight_is_saved_in_the_khalf_layout(tmp_path):
    """A model repacked for decode (`prepare_for_inference`) saves as the khalf
    weight it came from: the format has no layout field."""
    from intel_extension_for_transformers_tpu_torch.bridge import llama_from_numpy
    from torch_port_util import tree_to_numpy

    tree = _mixed_tree()
    model = llama_from_numpy(tree_to_numpy(tree), LlamaConfig(**TINY), device="cpu")
    khalf_dir, w32_dir = str(tmp_path / "khalf"), str(tmp_path / "w32")
    save_load.save_low_bit(QuantizedParams(model, None, []), khalf_dir)
    tpk.prepare_for_inference(model)
    assert model.layers[0].attention.q.qt.layout == "w32"
    save_load.save_low_bit(QuantizedParams(model, None, []), w32_dir)
    _assert_same_dirs(khalf_dir, w32_dir)


def test_jax_bf16_tree_loads_from_void_arrays(tmp_path):
    """np.savez writes a JAX bf16 leaf as the 2-byte void |V2 (the JAX
    package's own load_low_bit then fails in jnp.asarray); the port reads it
    as bf16 with the same bits."""
    tree = jax.tree.map(lambda x: x.astype(jnp.bfloat16), llama_init_params(jax.random.PRNGKey(2), JLlamaConfig(**TINY)))
    tree["layers"][1]["mlp"]["down"]["kernel"] = jpk.quantize_groupwise(
        tree["layers"][1]["mlp"]["down"]["kernel"].astype(jnp.float32), "int8", "sym", 64, scale_dtype=jnp.bfloat16)
    d = str(tmp_path / "bf16")
    jax_save_low_bit(JQuantizedParams(tree, None, []), d)
    assert _npz(d)["embed_tokens"].dtype.str == "|V2"
    with pytest.raises(TypeError):
        jax_load_low_bit(d)  # the JAX fault, recorded in ROADMAP queue 3
    model = save_load.load_low_bit(d, LlamaConfig(**TINY), device="cpu").params
    assert model.embed_tokens.dtype == torch.bfloat16 and model.lm_head.weight.dtype == torch.bfloat16
    want = np.asarray(tree["embed_tokens"]).view(np.uint16)
    assert np.array_equal(model.embed_tokens.detach().view(torch.int16).numpy().view(np.uint16), want)
    down = model.layers[1].mlp.down
    assert down.scales.dtype == torch.bfloat16
    assert np.array_equal(down.scales.view(torch.int16).numpy().view(np.uint16),
                          np.asarray(tree["layers"][1]["mlp"]["down"]["kernel"].scales).view(np.uint16))
    port_dir = str(tmp_path / "port")
    save_load.save_low_bit(QuantizedParams(model, None, []), port_dir)
    _assert_same_dirs(d, port_dir)


def test_w8a8_leaf_raises(tmp_path):
    tree = llama_init_params(jax.random.PRNGKey(3), JLlamaConfig(**TINY))
    tree["layers"][0]["attention"]["q"]["kernel"] = quantize_w8a8(tree["layers"][0]["attention"]["q"]["kernel"])
    d = str(tmp_path / "w8a8")
    jax_save_low_bit(JQuantizedParams(tree, None, []), d)
    with pytest.raises(NotImplementedError, match="step 8"):
        save_load.load_low_bit(d, LlamaConfig(**TINY), device="cpu")


def test_load_low_bit_takes_the_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        save_load.load_low_bit(str(tmp_path), LlamaConfig(**TINY))
