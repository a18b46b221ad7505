"""Port parity: the BERT encoder, float and RTN int4, on the JAX package's
weights carried over by the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import tree_to_numpy

from intel_extension_for_transformers_tpu.models import bert as jbert
from intel_extension_for_transformers_tpu.quantization import RtnConfig as JRtn
from intel_extension_for_transformers_tpu.quantization import quantize_model as jquantize
from intel_extension_for_transformers_tpu_torch import bridge
from intel_extension_for_transformers_tpu_torch.models import bert as tbert
from intel_extension_for_transformers_tpu_torch.quantization import RtnConfig, quantize_model

torch.set_num_threads(1)

CONFIG = jbert.BertConfig.tiny(num_hidden_layers=2)
TCONFIG = tbert.BertConfig.tiny(num_hidden_layers=2)


@pytest.fixture(scope="module")
def jparams():
    return jbert.bert_init_params(jax.random.PRNGKey(0), CONFIG)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(200, CONFIG.vocab_size, size=(2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 11:] = 0
    return ids, mask


def _encode_both(jp, model, inputs, pooling):
    ids, mask = inputs
    want = jbert.bert_encode(jp, CONFIG, jnp.asarray(ids), jnp.asarray(mask), pooling=pooling)
    with torch.no_grad():
        got = tbert.bert_encode(
            model, torch.from_numpy(ids), torch.from_numpy(mask), pooling=pooling
        )
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_bert_encode_f32_matches(jparams, inputs, pooling):
    """Tolerance: 1e-5 absolute on unit-norm f32 embeddings."""
    model = bridge.params_from_numpy(tree_to_numpy(jparams), TCONFIG, device="cpu")
    got, want = _encode_both(jparams, model, inputs, pooling)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_bert_encode_rtn_int4_matches(jparams, inputs):
    """RTN int4 g64, M = 32 rows: the JAX side runs the Pallas kernel in
    interpret mode, the port K1's plain version. Tolerance: 1e-4 absolute."""
    jq = jquantize(jparams, JRtn(weight_dtype="int4", group_size=64))
    model = bridge.params_from_numpy(tree_to_numpy(jq.params), TCONFIG, device="cpu")
    got, want = _encode_both(jq.params, model, inputs, "cls")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_quantize_model_matches_jax(jparams):
    """Tolerance: none. The port quantizes the same layers to the same bytes."""
    jq = jquantize(jparams, JRtn(weight_dtype="int4", group_size=64))
    model = bridge.params_from_numpy(tree_to_numpy(jparams), TCONFIG, device="cpu")
    tq = quantize_model(model, RtnConfig(weight_dtype="int4", group_size=64))
    assert sorted(tq.quantized_paths) == sorted(jq.quantized_paths)
    jdata = jq.params["layers"][1]["mlp"]["output"]["kernel"]
    np.testing.assert_array_equal(
        tq.params.layers[1].mlp.output.data.numpy(), np.asarray(jdata.data)
    )
    np.testing.assert_array_equal(
        tq.params.layers[1].mlp.output.scales.numpy(), np.asarray(jdata.scales)
    )


def test_bert_init_params_shapes_and_scales():
    """Tolerance: none on shapes; the N(0, 0.02) draws' std within 5%."""
    model = tbert.bert_init_params(torch.Generator().manual_seed(0), TCONFIG)
    jp = jbert.bert_init_params(jax.random.PRNGKey(0), CONFIG)
    assert model.embeddings.word_embeddings.shape == jp["embeddings"]["word_embeddings"].shape
    q = model.layers[0].attention.query
    assert tuple(q.weight.T.shape) == jp["layers"][0]["attention"]["query"]["kernel"].shape
    assert abs(float(q.weight.detach().std()) - 0.02) < 0.001
    assert torch.all(q.bias == 0) and torch.all(model.layers[0].mlp.ln_scale == 1)
