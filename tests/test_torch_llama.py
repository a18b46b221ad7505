"""Port parity: the Llama decoder against the JAX package's on
`LlamaConfig.tiny()`, with the JAX params (float, khalf int4 and w32) carried
over by the bridge. The JAX quantized products run their Pallas kernels in
interpret mode; flash attention (T >= 1024) runs the Pallas kernel there and
K4's plain version here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import llama_models

from intel_extension_for_transformers_tpu.models import llama as jllama
from intel_extension_for_transformers_tpu.ops import layers as jlayers
from intel_extension_for_transformers_tpu.quantization import RtnConfig as JRtn
from intel_extension_for_transformers_tpu.quantization import quantize_model as jquantize
from intel_extension_for_transformers_tpu_torch.models import llama as tllama
from intel_extension_for_transformers_tpu_torch.ops import flash_attention as tfa
from intel_extension_for_transformers_tpu_torch.ops import layers as tlayers
from intel_extension_for_transformers_tpu_torch.quantization import RtnConfig, quantize_model

torch.set_num_threads(1)

# Max absolute logit error (the tiny model's logits are O(0.1)). f32 params
# and activations: both sides compute the same f32 ops in another order, so
# 1e-5 bounds it; the int4 products match the Pallas kernels to ~1e-6
# relative (tests/test_torch_quant_matmul.py, test_torch_w32.py).
ATOL = 1e-5
# With a bf16 KV cache, K and V are rounded to bf16 on both sides; an f32
# difference of one ulp can round the other way, one bf16 ulp (2^-8 relative)
# of a K entry, which moves a logit by ~1e-4: 1e-3 bounds it. The int8 cache
# quantizes with the same codes (test_kv_quantize_bit_identical), so the same
# bound holds.
CACHE_ATOL = 1e-3

JCFG = jllama.LlamaConfig.tiny()
TCFG = tllama.LlamaConfig.tiny()


@pytest.fixture(scope="module")
def models():
    return llama_models(JCFG, TCFG)


def _ids(B, T, seed=0):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, size=(B, T)).astype(np.int32)


def _logits_close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    """Tolerance: 1e-6 relative in f32 (same f32 ops); in bf16 one ulp of
    the rounded output, up to 2^-7 relative just above a power of two."""
    rng = np.random.default_rng(0)
    x, s = rng.normal(size=(3, 5, 64)).astype(np.float32), rng.normal(size=(64,)).astype(np.float32)
    want = np.asarray(jlayers.rms_norm(jnp.asarray(x).astype(dtype), jnp.asarray(s), 1e-5), np.float32)
    got = tlayers.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(s), 1e-5)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6 if dtype == "float32" else 2**-7)


@pytest.mark.parametrize("scaling", [None, ("linear", 4.0), ("llama3", 8.0, 1.0, 4.0, 8192.0)])
def test_rope_matches_jax(scaling):
    """Tolerance: 1e-6 relative on the frequencies (f32, same formula);
    1e-5 absolute on the rotated vectors at positions up to 5000."""
    want = np.asarray(jlayers.rope_inv_freq(128, 500000.0, scaling))
    got = tlayers.rope_inv_freq(128, 500000.0, scaling).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    pos = np.array([[0, 1, 17, 4999]], np.int32)
    x = np.random.default_rng(1).normal(size=(1, 4, 2, 128)).astype(np.float32)
    jc, js = jlayers.rotary_embedding(jnp.asarray(pos), 128, 500000.0, scaling)
    tc, ts = tlayers.rotary_embedding(torch.from_numpy(pos), 128, 500000.0, scaling)
    want = np.asarray(jlayers.apply_rotary(jnp.asarray(x), jc, js))
    got = tlayers.apply_rotary(torch.from_numpy(x), tc, ts).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_quantize_model_picks_the_jax_leaves():
    """The port's module paths match the JAX tree: both quantize the same
    layers (the seven projections of each layer; lm_head stays float)."""
    params = jllama.llama_init_params(jax.random.PRNGKey(1), JCFG)
    jpaths = jquantize(params, JRtn(weight_dtype="int4", group_size=32)).quantized_paths
    model = tllama.llama_init_params(torch.Generator().manual_seed(1), TCFG)
    tpaths = quantize_model(model, RtnConfig(weight_dtype="int4", group_size=32)).quantized_paths
    assert sorted(tpaths) == sorted(jpaths)
    assert "layers/0/attention/q/kernel" in tpaths and "lm_head/kernel" not in tpaths


def test_quantize_model_releases_each_float_layer():
    """Layer by layer: when the next layer is quantized, the float layers
    already replaced are gone, so the peak stays near the float model."""
    import weakref

    from torch import nn

    model = nn.Sequential(*(nn.Linear(128, 128) for _ in range(3)))
    refs = [weakref.ref(m) for m in model]
    alive = []

    def probe(path, leaf):
        alive.append(sum(r() is not None for r in refs))
        return True

    quantize_model(model, RtnConfig(weight_dtype="int4", group_size=32), is_quantizable=probe)
    assert alive == [3, 2, 1]


@pytest.mark.parametrize("weights", ["float", "khalf", "w32"])
def test_no_cache_forward_matches_jax(models, weights):
    params, model = models[weights]
    ids = _ids(2, 24)
    want, _ = jllama.llama_apply(params, JCFG, jnp.asarray(ids))
    got, cache = tllama.llama_apply(model, TCFG, torch.from_numpy(ids))
    assert cache is None and got.shape == (2, 24, JCFG.vocab_size)
    _logits_close(got, want, ATOL)


@pytest.mark.parametrize("weights,cache_dtype", [("float", "bfloat16"), ("float", "int8"), ("w32", "bfloat16")])
def test_prefill_then_decode_matches_jax(models, weights, cache_dtype):
    params, model = models[weights]
    ids = _ids(2, 12, seed=1)
    jdt = jnp.bfloat16 if cache_dtype == "bfloat16" else "int8"
    tdt = torch.bfloat16 if cache_dtype == "bfloat16" else "int8"
    jcache = jllama.init_kv_cache(JCFG, 2, 20, dtype=jdt)
    tcache = tllama.init_kv_cache(TCFG, 2, 20, dtype=tdt)
    want, jcache = jllama.llama_apply(params, JCFG, jnp.asarray(ids), jcache)
    got, tcache = tllama.llama_apply(model, TCFG, torch.from_numpy(ids), tcache)
    _logits_close(got, want, CACHE_ATOL)
    assert tcache.length == 12 and tcache.quantized == (cache_dtype == "int8")
    for step in range(2):
        tok = ids[:, step : step + 1]
        want, jcache = jllama.llama_apply(params, JCFG, jnp.asarray(tok), jcache)
        got, tcache = tllama.llama_apply(model, TCFG, torch.from_numpy(tok), tcache)
        _logits_close(got, want, CACHE_ATOL)
    assert tcache.length == 14


def test_sliding_window_matches_jax(models):
    """Mistral-style window, no cache and with a cache (prefill + decode)."""
    jcfg = jllama.LlamaConfig.tiny(sliding_window=5)
    tcfg = tllama.LlamaConfig.tiny(sliding_window=5)
    params, model = models["float"]
    ids = _ids(1, 16, seed=2)
    want, _ = jllama.llama_apply(params, jcfg, jnp.asarray(ids))
    got, _ = tllama.llama_apply(model, tcfg, torch.from_numpy(ids))
    _logits_close(got, want, ATOL)
    jcache = jllama.init_kv_cache(jcfg, 1, 18)
    tcache = tllama.init_kv_cache(tcfg, 1, 18)
    _, jcache = jllama.llama_apply(params, jcfg, jnp.asarray(ids), jcache)
    _, tcache = tllama.llama_apply(model, tcfg, torch.from_numpy(ids), tcache)
    want, _ = jllama.llama_apply(params, jcfg, jnp.asarray(ids[:, :1]), jcache)
    got, _ = tllama.llama_apply(model, tcfg, torch.from_numpy(ids[:, :1]), tcache)
    _logits_close(got, want, CACHE_ATOL)


def test_padded_batch_attention_mask_matches_jax(models):
    params, model = models["float"]
    ids = _ids(2, 10, seed=3)
    mask = np.ones((2, 10), np.int32)
    mask[1, 7:] = 0
    want, _ = jllama.llama_apply(params, JCFG, jnp.asarray(ids), attention_mask=jnp.asarray(mask))
    got, _ = tllama.llama_apply(model, TCFG, torch.from_numpy(ids), attention_mask=torch.from_numpy(mask))
    _logits_close(got[1, :7], np.asarray(want)[1, :7], ATOL)
    _logits_close(got[0], np.asarray(want)[0], ATOL)


def test_long_forward_takes_flash_on_both_sides(models, monkeypatch):
    """T = 1024 with no cache and no mask: every layer runs flash attention
    (the Pallas kernel on the JAX side, K4's plain version here), and the
    logits match the JAX ones and the port's own plain-attention forward."""
    cfg_j = jllama.LlamaConfig.tiny(max_position_embeddings=2048)
    cfg_t = tllama.LlamaConfig.tiny(max_position_embeddings=2048)
    params, model = models["float"]
    ids = _ids(1, 1024, seed=4)
    calls = []
    real = tfa.flash_attention_plain
    monkeypatch.setattr(tfa, "flash_attention_plain", lambda *a, **k: calls.append(1) or real(*a, **k))
    want, _ = jllama.llama_apply(params, cfg_j, jnp.asarray(ids))
    got, _ = tllama.llama_apply(model, cfg_t, torch.from_numpy(ids))
    assert len(calls) == TCFG.num_hidden_layers
    _logits_close(got, want, ATOL)
    plain, _ = tllama.llama_apply(model, cfg_t, torch.from_numpy(ids),
                                  attention_mask=torch.ones(1, 1024, dtype=torch.int32))
    assert len(calls) == TCFG.num_hidden_layers  # an all-ones mask takes the plain path
    _logits_close(got, plain.numpy(), ATOL)


def test_kv_quantize_bit_identical():
    """Tolerance: none. int8 codes and f32 scales equal the JAX ones as
    llama_apply runs them, under jit (where XLA turns / 127 into a product
    with the f32 reciprocal)."""
    t = np.random.default_rng(5).normal(size=(2, 7, 3, 16)).astype(np.float32)
    jq, js = jax.jit(jllama._kv_quantize)(jnp.asarray(t))
    tq, ts = tllama._kv_quantize(torch.from_numpy(t))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_cache_write_per_row_start_matches_jax():
    """Tolerance: none. Scalar and per-row (B,) start offsets."""
    rng = np.random.default_rng(6)
    buf = rng.normal(size=(3, 8, 2)).astype(np.float32)
    new = rng.normal(size=(3, 2, 2)).astype(np.float32)
    for start in (3, np.array([0, 4, 6], np.int32)):
        want = jllama._cache_write(jnp.asarray(buf), jnp.asarray(new), jnp.asarray(start))
        tstart = start if isinstance(start, int) else torch.from_numpy(start)
        got = tllama._cache_write(torch.from_numpy(buf.copy()), torch.from_numpy(new), tstart)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_params_and_configs():
    model = tllama.llama_init_params(torch.Generator().manual_seed(0), TCFG, dtype=torch.bfloat16)
    assert model.embed_tokens.shape == (512, 128) and model.embed_tokens.dtype == torch.bfloat16
    assert model.layers[0].attention.k.weight.shape == (2 * 32, 128)
    assert float(model.final_norm.detach().float().mean()) == 1.0
    assert abs(float(model.lm_head.weight.detach().float().std()) - 0.02) < 2e-3
    for name in ("llama2_7b", "llama3_8b", "llama31_8b", "mixtral_8x7b"):
        assert getattr(tllama.LlamaConfig, name)() == tllama.LlamaConfig(
            **vars(getattr(jllama.LlamaConfig, name)()))
    with pytest.raises(NotImplementedError, match="MoE"):
        tllama.LlamaModel(tllama.LlamaConfig.tiny(num_local_experts=4))
