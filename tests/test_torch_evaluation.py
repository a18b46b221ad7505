"""Port parity: the evaluation harness (log-likelihood scoring, multiple
choice, rolling-window perplexity) against the JAX package's, on the tiny
Llama. Windows of 1024 tokens take flash attention on both sides."""

import numpy as np
import pytest
import torch
from torch_port_util import llama_models

from intel_extension_for_transformers_tpu.evaluation import harness as jh
from intel_extension_for_transformers_tpu.models import llama as jllama
from intel_extension_for_transformers_tpu_torch.evaluation import harness as th
from intel_extension_for_transformers_tpu_torch.models import llama as tllama
from intel_extension_for_transformers_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

JCFG = jllama.LlamaConfig.tiny(max_position_embeddings=2048)
TCFG = tllama.LlamaConfig.tiny(max_position_embeddings=2048)
# log-likelihoods are sums of ~10-1000 f32 log-probs of O(6) each; the
# logits match to 1e-5 (tests/test_torch_llama.py), so a sum moves by
# ~1e-5 per token: 1e-5 relative bounds the sums and the perplexity.
RTOL = 1e-5


@pytest.fixture(scope="module")
def models():
    return llama_models(JCFG, TCFG, seed=3)


def _reqs(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, n).tolist(), rng.integers(0, 256, m).tolist())
            for n, m in ((5, 3), (9, 1), (2, 7), (12, 4))]


def test_pad_batch_identical():
    """Tolerance: none."""
    for a, b in zip(th._pad_batch(_reqs()), jh._pad_batch(_reqs())):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("weights", ["float", "khalf"])
def test_loglikelihood_matches_jax(models, weights):
    params, model = models[weights]
    want = jh.loglikelihood(params, JCFG, _reqs(), batch_size=3)
    got = th.loglikelihood(model, TCFG, _reqs(), batch_size=3)
    np.testing.assert_allclose([ll for ll, _ in got], [ll for ll, _ in want], rtol=RTOL)
    assert [g for _, g in got] == [g for _, g in want]


def test_multiple_choice_matches_jax(models):
    """Tolerance: none on the accuracy (argmax of the normalized ll)."""
    params, model = models["float"]
    rng = np.random.default_rng(1)
    qs = [{"context": rng.integers(0, 256, 6).tolist(),
           "choices": [rng.integers(0, 256, k).tolist() for k in (2, 3, 4)],
           "gold": int(rng.integers(0, 3))} for _ in range(6)]
    for norm in (True, False):
        assert th.evaluate_multiple_choice(model, TCFG, qs, batch_size=4, length_normalize=norm) == \
            jh.evaluate_multiple_choice(params, JCFG, qs, batch_size=4, length_normalize=norm)


def test_perplexity_short_windows_matches_jax(models):
    params, model = models["float"]
    ids = np.random.default_rng(2).integers(0, 256, 300).tolist()
    want = jh.evaluate_perplexity(params, JCFG, ids, window=64, stride=48, batch_size=4)
    got = th.evaluate_perplexity(model, TCFG, ids, window=64, stride=48, batch_size=4)
    assert got["tokens"] == want["tokens"]
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=RTOL)
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=RTOL)


def test_perplexity_long_windows_take_flash(models, monkeypatch):
    """Two 1024-token windows (window = stride = 1024, batch 1), each a
    no-cache, unmasked forward: flash attention in every layer of every
    window on the port's side, the Pallas flash kernel on the JAX side."""
    params, model = models["khalf"]
    ids = np.random.default_rng(3).integers(0, 256, 2048).tolist()
    calls = []
    real = tfa.flash_attention_plain
    monkeypatch.setattr(tfa, "flash_attention_plain", lambda *a, **k: calls.append(1) or real(*a, **k))
    got = th.evaluate_perplexity(model, TCFG, ids, window=1024, stride=1024, batch_size=1)
    assert len(calls) == 2 * TCFG.num_hidden_layers
    want = jh.evaluate_perplexity(params, JCFG, ids, window=1024, stride=1024, batch_size=1)
    assert got["tokens"] == want["tokens"] == 2046
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=RTOL)
    assert np.isfinite(got["perplexity"])
