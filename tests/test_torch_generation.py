"""Port parity: generation against the JAX package's on `LlamaConfig.tiny()`.
Greedy tokens must be identical; sampled tokens come from another generator
(torch.Generator against jax.random), so for sampling the filtered support
and its logits are compared instead."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import llama_models

from intel_extension_for_transformers_tpu.models import generation as jgen
from intel_extension_for_transformers_tpu.models import llama as jllama
from intel_extension_for_transformers_tpu.models.tokenization import ByteTokenizer as JByteTokenizer
from intel_extension_for_transformers_tpu_torch.models import generation as tgen
from intel_extension_for_transformers_tpu_torch.models import llama as tllama
from intel_extension_for_transformers_tpu_torch.models.tokenization import ByteTokenizer

torch.set_num_threads(1)

JCFG = jllama.LlamaConfig.tiny()
TCFG = tllama.LlamaConfig.tiny()
STEPS = 16


@pytest.fixture(scope="module")
def models():
    return llama_models(JCFG, TCFG, seed=1)


def _prompt(B=1, T=9, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(B, T)).astype(np.int32)


def _cfgs(**kw):
    return jgen.SamplingConfig(**kw), tgen.SamplingConfig(**kw)


@pytest.mark.parametrize("weights", ["float", "khalf", "w32"])
def test_greedy_generate_identical(models, weights):
    """Tolerance: none. 16 greedy steps give the same tokens, streamed and
    collected; the top-2 logit gap of the tiny model keeps argmax stable."""
    params, model = models[weights]
    jc, tc = _cfgs(max_new_tokens=STEPS)
    ids = _prompt()
    want = jgen.generate(params, JCFG, ids, jc)
    got = tgen.generate(model, TCFG, ids, tc)
    assert got.shape == (1, STEPS)
    np.testing.assert_array_equal(got, want)
    streamed = np.stack(list(tgen.generate_stream(model, TCFG, ids[0], tc)), axis=1)
    np.testing.assert_array_equal(streamed, want)


def test_greedy_batch_repetition_penalty_and_eos(models):
    """Tolerance: none. Batch of 2, repetition penalty 1.3, and an EOS that
    the first row emits: the stream stops when every row has finished."""
    params, model = models["float"]
    ids = _prompt(B=2, seed=1)
    jc, tc = _cfgs(max_new_tokens=STEPS, repetition_penalty=1.3)
    want = jgen.generate(params, JCFG, ids, jc)
    np.testing.assert_array_equal(tgen.generate(model, TCFG, ids, tc), want)
    eos = int(want[0, 3])
    jc, tc = _cfgs(max_new_tokens=STEPS, repetition_penalty=1.3, eos_token_id=eos)
    np.testing.assert_array_equal(
        tgen.generate(model, TCFG, ids[:1], tc), jgen.generate(params, JCFG, ids[:1], jc)
    )


def test_generate_compiled_contract_matches_jax(models):
    """Tolerance: none. (tokens, lengths) with positions after EOS holding EOS."""
    params, model = models["khalf"]
    ids = _prompt(B=2, seed=2)
    jc, _ = _cfgs(max_new_tokens=STEPS)
    free = jgen.generate(params, JCFG, ids, jc)
    eos = int(free[0, 5])
    jc, tc = _cfgs(max_new_tokens=STEPS, eos_token_id=eos)
    jt, jl = jgen.generate_compiled(params, JCFG, jnp.asarray(ids), jc, jax.random.PRNGKey(0))
    tt, tl = tgen.generate_compiled(model, TCFG, ids, tc, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert (tt[0, int(tl[0]):] == eos).all()


def test_generate_compiled_without_eos_matches_jax(models):
    """Tolerance: none. No EOS: every row runs max_new_tokens steps, and the
    tokens are the streamed ones."""
    params, model = models["w32"]
    ids = _prompt(B=2, seed=3)
    jc, tc = _cfgs(max_new_tokens=8)
    jt, jl = jgen.generate_compiled(params, JCFG, jnp.asarray(ids), jc, jax.random.PRNGKey(0))
    tt, tl = tgen.generate_compiled(model, TCFG, ids, tc, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tt.numpy(), tgen.generate(model, TCFG, ids, tc))


def _jax_filtered(logits, cfg, seen, monkeypatch):
    """The logits JAX's sample_logits hands to jax.random.categorical."""
    seen_logits = []

    def capture(rng, lg, axis=-1):
        seen_logits.append(np.asarray(lg))
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jgen.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0), cfg, jnp.asarray(seen))
    monkeypatch.undo()
    return seen_logits[0]


@pytest.mark.parametrize("kw", [
    dict(top_k=5),
    dict(top_p=0.6),
    dict(temperature=0.7, top_k=40, top_p=0.75, repetition_penalty=1.1),  # the chat defaults
    dict(top_p=0.999, repetition_penalty=1.5),
])
def test_sample_support_matches_jax(kw, monkeypatch):
    """The support (finite logits) is identical; the kept logits agree to
    1e-6 (f32, same operations); every draw lies in the support."""
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(3, 300)) * 3).astype(np.float32)
    seen = rng.random((3, 300)) < 0.2
    jc, tc = _cfgs(do_sample=True, **kw)
    want = _jax_filtered(logits, jc, seen, monkeypatch)
    got = tgen.filter_logits(torch.from_numpy(logits), tc, torch.from_numpy(seen)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    keep = np.isfinite(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = tgen.sample_logits(torch.from_numpy(logits), gen, tc, torch.from_numpy(seen)).numpy()
        assert keep[np.arange(3), tok].all()


def test_greedy_sample_with_penalty_matches_jax():
    """Tolerance: none (argmax after the repetition penalty)."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(4, 50)).astype(np.float32)
    seen = rng.random((4, 50)) < 0.5
    jc, tc = _cfgs(repetition_penalty=2.0)
    want = jgen.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0), jc, jnp.asarray(seen))
    got = tgen.sample_logits(torch.from_numpy(logits), torch.Generator(), tc, torch.from_numpy(seen))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_generation_is_seeded(models):
    """The same seed gives the same sampled tokens; every token is in the vocabulary."""
    _, model = models["float"]
    _, tc = _cfgs(max_new_tokens=8, do_sample=True, temperature=0.9, top_k=40, top_p=0.75)
    a = tgen.generate(model, TCFG, _prompt(), tc, seed=5)
    b = tgen.generate(model, TCFG, _prompt(), tc, seed=5)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (1, 8) and (a < TCFG.vocab_size).all()


def test_detokenize_stream_matches_jax():
    """Tolerance: none. Multi-byte characters are held back until whole."""
    text = "naïve café → 東京 ok"
    ids = ByteTokenizer().encode(text, add_bos=False)
    assert ids == JByteTokenizer().encode(text, add_bos=False)
    toks = [np.array([i], np.int32) for i in ids]
    want = list(jgen.detokenize_stream(iter(toks), JByteTokenizer()))
    got = list(tgen.detokenize_stream(iter(toks), ByteTokenizer()))
    assert got == want and "".join(got) == text
    batch = ByteTokenizer()(["ab", "abcd"])
    jbatch = JByteTokenizer()(["ab", "abcd"])
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(batch[key], jbatch[key])
