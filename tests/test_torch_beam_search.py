"""Port parity: beam search (`models/generation.py::generate_beam`) against the
JAX package's, on a tiny Llama (2 layers, hidden 64, vocab 256) whose weights
the bridge carries from the JAX params. Ids must be equal; scores are f32
sums of log-probabilities from two f32 forwards over bf16 KV caches, which
differ by summation order: they agree within SCORE_TOL."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import llama_models

from intel_extension_for_transformers_tpu.models import generation as jgen
from intel_extension_for_transformers_tpu.models import llama as jllama
from intel_extension_for_transformers_tpu_torch.models import generation as tgen
from intel_extension_for_transformers_tpu_torch.models import llama as tllama
from intel_extension_for_transformers_tpu_torch.models.auto import CausalLM

torch.set_num_threads(1)

TINY = dict(vocab_size=256, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=128, max_position_embeddings=128)
JCFG = jllama.LlamaConfig.tiny(**TINY)
TCFG = tllama.LlamaConfig.tiny(**TINY)
PROMPT = (np.arange(7, dtype=np.int32) * 37 + 5) % 256
SCORE_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    return llama_models(JCFG, TCFG, seed=4)


def _both(params, model, **kw):
    jids, jscore = jgen.generate_beam(params, JCFG, jnp.asarray(PROMPT), **kw)
    tids, tscore = tgen.generate_beam(model, TCFG, PROMPT, **kw)
    return (np.asarray(jids), jscore), (tids, tscore)


@pytest.mark.parametrize("length_penalty", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("num_beams", [2, 4])
def test_beam_matches_jax_without_eos(models, num_beams, length_penalty):
    (jids, jscore), (tids, tscore) = _both(*models["float"], num_beams=num_beams, max_new_tokens=10,
                                           length_penalty=length_penalty)
    assert len(tids) == 10
    np.testing.assert_array_equal(tids, jids)
    assert abs(tscore - jscore) <= SCORE_TOL


@pytest.mark.parametrize("length_penalty", [0.5, 1.0, 2.0])
def test_beam_eos_finishes_early_as_jax(models, length_penalty):
    """EOS ids among the tokens the beams emit early: both packages return the
    same ids. Below length_penalty 2 a finished beam wins for some id (the
    result ends in EOS, shorter); at 2 the penalty favours long beams."""
    params, model = models["float"]
    base, _ = tgen.generate_beam(model, TCFG, PROMPT, num_beams=4, max_new_tokens=10,
                                 length_penalty=length_penalty)
    finished = 0
    for eos in dict.fromkeys(int(t) for t in base[:6]):
        (jids, jscore), (tids, tscore) = _both(params, model, num_beams=4, max_new_tokens=10,
                                               length_penalty=length_penalty, eos_token_id=eos)
        np.testing.assert_array_equal(tids, jids)
        assert abs(tscore - jscore) <= SCORE_TOL
        finished += len(tids) < 10 and int(tids[-1]) == eos
    assert finished >= 1 or length_penalty >= 2.0


def test_beam_int4_matches_jax(models):
    """The khalf int4 model (the JAX side on its Pallas kernel in interpret
    mode, the port on the plain K1 twin)."""
    (jids, jscore), (tids, tscore) = _both(*models["khalf"], num_beams=3, max_new_tokens=6)
    np.testing.assert_array_equal(tids, jids)
    assert abs(tscore - jscore) <= SCORE_TOL


def test_beam_score_is_the_penalized_log_probability(models):
    """The returned score is the sum of the chosen ids' log-probabilities
    under one no-cache forward, over len ** length_penalty (f32 forwards
    with and without the bf16 cache: SCORE_TOL); a one-beam search is greedy
    decoding."""
    _, model = models["float"]
    for lp in (0.5, 1.0, 2.0):
        ids, score = tgen.generate_beam(model, TCFG, PROMPT, num_beams=4, max_new_tokens=8, length_penalty=lp)
        seq = torch.as_tensor(np.concatenate([PROMPT, ids]), dtype=torch.int64)[None]
        logits, _ = tllama.llama_apply(model, TCFG, seq)
        logp = torch.log_softmax(logits[0, len(PROMPT) - 1:-1].float(), dim=-1)
        want = float(logp.gather(1, seq[0, len(PROMPT):, None]).sum()) / len(ids) ** lp
        assert abs(score - want) <= SCORE_TOL
    ids, _ = tgen.generate_beam(model, TCFG, PROMPT, num_beams=1, max_new_tokens=8)
    greedy = tgen.generate(model, TCFG, PROMPT, tgen.SamplingConfig(max_new_tokens=8))
    np.testing.assert_array_equal(ids, greedy[0])


def test_beam_reorders_an_int8_cache(models):
    """With an int8 KV cache the per-slot scales are reordered with the codes:
    the score still equals the no-cache recomputation within the int8
    cache's rounding (1e-2)."""
    _, model = models["float"]
    ids, score = tgen.generate_beam(model, TCFG, PROMPT, num_beams=4, max_new_tokens=8, cache_dtype="int8")
    seq = torch.as_tensor(np.concatenate([PROMPT, ids]), dtype=torch.int64)[None]
    logits, _ = tllama.llama_apply(model, TCFG, seq)
    logp = torch.log_softmax(logits[0, len(PROMPT) - 1:-1].float(), dim=-1)
    assert abs(score - float(logp.gather(1, seq[0, len(PROMPT):, None]).sum()) / len(ids)) <= 1e-2


def test_causal_lm_generate_routes_num_beams(models):
    _, model = models["float"]
    lm = CausalLM(model, TCFG)
    got = lm.generate(PROMPT, num_beams=3, max_new_tokens=7, length_penalty=2.0)
    want, _ = tgen.generate_beam(model, TCFG, PROMPT, num_beams=3, max_new_tokens=7, length_penalty=2.0)
    assert got.shape == (1, len(want))
    np.testing.assert_array_equal(got[0], want)
