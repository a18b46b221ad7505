"""Port parity: speculative decoding (`models/speculative.py`) against the JAX
package's, on a tiny Llama target (2 layers, hidden 64, vocab 256) and a
smaller draft (1 layer), both carried from the JAX params by the bridge.

- Greedy: the output equals the JAX package's and target-only greedy
  decoding, token for token, with a bad draft and with the target as its own
  draft (which keeps every draft token).
- Sampled: the acceptance step and the token after it, fed the JAX
  package's own draws (the uniforms, and the Gumbel noise that
  `jax.random.categorical` adds), equal JAX `_verify`'s exactly over several
  seeds; the target probabilities of the two forwards agree within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import llama_models

from intel_extension_for_transformers_tpu.models import generation as jgen
from intel_extension_for_transformers_tpu.models import llama as jllama
from intel_extension_for_transformers_tpu.models import speculative as jspec
from intel_extension_for_transformers_tpu_torch.models import generation as tgen
from intel_extension_for_transformers_tpu_torch.models import llama as tllama
from intel_extension_for_transformers_tpu_torch.models import speculative as tspec

torch.set_num_threads(1)

TINY = dict(vocab_size=256, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=128, max_position_embeddings=128)
DRAFT = dict(TINY, num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1, intermediate_size=64)
JCFG, TCFG = jllama.LlamaConfig.tiny(**TINY), tllama.LlamaConfig.tiny(**TINY)
JDCFG, TDCFG = jllama.LlamaConfig.tiny(**DRAFT), tllama.LlamaConfig.tiny(**DRAFT)
PROMPT = (np.arange(8, dtype=np.int32) * 29 + 3) % 256
GREEDY = dict(max_new_tokens=20, do_sample=False, temperature=0.0, repetition_penalty=1.0)
K = 4


@pytest.fixture(scope="module")
def target():
    return llama_models(JCFG, TCFG, seed=0)


@pytest.fixture(scope="module")
def draft():
    return llama_models(JDCFG, TDCFG, seed=1)["float"]


def _greedy_both(tgt, dft, dcfgs, **cfg_kw):
    (jp, tm), (jd, td) = tgt, dft
    jcfg, tcfg = jgen.SamplingConfig(**{**GREEDY, **cfg_kw}), tgen.SamplingConfig(**{**GREEDY, **cfg_kw})
    jstats, tstats = {}, {}
    want = jspec.generate_speculative(jp, JCFG, jd, dcfgs[0], PROMPT, jcfg, spec_k=K, stats=jstats)
    got = tspec.generate_speculative(tm, TCFG, td, dcfgs[1], PROMPT, tcfg, spec_k=K, stats=tstats)
    return np.asarray(want), got, jstats, tstats


def test_greedy_bad_draft_matches_jax_and_target_only(target, draft):
    want, got, jstats, tstats = _greedy_both(target["float"], draft, (JDCFG, TDCFG))
    np.testing.assert_array_equal(got, want)
    plain = tgen.generate(target["float"][1], TCFG, PROMPT, tgen.SamplingConfig(**GREEDY))
    np.testing.assert_array_equal(got, plain)
    assert tstats == jstats and tstats["rounds"] > 0


def test_greedy_self_draft_accepts_every_draft(target):
    want, got, jstats, tstats = _greedy_both(target["float"], target["float"], (JCFG, TCFG))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tgen.generate(target["float"][1], TCFG, PROMPT,
                                                     tgen.SamplingConfig(**GREEDY)))
    assert tstats["acceptance_rate"] == 1.0 and tstats == jstats


def test_greedy_int4_target_matches_jax(target, draft):
    """The khalf int4 target (the JAX side on its Pallas kernel in interpret
    mode, the port on the plain K1 twin) under the float draft."""
    want, got, _, _ = _greedy_both(target["khalf"], draft, (JDCFG, TDCFG), max_new_tokens=10)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("at", [0, 6])
def test_eos_stops_the_stream(target, draft, at):
    plain = tgen.generate(target["float"][1], TCFG, PROMPT, tgen.SamplingConfig(**GREEDY))[0]
    eos = int(plain[at])
    first = int(np.argmax(plain == eos))  # the first time the stream emits it
    want, got, _, _ = _greedy_both(target["float"], draft, (JDCFG, TDCFG), eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], plain[: first + 1])


def _verify_inputs(tm, seed, V=TCFG.vocab_size):
    """(cur, drafts, qs) from a seed: the target's greedy continuation with
    some tokens replaced, and draft distributions that put a seeded share of
    their mass on the drafts (seed 0: all greedy, q small, so all are kept)."""
    rng = np.random.default_rng(seed)
    cont = tgen.generate(tm, TCFG, PROMPT, tgen.SamplingConfig(max_new_tokens=K + 1))[0]
    cur, drafts = cont[:1], cont[1:].copy()
    if seed:
        swap = rng.random(K) < 0.4
        drafts[swap] = rng.integers(0, V, swap.sum())
    qs = rng.dirichlet(np.ones(V), size=K).astype(np.float32)
    share = np.full(K, 1e-6) if seed == 0 else rng.uniform(0.05, 0.9, K)
    qs *= (1 - share)[:, None]
    if seed == 0:
        qs[np.arange(K), drafts] = 0.0
    qs[np.arange(K), drafts] += share
    return cur.astype(np.int32), drafts.astype(np.int32), (qs / qs.sum(1, keepdims=True)).astype(np.float32)


def test_verify_matches_jax_on_jax_draws(target):
    """Sampled acceptance (temperature 0.8) over 12 seeds: JAX `_verify`'s
    kept count and next token, against the port's forward with `_accept` and
    `_next_token` fed the draws JAX `_verify` takes from its key."""
    jp, tm = target["float"]
    S, temp, counts = len(PROMPT) + K + 1, 0.8, []
    for seed in range(12):
        cur, drafts, qs = _verify_inputs(tm, seed)
        jcache = jllama.init_kv_cache(JCFG, 1, S)
        _, jcache = jllama.llama_apply(jp, JCFG, jnp.asarray(PROMPT)[None], jcache)
        key = jax.random.PRNGKey(100 + seed)
        n_j, nxt_j, _, _ = jspec._verify(jp, JCFG, jcache, jnp.asarray(cur), jnp.asarray(drafts),
                                         jnp.asarray(qs), key, K, temp, False)
        # the draws inside JAX `_verify`: split, uniform (K,); split, categorical's Gumbel (V,)
        key, sub = jax.random.split(key)
        u = jax.random.uniform(sub, (K,))
        _, sub = jax.random.split(key)
        g = jax.random.gumbel(sub, (TCFG.vocab_size,), jnp.float32)

        tcache = tllama.init_kv_cache(TCFG, 1, S, device="cpu")
        _, tcache = tllama.llama_apply(tm, TCFG, torch.as_tensor(PROMPT[None], dtype=torch.int64), tcache)
        seq = torch.as_tensor(np.concatenate([cur, drafts])[None], dtype=torch.int64)
        logits, _ = tllama.llama_apply(tm, TCFG, seq, tcache)
        p = tspec._probs(logits[0], temp)
        jlogits, _ = jllama.llama_apply(jp, JCFG, jnp.asarray(seq.numpy()), jcache)
        np.testing.assert_allclose(p.numpy(), np.asarray(jspec._probs(jlogits[0], temp)), rtol=0, atol=1e-6)
        tq, td = torch.from_numpy(qs), torch.from_numpy(drafts.astype(np.int64))
        n_t = tspec._accept(p, tq, td, torch.from_numpy(np.array(u)), False)
        nxt_t = tspec._next_token(p, tq, n_t, torch.from_numpy(np.array(g)), False)
        assert (int(n_t), int(nxt_t)) == (int(n_j), int(nxt_j)), seed
        counts.append(int(n_j))
    assert counts[0] == K and 0 in counts and any(0 < c < K for c in counts)


def test_sampled_stream_runs(target, draft):
    cfg = tgen.SamplingConfig(max_new_tokens=16, do_sample=True, temperature=0.8)
    stats = {}
    out = tspec.generate_speculative(target["float"][1], TCFG, draft[1], TDCFG, PROMPT, cfg, spec_k=3,
                                     stats=stats, seed=3)
    assert out.shape == (1, 16) and ((out >= 0) & (out < TCFG.vocab_size)).all()
    assert stats["rounds"] > 0 and 0 <= stats["acceptance_rate"] <= 1
