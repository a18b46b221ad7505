"""Port parity: the KV policies (`models/kv_policies.py`: H2O and attention
sinks over a slot cache) against the JAX package's, step by step, on a tiny
Llama (2 layers, hidden 64, vocab 256) whose weights the bridge carries from
the JAX params. Greedy tokens, slot positions and each step's victim slot
must be equal; the accumulated attention mass (f32 sums over heads and
steps, in another order) within ACCUM_TOL."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import llama_models

from intel_extension_for_transformers_tpu.models import generation as jgen
from intel_extension_for_transformers_tpu.models import kv_policies as jkv
from intel_extension_for_transformers_tpu.models import llama as jllama
from intel_extension_for_transformers_tpu_torch.models import generation as tgen
from intel_extension_for_transformers_tpu_torch.models import kv_policies as tkv
from intel_extension_for_transformers_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

TINY = dict(vocab_size=256, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=128, max_position_embeddings=128)
JCFG = jllama.LlamaConfig.tiny(**TINY)
TCFG = tllama.LlamaConfig.tiny(**TINY)
PROMPTS = np.stack([(np.arange(9) * 37 + 5) % 256, (np.arange(9) * 11 + 90) % 256]).astype(np.int32)
T = PROMPTS.shape[1]
STEPS = 14
ACCUM_TOL = 1e-4
GREEDY = dict(max_new_tokens=STEPS + 1, do_sample=False, repetition_penalty=1.0)


@pytest.fixture(scope="module")
def models():
    return llama_models(JCFG, TCFG, seed=6)


def _policies(budget):
    return (
        ("h2o", jkv.H2OKVPolicy(budget=budget, recent_size=4), tkv.H2OKVPolicy(budget=budget, recent_size=4)),
        ("sink", jkv.AttentionSinkKVPolicy(budget=budget, sink_size=2),
         tkv.AttentionSinkKVPolicy(budget=budget, sink_size=2)),
    )


def _victims(positions, next_pos):
    """Each row's slot that took position next_pos - 1."""
    return np.argmax(np.asarray(positions) == next_pos - 1, axis=1)


def _step_by_step(jpol, tpol, params, model, budget, steps=STEPS):
    """Drive both policies from the same prompts, each decode step fed its own
    greedy token; compare tokens, positions, victims and accum at every step."""
    jcache = jpol.init_cache(JCFG, 2, budget)
    jlogits, jcache = jpol.prefill(params, JCFG, jnp.asarray(PROMPTS), jcache)
    tcache = tpol.init_cache(TCFG, 2, budget, device="cpu")
    tlogits, tcache = tpol.prefill(model, TCFG, torch.as_tensor(PROMPTS, dtype=torch.int64), tcache)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)
    cfg = jgen.SamplingConfig(**GREEDY)
    tcfg = tgen.SamplingConfig(**GREEDY)
    jtok = jnp.argmax(jlogits[:, -1], axis=-1)
    ttok = torch.argmax(tlogits[:, -1], dim=-1)
    rng, jseen = jax.random.PRNGKey(0), jgen._seen_from_ids(jnp.asarray(PROMPTS), JCFG.vocab_size)
    tseen = tgen._seen_from_ids(torch.as_tensor(PROMPTS, dtype=torch.int64), TCFG.vocab_size)
    gen = torch.Generator().manual_seed(0)
    victims = []
    for _ in range(steps):
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jtok, jcache, rng, jseen = jpol.decode_step(params, JCFG, cfg, jcache, jtok, rng, jseen)
        ttok, tcache, tseen = tpol.decode_step(model, TCFG, tcfg, tcache, ttok, gen, tseen)
        assert tcache.next_pos == int(jcache.next_pos)
        np.testing.assert_array_equal(tcache.positions.numpy(), np.asarray(jcache.positions))
        jv, tv = _victims(jcache.positions, int(jcache.next_pos)), _victims(tcache.positions, tcache.next_pos)
        np.testing.assert_array_equal(tv, jv)
        victims.append(tv)
        np.testing.assert_allclose(tcache.accum.numpy(), np.asarray(jcache.accum), rtol=0, atol=ACCUM_TOL)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    return np.stack(victims), tcache


@pytest.mark.parametrize("evict", [False, True])
@pytest.mark.parametrize("which", ["h2o", "sink"])
def test_policy_matches_jax_step_by_step(models, which, evict):
    """Within budget (T + STEPS slots) and with STEPS - 4 evictions (T + 4)."""
    budget = T + 4 if evict else T + STEPS
    _, jpol, tpol = next(p for p in _policies(budget) if p[0] == which)
    victims, tcache = _step_by_step(jpol, tpol, *models["float"], budget)
    # slots fill in order, then evictions reuse them
    np.testing.assert_array_equal(victims[: budget - T], np.broadcast_to(np.arange(T, budget)[:, None], (budget - T, 2)))
    pos = tcache.positions.numpy()
    assert (pos >= 0).all() and all(len(set(r)) == len(r) for r in pos)
    if evict and which == "sink":  # the sinks stay, the rest is the most recent ring
        for r in pos:
            assert {0, 1} <= set(r) and sorted(r)[2:] == list(range(T + STEPS - (budget - 2), T + STEPS))
    if evict and which == "h2o":  # the 4 most recent positions are never evicted
        for r in pos:
            assert set(range(T + STEPS - 4, T + STEPS)) <= set(r)


def test_policy_int4_matches_jax(models):
    """The khalf int4 model (the JAX side on its Pallas kernel in interpret
    mode, the port on the plain K1 twin), H2O with evictions."""
    _, jpol, tpol = _policies(T + 3)[0]
    _step_by_step(jpol, tpol, *models["khalf"], T + 3, steps=6)


@pytest.mark.parametrize("which", ["h2o", "sink"])
def test_generate_stream_with_policy_matches_jax(models, which):
    """`generate_stream(kv_policy=...)` end to end, with evictions."""
    params, model = models["float"]
    _, jpol, tpol = next(p for p in _policies(T + 5) if p[0] == which)
    want = jgen.generate(params, JCFG, PROMPTS, jgen.SamplingConfig(**GREEDY), kv_policy=jpol)
    got = tgen.generate(model, TCFG, PROMPTS, tgen.SamplingConfig(**GREEDY), kv_policy=tpol)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("which", ["h2o", "sink"])
def test_policy_within_budget_is_plain_generation(models, which):
    _, model = models["float"]
    _, _, tpol = next(p for p in _policies(T + STEPS + 1) if p[0] == which)
    cfg = tgen.SamplingConfig(**GREEDY)
    np.testing.assert_array_equal(tgen.generate(model, TCFG, PROMPTS, cfg, kv_policy=tpol),
                                  tgen.generate(model, TCFG, PROMPTS, cfg))


def test_prompt_longer_than_budget_raises(models):
    _, model = models["float"]
    pol = tkv.H2OKVPolicy(budget=T - 1)
    with pytest.raises(ValueError, match="exceeds KV budget"):
        tgen.generate(model, TCFG, PROMPTS, tgen.SamplingConfig(max_new_tokens=2), kv_policy=pol)
