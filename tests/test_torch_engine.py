"""Port parity: the continuous-batching DecodeEngine against the JAX
package's on `LlamaConfig.tiny()` weights carried over by the bridge.

The same numpy prompts go through both engines. Greedy tokens must be
identical (tolerance: none); sampled tokens come from another generator
(torch.Generator against jax.random), so sampling is held by its support."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import tree_to_numpy

from intel_extension_for_transformers_tpu.models import engine as jengine
from intel_extension_for_transformers_tpu.models import llama as jllama
from intel_extension_for_transformers_tpu.models.generation import SamplingConfig, generate
from intel_extension_for_transformers_tpu_torch.bridge import llama_from_numpy
from intel_extension_for_transformers_tpu_torch.models import engine as tengine
from intel_extension_for_transformers_tpu_torch.models import llama as tllama

torch.set_num_threads(1)

KW = dict(vocab_size=256, hidden_size=64, intermediate_size=128)
JCFG, TCFG = jllama.LlamaConfig.tiny(**KW), tllama.LlamaConfig.tiny(**KW)
PROMPT = np.array([5, 17, 99, 3], np.int32)


@pytest.fixture(scope="module")
def tiny():
    params = jllama.llama_init_params(jax.random.PRNGKey(0), JCFG)
    return params, llama_from_numpy(tree_to_numpy(params), TCFG, device="cpu")


def _engines(tiny, draft=None, **kw):
    """(JAX engine, port engine) on the same weights and settings, started."""
    params, model = tiny
    jkw, tkw = dict(kw), dict(kw)
    if draft is not None:
        jkw.update(draft_params=draft[0], draft_config=JCFG)
        tkw.update(draft_model=draft[1], draft_config=TCFG)
    return (jengine.DecodeEngine(params, JCFG, **jkw).start(),
            tengine.DecodeEngine(model, TCFG, device="cpu", **tkw).start())


def _serve(eng, mod, prompts, **kw):
    reqs = [eng.submit(mod.EngineRequest(np.asarray(p, np.int32), **kw)) for p in prompts]
    return [list(r.tokens()) for r in reqs]


def _both(engines, prompts, **kw):
    je, te = engines
    return _serve(je, jengine, prompts, **kw), _serve(te, tengine, prompts, **kw)


@pytest.fixture(scope="module")
def pair(tiny):
    je, te = _engines(tiny, max_slots=4, max_len=128)
    yield je, te
    je.stop()
    te.stop()


def test_greedy_one_request_matches_jax(pair, tiny):
    want, got = _both(pair, [PROMPT], max_new_tokens=12)
    assert got == want
    ref = generate(tiny[0], JCFG, PROMPT, SamplingConfig(max_new_tokens=12))[0]
    np.testing.assert_array_equal(np.array(got[0]), ref)


def test_greedy_concurrent_requests_match_jax(pair):
    """6 requests on 4 slots (2 queue and join as slots free); fewer pool
    steps than the serialized sum."""
    prompts = [np.array([i + 1, i + 2, i + 3] + [7] * i, np.int32) for i in range(6)]
    steps0 = pair[1]._steps
    want, got = _both(pair, prompts, max_new_tokens=10)
    assert got == want
    assert pair[1]._steps - steps0 < 6 * 10


def test_eos_and_cancel_free_their_slots(pair):
    je, te = pair
    full = _serve(te, tengine, [PROMPT], max_new_tokens=12)[0]
    want, got = _both(pair, [PROMPT], max_new_tokens=12, eos_token_id=full[4])
    assert got == want == [full[:4]]
    assert te.active_slots == 0
    r = te.submit(tengine.EngineRequest(np.array([1, 2, 3], np.int32), max_new_tokens=500))
    it = r.tokens()
    next(it)
    r.cancel()
    deadline = time.time() + 30
    while te.active_slots and time.time() < deadline:
        time.sleep(0.01)
    assert te.active_slots == 0
    # cancelled while queued: it never takes a slot
    blockers = [te.submit(tengine.EngineRequest(np.array([i, 2, 3], np.int32), max_new_tokens=30))
                for i in range(4)]
    queued = te.submit(tengine.EngineRequest(np.array([9, 9, 9], np.int32), max_new_tokens=30))
    queued.cancel()
    assert len(list(queued.tokens())) < 30
    for b in blockers:
        list(b.tokens())
    assert te.active_slots == 0


def test_stats_keys_and_counters(pair):
    je, te = pair
    assert sorted(te.stats()) == sorted(je.stats())
    s0 = te.stats()
    out = te.generate(np.array([4, 5, 6], np.int32), max_new_tokens=5)
    s1 = te.stats()
    assert len(out) == 5
    assert s1["total_tokens"] == s0["total_tokens"] + 5
    assert s1["completed_requests"] == s0["completed_requests"] + 1
    assert s1["decode_steps"] == s0["decode_steps"] + 4
    assert s1["max_slots"] == 4 and s1["kv_dtype"] == "bfloat16" and s1["kv_policy"] == "none"


def test_oversized_prompt_rejected(pair):
    for eng, mod in ((pair[0], jengine), (pair[1], tengine)):
        with pytest.raises(ValueError):
            eng.submit(mod.EngineRequest(np.zeros(128, np.int32)))


def _jax_filtered(logits, knobs, seen, allow, monkeypatch):
    """The logits JAX's per-slot sampler hands to jax.random.categorical."""
    caught = []

    def capture(rng, lg, axis=-1):
        caught.append(np.asarray(lg))
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jengine.sample_logits_per_slot(jnp.asarray(logits), jax.random.PRNGKey(0),
                                   *map(jnp.asarray, knobs), jnp.asarray(seen), jnp.asarray(allow))
    monkeypatch.undo()
    return caught[0]


def test_sampler_support_per_slot_matches_jax(monkeypatch):
    """Each slot its own knobs (greedy, top-k, top-p, both, a penalty, a
    guide mask). The support (finite logits) is identical, the kept logits
    agree to 1e-6 (f32, same operations), greedy rows are equal, and every
    draw lies in its row's support."""
    rng = np.random.default_rng(3)
    B, V = 5, 300
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    seen = rng.random((B, V)) < 0.2
    allow = np.ones((B, V), bool)
    allow[4] = rng.random(V) < 0.1
    knobs = (np.array([1.0, 0.7, 1.3, 0.9, 1.0], np.float32), np.array([0, 5, 0, 40, 0], np.int64),
             np.array([1.0, 1.0, 0.6, 0.75, 0.9], np.float32), np.array([False, True, True, True, True]),
             np.array([1.0, 1.0, 1.2, 1.1, 1.0], np.float32))
    want = _jax_filtered(logits, knobs, seen, allow, monkeypatch)
    t = [torch.from_numpy(k) for k in knobs]
    greedy, got = tengine.filter_logits_per_slot(
        torch.from_numpy(logits), t[0], t[1], t[2], t[4], torch.from_numpy(seen), torch.from_numpy(allow))
    got = got.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    keep = np.isfinite(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)
    jgreedy = jengine.sample_logits_per_slot(jnp.asarray(logits), jax.random.PRNGKey(0), *map(jnp.asarray, knobs[:3]),
                                             jnp.zeros(B, bool), jnp.asarray(knobs[4]), jnp.asarray(seen),
                                             jnp.asarray(allow))
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(jgreedy))
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = tengine.sample_logits_per_slot(torch.from_numpy(logits), gen, *t, torch.from_numpy(seen),
                                             torch.from_numpy(allow)).numpy()
        assert keep[np.arange(B), tok].all()
        assert tok[0] == greedy[0]


def test_sampled_slot_keeps_greedy_neighbour_exact(pair):
    te = pair[1]
    ref = te.generate(np.array([9, 8, 7], np.int32), max_new_tokens=8)
    rs = te.submit(tengine.EngineRequest(np.array([1, 2, 3], np.int32), max_new_tokens=8, do_sample=True,
                                         temperature=1.3, top_k=20, top_p=0.9))
    rg = te.submit(tengine.EngineRequest(np.array([9, 8, 7], np.int32), max_new_tokens=8))
    out_s, out_g = list(rs.tokens()), list(rg.tokens())
    assert out_g == ref and len(out_s) == 8 and all(0 <= t < TCFG.vocab_size for t in out_s)


def test_prefix_cache_parity_reuse_and_no_aliasing(tiny):
    """Repeated, truncated and extended prompts restore stored rows and decode
    as JAX does, with the same hit counters. The port writes caches in
    place, so a hit restores a copy: a truncated prompt's tail prefill (its
    pad rows land on rows the stored prompt holds) leaves the stored entry's
    rows as they were, and the next request restoring them still matches JAX."""
    engines = _engines(tiny, max_slots=2, max_len=128, prefill_chunk=8, prefix_cache=4,
                       prefix_cache_min_tokens=4)
    je, te = engines
    try:
        base = (np.arange(1, 25, dtype=np.int32) * 7) % 250 + 1
        ext = np.concatenate([base, np.array([7, 9, 11, 13, 2], np.int32)])
        want, got = _both(engines, [base], max_new_tokens=8)
        assert got == want
        entry = te._prefix_lru[base.tobytes()]
        stored = [t.clone() for t in entry["cache"].k + entry["cache"].v]
        want, got = _both(engines, [base[:10]], max_new_tokens=8)  # restores 8 rows of `base`
        assert got == want and te.stats()["prefix_cache_hits"] == 1
        assert all(torch.equal(a, b) for a, b in zip(stored, entry["cache"].k + entry["cache"].v))
        assert entry["cache"].length == len(base)
        for p in (base, ext):  # restore 16 rows of `base`, then 24 of `base`'s newer entry
            want, got = _both(engines, [p], max_new_tokens=8)
            assert got == want
        s, js = te.stats(), je.stats()
        for key in ("prefix_cache_hits", "prefix_tokens_reused", "prefix_cache_entries"):
            assert s[key] == js[key], key
        assert s["prefix_cache_hits"] == 3 and s["prefix_tokens_reused"] == 8 + 16 + 24
    finally:
        je.stop()
        te.stop()


def test_warm_prefix_and_lru(tiny):
    engines = _engines(tiny, max_slots=2, max_len=128, prefill_chunk=8, prefix_cache=1, prefix_cache_min_tokens=4)
    je, te = engines
    try:
        system = (np.arange(1, 33, dtype=np.int32) * 3) % 250 + 1
        assert te.warm_prefix(system) == je.warm_prefix(system) == len(system)
        prompt = np.concatenate([system, np.array([9, 4, 2], np.int32)])
        want, got = _both(engines, [prompt], max_new_tokens=8)
        assert got == want
        s = te.stats()
        assert s["prefix_cache_hits"] == 1 and s["prefix_tokens_reused"] == len(system)
        assert s["prefix_cache_entries"] == 1
        other = (np.arange(1, 20, dtype=np.int32) * 11) % 250 + 1
        te.generate(other, max_new_tokens=4)
        assert te.stats()["prefix_cache_entries"] == 1
    finally:
        je.stop()
        te.stop()


def test_guided_choice_matches_jax(pair):
    """Guided slots emit exactly what JAX's do (a full choice, the shortest
    match winning) while a free slot beside them stays exact."""
    je, te = pair
    choices = [[7, 8, 9, 10], [7, 11], [200, 201, 202]]
    outs = []
    for eng, mod in pair_mods(pair):
        rg = eng.submit(mod.EngineRequest(PROMPT, max_new_tokens=16, guided_token_seqs=choices))
        rf = eng.submit(mod.EngineRequest(PROMPT, max_new_tokens=8))
        r2 = eng.submit(mod.EngineRequest(PROMPT, max_new_tokens=16, guided_token_seqs=[[42, 1, 2, 3], [42, 1]]))
        outs.append([list(r.tokens()) for r in (rg, rf, r2)])
    assert outs[1] == outs[0]
    assert outs[1][0] in choices and outs[1][2] == [42, 1]
    assert te.active_slots == 0


def pair_mods(pair):
    return ((pair[0], jengine), (pair[1], tengine))


def test_int4_quantized_weights(tiny):
    """The pool serves khalf int4 weights (the port's WOQLinear: the plain
    products on the CPU) with JAX's greedy tokens."""
    from intel_extension_for_transformers_tpu.quantization import RtnConfig, quantize_model

    q = quantize_model(tiny[0], RtnConfig(weight_dtype="int4", group_size=32)).params
    engines = _engines((q, llama_from_numpy(tree_to_numpy(q), TCFG, device="cpu")), max_slots=2, max_len=128)
    try:
        want, got = _both(engines, [PROMPT, np.array([7, 1, 42], np.int32)], max_new_tokens=10)
        assert got == want
    finally:
        for e in engines:
            e.stop()


def test_speculation_self_draft_exact_in_fewer_steps(tiny):
    engines = _engines(tiny, draft=tiny, max_slots=2, max_len=128, num_speculative_tokens=4)
    try:
        steps0 = engines[1]._steps
        want, got = _both(engines, [PROMPT], max_new_tokens=16)
        assert got == want
        np.testing.assert_array_equal(np.array(got[0]),
                                      generate(tiny[0], JCFG, PROMPT, SamplingConfig(max_new_tokens=16))[0])
        assert engines[1]._steps - steps0 <= 6  # 1 token from the prefill, 15 in steps of up to 5
    finally:
        for e in engines:
            e.stop()


def test_speculation_admissions_behind_a_step_stay_exact(tiny):
    """Prompts of several chunks admitted while other slots speculate: each
    request's greedy tokens equal plain greedy decoding. A slot admitted
    behind a pool step holds none of that step's tokens (the JAX engine
    emitted the empty row's into the new request, so it is not compared
    here; its own tests admit one prompt at a time)."""
    params, model = tiny
    dparams = jllama.llama_init_params(jax.random.PRNGKey(7), JCFG)
    dmodel = llama_from_numpy(tree_to_numpy(dparams), TCFG, device="cpu")
    prompts = [np.random.default_rng(i).integers(1, 250, size=20 + 9 * i).astype(np.int32) for i in range(4)]
    eng = tengine.DecodeEngine(model, TCFG, device="cpu", max_slots=4, max_len=128, prefill_chunk=16,
                               draft_model=dmodel, draft_config=TCFG, num_speculative_tokens=3).start()
    try:
        got = _serve(eng, tengine, prompts, max_new_tokens=10)
    finally:
        eng.stop()
    for p, toks in zip(prompts, got):
        np.testing.assert_array_equal(np.array(toks), generate(params, JCFG, p, SamplingConfig(max_new_tokens=10))[0])


def test_speculation_adversarial_draft_still_exact(tiny):
    dparams = jllama.llama_init_params(jax.random.PRNGKey(123), JCFG)
    draft = (dparams, llama_from_numpy(tree_to_numpy(dparams), TCFG, device="cpu"))
    engines = _engines(tiny, draft=draft, max_slots=2, max_len=128, num_speculative_tokens=3)
    try:
        prompt = np.array([7, 1, 42], np.int32)
        want, got = _both(engines, [prompt, PROMPT], max_new_tokens=12)
        assert got == want
        te = engines[1]
        rs = te.submit(tengine.EngineRequest(np.array([1, 2, 3], np.int32), max_new_tokens=12, do_sample=True,
                                             temperature=1.2, top_k=16))
        rg = te.submit(tengine.EngineRequest(prompt, max_new_tokens=12))
        assert list(rg.tokens()) == got[0] and len(list(rs.tokens())) == 12
    finally:
        for e in engines:
            e.stop()


def test_concurrent_admissions(tiny):
    """Two 4-chunk prompts admit together under a busy pool at horizon 4:
    JAX's tokens, in far fewer steps than serialized admissions need."""
    C = 8
    engines = _engines(tiny, max_slots=4, max_len=128, prefill_chunk=C, decode_horizon=4, max_admissions=2)
    try:
        prompts = [np.arange(1, 1 + 4 * C, dtype=np.int32) % 250, (np.arange(1, 1 + 4 * C, dtype=np.int32) * 3) % 250]
        outs = []
        for eng, mod in pair_mods(engines):
            bg = eng.submit(mod.EngineRequest(np.array([9, 8, 7], np.int32), max_new_tokens=96))
            while eng.active_slots == 0:
                time.sleep(0.002)
            steps0 = eng._steps
            outs.append(_serve(eng, mod, prompts, max_new_tokens=4))
            assert eng._steps - steps0 <= 2 * 4 + 8
            bg.cancel()
        assert outs[1] == outs[0]
        assert engines[1].stats()["max_admissions"] == 2
    finally:
        for e in engines:
            e.stop()


def test_32_slot_int8_kv_pool(tiny):
    """40 requests on a 32-slot int8-KV pool at horizon 4: JAX's tokens for
    every stream (int8 codes are bit for bit with JAX's), batched."""
    engines = _engines(tiny, max_slots=32, max_len=96, kv_dtype="int8", decode_horizon=4, max_admissions=8)
    try:
        prompts = [(np.arange(1, 6, dtype=np.int32) * (i + 2)) % 250 for i in range(40)]
        steps0 = engines[1]._steps
        want, got = _both(engines, prompts, max_new_tokens=8)
        assert got == want
        assert engines[1]._steps - steps0 < 40 * 8 // 4
        assert engines[1].stats()["kv_dtype"] == "int8"
    finally:
        for e in engines:
            e.stop()


def test_dead_step_thread_fails_fast(tiny):
    eng = tengine.DecodeEngine(tiny[1], TCFG, max_slots=1, max_len=32, device="cpu")

    def boom():
        raise RuntimeError("boom")

    eng._loop_inner = boom
    req = tengine.EngineRequest(np.array([1, 2, 3], np.int32), max_new_tokens=4)
    eng.submit(req)
    eng.start()
    with pytest.raises(RuntimeError, match="step thread died"):
        list(req.tokens())
    eng._thread.join(timeout=10)
    assert isinstance(eng.fatal_error, RuntimeError)
    with pytest.raises(RuntimeError, match="step thread died"):
        eng.submit(tengine.EngineRequest(np.array([1], np.int32)))


def test_a_failing_step_fails_waiting_consumers(tiny, monkeypatch):
    """An error inside a pool step (not a stubbed loop) ends the thread,
    sets fatal_error, and fails the running and queued requests."""
    eng = tengine.DecodeEngine(tiny[1], TCFG, max_slots=1, max_len=64, device="cpu").start()

    def bad_step(*a, **k):
        raise RuntimeError("step failed")

    monkeypatch.setattr(tengine, "_engine_step_multi", bad_step)
    running = eng.submit(tengine.EngineRequest(PROMPT, max_new_tokens=8))
    queued = eng.submit(tengine.EngineRequest(PROMPT, max_new_tokens=8))
    for req in (running, queued):
        with pytest.raises(RuntimeError, match="step thread died"):
            list(req.tokens())
    assert "step failed" in str(eng.fatal_error)
    eng.stop()


def test_pp_state_raises(tiny):
    with pytest.raises(NotImplementedError, match="step 7"):
        tengine.DecodeEngine(tiny[1], TCFG, device="cpu", pp_state=object())
    with pytest.raises(ValueError, match="draft_model and draft_config"):
        tengine.DecodeEngine(tiny[1], TCFG, device="cpu", draft_model=tiny[1])


def test_submits_from_many_threads(pair):
    """12 threads (more than the host's cores) submit at once with a short
    switch interval: each gets the tokens its prompt gets alone, and the
    engine's counters lose no request and no token."""
    import sys

    te = pair[1]
    prompts = [np.array([3 + i, 1, 4, 1, 5], np.int32) for i in range(12)]
    alone = [te.generate(p, max_new_tokens=6) for p in prompts]
    s0 = te.stats()
    got = [None] * len(prompts)

    def work(i):
        got[i] = te.generate(prompts[i], max_new_tokens=6)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert got == alone
    s1 = te.stats()
    assert s1["completed_requests"] - s0["completed_requests"] == len(prompts)
    assert s1["total_tokens"] - s0["total_tokens"] == 6 * len(prompts)
