"""Port parity: the engine's KV compaction, H2O mass, eviction policies,
chunked prefill and decode horizon against the JAX package's, on
`LlamaConfig.tiny()` weights carried over by the bridge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import tree_to_numpy

from intel_extension_for_transformers_tpu.models import engine as jengine
from intel_extension_for_transformers_tpu.models import llama as jllama
from intel_extension_for_transformers_tpu.models.generation import SamplingConfig, generate
from intel_extension_for_transformers_tpu.ops import layers as jlayers
from intel_extension_for_transformers_tpu_torch.bridge import llama_from_numpy
from intel_extension_for_transformers_tpu_torch.models import engine as tengine
from intel_extension_for_transformers_tpu_torch.models import llama as tllama
from intel_extension_for_transformers_tpu_torch.ops import layers as tlayers

torch.set_num_threads(1)

KW = dict(vocab_size=256, hidden_size=64, intermediate_size=128)
JCFG, TCFG = jllama.LlamaConfig.tiny(**KW), tllama.LlamaConfig.tiny(**KW)
PROMPT = np.array([5, 17, 99, 3], np.int32)


@pytest.fixture(scope="module")
def tiny():
    params = jllama.llama_init_params(jax.random.PRNGKey(0), JCFG)
    return params, llama_from_numpy(tree_to_numpy(params), TCFG, device="cpu")


def _both(tiny, prompts, engine_kw, draft=False, **kw):
    """Serve `prompts` on a JAX and a port engine of the same settings → (JAX tokens, port tokens, port engine)."""
    params, model = tiny
    jkw, tkw = dict(engine_kw), dict(engine_kw)
    if draft:
        jkw.update(draft_params=params, draft_config=JCFG)
        tkw.update(draft_model=model, draft_config=TCFG)
    outs = []
    for eng, mod in ((jengine.DecodeEngine(params, JCFG, **jkw), jengine),
                     (tengine.DecodeEngine(model, TCFG, device="cpu", **tkw), tengine)):
        eng.start()
        try:
            reqs = [eng.submit(mod.EngineRequest(np.asarray(p, np.int32), **kw)) for p in prompts]
            outs.append([list(r.tokens()) for r in reqs])
        finally:
            eng.stop()
    return outs[0], outs[1], eng


def _to_torch(x):
    if x.dtype == jnp.bfloat16:  # exact through f32
        return torch.tensor(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    return torch.tensor(np.asarray(x))


def _filled_caches(tiny, kv_dtype, L=48, S=64):
    """A prompt prefilled by the JAX apply into a 1-row cache of S rows, laid
    out as a 2-slot engine pool (slot 1 holds it) in each package's layout,
    the port's holding the same values."""
    params, _ = tiny
    ids = np.random.default_rng(1).integers(0, 256, size=(1, L)).astype(np.int32)
    jc = jllama.init_kv_cache(JCFG, 1, S, dtype=jnp.bfloat16 if kv_dtype == "bfloat16" else "int8")
    _, jc = jllama.llama_apply(params, JCFG, jnp.asarray(ids), jc)

    def jpool(lst):  # (slots, 1, S, ...)
        return None if lst is None else [jnp.concatenate([jnp.zeros_like(x), x])[:, None] for x in lst]

    def tpool(lst):  # (slots, S, ...)
        return None if lst is None else [torch.cat([torch.zeros_like(t), t]) for t in map(_to_torch, lst)]

    jb = jllama.KVCache(k=jpool(jc.k), v=jpool(jc.v), length=jnp.full((2,), L, jnp.int32),
                        k_scale=jpool(jc.k_scale), v_scale=jpool(jc.v_scale))
    tb = tllama.KVCache(k=tpool(jc.k), v=tpool(jc.v), length=torch.full((2,), L),
                        k_scale=tpool(jc.k_scale), v_scale=tpool(jc.v_scale))
    return jb, tb


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("policy", ["sink", "heavy"])
def test_compact_cache_slot_matches_jax(tiny, kv_dtype, policy):
    """Tolerance. Values (and their int8 scales) move bit for bit, and rows
    that do not move (delta 0) keep their keys bit for bit. Moved keys
    rotate in f32 by cos/sin of the delta angle, which torch and XLA may
    round one f32 ulp apart: bf16 keys then differ by at most one bf16 ulp
    (2^-8 relative), int8 codes by at most 1 with scales within 1e-6
    relative, and at least 97% of the moved keys' entries are bit for bit.
    The untouched slot stays as it was, and the length becomes K."""
    jb, tb = _filled_caches(tiny, kv_dtype)
    L = 48
    if policy == "sink":
        keep = np.concatenate([np.arange(4), np.arange(L - 16, L)])
    else:
        keep = np.sort(np.random.default_rng(2).choice(L - 8, 12, replace=False))
        keep = np.concatenate([keep, np.arange(L - 8, L)])
    K = len(keep)
    jo = jengine._compact_cache_slot(jb, jnp.int32(1), jnp.asarray(keep.astype(np.int32)),
                                     jengine._rope_spec(JCFG))
    before0 = [t[0].clone() for t in tb.k]
    to = tengine._compact_cache_slot(tb, 1, torch.from_numpy(keep), tengine._rope_spec(TCFG))
    assert int(to.length[1]) == int(jo.length[1]) == K and int(to.length[0]) == L
    still = np.arange(K) == keep  # rows whose delta is 0
    same = total = 0
    for li in range(TCFG.num_hidden_layers):
        assert torch.equal(to.k[li][0], before0[li])
        np.testing.assert_array_equal(_f32(to.v[li][1, :K]), _f32(jo.v[li][1, 0, :K]))
        jk, tk = _f32(jo.k[li][1, 0, :K]), _f32(to.k[li][1, :K])
        if kv_dtype == "int8":
            np.testing.assert_array_equal(_f32(to.v_scale[li][1, :K]), _f32(jo.v_scale[li][1, 0, :K]))
            np.testing.assert_allclose(_f32(to.k_scale[li][1, :K]), _f32(jo.k_scale[li][1, 0, :K]), rtol=1e-6)
            assert np.abs(tk - jk).max() <= 1
        else:
            np.testing.assert_allclose(tk, jk, rtol=2**-8, atol=0)
        np.testing.assert_array_equal(tk[still], jk[still])
        same += int((tk[~still] == jk[~still]).sum())
        total += tk[~still].size
    assert same >= 0.97 * total, same / total


def test_h2o_mass_matches_jax_tap(tiny):
    """Tolerance: 2e-6 absolute. The per-key attention mass that each
    package's tap collects over one cached forward (a 6-token chunk after a
    20-token prefill, summed over layers and heads, probabilities in
    [0, 1]) agrees to f32 rounding of the logits."""
    params, model = tiny
    ids = np.random.default_rng(4).integers(0, 256, size=(2, 26)).astype(np.int32)
    jc = jllama.init_kv_cache(JCFG, 2, 32)
    _, jc = jllama.llama_apply(params, JCFG, jnp.asarray(ids[:, :20]), jc)
    tc = tllama.init_kv_cache(TCFG, 2, 32)
    _, tc = tllama.llama_apply(model, TCFG, torch.from_numpy(ids[:, :20]), tc)
    jtap, ttap = [], []
    jlayers.set_mass_tap(jtap)
    try:  # un-jitted, as the JAX engine taps it
        jengine._eager(jllama.llama_apply)(params, JCFG, jnp.asarray(ids[:, 20:]), jc)
    finally:
        jlayers.set_mass_tap(None)
    tlayers.set_mass_tap(ttap)
    try:
        tllama.llama_apply(model, TCFG, torch.from_numpy(ids[:, 20:]), tc)
    finally:
        tlayers.set_mass_tap(None)
    assert len(ttap) == len(jtap) == TCFG.num_hidden_layers
    want, got = np.asarray(sum(jtap)), sum(ttap).numpy()
    assert got.shape == want.shape == (2, 6, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert tlayers.get_mass_tap() is None


@pytest.mark.parametrize("name,engine_kw,draft,prompt_len,n", [
    ("sink", dict(kv_policy="sink", kv_sink=4, kv_recent=24), False, 8, 150),
    ("h2o", dict(kv_policy="h2o", kv_heavy=16, kv_recent=16), False, 8, 120),
    ("sink int8", dict(kv_dtype="int8", kv_policy="sink", kv_sink=4, kv_recent=24), False, 8, 120),
    ("sink horizon 4", dict(decode_horizon=4, kv_policy="sink", kv_sink=4, kv_recent=24), False, 8, 120),
    ("sink speculative", dict(kv_policy="sink", kv_sink=4, kv_recent=24, num_speculative_tokens=3), True, 8, 120),
    ("sink long prompt", dict(prefill_chunk=16, kv_policy="sink", kv_sink=4, kv_recent=24), False, 200, 20),
    ("h2o long prompt", dict(prefill_chunk=16, kv_policy="h2o", kv_heavy=16, kv_recent=16), False, 200, 12),
])
def test_policies_serve_past_max_len_like_jax(tiny, name, engine_kw, draft, prompt_len, n):
    """Tolerance: none. A slot generates (or ingests a prompt) far past
    max_len = 64 from a bounded cache, compacting several times, with JAX's
    tokens."""
    prompt = (np.arange(1, prompt_len + 1, dtype=np.int32) * 3) % 250
    want, got, eng = _both(tiny, [prompt], dict(max_slots=2, max_len=64, **engine_kw), draft=draft,
                           max_new_tokens=n)
    assert len(got[0]) == n
    assert got == want
    assert eng._compactions >= 2 and int(eng._host_len[0]) <= 64


def test_policy_keep_size_validation(tiny):
    with pytest.raises(ValueError):
        tengine.DecodeEngine(tiny[1], TCFG, max_len=32, kv_policy="sink", kv_sink=4, kv_recent=32, device="cpu")
    with pytest.raises(ValueError):
        tengine.DecodeEngine(tiny[1], TCFG, kv_policy="lru", device="cpu")


def test_chunked_prefill_parity(tiny):
    """A 3-chunk prompt decodes as JAX's engine and one-shot generate do.
    With a 1-chunk prompt admitted beside it (which finishes first), the
    port's tokens for both still equal JAX's generate; the JAX engine itself
    cannot run that case (its list.remove compares two admissions' dicts
    with ==, and their arrays refuse)."""
    prompt = (np.arange(1, 41, dtype=np.int32) * 7) % 251
    want, got, eng = _both(tiny, [prompt], dict(max_slots=2, max_len=128, prefill_chunk=16), max_new_tokens=12)
    assert got == want
    assert eng._chunks == 3
    eng = tengine.DecodeEngine(tiny[1], TCFG, max_slots=2, max_len=128, prefill_chunk=16, device="cpu").start()
    try:
        reqs = [eng.submit(tengine.EngineRequest(p, max_new_tokens=12)) for p in (prompt, PROMPT)]
        got = [list(r.tokens()) for r in reqs]
    finally:
        eng.stop()
    for p, out in zip((prompt, PROMPT), got):
        np.testing.assert_array_equal(np.array(out), generate(tiny[0], JCFG, p, SamplingConfig(max_new_tokens=12))[0])


@pytest.mark.parametrize("t", [90, 97, 98])
def test_last_chunk_past_max_len(tiny, t):
    """max_len 100, chunks of 32: a 97- or 98-token prompt's last chunk would
    write rows 96..127. JAX's `dynamic_update_slice` clamps its start into
    the cache (rows 68..99, positions still 96..127); the port's cache write
    clamps the same way, so the tokens match JAX's (t = 90 stays inside)."""
    prompt = (np.arange(1, t + 1, dtype=np.int32) * 5) % 250
    want, got, eng = _both(tiny, [prompt], dict(max_slots=2, max_len=100, prefill_chunk=32), max_new_tokens=6)
    assert got == want and len(got[0]) >= 1
    assert eng._chunks == -(-t // 32)


def test_horizon_parity_and_fewer_dispatches(tiny):
    prompts = [np.array([i + 1, i + 2, i + 3], np.int32) for i in range(4)]
    want, got, eng = _both(tiny, prompts, dict(max_slots=4, max_len=128, decode_horizon=4), max_new_tokens=13)
    assert got == want
    for p, out in zip(prompts, got):
        np.testing.assert_array_equal(np.array(out), generate(tiny[0], JCFG, p, SamplingConfig(max_new_tokens=13))[0])
    assert eng._steps <= 7 and eng.stats()["decode_horizon"] == 4


def test_horizon_eos_mid_burst(tiny):
    full = generate(tiny[0], JCFG, PROMPT, SamplingConfig(max_new_tokens=12))[0]
    want, got, eng = _both(tiny, [PROMPT], dict(max_slots=2, max_len=128, decode_horizon=4), max_new_tokens=12,
                           eos_token_id=int(full[6]))
    assert got == want == [list(full[:6])]
    assert eng.active_slots == 0


def test_horizon_guided_choice(tiny):
    seqs = [[11, 22, 33], [44, 55]]
    want, got, _ = _both(tiny, [np.array([1, 2, 3], np.int32)], dict(max_slots=2, max_len=128, decode_horizon=4),
                         max_new_tokens=32, guided_token_seqs=seqs)
    assert got == want and got[0] in seqs


def test_guided_device_state_growth(tiny):
    seqs = [[40, 41, 42, 43, 44, 45], [40, 41, 52], [40, 61, 62, 63]]
    want, got, eng = _both(tiny, [np.array([5, 6], np.int32)], dict(max_slots=2, max_len=64), max_new_tokens=8,
                           guided_token_seqs=seqs)
    assert got == want and got[0] in seqs
    assert eng._guide.seqs.shape[1] >= 3 and eng._guide.seqs.shape[2] >= 6
