"""The port's serving engine on the card.

Marked `cuda`: each test skips on a host without a CUDA device. This file
imports no jax (the machine with the card has none). Run it there with
`python -m pytest --noconftest tests/test_torch_cuda_engine.py -m cuda -p no:cacheprovider`.
"""

import copy

import numpy as np
import pytest
import torch

from intel_extension_for_transformers_tpu_torch.models import engine as engine_module
from intel_extension_for_transformers_tpu_torch.models.engine import DecodeEngine, EngineRequest
from intel_extension_for_transformers_tpu_torch.models.llama import LlamaConfig, llama_init_params
from intel_extension_for_transformers_tpu_torch.ops import quant_matmul
from intel_extension_for_transformers_tpu_torch.quantization import RtnConfig, quantize_model

pytestmark = pytest.mark.cuda

CFG = LlamaConfig.tiny()
PROMPTS = [np.random.default_rng(i).integers(1, 500, size=5 + 7 * i).astype(np.int32) for i in range(6)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from intel_extension_for_transformers_tpu_torch.utils.device import require_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    return require_cuda()


def _khalf(dtype):
    model = llama_init_params(torch.Generator().manual_seed(0), CFG, dtype=dtype)
    return quantize_model(model, RtnConfig(weight_dtype="int4", group_size=32)).params


def _run(model, device, **kw):
    eng = DecodeEngine(model, CFG, max_slots=4, max_len=128, device=device, **kw).start()
    try:
        reqs = [eng.submit(EngineRequest(p, max_new_tokens=12)) for p in PROMPTS]
        return [list(r.tokens()) for r in reqs], eng
    finally:
        eng.stop()


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_card_engine_matches_the_cpu_engine(dev, kv_dtype):
    """Tolerance: none. An f32 khalf model runs K1's SIMT tiles (f32 x) on
    the card and the plain product on the CPU, which differ in summation
    order only (1e-5 relative); the tiny model's top-2 logit gaps are far
    wider, so the greedy tokens are the same, 6 requests on 4 slots."""
    model = _khalf(torch.float32)
    want, _ = _run(model, "cpu", kv_dtype=kv_dtype)
    n0 = quant_matmul.woq_int4_cuda.launches
    got, eng = _run(copy.deepcopy(model).to(dev), None, kv_dtype=kv_dtype)
    assert eng.device.type == "cuda" and eng.fatal_error is None
    assert quant_matmul.woq_int4_cuda.launches > n0
    assert got == want


def _state(eng, H):
    return (eng.model, CFG, eng._cache, eng._tokens, eng._generator, *eng._device_knobs(), eng._seen,
            eng._guide, eng._accum, H, eng._with_mass)


@pytest.mark.parametrize("kw", [dict(), dict(kv_dtype="int8"), dict(kv_policy="h2o", kv_heavy=16, kv_recent=16)])
def test_horizon_burst_never_syncs(dev, kw):
    """A horizon-4 burst of pool steps (two requests in the pool, one of them
    sampled) queues every launch with no host sync: it runs under
    torch.cuda.set_sync_debug_mode("error")."""
    model = _khalf(torch.bfloat16).to(dev)
    eng = DecodeEngine(model, CFG, max_slots=4, max_len=128, decode_horizon=4, **kw)
    eng.submit(EngineRequest(PROMPTS[1], max_new_tokens=100))
    eng.submit(EngineRequest(PROMPTS[2], max_new_tokens=100, do_sample=True, temperature=0.8, top_k=20, top_p=0.9))
    eng._admit_pending()
    while eng._adms:
        eng._step_admissions()
    assert eng.active_slots == 2
    engine_module._engine_step_multi(*_state(eng, 4))  # warm-up: the split-K counters are made once
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks = engine_module._engine_step_multi(*_state(eng, 4))[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    toks = toks.cpu().numpy()
    assert toks.shape == (4, 4) and ((0 <= toks) & (toks < CFG.vocab_size)).all()


def test_pool_steps_run_k1_tiles_at_m_slots(dev):
    """Each pool step runs every int4 product once at M = max_slots on K1's
    tensor-core tiles (bf16 x, M > K1_GEMV_MAX_M); each prefill chunk at
    M = prefill_chunk."""
    model = _khalf(torch.bfloat16).to(dev)
    ms = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: ms.append(args[0].numel() // args[0].shape[-1]))
             for m in model.modules() if isinstance(m, quant_matmul.WOQLinear)]
    tiles0 = quant_matmul.woq_int4_cuda.tile_launches
    eng = DecodeEngine(model, CFG, max_slots=8, max_len=128, prefill_chunk=16).start()
    try:
        out = eng.generate(PROMPTS[3], max_new_tokens=6)
    finally:
        eng.stop()
        for h in hooks:
            h.remove()
    n_products = 7 * CFG.num_hidden_layers
    assert len(out) == 6 and eng._steps == 5 and eng._chunks == 2
    assert ms.count(8) == n_products * eng._steps
    assert ms.count(16) == n_products * eng._chunks
    assert quant_matmul.k1_route(torch.empty(8, CFG.hidden_size, dtype=torch.bfloat16, device=dev), 8, 32) == "tiles"
    assert quant_matmul.woq_int4_cuda.tile_launches - tiles0 == len(ms)


def test_pool_step_captures_as_one_cuda_graph(dev):
    """One pool step (forward, sampler, guide, seen) captured as a CUDA graph
    and replayed gives the eager step's greedy tokens (slots 0 and 1; slot 2
    samples), lengths and seen rows from the same state: the step holds
    nothing a capture refuses once its stream has run it (the split-K
    counters) and the engine's generator is registered with the graph."""
    model = _khalf(torch.bfloat16).to(dev)
    eng = DecodeEngine(model, CFG, max_slots=4, max_len=128)
    for p in PROMPTS[:3]:
        eng.submit(EngineRequest(p, max_new_tokens=100, do_sample=p is PROMPTS[2], temperature=0.8))
    eng._admit_pending()
    while eng._adms:
        eng._step_admissions()
        eng._admit_pending()
    assert eng.active_slots == 3

    def snapshot():
        c = eng._cache
        return ([t.clone() for t in c.k + c.v], c.length.clone(), eng._tokens.clone(), eng._seen.clone(),
                eng._generator.get_state())

    def restore(snap):
        bufs, length, tokens, seen, rng = snap
        for dst, src in zip(eng._cache.k + eng._cache.v, bufs):
            dst.copy_(src)
        eng._cache.length.copy_(length)
        eng._tokens.copy_(tokens)
        eng._seen.copy_(seen)
        eng._generator.set_state(rng)

    def step():
        return engine_module._step_body(model, CFG, eng._cache, eng._tokens, eng._generator, *eng._device_knobs(),
                                        eng._seen, eng._guide, eng._accum)

    start = snapshot()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()  # the split-K counters of the capturing stream
    torch.cuda.current_stream().wait_stream(side)
    restore(start)
    want_tok, want_cache, want_seen, _, _ = step()
    want = (want_tok.clone(), want_cache.length.clone(), want_seen.clone())
    restore(start)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(eng._generator)
    with torch.cuda.graph(graph, stream=side):
        got_tok, got_cache, got_seen, _, _ = step()
    restore(start)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got_tok[:2], want[0][:2])
    assert torch.equal(got_cache.length, want[1]) and torch.equal(got_seen[:2], want[2][:2])
