"""The port's generation modes on the card: beam search, speculative decoding
and the KV policies on a tiny khalf int4 Llama (K1 in every product), against
the same model on the CPU (the plain K1 twin).

Marked `cuda`: each test skips on a host without a CUDA device. This file
imports no jax (the machine with the card has none). Run it there with
`python -m pytest --noconftest tests/test_torch_cuda_generation.py -m cuda -p no:cacheprovider`.
The two sides differ only in the f32 summation order of each product (the
model is f32), so greedy tokens, beams and victims are equal and scores
agree within 1e-4.
"""

import copy

import numpy as np
import pytest
import torch

from intel_extension_for_transformers_tpu_torch.models import generation, kv_policies, speculative
from intel_extension_for_transformers_tpu_torch.models.llama import LlamaConfig, llama_init_params
from intel_extension_for_transformers_tpu_torch.ops import quant_matmul
from intel_extension_for_transformers_tpu_torch.quantization import RtnConfig, quantize_model

pytestmark = pytest.mark.cuda

CFG = LlamaConfig.tiny()
DRAFT = LlamaConfig.tiny(num_hidden_layers=1)
PROMPT = (np.arange(11, dtype=np.int32) * 37 + 5) % 500
GREEDY = generation.SamplingConfig(max_new_tokens=16, do_sample=False, repetition_penalty=1.0)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from intel_extension_for_transformers_tpu_torch.utils.device import require_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    return require_cuda()


def _khalf(cfg, seed):
    model = llama_init_params(torch.Generator().manual_seed(seed), cfg)
    return quantize_model(model, RtnConfig(weight_dtype="int4", group_size=32)).params


@pytest.fixture(scope="module")
def models(dev):
    cpu, draft = _khalf(CFG, 0), _khalf(DRAFT, 1)
    return cpu, copy.deepcopy(cpu).to(dev), draft, copy.deepcopy(draft).to(dev)


def _k1_by_m():
    """K1's launches by M, counted by its wrapper from here on."""
    by_m = quant_matmul.woq_int4_cuda.launches_by_m
    by_m.clear()
    return by_m


def test_beam_on_the_card_matches_the_cpu(models):
    cpu, card, _, _ = models
    by_m = _k1_by_m()
    got_ids, got_score = generation.generate_beam(card, CFG, PROMPT, num_beams=4, max_new_tokens=12)
    want_ids, want_score = generation.generate_beam(cpu, CFG, PROMPT, num_beams=4, max_new_tokens=12)
    np.testing.assert_array_equal(got_ids, want_ids)
    assert abs(got_score - want_score) <= 1e-4
    assert by_m.get(4, 0) == 7 * CFG.num_hidden_layers * 11  # 11 beam steps feed a forward


def test_speculative_on_the_card_is_greedy_decoding(models):
    cpu, card, _, draft = models
    by_m = _k1_by_m()
    want = generation.generate(cpu, CFG, PROMPT, GREEDY)
    for d, dcfg, rate in ((draft, DRAFT, None), (card, CFG, 1.0)):
        stats = {}
        got = speculative.generate_speculative(card, CFG, d, dcfg, PROMPT, GREEDY, spec_k=4, stats=stats)
        np.testing.assert_array_equal(got, want)
        assert rate is None or stats["acceptance_rate"] == rate
    assert by_m.get(1, 0) > 0 and by_m.get(5, 0) > 0  # draft steps (the GEMV), verify forwards (the tiles)


@pytest.mark.parametrize("policy", [kv_policies.H2OKVPolicy(budget=len(PROMPT) + 6, recent_size=4),
                                    kv_policies.AttentionSinkKVPolicy(budget=len(PROMPT) + 6, sink_size=2)])
def test_policy_on_the_card_matches_the_cpu(models, policy):
    cpu, card, _, _ = models
    ids = np.stack([PROMPT, PROMPT[::-1]])
    got = generation.generate(card, CFG, ids, GREEDY, kv_policy=policy)
    np.testing.assert_array_equal(got, generation.generate(cpu, CFG, ids, GREEDY, kv_policy=policy))
