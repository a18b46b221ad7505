"""Port parity for the HF converters: tiny HF models built from local configs
(nothing is downloaded) go through the JAX package's converter and model and
through the port's, on the same token ids.

Tolerance: f32 logits (hidden states for BERT) within 1e-5 relative
(Frobenius): both sides hold the same f32 weights and differ only in the
order of f32 sums. Configs are read by attribute into equal dataclasses."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers as hf

from intel_extension_for_transformers_tpu.models import hf_convert as jhc
from intel_extension_for_transformers_tpu.models.bert import bert_apply as jax_bert_apply
from intel_extension_for_transformers_tpu.models.llama import llama_apply as jax_llama_apply
from intel_extension_for_transformers_tpu_torch.models import hf_convert as thc
from intel_extension_for_transformers_tpu_torch.models.llama import llama_apply

torch.set_num_threads(1)

REL_TOL = 1e-5
SMALL = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, intermediate_size=128, max_position_embeddings=128)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _hf(cls_name, config_name, seed=0, **kw):
    torch.manual_seed(seed)
    model = getattr(hf, cls_name)(getattr(hf, config_name)(**{**SMALL, **kw}))
    return model.eval()


CASES = {
    "llama": ("LlamaForCausalLM", "LlamaConfig", {}),
    "llama tied embeddings": ("LlamaForCausalLM", "LlamaConfig", {"tie_word_embeddings": True}),
    "llama rope linear": ("LlamaForCausalLM", "LlamaConfig", {"rope_scaling": {"rope_type": "linear", "factor": 2.0}}),
    "qwen2 q/k/v biases": ("Qwen2ForCausalLM", "Qwen2Config", {}),
    "mistral sliding window": ("MistralForCausalLM", "MistralConfig", {"sliding_window": 4}),
    "phi3 fused qkv / gate_up": ("Phi3ForCausalLM", "Phi3Config", {"pad_token_id": 0}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_llama_params_from_hf_matches_jax(case):
    cls_name, cfg_name, kw = CASES[case]
    hf_model = _hf(cls_name, cfg_name, **kw)
    jparams, jcfg = jhc.llama_params_from_hf(hf_model)
    model, cfg = thc.llama_params_from_hf(hf_model, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    ids = (np.arange(12, dtype=np.int32)[None] * 37 + 5) % SMALL["vocab_size"]
    want, _ = jax_llama_apply(jparams, jcfg, jnp.asarray(ids))
    got, _ = llama_apply(model, cfg, torch.from_numpy(ids))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), np.asarray(want)) <= REL_TOL
    # the port's model shares no storage with the HF model
    hf_ptrs = {p.data_ptr() for p in hf_model.parameters()}
    assert not any(p.data_ptr() in hf_ptrs for p in model.parameters())


def test_structure_of_special_checkpoints():
    qwen, _ = thc.llama_params_from_hf(_hf(*CASES["qwen2 q/k/v biases"][:2]), device="cpu")
    att = qwen.layers[0].attention
    assert att.q.bias is not None and att.k.bias is not None and att.o.bias is None
    _, cfg = thc.llama_params_from_hf(_hf(*CASES["mistral sliding window"][:2], sliding_window=4), device="cpu")
    assert cfg.sliding_window == 4
    tied = _hf(*CASES["llama tied embeddings"][:2], tie_word_embeddings=True)
    model, _ = thc.llama_params_from_hf(tied, device="cpu")
    assert torch.equal(model.lm_head.weight, model.embed_tokens)
    assert model.lm_head.weight.data_ptr() != model.embed_tokens.data_ptr()  # copied, as JAX does


def test_mixtral_checkpoint_raises():
    hf_model = _hf("MixtralForCausalLM", "MixtralConfig", num_local_experts=2, num_experts_per_tok=1)
    with pytest.raises(NotImplementedError, match="step 10"):
        thc.llama_params_from_hf(hf_model, device="cpu")


@pytest.mark.parametrize("pooler", [True, False])
def test_bert_params_from_hf_matches_jax(pooler):
    torch.manual_seed(1)
    cfg = hf.BertConfig(vocab_size=256, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=128, max_position_embeddings=64)
    hf_model = hf.BertModel(cfg, add_pooling_layer=pooler).eval()
    jparams, jcfg = jhc.bert_params_from_hf(hf_model)
    model, tcfg = thc.bert_params_from_hf(hf_model, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    ids = (np.arange(20, dtype=np.int32).reshape(2, 10) * 11 + 3) % 256
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    want = jax_bert_apply(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    got = model(torch.from_numpy(ids), torch.from_numpy(mask))
    assert _rel(got.detach().numpy(), np.asarray(want)) <= REL_TOL
    assert np.array_equal(model.pooler.weight.detach().numpy(), np.asarray(jparams["pooler"]["kernel"]).T)
