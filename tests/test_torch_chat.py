"""Port parity: the chat API (build_chatbot → predict / predict_stream, the
retrieval plugin, adapters and templates) against the JAX package's, on a
preloaded tiny Llama with the ByteTokenizer and greedy decoding. Greedy text
must be identical."""

import jax
import numpy as np
import pytest
import torch
from torch_port_util import llama_models, tree_to_numpy

from intel_extension_for_transformers_tpu.models import bert as jbert
from intel_extension_for_transformers_tpu.models import llama as jllama
from intel_extension_for_transformers_tpu.models.tokenization import ByteTokenizer as JByteTokenizer
from intel_extension_for_transformers_tpu.neural_chat import GenerationConfig as JGen
from intel_extension_for_transformers_tpu.neural_chat import LoadingModelConfig as JLoad
from intel_extension_for_transformers_tpu.neural_chat import PipelineConfig as JPipe
from intel_extension_for_transformers_tpu.neural_chat import build_chatbot as jbuild
from intel_extension_for_transformers_tpu.neural_chat import prompts as jprompts
from intel_extension_for_transformers_tpu.neural_chat.plugins import reset_plugins as jreset
from intel_extension_for_transformers_tpu.quantization import RtnConfig as JRtn
from intel_extension_for_transformers_tpu.retrieval.embedder import TextEmbedder as JEmbedder
from intel_extension_for_transformers_tpu_torch import bridge
from intel_extension_for_transformers_tpu_torch.models import llama as tllama
from intel_extension_for_transformers_tpu_torch.models.bert import BertConfig
from intel_extension_for_transformers_tpu_torch.models.tokenization import ByteTokenizer
from intel_extension_for_transformers_tpu_torch.neural_chat import (
    GenerationConfig,
    LoadingModelConfig,
    PipelineConfig,
    build_chatbot,
    optimize_model,
    prompts,
)
from intel_extension_for_transformers_tpu_torch.neural_chat.plugins import reset_plugins
from intel_extension_for_transformers_tpu_torch.ops.packing import prepare_for_inference
from intel_extension_for_transformers_tpu_torch.quantization import RtnConfig
from intel_extension_for_transformers_tpu_torch.retrieval.embedder import TextEmbedder
from intel_extension_for_transformers_tpu_torch.utils.error_utils import get_latest_error
from intel_extension_for_transformers_tpu_torch.utils.errorcode import ErrorCodes

torch.set_num_threads(1)

JCFG = jllama.LlamaConfig.tiny()
TCFG = tllama.LlamaConfig.tiny()
GREEDY = dict(max_new_tokens=12, do_sample=False, temperature=1.0, repetition_penalty=1.0)
QUERY = "what do int4 weights pack"


@pytest.fixture(autouse=True)
def _clean_plugins():
    jreset()
    reset_plugins()
    yield
    jreset()
    reset_plugins()


@pytest.fixture(scope="module")
def models():
    return llama_models(JCFG, TCFG, seed=2)


def _bots(params, model, name="tiny-llama-test", jopt=None, topt=None, **plugins):
    jbot = jbuild(JPipe(
        model_name_or_path=name,
        loading_config=JLoad(preloaded=(params, JCFG, JByteTokenizer()), optimization_config=jopt),
        generation_config=JGen(**GREEDY),
        plugins=plugins.get("jax", {}),
    ))
    tbot = build_chatbot(PipelineConfig(
        model_name_or_path=name,
        loading_config=LoadingModelConfig(preloaded=(model, TCFG, ByteTokenizer()), optimization_config=topt),
        generation_config=GenerationConfig(**GREEDY),
        plugins=plugins.get("torch", {}),
    ))
    assert jbot is not None and tbot is not None
    return jbot, tbot


@pytest.mark.parametrize("weights", ["float", "w32"])
def test_predict_identical_text(models, weights):
    """Tolerance: none. Same greedy text; the stream's deltas join to it."""
    jbot, tbot = _bots(*models[weights])
    want = jbot.predict(QUERY)
    assert want and tbot.predict(QUERY) == want
    assert "".join(tbot.predict_stream(QUERY)) == want


def test_optimization_config_quantizes_like_jax(models):
    """Tolerance: none. The chat loader quantizes the float model (RTN int4
    g32) on both sides, to the same bytes, and the greedy text agrees, also
    after prepare_for_inference repacks the port's model into w32."""
    params, _ = models["float"]
    model = bridge.llama_from_numpy(tree_to_numpy(params), TCFG, device="cpu")
    jbot, tbot = _bots(params, model, jopt=JRtn(weight_dtype="int4", group_size=32),
                       topt=RtnConfig(weight_dtype="int4", group_size=32))
    np.testing.assert_array_equal(
        tbot.params.layers[0].mlp.up.data.numpy(),
        np.asarray(jbot.params["layers"][0]["mlp"]["up"]["kernel"].data),
    )
    want = jbot.predict(QUERY)
    assert tbot.predict(QUERY) == want
    prepare_for_inference(tbot.params)
    assert tbot.params.layers[0].attention.q.qt.layout == "w32"
    assert tbot.predict(QUERY) == want


def test_retrieval_plugin_prompt_and_answer_identical(models, tmp_path, monkeypatch):
    """Tolerance: none. The retrieval pre-hook builds the same QA prompt
    from a preloaded tiny BGE embedder over the same files (bf16 index), and
    the chatbot answers it with the same greedy text."""
    for i, topic in enumerate(("int4 weights pack two values per byte with group scales",
                               "a cross encoder reranker scores query passage pairs",
                               "documents are split into overlapping chunks")):
        (tmp_path / f"doc{i}.md").write_text(f"# Doc {i}\n\n" + f"{topic}. " * 6)
    bcfg = jbert.BertConfig.tiny(num_hidden_layers=2)
    enc = jbert.bert_init_params(jax.random.PRNGKey(0), bcfg)
    tenc = bridge.params_from_numpy(tree_to_numpy(enc), BertConfig.tiny(num_hidden_layers=2), device="cpu")
    prompts_seen = {}
    from intel_extension_for_transformers_tpu.neural_chat import base_model as jbase
    from intel_extension_for_transformers_tpu_torch.neural_chat import base_model as tbase

    for side, mod in (("jax", jbase), ("torch", tbase)):
        real = mod.BaseModel._encode_prompt
        monkeypatch.setattr(mod.BaseModel, "_encode_prompt",
                            lambda self, p, side=side, real=real: prompts_seen.setdefault(side, p)
                            and real(self, p))
    jbot, tbot = _bots(
        *models["float"],
        jax={"retrieval": {"embedder": JEmbedder(enc, bcfg), "input_path": str(tmp_path)}},
        torch={"retrieval": {"embedder": TextEmbedder(tenc, BertConfig.tiny(num_hidden_layers=2)),
                             "input_path": str(tmp_path)}},
    )
    want = jbot.predict(QUERY)
    got = tbot.predict(QUERY)
    assert "### Context:" in prompts_seen["torch"]
    assert prompts_seen["torch"] == prompts_seen["jax"]
    assert got == want


def test_conversation_templates_and_adapters_match_jax(models):
    """Tolerance: none. Adapter dispatch by name and the templated prompt."""
    for name in ("meta-llama/Llama-2-7b-chat-hf", "mistralai/Mistral-7B-Instruct",
                 "Intel/neural-chat-7b-v3", "THUDM/chatglm2-6b", "Qwen/Qwen-7B", "gpt2"):
        jbot, tbot = _bots(*models["float"], name=name)
        assert type(tbot).__name__ == type(jbot).__name__
        assert tbot.prepare_prompt(QUERY) == jbot.prepare_prompt(QUERY)
    assert prompts.generate_qa_prompt(QUERY, "ctx") == jprompts.generate_qa_prompt(QUERY, "ctx")


def test_generation_config_defaults_match_jax():
    assert vars(GenerationConfig()) == vars(JGen())
    assert vars(GenerationConfig().to_sampling_config(7)) == vars(JGen().to_sampling_config(7))
    assert vars(LoadingModelConfig()) == vars(JLoad())


def test_unported_branches_raise(models):
    """Branches that wait for later steps raise and say so; an unknown plugin
    returns None with the JAX package's error code. (Loading a checkpoint and
    the model-free plugins are ported: tests/test_torch_retrieval_types.py;
    beam search and the assistant model: the tests below.)"""
    _, model = models["float"]
    preloaded = (model, TCFG, ByteTokenizer())
    assert build_chatbot(PipelineConfig(
        loading_config=LoadingModelConfig(preloaded=preloaded), plugins={"bogus": {}})) is None
    assert get_latest_error() == ErrorCodes.ERROR_PLUGIN_NOT_SUPPORTED
    with pytest.raises(NotImplementedError, match="step 10"):
        build_chatbot(PipelineConfig(loading_config=LoadingModelConfig(preloaded=preloaded),
                                     plugins={"asr": {}}))
    with pytest.raises(NotImplementedError, match="step 7"):
        build_chatbot(PipelineConfig(loading_config=LoadingModelConfig(preloaded=preloaded, tensor_parallel=2)))


@pytest.mark.parametrize("weights", ["float", "khalf"])
def test_beam_search_chat_matches_jax(models, weights):
    """Tolerance: none. predict with num_beams=2 (greedy) gives the JAX
    package's text; on the khalf model the JAX side runs its Pallas kernel
    in interpret mode."""
    jbot, tbot = _bots(*models[weights])
    cfg = dict(GREEDY, num_beams=2, max_new_tokens=8)
    want = jbot.predict(QUERY, JGen(**cfg))
    assert want and tbot.predict(QUERY, GenerationConfig(**cfg)) == want


def test_assistant_model_speculative_chat_matches_jax(models):
    """Tolerance: none. With an assistant (draft) model, a (model, config)
    pair, greedy text equals the JAX chatbot's with the same draft and the
    plain chatbot's; the draft here is the target itself, so every draft
    token is kept, and a second, unrelated draft changes nothing."""
    params, model = models["float"]
    plain = _bots(params, model)[1].predict(QUERY)
    reset_plugins()
    jreset()
    draft_j = jllama.llama_init_params(jax.random.PRNGKey(9), JCFG)
    draft_t = bridge.llama_from_numpy(tree_to_numpy(draft_j), TCFG, device="cpu")
    for jd, td in (((params, JCFG), (model, TCFG)), ((draft_j, JCFG), (draft_t, TCFG))):
        jbot = jbuild(JPipe(
            model_name_or_path="tiny-llama-test",
            loading_config=JLoad(preloaded=(params, JCFG, JByteTokenizer()), assistant_model=jd, spec_k=3),
            generation_config=JGen(**GREEDY)))
        tbot = build_chatbot(PipelineConfig(
            model_name_or_path="tiny-llama-test",
            loading_config=LoadingModelConfig(preloaded=(model, TCFG, ByteTokenizer()), assistant_model=td,
                                              spec_k=3),
            generation_config=GenerationConfig(**GREEDY)))
        assert tbot.assistant == td and tbot.spec_k == 3
        want = jbot.predict(QUERY)
        assert want == plain and tbot.predict(QUERY) == want


def test_assistant_model_by_name_loads_a_checkpoint(models, monkeypatch):
    """An assistant named by path goes through `_load_hf` and
    `llama_params_from_hf`, as the chat model does."""
    from intel_extension_for_transformers_tpu_torch.models import auto
    from intel_extension_for_transformers_tpu_torch.neural_chat import base_model

    _, model = models["float"]
    seen = []
    monkeypatch.setattr(auto, "_load_hf", lambda name, kind: seen.append((name, kind)) or "hf-object")
    import intel_extension_for_transformers_tpu_torch.models.hf_convert as hf_convert

    monkeypatch.setattr(hf_convert, "llama_params_from_hf", lambda hf, device=None: (model, TCFG))
    bot = base_model.BaseModel("tiny")
    bot.load_model({"loading_config": LoadingModelConfig(preloaded=(model, TCFG, ByteTokenizer()),
                                                         assistant_model="some/draft-checkpoint"),
                    "device": "cpu"})
    assert seen == [("some/draft-checkpoint", "AutoModelForCausalLM")] and bot.assistant == (model, TCFG)


@pytest.mark.parametrize("which", ["h2o", "sink"])
def test_kv_policy_chat_matches_jax(models, which):
    """Tolerance: none. A chatbot's kv_policy bounds the cache below the
    prompt + answer (evictions while decoding): the same greedy text."""
    from intel_extension_for_transformers_tpu.models import kv_policies as jkv
    from intel_extension_for_transformers_tpu_torch.models import kv_policies as tkv

    jbot, tbot = _bots(*models["float"])
    n = len(jbot._encode_prompt(jbot.prepare_prompt(QUERY))[0]) + 4
    jbot.kv_policy, tbot.kv_policy = ((jkv.H2OKVPolicy(budget=n, recent_size=3), tkv.H2OKVPolicy(budget=n, recent_size=3))
                                      if which == "h2o" else
                                      (jkv.AttentionSinkKVPolicy(budget=n, sink_size=2),
                                       tkv.AttentionSinkKVPolicy(budget=n, sink_size=2)))
    want = jbot.predict(QUERY)
    assert want and tbot.predict(QUERY) == want


def test_optimize_model_quantizes_in_place():
    model = tllama.llama_init_params(torch.Generator().manual_seed(0), TCFG)
    out = optimize_model(model, RtnConfig(weight_dtype="int4", group_size=32))
    assert out is model and out.layers[1].mlp.down.qt.weight_dtype == "int4"
