"""Port parity: the OpenAI-compatible server against the JAX package's, each
on its own socket (port 0) over the same tiny Llama weights.

The locked path (requests serialize through the chatbot's predict_stream)
and the engine path (continuous batching) both answer greedy requests with
the JAX server's text. Routes the port has not ported yet answer 500 with a
message that names their ROADMAP step."""

import json
import threading
from http.client import HTTPConnection

import jax
import numpy as np
import pytest
import torch
from torch_port_util import tree_to_numpy

from intel_extension_for_transformers_tpu.models import llama as jllama
from intel_extension_for_transformers_tpu.models.tokenization import ByteTokenizer as JByteTokenizer
from intel_extension_for_transformers_tpu.neural_chat.plugins import reset_plugins as jreset_plugins
from intel_extension_for_transformers_tpu.neural_chat.server import NeuralChatServerExecutor as JExecutor
from intel_extension_for_transformers_tpu_torch.bridge import llama_from_numpy
from intel_extension_for_transformers_tpu_torch.models import llama as tllama
from intel_extension_for_transformers_tpu_torch.models.tokenization import ByteTokenizer
from intel_extension_for_transformers_tpu_torch.neural_chat.plugins import reset_plugins
from intel_extension_for_transformers_tpu_torch.neural_chat.server import (
    NeuralChatServerExecutor,
    TextChatClientExecutor,
)
from intel_extension_for_transformers_tpu_torch.neural_chat.server.neuralchat_server import (
    _apply_stop,
    _normalize_stops,
)

torch.set_num_threads(1)

# vocab 264 holds the byte tokenizer's BOS (256), which the port's embedding
# lookup needs in range
KW = dict(vocab_size=264, hidden_size=64, intermediate_size=128)
GEN = {"max_new_tokens": 6, "do_sample": False, "repetition_penalty": 1.0}
SERVING = {"continuous_batching": True, "max_slots": 4, "max_len": 128}


def _config(name, preloaded, serving=None, **extra):
    cfg = {"host": "127.0.0.1", "port": 0, "model_name_or_path": name, "loading_config": {"preloaded": preloaded},
           "generation_config": dict(GEN), **extra}
    if serving:
        cfg["serving_config"] = serving
    return cfg


@pytest.fixture(scope="module")
def servers():
    """{"jax"|"torch": (locked executor, engine executor)} over the same weights."""
    reset_plugins()
    jreset_plugins()
    jcfg, tcfg = jllama.LlamaConfig.tiny(**KW), tllama.LlamaConfig.tiny(**KW)
    params = jllama.llama_init_params(jax.random.PRNGKey(0), jcfg)
    model = llama_from_numpy(tree_to_numpy(params), tcfg, device="cpu")
    out = {}
    for key, make, pre in (("jax", JExecutor, (params, jcfg, JByteTokenizer())),
                           ("torch", NeuralChatServerExecutor, (model, tcfg, ByteTokenizer()))):
        extra = {"device": "cpu"} if key == "torch" else {}
        pair = []
        for serving, tasks in ((None, None), (SERVING, ["textchat", "completion", "models", "health", "tgi"])):
            ex = make()
            assert ex.init(_config("tiny-llama", pre, serving, tasks_list=tasks, **extra))
            ex.run(block=False)
            pair.append(ex)
        out[key] = tuple(pair)
    yield out
    for pair in out.values():
        for ex in pair:
            ex.stop()
    reset_plugins()
    jreset_plugins()


def _request(port, method, path, body=None, raw=None):
    conn = HTTPConnection("127.0.0.1", port, timeout=120)
    data = raw if raw is not None else (json.dumps(body) if body is not None else None)
    conn.request(method, path, data, {"Content-Type": "application/json"} if data is not None else {})
    resp = conn.getresponse()
    payload = resp.read()
    conn.close()
    return resp.status, payload


def _post(port, path, body):
    status, payload = _request(port, "POST", path, body)
    return status, json.loads(payload)


def _sse(payload):
    events = [ln[len("data: "):] for ln in payload.decode().splitlines() if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return [json.loads(e) for e in events[:-1]]


CHAT = {"messages": [{"role": "user", "content": "hello there"}], "max_tokens": 6}


@pytest.mark.parametrize("path", ["locked", "engine"])
def test_chat_completion_matches_jax(servers, path):
    i = 0 if path == "locked" else 1
    ts, tout = _post(servers["torch"][i].port, "/v1/chat/completions", CHAT)
    js, jout = _post(servers["jax"][i].port, "/v1/chat/completions", CHAT)
    assert ts == js == 200
    assert tout["choices"][0]["message"]["content"] == jout["choices"][0]["message"]["content"]
    assert tout["object"] == "chat.completion" and tout["id"].startswith("chatcmpl-")
    assert tout["choices"][0]["message"]["role"] == "assistant"
    assert tout["usage"] == jout["usage"] and tout["usage"]["total_tokens"] > 0


@pytest.mark.parametrize("path", ["locked", "engine"])
def test_completion_matches_jax(servers, path):
    i = 0 if path == "locked" else 1
    body = {"prompt": "once upon", "max_tokens": 5}
    ts, tout = _post(servers["torch"][i].port, "/v1/completions", body)
    js, jout = _post(servers["jax"][i].port, "/v1/completions", body)
    assert ts == js == 200 and tout["object"] == "text_completion"
    assert [c["text"] for c in tout["choices"]] == [c["text"] for c in jout["choices"]]


@pytest.mark.parametrize("path", ["locked", "engine"])
def test_chat_stream_is_the_same_text(servers, path):
    """The SSE deltas join to the non-streamed text (and JAX's), and the
    stream ends in a finish_reason "stop" chunk and [DONE]."""
    port = servers["torch"][0 if path == "locked" else 1].port
    _, full = _post(port, "/v1/chat/completions", CHAT)
    status, payload = _request(port, "POST", "/v1/chat/completions", {**CHAT, "stream": True})
    assert status == 200
    chunks = _sse(payload)
    text = "".join(c["choices"][0]["delta"].get("content") or "" for c in chunks)
    assert text == full["choices"][0]["message"]["content"]
    assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
    client = TextChatClientExecutor("127.0.0.1", port)
    assert "".join(client.chat_stream("hello there", max_tokens=6)) == text


def test_health_models_and_multi_turn(servers):
    client = TextChatClientExecutor("127.0.0.1", servers["torch"][0].port)
    assert client.health() and client.models() == ["tiny-llama"]
    body = {"messages": [{"role": "user", "content": "remember the number 7"},
                         {"role": "assistant", "content": "ok"},
                         {"role": "user", "content": "what number?"}], "max_tokens": 3}
    out = client._post("/v1/chat/completions", body)
    assert out["choices"][0]["finish_reason"] == "stop"
    assert isinstance(client.chat("hello", max_tokens=4, temperature=0.0), str)


def test_bad_route_bad_json_and_empty_messages(servers):
    port = servers["torch"][0].port
    assert _request(port, "GET", "/nope")[0] == 404
    assert _request(port, "POST", "/v1/chat/completions", raw="{not json")[0] == 400
    status, body = _post(port, "/v1/chat/completions", {"messages": []})
    assert status == 400 and "error" in body
    status, body = _post(port, "/v1/chat/completions", {**CHAT, "guided_choice": ["yes", "no"]})
    assert status == 400 and "continuous_batching" in body["error"]["message"]


def test_engine_concurrent_streams(servers):
    """6 concurrent streamed requests on the 4-slot pool each complete with
    the text a request gets alone."""
    ex = servers["torch"][1]
    bodies = [{"messages": [{"role": "user", "content": f"hello {i}"}], "max_tokens": 6} for i in range(6)]
    alone = [_post(ex.port, "/v1/chat/completions", b)[1]["choices"][0]["message"]["content"] for b in bodies]
    got, errors = [None] * 6, []

    def work(i):
        try:
            status, payload = _request(ex.port, "POST", "/v1/chat/completions", {**bodies[i], "stream": True})
            assert status == 200
            got[i] = "".join(c["choices"][0]["delta"].get("content") or "" for c in _sse(payload))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    steps0 = ex.engine.stats()["decode_steps"]
    threads = [threading.Thread(target=work, args=(i,)) for i in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors and got == alone
    assert ex.engine.stats()["decode_steps"] - steps0 < 6 * 6


def test_engine_with_an_assistant_speculates_as_jax(servers):
    """A chatbot with an assistant (draft) model builds its engine with the
    draft (in-pool speculation); greedy chat text over HTTP equals the JAX
    server's with the same draft and the port's engine without one."""
    jcfg, tcfg = jllama.LlamaConfig.tiny(**KW), tllama.LlamaConfig.tiny(**KW)
    dkw = dict(KW, num_hidden_layers=1)
    jdcfg, tdcfg = jllama.LlamaConfig.tiny(**dkw), tllama.LlamaConfig.tiny(**dkw)
    params = jllama.llama_init_params(jax.random.PRNGKey(0), jcfg)
    draft = jllama.llama_init_params(jax.random.PRNGKey(5), jdcfg)
    model = llama_from_numpy(tree_to_numpy(params), tcfg, device="cpu")
    tdraft = llama_from_numpy(tree_to_numpy(draft), tdcfg, device="cpu")
    out = {}
    for key, make, pre, assistant, extra in (
        ("jax", JExecutor, (params, jcfg, JByteTokenizer()), (draft, jdcfg), {}),
        ("torch", NeuralChatServerExecutor, (model, tcfg, ByteTokenizer()), (tdraft, tdcfg), {"device": "cpu"}),
    ):
        ex = make()
        cfg = _config("tiny-llama", pre, SERVING, tasks_list=["textchat"], **extra)
        cfg["loading_config"] = {**cfg["loading_config"], "assistant_model": assistant}
        assert ex.init(cfg)
        ex.run(block=False)
        try:
            assert getattr(ex.engine, "draft_model" if key == "torch" else "draft_params") is assistant[0]
            status, body = _post(ex.port, "/v1/chat/completions", CHAT)
            assert status == 200
            out[key] = (body["choices"][0]["message"]["content"], ex.engine.stats())
        finally:
            ex.stop()
    text, stats = out["torch"]
    assert stats["speculative"] and stats["decode_steps"] > 0
    plain = _post(servers["torch"][1].port, "/v1/chat/completions", CHAT)[1]["choices"][0]["message"]["content"]
    assert text == out["jax"][0] == plain


def test_guided_choice_over_http_matches_jax(servers):
    body = {"messages": [{"role": "user", "content": "Is the sky blue?"}], "guided_choice": ["yes", "no"],
            "max_tokens": 16}
    ts, tout = _post(servers["torch"][1].port, "/v1/chat/completions", body)
    js, jout = _post(servers["jax"][1].port, "/v1/chat/completions", body)
    assert ts == js == 200
    text = tout["choices"][0]["message"]["content"]
    assert text in ("yes", "no") and text == jout["choices"][0]["message"]["content"]


def test_kserve_tgi_codegen_and_stats(servers):
    ex = servers["torch"][1]
    name = "tiny-llama"
    assert _request(ex.port, "GET", f"/v2/models/{name}/ready")[0] == 200
    status, out = _post(ex.port, f"/v2/models/{name}/infer",
                        {"inputs": [{"name": "INPUT0", "datatype": "BYTES", "data": ["once upon", "a time"]}]})
    assert status == 200
    texts = out["outputs"][0]["data"]
    assert len(texts) == 2
    for prompt, text in zip(["once upon", "a time"], texts):
        assert _post(ex.port, "/generate", {"inputs": prompt})[1] == {"generated_text": text}
    assert _post(ex.port, f"/v2/models/nope/infer", {"inputs": []})[0] == 404
    status, payload = _request(ex.port, "POST", "/generate_stream", {"inputs": "once upon"})
    events = [json.loads(ln[len("data: "):]) for ln in payload.decode().splitlines() if ln.startswith("data: ")]
    assert status == 200 and events[-1]["generated_text"] == texts[0]
    stats = _request(ex.port, "GET", "/v1/stats")
    engine = json.loads(stats[1])["engine"]
    assert stats[0] == 200 and engine["max_slots"] == 4 and engine["completed_requests"] > 0


def test_codegen_and_embeddings_routes():
    """tasks_list codegen and embeddings: code generation through the locked
    path, embeddings from a preloaded embedder."""

    class Embedder:
        def encode(self, texts):
            return np.stack([np.full(4, len(t), np.float32) for t in texts])

    tcfg = tllama.LlamaConfig.tiny(**KW)
    model = tllama.llama_init_params(torch.Generator().manual_seed(0), tcfg)
    ex = NeuralChatServerExecutor()
    assert ex.init(_config("tiny-llama", (model, tcfg, ByteTokenizer()), device="cpu",
                           tasks_list=["textchat", "models", "health", "codegen", "embeddings"],
                           embedding_config={"embedder": Embedder()}))
    ex.run(block=False)
    try:
        status, out = _post(ex.port, "/v1/code_generation", {"prompt": "def f():", "max_tokens": 4})
        assert status == 200 and isinstance(out["response"], str) and out["usage"]["total_tokens"] > 0
        status, out = _post(ex.port, "/v1/embeddings", {"input": ["ab", "abc"]})
        assert status == 200 and [d["embedding"] for d in out["data"]] == [[2.0] * 4, [3.0] * 4]
        assert _post(ex.port, "/v1/embeddings", {"input": [""]})[0] == 400
    finally:
        ex.stop()


@pytest.mark.parametrize("method,path,step", [
    ("GET", "/", "step 10"), ("GET", "/compare", "step 10"), ("GET", "/askdoc", "step 10"),
    ("POST", "/v1/askdoc/chat", "step 4"), ("POST", "/v1/finetune", "step 4"), ("POST", "/v1/voicechat", "step 4"),
])
def test_unported_routes_name_their_step(servers, method, path, step):
    status, payload = _request(servers["torch"][0].port, method, path, {} if method == "POST" else None)
    body = json.loads(payload)
    assert status == 500 and body["error"]["type"] == "internal_error"
    assert "not ported yet" in body["error"]["message"] and step in body["error"]["message"]


@pytest.mark.parametrize("extra,err,match", [
    ({"tasks_list": ["textchat", "askdoc"]}, NotImplementedError, "step 4"),
    ({"tasks_list": ["finetune"]}, NotImplementedError, "step 4"),
    ({"serving_config": {**SERVING, "autotune_layouts": True}}, ValueError, "op_tuning"),
    ({"serving_config": {**SERVING, "pipeline_parallel": {"pp": 2}}}, NotImplementedError, "step 7"),
])
def test_unported_config_keys_raise(extra, err, match):
    tcfg = tllama.LlamaConfig.tiny(**KW)
    model = tllama.llama_init_params(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(err, match=match):
        NeuralChatServerExecutor().init({**_config("tiny", (model, tcfg, ByteTokenizer()), device="cpu"), **extra})


def test_apply_stop_streaming_semantics():
    assert _normalize_stops(None) == []
    assert _normalize_stops("X") == ["X"]
    assert _normalize_stops(["a", "", "b"]) == ["a", "b"]
    assert "".join(_apply_stop(iter(["hello ST", "OP world"]), ["STOP"])) == "hello "
    assert "".join(_apply_stop(iter(["abc", "def"]), ["ZZZ"])) == "abcdef"
    assert "".join(_apply_stop(iter(["one|two"]), ["|"])) == "one"
    fired = []
    assert "".join(_apply_stop(iter(["xSTOPy"]), ["STOP"], lambda: fired.append(1))) == "x" and fired == [1]
