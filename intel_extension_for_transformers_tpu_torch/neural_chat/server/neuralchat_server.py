"""OpenAI-compatible chat server on the Python standard library.

Port of `intel_extension_for_transformers_tpu/neural_chat/server/
neuralchat_server.py`: a ThreadingHTTPServer with a small router; SSE
streams are chunked `text/event-stream` writes fed by a token iterator.
With `serving_config: {continuous_batching: true, ...}` generation runs in
the port's `models.engine.DecodeEngine` (the slot pool on the card);
without it, requests serialize on a lock through the chatbot's
`predict_stream`. The executor runs on the card unless its config names a
`device` ("cpu" for tests); a host without a card raises.

Routes: chat and completions (JSON and SSE), models, health, `/v1/stats`,
embeddings, TGI `/generate[_stream]`, KServe v2 and code generation, with
guided choice. Not ported yet, each raising `NotImplementedError` that
names its ROADMAP step (the handler answers 500 with that message): the UI
pages (`/`, `/ui`, `/basic`, `/compare`, `/askdoc`), the askdoc, finetune
and media routers (`routers.py`), and pipeline-parallel serving. The
`autotune_layouts` key raises `ValueError`: `ops/op_tuning.py` is never
ported, the port's kernels pick their route by shape.
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from intel_extension_for_transformers_tpu_torch.neural_chat.config import (
    GenerationConfig,
    LoadingModelConfig,
    PipelineConfig,
)
from intel_extension_for_transformers_tpu_torch.neural_chat.server.openai_protocol import (
    ChatCompletionChoice,
    ChatCompletionChunk,
    ChatCompletionChunkChoice,
    ChatCompletionRequest,
    ChatCompletionResponse,
    ChatMessage,
    CompletionChoice,
    CompletionRequest,
    CompletionResponse,
    DeltaMessage,
    ErrorResponse,
    ModelCard,
    ModelList,
    UsageInfo,
    asdict_clean,
)
from intel_extension_for_transformers_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

DEFAULT_API_LIST = ["textchat", "completion", "models", "health"]

_UI_STEP = "ROADMAP queue 1, step 10"
_ROUTERS_STEP = "ROADMAP queue 1, step 4 (routers.py)"


def _not_ported(what: str, step: str):
    return NotImplementedError(f"{what} is not ported yet ({step})")


def _merge_generation_config(
    base: GenerationConfig, req
) -> GenerationConfig:
    """Overlay per-request OpenAI sampling params on the server defaults."""
    import dataclasses

    kw = {}
    if req.max_tokens is not None:
        kw["max_new_tokens"] = int(req.max_tokens)
    if req.temperature is not None:
        kw["temperature"] = float(req.temperature)
        kw["do_sample"] = req.temperature > 0
    if req.top_p is not None:
        kw["top_p"] = float(req.top_p)
    if req.top_k is not None:
        kw["top_k"] = int(req.top_k)
    if req.repetition_penalty is not None:
        kw["repetition_penalty"] = float(req.repetition_penalty)
    if req.seed is not None:
        kw["seed"] = int(req.seed)
    return dataclasses.replace(base, **kw)


def _normalize_stops(stop) -> list:
    if not stop:
        return []
    return [stop] if isinstance(stop, str) else [s for s in stop if s]


def _apply_stop(deltas, stops, on_stop=None):
    """Truncate a text-delta stream at the first stop sequence (OpenAI
    `stop`), holding back a stop-length tail so sequences split across
    deltas are caught; on_stop fires when truncation happens (used to
    cancel the engine request and free its slot)."""
    if not stops:
        yield from deltas
        return
    L = max(len(x) for x in stops)
    buf, emitted = "", 0
    for d in deltas:
        buf += d
        hits = [buf.find(x) for x in stops if x in buf]
        if hits:
            cut = min(hits)
            if cut > emitted:
                yield buf[emitted:cut]
            if on_stop is not None:
                on_stop()
            if hasattr(deltas, "close"):
                deltas.close()  # fire the stream's cleanup (engine cancel)
            return
        safe = len(buf) - (L - 1)
        if safe > emitted:
            yield buf[emitted:safe]
            emitted = safe
    if len(buf) > emitted:
        yield buf[emitted:]


def _locked_iter(lock, it):
    """Drain an iterator while holding a lock (single-stream fallback)."""
    with lock:
        yield from it


def _messages_to_query(messages) -> str:
    """Render an OpenAI message list into the chatbot query. The last user
    message is the query; prior turns are prepended as a transcript
    (reference renders history into the conv template the same way,
    textchat_api.py:399-430)."""
    if not messages:
        return ""
    history = messages[:-1]
    query = messages[-1].content
    if not history:
        return query
    lines = [f"{m.role}: {m.content}" for m in history]
    return "\n".join(lines) + f"\nuser: {query}"


class ChatApp:
    """Routes + handlers bound to one chatbot instance.

    With `engine` set (a models.engine.DecodeEngine), generation is
    continuous-batched: N concurrent requests share the slot pool and decode
    together. Without it, requests serialize on a lock. The askdoc,
    finetune and media routers are not ported yet."""

    def __init__(
        self, chatbot, model_name: str, api_list=None, engine=None,
        askdoc=None, finetune=None, media=None, embedder_factory=None,
    ):
        for what, router in (("the askdoc router", askdoc), ("the finetune router", finetune),
                             ("the media router", media)):
            if router is not None:
                raise _not_ported(what, _ROUTERS_STEP)
        self.chatbot = chatbot
        self.model_name = model_name
        self.api_list = list(api_list or DEFAULT_API_LIST)
        self.engine = engine
        self._embedder_factory = embedder_factory  # task "embeddings"
        self._embedder = None
        self._gen_lock = threading.Lock()

    # ------------------------------ engine path ------------------------------
    def _encode_choice(self, text: str):
        """Tokenize a guided-choice string WITHOUT special tokens."""
        tok = self.chatbot.tokenizer
        try:
            ids = tok.encode(text, add_special_tokens=False)
        except TypeError:
            try:
                ids = tok.encode(text, add_bos=False)
            except TypeError:
                ids = tok.encode(text)
        ids = list(ids.ids if hasattr(ids, "ids") else ids)
        bos = getattr(tok, "bos_token_id", None)
        if bos is not None and ids and ids[0] == bos:
            ids = ids[1:]
        return ids

    def _engine_submit(self, query: str, cfg: GenerationConfig,
                       guided_choice=None):
        from intel_extension_for_transformers_tpu_torch.models.engine import EngineRequest

        ids = self.chatbot._encode_prompt(query)
        guided = None
        if guided_choice:
            guided = [self._encode_choice(c) for c in guided_choice]
        req = EngineRequest(
            prompt_ids=ids,
            max_new_tokens=cfg.max_new_tokens,
            temperature=cfg.temperature,
            top_k=cfg.top_k,
            top_p=cfg.top_p,
            do_sample=cfg.do_sample,
            repetition_penalty=cfg.repetition_penalty,
            eos_token_id=self.chatbot._eos_id,
            guided_token_seqs=guided,
        )
        return self.engine.submit(req)

    def _engine_text_stream(self, query: str, cfg: GenerationConfig,
                            guided_choice=None, stops=None):
        """→ iterator of text deltas from the shared decode pool."""
        import numpy as np

        from intel_extension_for_transformers_tpu_torch.models.generation import detokenize_stream

        req = self._engine_submit(query, cfg, guided_choice)
        token_arrays = (np.array([t]) for t in req.tokens())
        deltas = detokenize_stream(token_arrays, self.chatbot.tokenizer)

        def gen():
            try:
                yield from deltas
            finally:
                # abandoned stream (client disconnect) → free the slot; a
                # no-op when the request already finished
                req.cancel()

        return _apply_stop(gen(), _normalize_stops(stops))

    # ---------------------------------------------------------- helpers
    def _count_tokens(self, text: str) -> int:
        tok = getattr(self.chatbot, "tokenizer", None)
        if tok is not None and hasattr(tok, "encode"):
            try:
                ids = tok.encode(text)
                return len(ids.ids if hasattr(ids, "ids") else ids)
            except Exception:
                pass
        return max(1, len(text.split()))

    # ---------------------------------------------------------- handlers
    def handle_models(self):
        return 200, asdict_clean(ModelList(data=[ModelCard(id=self.model_name)]))

    def handle_health(self):
        # reference: textchat_api.py:477 — plain 200 liveness probe
        return 200, {"status": "healthy"}

    def handle_chat_completion(self, body: dict):
        req = ChatCompletionRequest.from_dict(body)
        if not req.messages:
            return 400, ErrorResponse("messages must be non-empty").to_body()
        cfg = _merge_generation_config(self.chatbot.generation_config, req)
        query = _messages_to_query(req.messages)
        if req.guided_choice and self.engine is None:
            return 400, ErrorResponse(
                "guided_choice requires continuous_batching"
            ).to_body()
        if req.stream:
            return 200, self._chat_stream(
                query, cfg, req.guided_choice, _normalize_stops(req.stop),
                n=max(1, int(req.n or 1)),
            )
        n = max(1, int(req.n or 1))
        stops = _normalize_stops(req.stop)
        if self.engine is not None:
            # n>1 choices decode CONCURRENTLY in the slot pool
            streams = [
                self._engine_text_stream(query, cfg, req.guided_choice, stops)
                for _ in range(n)
            ]
            texts = ["".join(st) for st in streams]
        else:
            texts = []
            for _ in range(n):
                with self._gen_lock:
                    texts.append(self.chatbot.predict(query, cfg))
            texts = ["".join(_apply_stop(iter([t]), stops)) for t in texts]
        usage = UsageInfo(prompt_tokens=self._count_tokens(query))
        choices = []
        for i, text in enumerate(texts):
            choices.append(
                ChatCompletionChoice(
                    index=i, message=ChatMessage("assistant", text)
                )
            )
            usage.completion_tokens += self._count_tokens(text)
        usage.total_tokens = usage.prompt_tokens + usage.completion_tokens
        resp = ChatCompletionResponse(
            model=self.model_name, choices=choices, usage=usage,
        )
        return 200, asdict_clean(resp)

    def _chat_stream(self, query: str, cfg: GenerationConfig,
                     guided_choice=None, stops=None, n: int = 1):
        """→ generator of SSE event strings (reference:
        chat_completion_stream_generator textchat_api.py:219).

        n>1 streams n choices with distinct `index` fields per OpenAI
        semantics — interleaved live from n engine slots when the
        continuous-batching engine is up, sequentially otherwise."""
        chunk_id = ChatCompletionChunk(model=self.model_name).id

        def chunk_of(index, delta, finish=None):
            c = ChatCompletionChunk(
                id=chunk_id,
                model=self.model_name,
                choices=[ChatCompletionChunkChoice(
                    index=index, delta=delta, finish_reason=finish)],
            )
            return f"data: {json.dumps(asdict_clean(c))}\n\n"

        def one_choice_deltas():
            if self.engine is not None:
                return self._engine_text_stream(query, cfg, guided_choice,
                                                stops)
            return _apply_stop(
                _locked_iter(self._gen_lock,
                             self.chatbot.predict_stream(query, cfg)),
                stops,
            )

        def events():
            for i in range(n):
                yield chunk_of(i, DeltaMessage(role="assistant"))
            if self.engine is not None and n > 1:
                # n concurrent slots; pump each into one queue and interleave
                import queue as _queue

                q: "_queue.Queue" = _queue.Queue()

                def pump(i):
                    try:
                        for d in one_choice_deltas():
                            q.put((i, d))
                    finally:
                        q.put((i, None))

                for i in range(n):
                    threading.Thread(target=pump, args=(i,),
                                     daemon=True).start()
                live = n
                while live:
                    i, d = q.get()
                    if d is None:
                        live -= 1
                        yield chunk_of(i, DeltaMessage(), finish="stop")
                    else:
                        yield chunk_of(i, DeltaMessage(content=d))
            else:
                for i in range(n):
                    for delta in one_choice_deltas():
                        yield chunk_of(i, DeltaMessage(content=delta))
                    yield chunk_of(i, DeltaMessage(), finish="stop")
            yield "data: [DONE]\n\n"

        return events()

    def _gen_text(self, query: str, cfg: GenerationConfig) -> str:
        """One generation through the engine pool (concurrent) or the lock."""
        if self.engine is not None:
            return "".join(self._engine_text_stream(query, cfg))
        with self._gen_lock:
            return self.chatbot.predict(query, cfg)

    # ------------------- KServe v2 predict protocol (Triton analogue) ------
    # The reference ships a Triton python-backend text-generation model
    # (reference: neural_chat/serving/triton/text_generation/model.py:1 —
    # INPUT0 BYTES prompt → OUTPUT0 BYTES completion, batching delegated to
    # Triton). The server speaks Triton's wire protocol itself, with no
    # Triton runtime: the KServe v2 predict API under /v2. Batched
    # inputs decode CONCURRENTLY in the continuous-batching slot pool — the
    # native stand-in for Triton dynamic batching.

    def handle_kserve_server_meta(self):
        return 200, {"name": "neuralchat", "version": "2",
                     "extensions": ["model_repository"]}

    def handle_kserve_model_meta(self, name: str):
        if name != self.model_name:
            return 404, ErrorResponse(f"unknown model {name!r}").to_body()
        return 200, {
            "name": name,
            "versions": ["1"],
            "platform": "neuralchat_python",
            "inputs": [
                {"name": "INPUT0", "datatype": "BYTES", "shape": [-1]}
            ],
            "outputs": [
                {"name": "OUTPUT0", "datatype": "BYTES", "shape": [-1]}
            ],
        }

    def handle_kserve_infer(self, name: str, body: dict):
        if name != self.model_name:
            return 404, ErrorResponse(f"unknown model {name!r}").to_body()
        texts = None
        for t in (body or {}).get("inputs") or []:
            if t.get("name") in ("INPUT0", "text_input") and \
                    t.get("datatype") == "BYTES":
                texts = [str(x) for x in t.get("data", [])]
        if not texts:
            return 400, ErrorResponse(
                "expected a BYTES input named INPUT0/text_input"
            ).to_body()

        class _P:  # parameters → the OpenAI-ish overlay shape
            pass

        params = (body or {}).get("parameters") or {}
        req = _P()
        for k in ("max_tokens", "temperature", "top_p", "top_k",
                  "repetition_penalty", "seed"):
            setattr(req, k, params.get(k))
        cfg = _merge_generation_config(self.chatbot.generation_config, req)

        results: list = [None] * len(texts)
        if self.engine is not None and len(texts) > 1:
            # batch → concurrent slots (the dynamic-batching analogue)
            threads = []
            for i, q in enumerate(texts):
                def work(i=i, q=q):
                    results[i] = self._gen_text(q, cfg)

                th = threading.Thread(target=work, daemon=True)
                th.start()
                threads.append(th)
            for th in threads:
                th.join()
        else:
            for i, q in enumerate(texts):
                results[i] = self._gen_text(q, cfg)
        return 200, {
            "model_name": name,
            "model_version": "1",
            "id": (body or {}).get("id", ""),
            "outputs": [{
                "name": "OUTPUT0",
                "datatype": "BYTES",
                "shape": [len(results)],
                "data": results,
            }],
        }

    def handle_code_generation(self, body: dict, chat: bool = False):
        """POST /v1/code_generation | /v1/code_chat (reference:
        restful/codegen_api.py — the codegen task router wraps the resident
        code model; code_chat additionally applies the chat template)."""
        prompt = body.get("prompt") or ""
        if not prompt:
            return 400, ErrorResponse("prompt must be non-empty").to_body()
        cfg = _merge_generation_config(
            self.chatbot.generation_config, CompletionRequest.from_dict(body)
        )
        query = _messages_to_query(
            [ChatMessage("user", prompt)]
        ) if chat else prompt
        text = self._gen_text(query, cfg)
        usage = UsageInfo(
            prompt_tokens=self._count_tokens(prompt),
            completion_tokens=self._count_tokens(text),
        )
        usage.total_tokens = usage.prompt_tokens + usage.completion_tokens
        return 200, {"response": text, "usage": asdict_clean(usage)}

    @staticmethod
    def _tgi_config_from(base: GenerationConfig, parameters: dict):
        class _P:  # adapt TGI parameter names onto the OpenAI merge helper
            max_tokens = parameters.get("max_new_tokens")
            temperature = parameters.get("temperature")
            top_p = parameters.get("top_p")
            top_k = parameters.get("top_k")
            repetition_penalty = parameters.get("repetition_penalty")
            seed = parameters.get("seed")

        cfg = _merge_generation_config(base, _P)
        if parameters.get("do_sample") is not None:
            import dataclasses

            cfg = dataclasses.replace(cfg, do_sample=bool(parameters["do_sample"]))
        return cfg

    def handle_tgi_generate(self, body: dict):
        """POST /generate — text-generation-inference wire format
        (reference: restful/tgi_api.py; {inputs, parameters} →
        {generated_text})."""
        inputs = (body or {}).get("inputs") or ""
        if not inputs:
            return 400, ErrorResponse("inputs must be non-empty").to_body()
        cfg = self._tgi_config_from(
            self.chatbot.generation_config, (body or {}).get("parameters") or {}
        )
        text = self._gen_text(inputs, cfg)
        return 200, {"generated_text": text}

    def handle_tgi_generate_stream(self, body: dict):
        """POST /generate_stream — TGI SSE: one {token:{text}} event per
        delta, then a final event carrying generated_text."""
        inputs = (body or {}).get("inputs") or ""
        if not inputs:
            return 400, ErrorResponse("inputs must be non-empty").to_body()
        cfg = self._tgi_config_from(
            self.chatbot.generation_config, (body or {}).get("parameters") or {}
        )

        def events():
            if self.engine is not None:
                deltas = self._engine_text_stream(inputs, cfg)
            else:
                deltas = _locked_iter(self._gen_lock,
                                      self.chatbot.predict_stream(inputs, cfg))
            pieces = []
            for delta in deltas:
                pieces.append(delta)
                evt = {"token": {"text": delta, "special": False}}
                yield f"data: {json.dumps(evt)}\n\n"
            final = {
                "token": {"text": "", "special": True},
                "generated_text": "".join(pieces),
            }
            yield f"data: {json.dumps(final)}\n\n"

        return 200, events()

    def handle_embeddings(self, body: dict):
        """POST /v1/embeddings — OpenAI embeddings wire format over the
        resident BGE encoder (the encode side of the RAG north star)."""
        inputs = (body or {}).get("input")
        if inputs is None:
            return 400, ErrorResponse("input must be set").to_body()
        texts = [inputs] if isinstance(inputs, str) else list(inputs)
        if not texts or not all(isinstance(t, str) and t for t in texts):
            return 400, ErrorResponse(
                "input must be a non-empty string or list of strings"
            ).to_body()
        if self._embedder is None:
            self._embedder = self._embedder_factory()
        vecs = self._embedder.encode(texts)
        data = [
            {"object": "embedding", "index": i, "embedding": [float(x) for x in v]}
            for i, v in enumerate(vecs)
        ]
        toks = sum(self._count_tokens(t) for t in texts)
        return 200, {
            "object": "list",
            "data": data,
            "model": body.get("model") or self.model_name,
            "usage": {"prompt_tokens": toks, "total_tokens": toks},
        }

    def handle_completion(self, body: dict):
        req = CompletionRequest.from_dict(body)
        prompts = req.prompt if isinstance(req.prompt, list) else [req.prompt]
        cfg = _merge_generation_config(self.chatbot.generation_config, req)
        if req.stream:
            if len(prompts) != 1:
                return 400, ErrorResponse("stream needs exactly 1 prompt").to_body()
            return 200, self._completion_stream(prompts[0], cfg)
        choices, usage = [], UsageInfo()
        stops = _normalize_stops(req.stop)
        if self.engine is not None:
            # multi-prompt completions decode CONCURRENTLY in the slot pool
            streams = [
                self._engine_text_stream(p, cfg, stops=stops) for p in prompts
            ]
            texts = ["".join(s) for s in streams]
        else:
            texts = []
            for p in prompts:
                with self._gen_lock:
                    texts.append(self.chatbot.predict(p, cfg))
            texts = ["".join(_apply_stop(iter([t]), stops)) for t in texts]
        for i, (p, text) in enumerate(zip(prompts, texts)):
            choices.append(CompletionChoice(index=i, text=text))
            usage.prompt_tokens += self._count_tokens(p)
            usage.completion_tokens += self._count_tokens(text)
        usage.total_tokens = usage.prompt_tokens + usage.completion_tokens
        resp = CompletionResponse(model=self.model_name, choices=choices, usage=usage)
        return 200, asdict_clean(resp)

    def _completion_stream(self, prompt: str, cfg: GenerationConfig):
        resp_id = CompletionResponse(model=self.model_name).id

        def events():
            if self.engine is not None:
                deltas = self._engine_text_stream(prompt, cfg)
            else:
                deltas = _locked_iter(self._gen_lock,
                                      self.chatbot.predict_stream(prompt, cfg))
            for delta in deltas:
                chunk = CompletionResponse(
                    id=resp_id,
                    model=self.model_name,
                    choices=[
                        CompletionChoice(index=0, text=delta, finish_reason=None)
                    ],
                )
                yield f"data: {json.dumps(asdict_clean(chunk))}\n\n"
            yield "data: [DONE]\n\n"

        return events()

    # ---------------------------------------------------------- routing
    def route(self, method: str, path: str, body: Optional[dict]):
        """→ (status, payload). payload is a dict (JSON), a generator
        (SSE stream), or an ("html", str) tuple."""
        if method == "GET" and path in ("/", "/ui", "/basic", "/compare", "/askdoc"):
            raise _not_ported(f"the {path} page (neural_chat/ui)", _UI_STEP)
        if path == "/v2" and method == "GET":
            return self.handle_kserve_server_meta()
        if path.startswith("/v2/health/") and method == "GET":
            return 200, {"live": True} if path.endswith("live") else {"ready": True}
        if path.startswith("/v2/models/"):
            rest = path[len("/v2/models/"):]
            if method == "POST" and rest.endswith("/infer"):
                return self.handle_kserve_infer(rest[: -len("/infer")], body)
            if method == "GET" and rest.endswith("/ready"):
                name = rest[: -len("/ready")]
                ok = name == self.model_name
                return (200 if ok else 404), {"name": name, "ready": ok}
            if method == "GET":
                return self.handle_kserve_model_meta(rest)
        if method == "GET" and path == "/v1/stats":
            # serving counters (slot utilization, tokens, steps)
            stats = {"engine": None}
            if self.engine is not None:
                stats["engine"] = self.engine.stats()
            stats["model"] = self.model_name
            return 200, stats
        if method == "GET" and path == "/health":
            return self.handle_health()
        if method == "GET" and path == "/v1/models" and "models" in self.api_list:
            return self.handle_models()
        if (
            method == "POST"
            and path == "/v1/chat/completions"
            and "textchat" in self.api_list
        ):
            return self.handle_chat_completion(body or {})
        if (
            method == "POST"
            and path == "/v1/completions"
            and "completion" in self.api_list
        ):
            return self.handle_completion(body or {})
        # -- embeddings (OpenAI wire format over the BGE encoder) --
        if (
            method == "POST" and path == "/v1/embeddings"
            and "embeddings" in self.api_list
            and self._embedder_factory is not None
        ):
            return self.handle_embeddings(body or {})
        # -- codegen router (reference: restful/api.py 'codegen') --
        if "codegen" in self.api_list:
            if method == "POST" and path == "/v1/code_generation":
                return self.handle_code_generation(body or {}, chat=False)
            if method == "POST" and path == "/v1/code_chat":
                return self.handle_code_generation(body or {}, chat=True)
        # -- tgi-compatible router (reference: restful/api.py 'tgi') --
        if "tgi" in self.api_list:
            if method == "POST" and path == "/generate":
                return self.handle_tgi_generate(body or {})
            if method == "POST" and path == "/generate_stream":
                return self.handle_tgi_generate_stream(body or {})
        # -- the askdoc, media and finetune routers (routers.py) --
        if path.startswith(("/v1/askdoc/", "/v1/voicechat", "/v1/text2image", "/v1/plugin/audio/",
                            "/v1/finetune")):
            raise _not_ported(f"the router of {path} (neural_chat/server/routers.py)", _ROUTERS_STEP)
        return 404, ErrorResponse(f"no route {method} {path}", code=404).to_body()


class _Handler(BaseHTTPRequestHandler):
    app: ChatApp = None  # set by make_server
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.info("%s - %s", self.address_string(), fmt % args)

    def _send_json(self, status: int, payload: dict) -> None:
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_sse(self, events) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            for ev in events:
                data = ev.encode()
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            logger.info("client disconnected mid-stream")
            if hasattr(events, "close"):
                events.close()  # fires generator finally → engine cancel

    def _dispatch(self, method: str) -> None:
        body = None
        if method == "POST":
            try:
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError):
                self._send_json(400, ErrorResponse("invalid JSON body").to_body())
                return
        try:
            status, payload = self.app.route(method, self.path, body)
        except Exception as e:  # request-level failure, keep serving
            logger.exception("handler error")
            self._send_json(
                500, ErrorResponse(str(e), type="internal_error", code=500).to_body()
            )
            return
        if isinstance(payload, dict):
            self._send_json(status, payload)
        elif isinstance(payload, tuple) and payload[0] == "html":
            data = payload[1].encode()
            self.send_response(status)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        else:
            self._send_sse(payload)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")


def make_server(app: ChatApp, host: str = "0.0.0.0", port: int = 8000):
    handler = type("BoundHandler", (_Handler,), {"app": app})
    return ThreadingHTTPServer((host, port), handler)


class NeuralChatServerExecutor:
    """Config (a dict, or a YAML path) → chatbot → HTTP server. Runs on the
    card unless the config names a `device`."""

    def __init__(self):
        self.chatbot = None
        self.app: Optional[ChatApp] = None
        self.server = None
        self.engine = None
        self.host = "0.0.0.0"
        self.port = 8000
        self.device = None

    def init(self, config) -> bool:
        """config: dict or path to YAML. Returns False on failure (error code
        retrievable via utils.error_utils.get_latest_error)."""
        if isinstance(config, str):
            import yaml

            with open(config) as f:
                config = yaml.safe_load(f)
        self.device = resolve_device(config.get("device"))
        self.host = config.get("host", "0.0.0.0")
        self.port = int(config.get("port", 8000))
        api_list = (config.get("tasks_list") or DEFAULT_API_LIST)
        for tasks, what in (({"retrieval", "askdoc"}, "the askdoc router"), ({"finetune"}, "the finetune router"),
                            ({"voicechat", "text2image", "plugin_audio"}, "the media router")):
            if tasks & set(api_list):
                raise _not_ported(f"{what} (tasks_list {sorted(tasks & set(api_list))})", _ROUTERS_STEP)

        pipeline = self._pipeline_config_from(config)
        from intel_extension_for_transformers_tpu_torch.neural_chat.chatbot import build_chatbot

        self.chatbot = config.get("_prebuilt_chatbot") or build_chatbot(pipeline)
        if self.chatbot is None:
            return False
        engine = None
        serving = config.get("serving_config") or {}
        if serving.get("continuous_batching"):
            engine = self._build_engine(serving)
        embedder_factory = None
        if "embeddings" in api_list:
            embedder_factory = self._embedder_factory_from(config)
        self.app = ChatApp(
            self.chatbot,
            pipeline.model_name_or_path,
            api_list=api_list,
            engine=engine,
            embedder_factory=embedder_factory,
        )
        return True

    def _embedder_factory_from(self, config: dict):
        """A preloaded `embedder`, else the retrieval plugin's; loading one
        by name is not ported yet."""
        cfg = dict(config.get("embedding_config") or {})
        preloaded = cfg.pop("embedder", None)
        model_name = cfg.pop("embedding_model", "BAAI/bge-small-en-v1.5")

        def factory():
            if preloaded is not None:
                return preloaded
            from intel_extension_for_transformers_tpu_torch.neural_chat.plugins import (
                get_plugin_instance,
            )

            agent = get_plugin_instance("retrieval")
            if agent is not None and getattr(agent, "embedder", None) is not None:
                return agent.embedder
            raise _not_ported(f"loading the embedding model {model_name!r} by name", "ROADMAP queue 1, step 1")

        return factory

    def _build_engine(self, serving: dict):
        """The continuous-batching pool over the chatbot's resident model
        (serving_config: {continuous_batching: true, max_slots: 8,
        max_len: 1024, ...}), on the executor's device."""
        from intel_extension_for_transformers_tpu_torch.models.engine import DecodeEngine

        model = getattr(self.chatbot, "params", None)
        model_config = getattr(self.chatbot, "model_config", None)
        if model is None or model_config is None:
            raise ValueError("continuous_batching needs a chatbot with a model and its model_config")
        if serving.get("pipeline_parallel"):
            raise _not_ported("pipeline-parallel serving (parallel/pp_serve.py)", "ROADMAP queue 1, step 7")
        if serving.get("autotune_layouts"):
            raise ValueError(
                "serving_config.autotune_layouts: ops/op_tuning.py is not ported and will not be; "
                "the port's WOQ kernels pick their route by shape (quant_matmul.k1_route, k2_route, k3_route)"
            )
        # speculative decoding inside the pool: the chatbot's assistant
        # (draft) model, if it has one
        draft = getattr(self.chatbot, "assistant", None)
        d_model, d_config = draft if draft is not None else (None, None)
        kv_kwargs = {k: serving[k] for k in ("kv_policy", "kv_sink", "kv_recent", "kv_heavy")
                     if serving.get(k) is not None}
        self.engine = DecodeEngine(
            model,
            model_config,
            max_slots=int(serving.get("max_slots", 8)),
            max_len=int(serving.get("max_len", 1024)),
            prefill_chunk=int(serving.get("prefill_chunk", 128)),
            decode_horizon=int(serving.get("decode_horizon", 1)),
            draft_model=d_model,
            draft_config=d_config,
            num_speculative_tokens=int(serving.get("num_speculative_tokens", 4)),
            kv_dtype=serving.get("kv_dtype", "bfloat16"),
            prefix_cache=int(serving.get("prefix_cache", 0)),
            prefix_cache_min_tokens=int(serving.get("prefix_cache_min_tokens", 16)),
            max_admissions=int(serving.get("max_admissions", 2)),
            device=self.device,
            **kv_kwargs,
        ).start()
        # serving_config: {warm_prefix: "<system prompt>"}: prefill the shared
        # prompt once at startup, so every admission restores it
        warm = serving.get("warm_prefix")
        tok = getattr(self.chatbot, "tokenizer", None)
        if warm and self.engine.prefix_cache and tok is not None:
            rows = self.engine.warm_prefix(tok.encode(warm))
            logger.info("warmed prefix cache with %d prompt rows", rows)
        return self.engine

    def _pipeline_config_from(self, config: dict) -> PipelineConfig:
        loading = LoadingModelConfig(**(config.get("loading_config") or {}))
        gen = GenerationConfig(**(config.get("generation_config") or {}))
        plugins = {}
        for name, args in (config.get("plugins") or {}).items():
            if isinstance(args, dict) and args.get("enable", True):
                plugins[name] = {
                    k: v for k, v in args.items() if k != "enable"
                } | {"enable": True}
        return PipelineConfig(
            model_name_or_path=config.get(
                "model_name_or_path", "meta-llama/Llama-2-7b-chat-hf"
            ),
            device=str(self.device),
            loading_config=loading,
            generation_config=gen,
            plugins=plugins,
        )

    def __call__(self, config_file: str) -> None:
        if not self.init(config_file):
            raise RuntimeError("server init failed (see latest error code)")
        self.run()

    def run(self, block: bool = True):
        assert self.app is not None, "call init() first"
        self.server = make_server(self.app, self.host, self.port)
        self.port = self.server.server_address[1]  # resolve port=0
        logger.info("serving on %s:%d", self.host, self.port)
        if block:
            self.server.serve_forever()
        else:
            t = threading.Thread(target=self.server.serve_forever, daemon=True)
            t.start()
            return t

    def stop(self):
        if self.engine is not None:
            self.engine.stop()
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()


def main(argv=None):
    p = argparse.ArgumentParser("neuralchat_server")
    p.add_argument("--config_file", required=True)
    p.add_argument("--log_file", default=None)
    args = p.parse_args(argv)
    if args.log_file:
        logging.basicConfig(filename=args.log_file, level=logging.INFO)
    else:
        logging.basicConfig(level=logging.INFO)
    NeuralChatServerExecutor()(args.config_file)


if __name__ == "__main__":
    main()
