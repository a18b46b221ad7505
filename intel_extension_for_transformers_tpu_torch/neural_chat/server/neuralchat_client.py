"""Client for the NeuralChat server (stdlib http.client).

Port of `intel_extension_for_transformers_tpu/neural_chat/server/
neuralchat_client.py`, unchanged: pure Python.

Reference: neural_chat/server/neuralchat_client.py — TextChatClientExecutor
posting to the REST endpoints; here OpenAI-shaped.
"""

from __future__ import annotations

import json
from http.client import HTTPConnection
from typing import Iterator, List, Optional


class TextChatClientExecutor:
    def __init__(self, server_ip: str = "127.0.0.1", port: int = 8000):
        self.server_ip = server_ip
        self.port = port

    def _conn(self) -> HTTPConnection:
        return HTTPConnection(self.server_ip, self.port, timeout=600)

    def _post(self, path: str, body: dict) -> dict:
        conn = self._conn()
        conn.request(
            "POST", path, json.dumps(body), {"Content-Type": "application/json"}
        )
        resp = conn.getresponse()
        data = json.loads(resp.read())
        conn.close()
        if resp.status != 200:
            raise RuntimeError(f"{resp.status}: {data}")
        return data

    def get(self, path: str) -> dict:
        conn = self._conn()
        conn.request("GET", path)
        resp = conn.getresponse()
        data = json.loads(resp.read())
        conn.close()
        return data

    def models(self) -> List[str]:
        return [m["id"] for m in self.get("/v1/models")["data"]]

    def health(self) -> bool:
        return self.get("/health").get("status") == "healthy"

    def chat(
        self,
        prompt: str,
        model: str = "",
        max_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        **kw,
    ) -> str:
        body = {
            "model": model,
            "messages": [{"role": "user", "content": prompt}],
            **({"max_tokens": max_tokens} if max_tokens is not None else {}),
            **({"temperature": temperature} if temperature is not None else {}),
            **kw,
        }
        out = self._post("/v1/chat/completions", body)
        return out["choices"][0]["message"]["content"]

    def chat_stream(
        self, prompt: str, model: str = "", **kw
    ) -> Iterator[str]:
        """Yield content deltas from the SSE stream."""
        body = {
            "model": model,
            "messages": [{"role": "user", "content": prompt}],
            "stream": True,
            **kw,
        }
        conn = self._conn()
        conn.request(
            "POST",
            "/v1/chat/completions",
            json.dumps(body),
            {"Content-Type": "application/json"},
        )
        resp = conn.getresponse()
        try:
            for raw in resp:
                line = raw.decode().strip()
                if not line.startswith("data: "):
                    continue
                payload = line[len("data: ") :]
                if payload == "[DONE]":
                    return
                chunk = json.loads(payload)
                for choice in chunk.get("choices", []):
                    delta = choice.get("delta", {}).get("content")
                    if delta:
                        yield delta
        finally:
            conn.close()

    def embeddings(self, texts, model: str = "") -> List[List[float]]:
        """POST /v1/embeddings → list of vectors (OpenAI wire format)."""
        if isinstance(texts, str):
            texts = [texts]
        out = self._post("/v1/embeddings", {"model": model, "input": texts})
        data = sorted(out["data"], key=lambda d: d["index"])
        return [d["embedding"] for d in data]

    def stats(self) -> dict:
        """GET /v1/stats — serving counters (slot pool utilization etc.)."""
        return self.get("/v1/stats")
