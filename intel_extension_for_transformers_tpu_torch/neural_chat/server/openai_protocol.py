"""OpenAI API protocol types.

Port of `intel_extension_for_transformers_tpu/neural_chat/server/
openai_protocol.py`, unchanged but for `ModelCard.owned_by`: pure Python.
Dependency-free dataclass re-creation of the reference's pydantic protocol
(reference: neural_chat/server/restful/openai_protocol.py — request/response
shapes for /v1/chat/completions, /v1/completions, /v1/models). Only fields
the server actually serves are modeled; unknown request fields are ignored
like the reference's pydantic `extra="ignore"`.
"""

from __future__ import annotations

import dataclasses
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


def _now() -> int:
    return int(time.time())


def _id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex[:24]}"


def asdict_clean(obj) -> Any:
    """dataclass → dict, dropping None leaves (OpenAI omits null fields)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            k: asdict_clean(v)
            for k, v in dataclasses.asdict(obj).items()
            if v is not None
        }
    if isinstance(obj, list):
        return [asdict_clean(x) for x in obj]
    if isinstance(obj, dict):
        return {k: asdict_clean(v) for k, v in obj.items() if v is not None}
    return obj


# ---------------------------------------------------------------- requests


@dataclass
class ChatMessage:
    role: str = "user"
    content: str = ""


@dataclass
class ChatCompletionRequest:
    model: str = ""
    messages: List[ChatMessage] = field(default_factory=list)
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    n: int = 1
    max_tokens: Optional[int] = None
    stream: bool = False
    stop: Optional[Any] = None
    repetition_penalty: Optional[float] = None
    seed: Optional[int] = None
    # extension (vLLM-style guided decoding): output must be one of these
    guided_choice: Optional[List[str]] = None

    @classmethod
    def from_dict(cls, d: Dict) -> "ChatCompletionRequest":
        msgs = [
            ChatMessage(m.get("role", "user"), _content_text(m.get("content", "")))
            for m in d.get("messages", [])
        ]
        names = {f.name for f in dataclasses.fields(cls)} - {"messages"}
        kw = {k: v for k, v in d.items() if k in names}
        return cls(messages=msgs, **kw)


def _content_text(content) -> str:
    """OpenAI content can be a string or a list of typed parts."""
    if isinstance(content, str):
        return content
    if isinstance(content, list):
        return "".join(
            p.get("text", "") for p in content if isinstance(p, dict)
        )
    return str(content)


@dataclass
class CompletionRequest:
    model: str = ""
    prompt: Any = ""
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    n: int = 1
    max_tokens: Optional[int] = None
    stream: bool = False
    stop: Optional[Any] = None
    repetition_penalty: Optional[float] = None
    seed: Optional[int] = None

    @classmethod
    def from_dict(cls, d: Dict) -> "CompletionRequest":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


# ---------------------------------------------------------------- responses


@dataclass
class UsageInfo:
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0


@dataclass
class ChatCompletionChoice:
    index: int
    message: ChatMessage
    finish_reason: str = "stop"


@dataclass
class ChatCompletionResponse:
    id: str = field(default_factory=lambda: _id("chatcmpl"))
    object: str = "chat.completion"
    created: int = field(default_factory=_now)
    model: str = ""
    choices: List[ChatCompletionChoice] = field(default_factory=list)
    usage: UsageInfo = field(default_factory=UsageInfo)


@dataclass
class DeltaMessage:
    role: Optional[str] = None
    content: Optional[str] = None


@dataclass
class ChatCompletionChunkChoice:
    index: int
    delta: DeltaMessage
    finish_reason: Optional[str] = None


@dataclass
class ChatCompletionChunk:
    id: str = field(default_factory=lambda: _id("chatcmpl"))
    object: str = "chat.completion.chunk"
    created: int = field(default_factory=_now)
    model: str = ""
    choices: List[ChatCompletionChunkChoice] = field(default_factory=list)


@dataclass
class CompletionChoice:
    index: int
    text: str
    finish_reason: Optional[str] = "stop"


@dataclass
class CompletionResponse:
    id: str = field(default_factory=lambda: _id("cmpl"))
    object: str = "text_completion"
    created: int = field(default_factory=_now)
    model: str = ""
    choices: List[CompletionChoice] = field(default_factory=list)
    usage: UsageInfo = field(default_factory=UsageInfo)


@dataclass
class ModelCard:
    id: str
    object: str = "model"
    created: int = field(default_factory=_now)
    owned_by: str = "intel_extension_for_transformers_tpu_torch"


@dataclass
class ModelList:
    object: str = "list"
    data: List[ModelCard] = field(default_factory=list)


@dataclass
class ErrorResponse:
    message: str
    type: str = "invalid_request_error"
    code: int = 400

    def to_body(self) -> dict:
        return {"error": asdict_clean(self)}
