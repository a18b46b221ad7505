"""Conversation templates + prompt builders (port of the JAX package's
neural_chat/prompts.py, unchanged: it is pure Python).

Parity with the reference's prompt plugin
(reference: pipeline/plugins/prompt/prompt_template.py — conv templates per
model family via get_conv_template, generate_qa_prompt,
generate_intent_prompt; model mapping in base_model.py:448).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass
class Conversation:
    name: str
    system: str = ""
    roles: Tuple[str, str] = ("USER", "ASSISTANT")
    sep: str = "\n"
    sep2: str = "</s>"
    messages: List[Tuple[str, str]] = field(default_factory=list)

    def append_message(self, role: str, content: str) -> None:
        self.messages.append((role, content))

    def get_prompt(self) -> str:
        parts = [self.system] if self.system else []
        for role, content in self.messages:
            if content:
                parts.append(f"{role}: {content}")
            else:
                parts.append(f"{role}:")
        return self.sep.join(parts)

    def copy(self) -> "Conversation":
        return Conversation(
            name=self.name,
            system=self.system,
            roles=self.roles,
            sep=self.sep,
            sep2=self.sep2,
            messages=list(self.messages),
        )


CONV_TEMPLATES = {
    "zero_shot": Conversation(
        name="zero_shot",
        system=(
            "A chat between a curious human and an artificial intelligence "
            "assistant. The assistant gives helpful, detailed, and polite "
            "answers to the human's questions."
        ),
        roles=("Human", "Assistant"),
        sep="\n### ",
    ),
    "llama-2": Conversation(
        name="llama-2",
        system=(
            "[INST] <<SYS>>\nYou are a helpful, respectful and honest "
            "assistant.\n<</SYS>>\n\n"
        ),
        roles=("[INST]", "[/INST]"),
        sep=" ",
    ),
    "alpaca": Conversation(
        name="alpaca",
        system=(
            "Below is an instruction that describes a task. Write a response "
            "that appropriately completes the request."
        ),
        roles=("### Instruction", "### Response"),
        sep="\n\n",
    ),
    "neural-chat-7b-v2": Conversation(
        name="neural-chat-7b-v2",
        system=(
            "### System:\n- You are a helpful assistant chatbot trained by "
            "Intel.\n"
        ),
        roles=("### User", "### Assistant"),
        sep="\n",
    ),
    "chatglm": Conversation(
        name="chatglm", roles=("问", "答"), sep="\n"
    ),
    "mistral": Conversation(
        name="mistral", roles=("[INST]", "[/INST]"), sep=" "
    ),
}

# model-name substring → template (reference: base_model.py get_conv_template)
_MODEL_TEMPLATE_MAP = [
    ("llama-2", "llama-2"),
    ("llama2", "llama-2"),
    ("mistral", "mistral"),
    ("chatglm", "chatglm"),
    ("neural-chat", "neural-chat-7b-v2"),
    ("alpaca", "alpaca"),
]


def get_conv_template(model_name: str = "") -> Conversation:
    low = (model_name or "").lower()
    for key, tmpl in _MODEL_TEMPLATE_MAP:
        if key in low:
            return CONV_TEMPLATES[tmpl].copy()
    return CONV_TEMPLATES["zero_shot"].copy()


def generate_qa_prompt(query: str, context: str = "") -> str:
    from intel_extension_for_transformers_tpu_torch.retrieval.agent import (
        NO_CONTEXT_TEMPLATE,
        QA_PROMPT_TEMPLATE,
    )

    if context:
        return QA_PROMPT_TEMPLATE.format(context=context, question=query)
    return NO_CONTEXT_TEMPLATE.format(question=query)


INTENT_PROMPT = (
    "Please identify the intent of the provided context. You may only "
    'respond with "chitchat" or "QA" without explanations or engaging in '
    "conversation.\nContext: {query}\nIntent:"
)


def generate_intent_prompt(query: str) -> str:
    """(reference: detector/intent_detection.py:24 — LLM intent probe)"""
    return INTENT_PROMPT.format(query=query)
