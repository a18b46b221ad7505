"""Global plugin registry (port of the JAX package's neural_chat/plugins.py,
unchanged: it is pure Python).

Parity with the reference's plugin mechanism
(reference: neural_chat/plugins.py — a global `plugins` dict of
{name: {"enable": bool, "class": cls, "args": {...}, "instance": obj}} and
`register_plugin` decorator; hook protocol on BaseModel:
pre_llm_inference_actions / post_llm_inference_actions, base_model.py:182-272).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict

# ordered: pre-hooks run cache → asr → retrieval → safety (reference order,
# base_model.py:184-224); post-hooks run safety → tts
plugins: "OrderedDict[str, Dict]" = OrderedDict()


def register_plugin(name: str) -> Callable:
    def deco(cls):
        plugins.setdefault(
            name, {"enable": False, "class": cls, "args": {}, "instance": None}
        )
        plugins[name]["class"] = cls
        return cls

    return deco


def enable_plugin(name: str, **args) -> None:
    if name not in plugins:
        plugins[name] = {"enable": True, "class": None, "args": {}, "instance": None}
    plugins[name]["enable"] = True
    plugins[name]["args"].update(args)


def disable_plugin(name: str) -> None:
    if name in plugins:
        plugins[name]["enable"] = False
        plugins[name]["instance"] = None


def get_plugin_instance(name: str):
    meta = plugins.get(name)
    if not meta or not meta["enable"]:
        return None
    if meta["instance"] is None and meta["class"] is not None:
        meta["instance"] = meta["class"](**meta["args"])
    return meta["instance"]


def is_plugin_enabled(name: str) -> bool:
    return bool(plugins.get(name, {}).get("enable"))


def reset_plugins() -> None:
    for meta in plugins.values():
        meta["enable"] = False
        meta["instance"] = None
        meta["args"] = {}
