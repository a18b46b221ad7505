"""Latest-error API threaded through build/predict paths (port of the JAX
package's utils/error_utils.py, unchanged: it is pure Python).

Mirrors reference neural_chat/utils/error_utils.py:1-37
(`set_latest_error` / `get_latest_error` global-singleton pattern), with a
thread-local twist so concurrent server requests don't clobber each other.
"""

from __future__ import annotations

import threading

_state = threading.local()


def set_latest_error(code: int) -> None:
    _state.code = code


def get_latest_error() -> int | None:
    return getattr(_state, "code", None)


def clear_latest_error() -> None:
    _state.code = None
