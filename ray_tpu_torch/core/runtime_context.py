"""Process-global runtime registry (counterpart of
``ray_tpu/core/runtime_context.py``).

The driver's runtime and a worker's runtime both register here, so the
public API (``get``, ``put``, the KV) resolves the right engine in any
process.
"""

from __future__ import annotations

from typing import Optional

_current = None


def set_runtime(rt):
    global _current
    _current = rt


def current_runtime_or_none():
    return _current


def current_runtime():
    from .exceptions import RuntimeNotInitializedError

    if _current is None:
        raise RuntimeNotInitializedError()
    return _current


def is_initialized() -> bool:
    return _current is not None


class RuntimeContext:
    """User-visible runtime introspection."""

    def __init__(self, rt):
        self._rt = rt

    def get_node_id(self) -> str:
        return self._rt.node_id

    def get_worker_id(self) -> str:
        return self._rt.worker_id

    def get_actor_id(self) -> Optional[str]:
        return getattr(self._rt, "current_actor_id", None)

    def get_task_id(self) -> Optional[str]:
        return getattr(self._rt, "current_task_id", None)


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext(current_runtime())
