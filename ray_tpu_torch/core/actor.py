"""Actor classes, handles and methods (counterpart of
``ray_tpu/core/actor.py``).

Each actor lives in a worker process of its own and runs its method calls
one at a time in the order they were submitted, or, with
``max_concurrency`` above 1, on that many threads of its worker at once
(a call that blocks then holds one thread, not the actor). Options:
``num_cpus`` (default 0, as in the JAX package), ``num_gpus``,
``resources``, ``scheduling_strategy``, ``max_restarts`` (default 0),
``max_concurrency`` (default 1) and ``name``. Every actor answers
``__rtpu_ping__`` with ``"ok"`` once its constructor has run. A method
called with ``.options(num_returns="streaming")`` returns an
:class:`~.streaming.ObjectRefGenerator`; every call carries the caller's
ambient deadline (``util/overload``).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from .remote_function import _build_resources, wrap_returns
from .runtime_context import current_runtime


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns

    def options(self, **opts) -> "ActorMethod":
        return ActorMethod(self._handle, self._method_name,
                           opts.get("num_returns", 1))

    def remote(self, *args, **kwargs):
        from ..util.overload import ambient_deadline

        rt = current_runtime()
        refs = rt.submit(dict(
            kind="call",
            actor=self._handle._actor_id,
            method=self._method_name,
            name=f"{self._handle._class_name}.{self._method_name}",
            num_returns=self._num_returns,
            deadline=ambient_deadline(),
        ), args, kwargs)
        return wrap_returns(refs, self._num_returns)

    def __call__(self, *args, **kwargs):
        raise TypeError("Actor methods must be called with '.remote()'.")


class ActorHandle:
    def __init__(self, actor_id: str, class_name: str = ""):
        self._actor_id = actor_id
        self._class_name = class_name

    def __getattr__(self, name: str) -> ActorMethod:
        # "__rtpu_ping__" is the built-in liveness probe every actor
        # answers; other dunder and private lookups are Python machinery.
        if name.startswith("_") and name != "__rtpu_ping__":
            raise AttributeError(name)
        method = ActorMethod(self, name)
        self.__dict__[name] = method
        return method

    @property
    def actor_id(self) -> str:
        return self._actor_id

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id[:8]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name))


class ActorClass:
    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = dict(options or {})
        functools.update_wrapper(self, cls, updated=[])

    def options(self, **opts) -> "ActorClass":
        merged = dict(self._options)
        merged.update(opts)
        return ActorClass(self._cls, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        rt = current_runtime()
        (actor_id,) = rt.submit(dict(
            kind="create",
            fn=rt.ensure_function(self._cls),
            name=self._options.get("name", "") or "",
            class_name=self._cls.__name__,
            resources=_build_resources(self._options, default_num_cpus=0),
            strategy=self._options.get("scheduling_strategy"),
            max_restarts=self._options.get("max_restarts", 0),
            max_concurrency=int(self._options.get("max_concurrency", 1)),
        ), args, kwargs)
        return ActorHandle(actor_id, self._cls.__name__)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self._cls.__name__}' cannot be instantiated "
            "directly; use '.remote()'."
        )


def get_actor(name: str) -> ActorHandle:
    """Look up a named actor."""
    found = current_runtime().get_named_actor(name)
    if found is None:
        raise ValueError(f"Failed to look up actor with name '{name}'")
    return ActorHandle(*found)
