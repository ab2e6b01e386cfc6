"""Model multiplexing (counterpart of ``ray_tpu/serve/multiplex.py``).

Ref analogue: serve/api.py @serve.multiplexed + _private/
request_router's model-aware routing: one deployment serves MANY models;
each replica lazily loads the models it is asked for and keeps an LRU of
``max_num_models_per_replica``; the router prefers replicas that already
hold the requested model (cache affinity), so hot models stay loaded.
"""

from __future__ import annotations

import contextvars
import functools
from collections import OrderedDict
from typing import Any, Callable, Optional

_current_model_id: contextvars.ContextVar[str] = contextvars.ContextVar(
    "ray_tpu_serve_multiplexed_model_id", default=""
)


def get_multiplexed_model_id() -> str:
    """Inside a request: the model id the caller targeted (ref:
    serve.get_multiplexed_model_id)."""
    return _current_model_id.get()


def _set_model_id(model_id: str):
    _current_model_id.set(model_id)


def multiplexed(_func: Optional[Callable] = None, *,
                max_num_models_per_replica: int = 3):
    """Decorate a per-model LOADER (usually a method of the deployment
    class taking a model id). Calls are LRU-cached per replica; loading a
    model beyond the cap evicts the least-recently-used one (its
    ``__del__``/GC releases resources)."""

    def wrap(load_fn):
        cache: "OrderedDict[str, Any]" = OrderedDict()

        @functools.wraps(load_fn)
        def loader(*args):
            # Support plain functions and methods (self, model_id).
            model_id = args[-1]
            if model_id in cache:
                cache.move_to_end(model_id)
                return cache[model_id]
            model = load_fn(*args)
            cache[model_id] = model
            if len(cache) > max_num_models_per_replica:
                cache.popitem(last=False)  # evict LRU
            return model

        loader._is_multiplexed = True
        return loader

    if _func is not None:
        return wrap(_func)
    return wrap
