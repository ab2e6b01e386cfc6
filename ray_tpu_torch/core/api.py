"""Public core API (counterpart of ``ray_tpu/core/api.py``, head mode on
one node): ``init``, ``shutdown``, ``is_initialized``, ``remote``, ``get``,
``put``, ``wait``, ``kill``, ``nodes``, ``cluster_resources``,
``available_resources`` and the KV.

``init(num_gpus=None)`` counts the cards the driver sees with
``torch.cuda.device_count()`` (the only place the runtime imports torch);
``num_gpus=0`` gives a node without ``"GPU"``, on which a GPU request
fails as a ``"TPU"`` request does in the JAX package on a node without one.
There is no ``address=``: the port's runtime is one node, in head mode.
"""

from __future__ import annotations

import atexit
import inspect
import os
from typing import Any, Dict, Optional, Sequence

from . import runtime_context
from .actor import ActorClass, ActorHandle
from .config import get_config, reset_config
from .reference import ObjectRef
from .remote_function import RemoteFunction
from .resources import CPU, GPU, check_whole_gpus
from .runtime import DriverRuntime, make_session_dir


def _visible_cards(count: int):
    """The ``CUDA_VISIBLE_DEVICES`` entries of the node's ``count`` cards:
    the driver's own first ``count`` entries, or ``0..count-1`` when the
    variable is unset. A node cannot have more cards than the driver
    sees."""
    raw = os.environ.get("CUDA_VISIBLE_DEVICES")
    if raw is None:
        return [str(i) for i in range(count)]
    entries = [e.strip() for e in raw.split(",") if e.strip()]
    if count > len(entries):
        raise ValueError(
            f"init(num_gpus={count}) asks for more cards than the driver "
            f"sees (CUDA_VISIBLE_DEVICES={raw!r})")
    return entries[:count]


def init(
    *,
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    object_store_memory: Optional[int] = None,
    system_config: Optional[Dict[str, Any]] = None,
    ignore_reinit_error: bool = False,
) -> DriverRuntime:
    """Start the runtime in this process: the node's scheduler, object
    table and KV here, the workers as processes of their own.
    ``object_store_memory`` is the capacity, in bytes, that the objects
    the driver holds are counted against (``StoreUsagePolicy`` reads it);
    None keeps the config's ``object_store_memory`` (default 0: none)."""
    existing = runtime_context.current_runtime_or_none()
    if existing is not None:
        if ignore_reinit_error:
            return existing
        raise RuntimeError("ray_tpu.init() called twice; use shutdown() "
                           "first.")
    reset_config()
    config = get_config()
    config.apply_overrides(system_config)
    if object_store_memory is not None:
        config.object_store_memory = int(object_store_memory)
    if num_gpus is None:
        import torch

        num_gpus = torch.cuda.device_count()
    check_whole_gpus({GPU: num_gpus})
    cards = _visible_cards(int(num_gpus))
    res: Dict[str, float] = dict(resources or {})
    res.setdefault(CPU, num_cpus if num_cpus is not None
                   else os.cpu_count() or 1)
    if num_gpus:
        res[GPU] = num_gpus
    else:
        res.pop(GPU, None)
    rt = DriverRuntime(res, cards, make_session_dir())
    runtime_context.set_runtime(rt)
    atexit.register(_atexit_shutdown)
    return rt


def _atexit_shutdown():
    try:
        shutdown()
    except Exception:  # the interpreter is going down either way
        pass


def shutdown():
    """Stop every worker process and drop the runtime."""
    rt = runtime_context.current_runtime_or_none()
    if rt is None:
        return
    runtime_context.set_runtime(None)
    rt.shutdown()


def is_initialized() -> bool:
    return runtime_context.is_initialized()


def kv_put(key: str, value: bytes, overwrite: bool = True) -> bool:
    return runtime_context.current_runtime().kv_put(key, value, overwrite)


def kv_get(key: str):
    return runtime_context.current_runtime().kv_get(key)


def remote(*args, **kwargs):
    """@remote decorator for functions and classes, with or without
    options."""
    if len(args) == 1 and not kwargs and (
        inspect.isfunction(args[0]) or inspect.isclass(args[0])
    ):
        target = args[0]
        if inspect.isclass(target):
            return ActorClass(target)
        return RemoteFunction(target)
    if args:
        raise TypeError("remote() takes keyword options only, e.g. "
                        "@remote(num_cpus=2)")

    def decorator(target):
        if inspect.isclass(target):
            return ActorClass(target, kwargs)
        return RemoteFunction(target, kwargs)

    return decorator


def put(value) -> ObjectRef:
    return runtime_context.current_runtime().put(value)


def get(refs, *, timeout: Optional[float] = None):
    return runtime_context.current_runtime().get(refs, timeout)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None):
    return runtime_context.current_runtime().wait(refs, num_returns,
                                                  timeout)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    """Kill the actor's worker process. With ``no_restart=False`` an actor
    with restarts left is created again, as after a crash."""
    runtime_context.current_runtime().kill_actor(actor.actor_id, no_restart)


def cluster_resources() -> Dict[str, float]:
    return runtime_context.current_runtime().cluster_resources()


def available_resources() -> Dict[str, float]:
    return runtime_context.current_runtime().available_resources()


def nodes():
    return runtime_context.current_runtime().nodes()
