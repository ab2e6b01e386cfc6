"""Serve public API (counterpart of ``ray_tpu/serve/api.py``).

Ref analogue: python/ray/serve/api.py — serve.run (:449), serve.batch,
serve.delete, serve.shutdown, get_deployment_handle, serve.status.

A deployment's function or class travels to its replicas by reference
(``replica.target_blob``: its module and qualified name), so it must be
defined at module level in a module the workers can import, decorated
with ``@serve.deployment`` or not; a lambda, a local or a ``__main__``
class raises ``TypeError`` at ``run``. The controller is a
named actor on the port's one node, created by the first caller.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from .. import core as rt
from . import http_proxy
from .controller import (
    CONTROLLER_MAX_CONCURRENCY,
    CONTROLLER_NAME,
    ServeControllerActor,
)
from .deployment import AutoscalingConfig, Deployment, deployment  # noqa: F401
from .handle import DeploymentHandle
from .multiplex import (  # noqa: F401
    get_multiplexed_model_id,
    multiplexed,
)
from .replica import target_blob

_controller = None
# One router-state family per deployment: redeploys and repeated
# get_deployment_handle calls share the same long-poller instead of
# leaking one thread per handle.
_states: Dict[str, Any] = {}


def _make_handle(name: str, snap: Dict[str, Any],
                 batch_config=None) -> DeploymentHandle:
    state = _states.get(name)
    if state is not None and not state.closed:
        handle = DeploymentHandle(
            name, [], batch_config=batch_config, _state=state
        )
        state.force_refresh()
        return handle
    handle = DeploymentHandle(
        name, snap["replicas"],
        batch_config=batch_config,
        controller=_get_controller(),
        route_version=snap["version"],
    )
    _states[name] = handle._state
    return handle


def _get_controller():
    global _controller
    if _controller is not None:
        return _controller
    try:
        _controller = rt.get_actor(CONTROLLER_NAME)
    except ValueError:
        _controller = rt.remote(ServeControllerActor).options(
            name=CONTROLLER_NAME,
            max_concurrency=CONTROLLER_MAX_CONCURRENCY,
        ).remote()
        # Wait until the controller is live before first use.
        rt.get(_controller.list_deployments.remote())
    return _controller


def _deploy_children(controller, target: Deployment,
                     stack: tuple = ()) -> tuple:
    """Deployment-graph build: deploy every Deployment nested in the
    target's init args (post-order) and swap it for a picklable
    BoundDeployment the replica resolves to a live handle (ref:
    serve/_private/deployment_graph_build.py — ``Parent.bind(
    Child.bind())``)."""
    from .replica import BoundDeployment

    def resolve(v):
        if isinstance(v, Deployment):
            if v.name in stack:
                raise ValueError(
                    f"deployment graph cycle through {v.name!r}"
                )
            _deploy_one(controller, v.name, v,
                        stack=stack + (v.name,))
            return BoundDeployment(v.name)
        # Deployments may ride inside containers.
        if isinstance(v, dict):
            return {k: resolve(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(resolve(x) for x in v)
        return v

    args = tuple(resolve(a) for a in target._init_args)
    kwargs = {k: resolve(v) for k, v in target._init_kwargs.items()}
    return args, kwargs


def _deploy_one(controller, dep_name: str, target: Deployment, *,
                stack: tuple = ()):
    init_args, init_kwargs = _deploy_children(controller, target, stack)
    blob = target_blob(target.func_or_class)
    batch_config = getattr(target.func_or_class, "_serve_batch_config",
                           None)
    autoscaling = (
        dataclasses.asdict(target.autoscaling_config)
        if target.autoscaling_config is not None else None
    )
    rt.get(
        controller.deploy.remote(
            dep_name,
            blob,
            init_args,
            init_kwargs,
            target.num_replicas,
            target.ray_actor_options,
            batch_config,
            autoscaling,
            max_concurrent_queries=target.max_concurrent_queries,
        )
    )


def run(target: Deployment, *, name: Optional[str] = None,
        route_prefix: Optional[str] = None, http_port: int = 0,
        _blocking: bool = False) -> DeploymentHandle:
    """Deploy (or redeploy — rolling, zero-downtime) and return a handle
    (ref: serve.run). Nested ``.bind()`` deployments in the target's
    init args deploy first and arrive in the constructor as live
    handles (the deployment-graph build). Starts the HTTP proxy lazily
    on first use; ``http_port=0`` picks a free port."""
    controller = _get_controller()
    dep_name = name or target.name
    _deploy_one(controller, dep_name, target, stack=(dep_name,))
    snap = rt.get(controller.get_routing.remote(dep_name))
    handle = _make_handle(
        dep_name, snap,
        getattr(target.func_or_class, "_serve_batch_config", None))
    port = http_proxy.start_proxy(http_port)
    http_proxy.register_route(route_prefix or dep_name, handle)
    handle.http_port = port
    return handle


def get_deployment_handle(name: str) -> DeploymentHandle:
    controller = _get_controller()
    snap = rt.get(controller.get_routing.remote(name))
    return _make_handle(name, snap, snap["batch_config"])


def scale(name: str, num_replicas: int) -> DeploymentHandle:
    controller = _get_controller()
    rt.get(controller.scale.remote(name, num_replicas))
    return get_deployment_handle(name)


def status() -> Dict[str, int]:
    return rt.get(_get_controller().list_deployments.remote())


def details() -> Dict[str, Dict[str, Any]]:
    """Per-deployment state: replica count/target, version, autoscaling
    (ref: serve.status() ApplicationDetails)."""
    return rt.get(_get_controller().describe.remote())


def delete(name: str):
    state = _states.pop(name, None)
    if state is not None:
        state.closed = True
    rt.get(_get_controller().delete.remote(name))


def shutdown():
    """Stop the proxy, close every handle's poller, retire every replica
    and kill the controller."""
    global _controller
    http_proxy.stop_proxy()
    for state in _states.values():
        state.closed = True
    _states.clear()
    if _controller is not None:
        try:
            rt.get(_controller.shutdown.remote())
            rt.kill(_controller)
        except Exception:  # the runtime already went down with them
            pass
        _controller = None


def batch(_func=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """@serve.batch: mark a callable for dynamic batching (ref:
    serve/batching.py:65 _BatchQueue). The wrapped callable receives a LIST
    of requests and returns a list of responses; the router coalesces
    concurrent calls (continuous batching for model decode lives on top of
    this in serve/llm.py)."""

    def wrap(fn):
        fn._serve_batch_config = {
            "max_batch_size": max_batch_size,
            "batch_wait_timeout_s": batch_wait_timeout_s,
        }
        return fn

    if _func is not None:
        return wrap(_func)
    return wrap
