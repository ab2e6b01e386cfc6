"""Replica actor: hosts one copy of a deployment (counterpart of
``ray_tpu/serve/replica.py``).

Ref analogue: python/ray/serve/_private/replica.py RayServeReplica (:510,
call_user_method:851). Function deployments are called directly; class
deployments are instantiated once and called via __call__ or a named
method. ``handle_batch`` is the vectorized entry used by the router's
dynamic batcher (ref analogue: serve/batching.py _BatchQueue flushing into
the user's batch method). Each replica carries the deployment version it
was started under (ref: deployment_version.py) so the controller can
drive rolling updates.

The deployment's function or class arrives as a ``pickle`` blob that names
it by reference (:func:`target_blob`: its module and qualified name), not
as a ``cloudpickle`` blob that carries its code: the replica's worker
imports it (:func:`load_target`), so a deployment must be defined at
module level in a module the workers can import, as every function and
class the port's runtime runs. The name may hold the function or class
itself or, under ``@serve.deployment``, its Deployment.
"""

from __future__ import annotations

import importlib
import inspect
import os
import pickle
import sys
import threading
import time
from typing import Any, Dict, List, Tuple

from ..core.reference import refuse_unimportable
from .deployment import Deployment


def target_blob(target) -> bytes:
    """A deployment's function or class by reference: a pickled (module,
    qualified name). Raises ``TypeError`` for one a worker could not
    import (``__main__``, a local or a lambda)."""
    refuse_unimportable(target)
    return pickle.dumps((target.__module__, target.__qualname__))


def load_target(blob: bytes):
    """Import the function or class :func:`target_blob` names."""
    module, qualname = pickle.loads(blob)
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj.func_or_class if isinstance(obj, Deployment) else obj


class BoundDeployment:
    """Picklable stand-in for a DeploymentHandle riding in init args
    (live handles carry threads/locks and cannot pickle). Replicas
    resolve it to a real handle at construction time — this is what
    makes ``Child.bind()`` inside ``Parent.bind(child)`` work (ref
    analogue: the deployment-graph build's handle injection,
    serve/_private/deployment_graph_build.py)."""

    def __init__(self, name: str):
        self.name = name

    def resolve(self):
        from .api import get_deployment_handle

        return get_deployment_handle(self.name)


def _resolve_bound(value):
    if isinstance(value, BoundDeployment):
        return value.resolve()
    if isinstance(value, dict):
        return {k: _resolve_bound(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_resolve_bound(v) for v in value)
    return value


class Replica:
    def __init__(self, blob: bytes, init_args, init_kwargs,
                 version: str = "", deployment_name: str = "",
                 max_concurrent: int = 8):
        target = load_target(blob)
        init_args = tuple(_resolve_bound(a) for a in init_args)
        init_kwargs = {k: _resolve_bound(v)
                       for k, v in init_kwargs.items()}
        if inspect.isclass(target):
            self._callable = target(*init_args, **init_kwargs)
            self._is_class = True
        else:
            self._callable = target
            self._is_class = False
        self._num_handled = 0
        self._version = version
        self._deployment = deployment_name
        self._ongoing = 0
        self._lock = threading.Lock()
        # Identity tag for the ongoing gauge: gauges merge last-writer-
        # wins across processes, so replicas of one deployment must not
        # share a tag set (sum over `replica` for the total).
        from ..core.config import get_config
        from ..util.overload import AIMDLimiter

        # "local": the node tag of the port's one-node runtime
        # (util/device_metrics.node_tag, not imported here: it loads torch).
        self._replica_id = f"local:{os.getpid()}"
        # Adaptive admission: the deployment's max_concurrent_queries is
        # the ceiling; observed latency shrinks the admitted concurrency
        # below it (AIMD), and excess sheds with OverloadedError so the
        # handle routes it to a less-loaded replica instead of queueing
        # it here (ref analogue: replica-side max_ongoing_requests).
        self._limiter = AIMDLimiter(
            initial=max(1, int(max_concurrent)),
            min_limit=1,
            max_limit=max(1, int(max_concurrent)),
            latency_target_s=get_config().serve_aimd_latency_target_s,
        )

    def _resolve(self, method: str):
        if self._is_class and method != "__call__":
            return getattr(self._callable, method)
        return self._callable

    def _gauge_tags(self):
        return {"deployment": self._deployment or "anonymous",
                "replica": self._replica_id}

    def _begin(self, n: int = 1) -> None:
        from . import _telemetry

        with self._lock:
            self._num_handled += n
            self._ongoing += 1
            ongoing = self._ongoing
        _telemetry.REPLICA_ONGOING.set(float(ongoing),
                                       tags=self._gauge_tags())

    def _end(self, method: str, submit_ts: float, started: float) -> None:
        from . import _telemetry

        with self._lock:
            self._ongoing -= 1
            ongoing = self._ongoing
        _telemetry.REPLICA_ONGOING.set(float(ongoing),
                                       tags=self._gauge_tags())
        _telemetry.observe_replica_request(
            self._deployment, method, submit_ts, started, time.time()
        )
        # Natural sampling edge for accelerator state (throttled; only in
        # replicas whose code imported torch, a no-op where CUDA never
        # started).
        if "torch" in sys.modules:
            from ..util import device_metrics

            device_metrics.maybe_sample()

    def _admit(self, method: str) -> None:
        """Overload-control entry run before ANY user code: refuse
        deadline-expired work (it spent its budget queued — a dead
        request must never occupy the card), then enforce the adaptive
        concurrency limit (shed -> the handle retries a less-loaded
        replica)."""
        from ..core.exceptions import OverloadedError
        from ..util import overload
        from . import _telemetry

        overload.check_deadline(f"{self._deployment or 'replica'}.{method}")
        if not self._limiter.try_acquire():
            _telemetry.observe_shed(self._deployment, "replica")
            raise OverloadedError(
                f"replica {self._replica_id} of "
                f"{self._deployment or 'anonymous'!r} at adaptive "
                f"concurrency limit {self._limiter.limit}",
                retry_after_s=max(
                    0.1, self._limiter.ewma_latency_s or 0.5
                ),
            )

    def _chaos(self, method: str) -> None:
        """Chaos injection point INSIDE the measured request window, so
        an armed latency/error spec degrades this replica exactly like a
        slow or faulty one — feeding the caller's breaker and this
        replica's AIMD limiter (scope to one replica via
        ``match={"replica": <id>}``)."""
        from ..util import faults

        delay = faults.fire(
            faults.SERVE_REPLICA,
            deployment=self._deployment or "anonymous",
            replica=self._replica_id, method=method,
        )
        if delay:
            time.sleep(delay)

    def handle_request(self, method: str, args: Tuple, kwargs: Dict,
                       model_id: str = "", submit_ts: float = 0.0) -> Any:
        from ..util import overload
        from .multiplex import _set_model_id

        self._admit(method)
        self._begin()
        started = time.time()
        _set_model_id(model_id)
        try:
            self._chaos(method)
            # Injected (or real queueing) latency may have spent the
            # budget: cancel before user code runs, not after.
            overload.check_deadline(
                f"{self._deployment or 'replica'}.{method}"
            )
            return self._resolve(method)(*args, **kwargs)
        finally:
            self._limiter.release(time.time() - started)
            self._end(method, submit_ts, started)

    def handle_request_streaming(self, method: str, args: Tuple,
                                 kwargs: Dict, model_id: str = "",
                                 submit_ts: float = 0.0):
        """Generator entry: invoked with num_returns="streaming" by the
        handle so each yielded item seals as its own object and streams to
        the caller as produced (ref analogue: replica.py
        call_user_generator + the proxy's RESPONSE_STREAMING path).
        Deadline enforcement between items happens at the worker's
        stream-item seams (core/worker_main.py), so an expired stream stops
        producing instead of generating into the void."""
        from .multiplex import _set_model_id

        self._admit(method)
        self._begin()
        started = time.time()
        _set_model_id(model_id)
        try:
            self._chaos(method)
            out = self._resolve(method)(*args, **kwargs)
            if inspect.isgenerator(out) or hasattr(out, "__next__"):
                yield from out
            else:
                yield out
        finally:
            self._limiter.release(time.time() - started)
            self._end(method, submit_ts, started)

    def handle_batch(self, method: str, batched_args: List[Tuple],
                     model_id: str = "",
                     submit_ts: float = 0.0) -> List[Any]:
        """One call per batch: user function receives a list of first
        positional args and must return a list of equal length."""
        from .multiplex import _set_model_id

        self._admit(method)
        self._begin(len(batched_args))
        started = time.time()
        _set_model_id(model_id)
        try:
            self._chaos(method)
            fn = self._resolve(method)
            items = [a[0][0] if a[0] else None for a in batched_args]
            out = fn(items)
            if not isinstance(out, (list, tuple)) or len(out) != len(items):
                raise ValueError(
                    "batched deployment must return a list matching input "
                    "length"
                )
            return list(out)
        finally:
            self._limiter.release(time.time() - started)
            self._end(method, submit_ts, started)

    def stats(self) -> Dict[str, Any]:
        return {
            "num_handled": self._num_handled,
            "ongoing": self._ongoing,
            "version": self._version,
            "replica_id": self._replica_id,
            "concurrency_limit": self._limiter.limit,
            "sheds": self._limiter.sheds,
        }

    def version(self) -> str:
        return self._version

    def prepare_shutdown(self, timeout_s: float = 25.0) -> str:
        """Drain hook. For concurrency-1 replicas, per-submitter call
        ordering already guarantees earlier queued requests ran before
        this one; for concurrent replicas (and long-lived STREAMING
        generators) it additionally waits until no request is in flight,
        bounded by ``timeout_s`` (ref analogue: proxy/replica graceful
        drain on rolling update, serve/_private/proxy.py:1097)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if self._ongoing == 0:
                    return "drained"
            time.sleep(0.05)
        return f"timeout ({self._ongoing} ongoing)"

    def ping(self) -> str:
        return "pong"
