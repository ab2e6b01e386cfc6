"""DeploymentHandle + router (counterpart of ``ray_tpu/serve/handle.py``).

Ref analogue: serve/handle.py DeploymentHandle → _private/router.py Router
(:893) with PowerOfTwoChoicesReplicaScheduler (:290): each request samples
two replicas and picks the one with fewer outstanding requests (queue
lengths tracked by the caller; the reference queries replicas — local
tracking is the single-process simplification of the same policy).

Routing state (replica set + queue depths) lives in one shared
``_RouterState`` per handle family: ``handle.options(method=...)`` clones
share it, so a scale/rolling-update seen by any of them is seen by all.
The state keeps itself fresh via a LONG-POLL to the controller (ref
analogue: long_poll.py LongPollClient): a daemon thread blocks in
``listen_for_route_change`` and swaps the routable set the moment the
controller scales or rolls a deployment. The same thread pushes the
handle's outstanding-request total to the controller, which is the input
to queue-depth autoscaling (ref: handle-side autoscaling metrics). The
thread holds only a WEAK reference to the state — dropping every handle
ends the poller instead of leaking it.

Requests that land on a replica retired mid-flight (rolling update,
downscale, worker crash) evict that replica locally and retry against the
refreshed set — this is what makes redeploys zero-downtime and replica
crashes invisible to the caller.

Dynamic batching lives here too (ref analogue: serve/batching.py
_BatchQueue:65): requests buffer until max_batch_size or batch_wait_timeout_s
and flush as ONE replica call — on the card this is what keeps the tensor
cores fed with batched forward passes instead of single-row calls.

REQUEST ROBUSTNESS (util/overload.py mechanisms): every request carries
an absolute deadline (the ingress's ambient budget, else the
``serve_default_request_timeout_s`` default) that is installed on the
router thread, carried by the replica call's submission, and enforced
replica-side (refuse-before-execute + cooperative cancellation). The
router keeps a per-replica CIRCUIT BREAKER fed by every outcome — an
open breaker takes the replica out of the pick set (half-open probes
re-admit it), and non-closed breakers are reported to the controller,
which ejects persistently-unhealthy replicas through the drain
machinery. Retries ride a jittered backoff and a token-bucket RETRY
BUDGET so they cannot amplify an outage.

HOT PATH: replicas are plain actor handles, so a request is one actor
call submitted to the driver and one ``get`` of its result (the port's
runtime has no direct actor-call plane; every call goes through the
driver, which holds the objects). Blocking controller calls
(``force_refresh``) happen only in recovery paths (dead replica, stale
route).
"""

from __future__ import annotations

import os
import random
import threading
import time
import uuid
import weakref
from typing import Any, Dict, List, Optional, Tuple

from .. import core as rt

MAX_DEATH_RETRIES = 3
# Per-item deadline for streaming responses (overridable via env);
# guards proxy/consumer threads against a wedged replica generator.
STREAM_ITEM_TIMEOUT_S = float(
    os.environ.get("RAY_TPU_SERVE_STREAM_ITEM_TIMEOUT_S", "120")
)
# How long an evicted replica key stays filtered out of snapshots (covers
# the gap until the controller's health check removes it server-side).
DEAD_REPLICA_TTL_S = 10.0


def _replica_key(replica) -> Any:
    return getattr(replica, "_actor_id", None) or id(replica)


class _RouterState:
    """Shared routing view for one deployment (all handle clones)."""

    def __init__(self, deployment_name: str, replicas: List[Any],
                 controller, route_version: int):
        from ..core.config import get_config
        from ..util.overload import RetryBudget

        self.deployment_name = deployment_name
        self.lock = threading.Lock()
        self.replicas = list(replicas)
        self.route_version = route_version
        self.outstanding: Dict[Any, int] = {}
        self.controller = controller
        self.handle_id = uuid.uuid4().hex[:12]
        self.closed = False
        self._cfg = get_config()
        # Per-replica circuit breakers (keyed like `outstanding`): a
        # sick replica's breaker opens instead of letting retries
        # hammer it; half-open probes re-admit it after heal. The
        # shared retry budget caps retry amplification handle-wide.
        self.breakers: Dict[Any, Any] = {}
        self.retry_budget = RetryBudget(
            ratio=self._cfg.serve_retry_budget_ratio
        )
        # Keys of replicas we observed dead, with eviction time: filtered
        # out of controller snapshots until the health checker has had time
        # to remove them server-side (prevents re-routing to a corpse).
        self.dead: Dict[Any, float] = {}
        # multiplexed model id -> replica key that last served it.
        self.model_affinity: Dict[str, Any] = {}
        if controller is not None:
            t = threading.Thread(
                target=_refresh_loop, args=(weakref.ref(self),), daemon=True
            )
            t.start()

    # ---- replica selection (power of two choices) -------------------------

    MAX_TRACKED_MODELS = 256
    # A model spills onto another replica when its current holders are
    # this many requests deeper than the cluster's least-loaded replica.
    AFFINITY_SPILL_DEPTH = 2

    def _breaker(self, key):
        """Breaker for one replica key (caller holds ``self.lock``)."""
        br = self.breakers.get(key)
        if br is None:
            from ..util.overload import CircuitBreaker

            cfg = self._cfg
            key_str = str(key)

            def on_transition(state, _key=key_str):
                from . import _telemetry

                _telemetry.record_breaker_state(
                    self.deployment_name, self.handle_id, _key, state
                )

            br = CircuitBreaker(
                error_threshold=cfg.serve_breaker_error_threshold,
                min_volume=cfg.serve_breaker_min_volume,
                open_base_s=cfg.serve_breaker_open_s,
                latency_trip_s=0.0,
                on_transition=on_transition,
            )
            self.breakers[key] = br
        return br

    def _drop_breaker(self, key) -> None:
        """Remove a replica's breaker (caller holds ``self.lock``),
        zeroing its gauge series — an ejected replica must not read as
        permanently open."""
        br = self.breakers.pop(key, None)
        if br is not None and br.state != "closed":
            from . import _telemetry

            _telemetry.record_breaker_state(
                self.deployment_name, self.handle_id, str(key), "closed"
            )

    def record_result(self, replica, ok: bool,
                      latency_s: Optional[float] = None) -> None:
        """Feed one request outcome into the replica's breaker."""
        with self.lock:
            br = self._breaker(_replica_key(replica))
        br.record(ok, latency_s)

    def breaker_states(self) -> Dict[str, str]:
        """Non-closed breakers, keyed by replica actor id (reported to the
        controller by the refresh loop for persistent-unhealth
        ejection)."""
        with self.lock:
            out = {}
            for k, br in self.breakers.items():
                if br.state != "closed":
                    out[str(k)] = br.state
            return out

    def pick(self, model_id: Optional[str] = None):
        """Power of two choices on local outstanding counts; multiplexed
        requests prefer replicas that already hold their model (cache
        affinity) but SPILL onto additional replicas when those are
        saturated — affinity must not defeat load balancing (ref:
        model-multiplex-aware request routing). Replicas with an OPEN
        circuit breaker are not routable; when every breaker is open,
        one due half-open probe may go through, otherwise the request
        fails fast with ``OverloadedError`` (shed, not queued)."""
        from ..core.exceptions import OverloadedError

        with self.lock:
            all_reps = self.replicas
            if not all_reps:
                raise RuntimeError(
                    f"deployment {self.deployment_name!r} has no replicas"
                )
            reps = []
            probe = None
            for r in all_reps:
                br = self._breaker(_replica_key(r))
                if br.allow():
                    reps.append(r)
                elif probe is None and br.probe_due():
                    probe = (r, br)
            if probe is not None:
                # A due half-open probe takes priority over normal
                # routing: exactly one live request goes to the sick
                # replica so a healed one can rejoin — even while
                # healthy replicas are absorbing the traffic.
                probe[1].begin_probe()
                return probe[0]
            if not reps:
                # Every breaker open and no probe due yet: shed fast
                # instead of hammering sick replicas.
                raise OverloadedError(
                    f"deployment {self.deployment_name!r}: all "
                    f"{len(all_reps)} replica circuit breaker(s) open",
                    retry_after_s=self._cfg.serve_breaker_open_s,
                )

            def depth(r):
                return self.outstanding.get(_replica_key(r), 0)

            def p2c(cands):
                if len(cands) == 1:
                    return cands[0]
                a, b = random.sample(range(len(cands)), 2)
                return (cands[a] if depth(cands[a]) <= depth(cands[b])
                        else cands[b])

            if not model_id:
                return p2c(reps)
            live_keys = {_replica_key(r) for r in reps}
            holders = self.model_affinity.setdefault(model_id, [])
            holders[:] = [k for k in holders if k in live_keys]
            holding = [r for r in reps if _replica_key(r) in holders]
            min_depth = min((depth(r) for r in reps), default=0)
            if holding and (
                min(depth(r) for r in holding)
                <= min_depth + self.AFFINITY_SPILL_DEPTH
            ):
                return p2c(holding)
            # Saturated (or no holder yet): spread onto a new replica.
            chosen = p2c(reps)
            k = _replica_key(chosen)
            if k not in holders:
                holders.append(k)
            if len(self.model_affinity) > self.MAX_TRACKED_MODELS:
                self.model_affinity.pop(
                    next(iter(self.model_affinity))
                )
            return chosen

    def begin(self, replica) -> None:
        with self.lock:
            k = _replica_key(replica)
            self.outstanding[k] = self.outstanding.get(k, 0) + 1

    def end(self, replica) -> None:
        with self.lock:
            k = _replica_key(replica)
            n = self.outstanding.get(k, 0) - 1
            if n <= 0:
                self.outstanding.pop(k, None)
            else:
                self.outstanding[k] = n

    def evict(self, replica) -> None:
        """Drop a replica observed dead so retries don't re-pick it."""
        k = _replica_key(replica)
        with self.lock:
            self.dead[k] = time.monotonic()
            self._drop_breaker(k)
            self.replicas = [
                r for r in self.replicas if _replica_key(r) != k
            ]

    def apply_snapshot(self, snap: Dict[str, Any]) -> None:
        now = time.monotonic()
        with self.lock:
            for k, ts in list(self.dead.items()):
                if now - ts > DEAD_REPLICA_TTL_S:
                    del self.dead[k]
            self.route_version = snap["version"]
            self.replicas = [
                r for r in snap["replicas"]
                if _replica_key(r) not in self.dead
            ]
            # Breakers follow the replica set: entries for replicas no
            # longer routable are dropped (a retired replica must not
            # pin breaker state against a reused key), zeroing their
            # gauge series on the way out.
            live = {_replica_key(r) for r in self.replicas}
            for k in list(self.breakers):
                if k not in live:
                    self._drop_breaker(k)

    def force_refresh(self) -> None:
        """Synchronous route refresh after observing a dead replica."""
        if self.controller is None:
            return
        try:
            snap = rt.get(
                self.controller.get_routing.remote(self.deployment_name),
                timeout=5.0,
            )
            self.apply_snapshot(snap)
        except Exception:
            pass


def _refresh_loop(state_ref: "weakref.ref[_RouterState]") -> None:
    """Long-poll the controller for route changes and push metrics.

    Holds only a weakref: when the last handle sharing the state is
    garbage-collected, the loop exits — no immortal poller threads.
    """
    while True:
        state = state_ref()
        if state is None or state.closed:
            return
        try:
            with state.lock:
                outstanding = dict(state.outstanding)
                known = state.route_version
            total = sum(outstanding.values())
            controller = state.controller
            name = state.deployment_name
            handle_id = state.handle_id
            # Gauges publish from HERE (~2Hz), not the per-request
            # begin/end hot path: in-flight/queue-depth need freshness,
            # not per-event registry traffic under the router lock.
            from . import _telemetry

            _telemetry.update_router_gauges(name, handle_id, outstanding)
            controller.record_handle_metrics.remote(name, handle_id, total)
            # Breaker telemetry rides the same ~2Hz cadence: the
            # controller ejects replicas whose breakers stay open
            # (persistently unhealthy) through the drain machinery.
            open_breakers = state.breaker_states()
            if open_breakers:
                controller.report_breakers.remote(
                    name, handle_id, open_breakers
                )
            ref = controller.listen_for_route_change.remote(name, known, 0.5)
            del state  # don't pin the state across the blocking poll
            snap = rt.get(ref, timeout=10.0)
            state = state_ref()
            if state is None or state.closed:
                return
            if snap["version"] < 0:
                # Deployment deleted: back off instead of spinning on the
                # controller's immediate not-found replies (it may come
                # back on a future serve.run with the same name).
                del state
                time.sleep(0.5)
                continue
            if snap["version"] != known:
                state.apply_snapshot(snap)
            del state
        except Exception:
            time.sleep(0.2)


def _retry_backoff():
    """Jittered backoff between replica-evict/shed retries (satellite of
    the overload plane: the old loop retried immediately, unboundedly)."""
    from ..util.backoff import Backoff

    return Backoff(base=0.02, factor=2.0, max_delay=0.5, jitter=0.5)


def _pick_with_refresh(state: _RouterState, model_id, attempt: int,
                       bo=None):
    """Shared pick step: on an empty replica set (stale snapshot /
    just-created handle) force-refresh and signal retry by returning
    None; raises only once retries are exhausted."""
    try:
        return state.pick(model_id)
    except RuntimeError:
        if attempt < MAX_DEATH_RETRIES:
            state.force_refresh()
            if bo is not None:
                bo.sleep()
            else:
                time.sleep(0.05 * (attempt + 1))
            return None
        raise


def _spend_retry(state: _RouterState, deadline_ts: float) -> bool:
    """Gate one retry: never past the request's deadline, never beyond
    the handle's retry budget (retry amplification cap)."""
    from . import _telemetry

    if deadline_ts and time.time() >= deadline_ts:
        return False
    if not state.retry_budget.try_spend():
        _telemetry.observe_shed(state.deployment_name, "retry_budget")
        return False
    _telemetry.observe_retry(state.deployment_name)
    return True


def _route_with_retry(state: _RouterState, submit, deliver, deliver_error,
                      model_id: Optional[str] = None):
    """Shared request path: pick a replica (p2c + model affinity, open
    breakers excluded), submit, deliver the result. Recovery ladder:
    actor death -> evict + refresh + retry elsewhere; replica shed /
    transport fault -> breaker-recorded failure + retry elsewhere
    (jittered backoff, retry-budget capped); deadline expiry -> fail
    fast, no retry (the budget is spent). Every outcome feeds the
    picked replica's circuit breaker."""
    from ..core.exceptions import (
        ActorDiedError,
        DeadlineExceededError,
        GetTimeoutError,
        OverloadedError,
        WorkerCrashedError,
    )

    from ..util import overload
    from . import _telemetry

    state.retry_budget.record_request()
    deadline_ts = overload.ambient_deadline()
    bo = _retry_backoff()
    last_err: Optional[BaseException] = None
    attempt = 0
    # Only attempts that actually SUBMITTED to a replica charge the
    # retry budget — an empty-set snapshot refresh is not a retry, and
    # cold handles must not fail for lack of tokens.
    needs_budget = False
    while attempt <= MAX_DEATH_RETRIES:
        if needs_budget and not _spend_retry(state, deadline_ts):
            break  # budget/deadline exhausted: surface the last error
        try:
            replica = _pick_with_refresh(state, model_id, attempt, bo)
        except (RuntimeError, OverloadedError) as e:
            if isinstance(e, OverloadedError):
                _telemetry.observe_shed(state.deployment_name, "router")
            deliver_error(last_err or e)
            return
        if replica is None:
            attempt += 1
            continue  # refreshed after an empty set; try again
        state.begin(replica)
        t0 = time.monotonic()
        try:
            timeout = None
            if deadline_ts:
                # Bound the wait by the remaining budget plus a grace
                # second for the replica's own refusal to arrive.
                timeout = max(0.0, deadline_ts - time.time()) + 1.0
            deliver(rt.get(submit(replica), timeout=timeout))
            state.record_result(replica, True, time.monotonic() - t0)
            return
        except (ActorDiedError, WorkerCrashedError) as e:
            # Replica retired/crashed under us (rolling update, node
            # loss): evict it locally, refresh, retry elsewhere.
            last_err = e
            state.record_result(replica, False)
            state.evict(replica)
            state.force_refresh()
            bo.sleep()
        except OverloadedError as e:
            # Replica shed us (adaptive concurrency limit): a less
            # loaded replica may still have room.
            last_err = e
            state.record_result(replica, False, time.monotonic() - t0)
            bo.sleep()
        except DeadlineExceededError as e:
            # Refused or cancelled replica-side: the budget is spent,
            # retrying cannot meet it. The failure still counts against
            # the replica — a healthy one would have answered in time.
            state.record_result(replica, False, time.monotonic() - t0)
            _telemetry.observe_deadline_exceeded(
                state.deployment_name, "replica"
            )
            deliver_error(e)
            return
        except GetTimeoutError:
            state.record_result(replica, False, time.monotonic() - t0)
            _telemetry.observe_deadline_exceeded(
                state.deployment_name, "caller"
            )
            deliver_error(DeadlineExceededError(
                f"deployment {state.deployment_name!r}: request "
                f"deadline expired waiting for a replica reply"
            ))
            return
        except ConnectionError as e:
            # Transport fault (incl. injected chaos) with the actor
            # alive: count against the breaker, retry elsewhere.
            last_err = e
            state.record_result(replica, False, time.monotonic() - t0)
            bo.sleep()
        except BaseException as e:  # noqa: BLE001
            # Application errors (user exceptions, TaskError wrappers)
            # mean the replica did its job — success against the
            # breaker. Remaining FRAMEWORK faults (ObjectLostError,
            # ActorUnavailableError, ...) count as failures, same
            # classification as the streaming path.
            from ..core.exceptions import RayTpuError, TaskError

            app_error = isinstance(e, TaskError) or not isinstance(
                e, (RayTpuError, ConnectionError, TimeoutError)
            )
            state.record_result(replica, app_error,
                                time.monotonic() - t0)
            deliver_error(e)
            return
        finally:
            state.end(replica)
        # Fall-through = a retryable failure after a real submit: the
        # next attempt is a genuine retry and must spend budget.
        needs_budget = True
        attempt += 1
    deliver_error(last_err or RuntimeError(
        f"deployment {state.deployment_name!r}: retries exhausted"
    ))


class _PendingBatch:
    def __init__(self):
        # [(payload, future, caller trace span | None, deadline_ts), ...]
        self.items: List[Tuple[Any, "ServeFuture", Any, float]] = []
        self.created = time.monotonic()


class ServeFuture:
    """Resolves to the result of a routed request."""

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self._ref = None

    def _set_ref(self, ref):
        self._ref = ref
        self._event.set()

    def _set_value(self, value):
        self._value = value
        self._event.set()

    def _set_error(self, err):
        self._error = err
        self._event.set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("serve request timed out")
        if self._error is not None:
            raise self._error
        if self._ref is not None:
            return rt.get(self._ref, timeout=timeout)
        return self._value


class DeploymentHandle:
    def __init__(self, deployment_name: str, replicas: List[Any],
                 *, batch_config: Optional[Dict[str, Any]] = None,
                 method: str = "__call__", controller=None,
                 route_version: int = 0, _state: Optional[_RouterState] = None,
                 multiplexed_model_id: str = ""):
        self.deployment_name = deployment_name
        self._state = _state or _RouterState(
            deployment_name, replicas, controller, route_version
        )
        self._method = method
        self._model_id = multiplexed_model_id
        self._batch = batch_config
        self._batch_lock = threading.Lock()
        self._pending: Optional[_PendingBatch] = None

    def close(self):
        self._state.closed = True

    # ---- request path ------------------------------------------------------

    def options(self, method: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None
                ) -> "DeploymentHandle":
        """Clone bound to another method / multiplexed model id; shares
        routing + queue-depth state with the parent (one long-poller per
        handle family)."""
        return DeploymentHandle(
            self.deployment_name, [],
            batch_config=self._batch, method=method or self._method,
            _state=self._state,
            multiplexed_model_id=(self._model_id
                                  if multiplexed_model_id is None
                                  else multiplexed_model_id),
        )

    def _request_deadline(self) -> float:
        """The request's absolute deadline: the caller's ambient budget
        when one is installed (ingress-set, or a nested call inside a
        deadlined request), else the configured serve default — every
        serve request carries a budget."""
        from ..util import overload

        dl = overload.ambient_deadline()
        if dl:
            return dl
        return time.time() + self._state._cfg.serve_default_request_timeout_s

    def remote(self, *args, **kwargs) -> ServeFuture:
        if self._batch:
            return self._remote_batched(args, kwargs)
        from ..util.timeline import current_span

        fut = ServeFuture()
        # The submit happens on a router thread: capture the CALLER's
        # span AND deadline here, so the router's span events join the
        # caller's trace and the replica call carries the request's
        # remaining budget.
        threading.Thread(
            target=self._run_with_retry,
            args=(fut, self._method, args, kwargs, current_span(),
                  self._request_deadline()),
            daemon=True,
        ).start()
        return fut

    def _run_with_retry(self, fut: ServeFuture, method, args, kwargs,
                        span=None, deadline_ts: float = 0.0):
        from ..util.timeline import enter_span, exit_span
        from ..util import overload

        model_id = self._model_id
        prev = enter_span(*span) if span else None
        prev_dl = overload.set_ambient_deadline(deadline_ts)
        try:
            _route_with_retry(
                self._state,
                lambda replica: replica.handle_request.remote(
                    method, args, kwargs, model_id, time.time()
                ),
                fut._set_value,
                fut._set_error,
                model_id=model_id or None,
            )
        finally:
            overload.set_ambient_deadline(prev_dl)
            if span:
                exit_span(prev)

    def stream(self, *args, **kwargs):
        """Streaming request: yields response items as the replica
        produces them (ref analogue: handle.options(stream=True) over the
        replica's generator path + RESPONSE_STREAMING in proxy.py:1097).
        Routing (p2c, model affinity, dead-replica retry) happens on the
        first item; once a replica has started yielding, a mid-stream
        death surfaces to the caller rather than silently replaying
        side effects."""
        from ..core.exceptions import OverloadedError

        from ..util import overload

        model_id = self._model_id
        state = self._state
        # The generator body runs on the CONSUMER's thread (the proxy's
        # SSE handler), where the ingress installed the request's
        # deadline; fall back to the serve default budget.
        deadline_ts = self._request_deadline()
        state.retry_budget.record_request()
        bo = _retry_backoff()
        last_err = None
        attempt = 0
        # Mirror of _route_with_retry: only post-submit retries charge
        # the budget; empty-set refreshes are free.
        needs_budget = False
        while attempt <= MAX_DEATH_RETRIES:
            if needs_budget and not _spend_retry(state, deadline_ts):
                break
            try:
                replica = _pick_with_refresh(
                    state, model_id or None, attempt, bo
                )
            except (RuntimeError, OverloadedError) as e:
                if isinstance(e, OverloadedError):
                    from . import _telemetry

                    _telemetry.observe_shed(
                        state.deployment_name, "router"
                    )
                raise (last_err or e)
            if replica is None:
                attempt += 1
                continue  # refreshed after an empty set; try again
            state.begin(replica)
            started = False
            t0 = time.monotonic()
            try:
                with overload.deadline_scope(deadline_ts):
                    gen = replica.handle_request_streaming.options(
                        num_returns="streaming"
                    ).remote(self._method, args, kwargs, model_id,
                             time.time())
                # Per-item production deadline: a wedged replica
                # generator surfaces a timeout instead of pinning the
                # consumer (e.g. a proxy SSE thread) forever — bounded
                # further by the request's remaining budget.
                gen.item_timeout_s = STREAM_ITEM_TIMEOUT_S
                for ref in gen:
                    item_timeout = STREAM_ITEM_TIMEOUT_S
                    if deadline_ts:
                        item_timeout = min(
                            item_timeout,
                            max(0.0, deadline_ts - time.time()) + 1.0,
                        )
                    value = rt.get(ref, timeout=item_timeout)
                    started = True
                    yield value
                state.record_result(replica, True,
                                    time.monotonic() - t0)
                return
            except Exception as e:  # noqa: BLE001
                from ..core.exceptions import (
                    ActorDiedError,
                    OverloadedError,
                    WorkerCrashedError,
                )

                if isinstance(e, (ActorDiedError, WorkerCrashedError)) \
                        and not started:
                    last_err = e
                    state.record_result(replica, False)
                    state.evict(replica)
                    state.force_refresh()
                    bo.sleep()
                    needs_budget = True
                    attempt += 1
                    continue
                if isinstance(e, OverloadedError) and not started:
                    # Replica shed us before producing anything: a less
                    # loaded replica may still have room (mirror of the
                    # non-streaming retry ladder).
                    last_err = e
                    state.record_result(replica, False,
                                        time.monotonic() - t0)
                    bo.sleep()
                    needs_budget = True
                    attempt += 1
                    continue
                # Infra faults count against the breaker; application
                # errors mid-stream do not (the replica did its job).
                infra = isinstance(
                    e, (ActorDiedError, WorkerCrashedError,
                        OverloadedError, ConnectionError, TimeoutError)
                )
                state.record_result(replica, not infra,
                                    time.monotonic() - t0)
                raise
            finally:
                state.end(replica)
        raise last_err if last_err is not None else RuntimeError(
            f"deployment {state.deployment_name!r}: streaming retries "
            f"exhausted"
        )

    # ---- dynamic batching --------------------------------------------------

    def _remote_batched(self, args, kwargs) -> ServeFuture:
        from ..util.timeline import current_span

        fut = ServeFuture()
        flush: Optional[_PendingBatch] = None
        with self._batch_lock:
            if self._pending is None:
                self._pending = _PendingBatch()
                self._start_flusher()
            self._pending.items.append(
                ((args, kwargs), fut, current_span(),
                 self._request_deadline())
            )
            if len(self._pending.items) >= self._batch["max_batch_size"]:
                flush = self._pending
                self._pending = None
        if flush is not None:
            self._flush(flush)
        return fut

    def _start_flusher(self):
        wait_s = self._batch["batch_wait_timeout_s"]

        def run():
            time.sleep(wait_s)
            with self._batch_lock:
                flush, self._pending = self._pending, None
            if flush is not None:
                self._flush(flush)

        threading.Thread(target=run, daemon=True).start()

    def _flush(self, batch: _PendingBatch):
        from ..util.timeline import enter_span, exit_span
        from ..util import overload

        payload = [item for item, _fut, _span, _dl in batch.items]
        model_id = self._model_id
        # A flush carries many callers' requests in one replica call;
        # its router thread runs under the first item's span (the others
        # still share its trace through the ingress-side spans). The
        # batch executes under the LOOSEST item deadline: one expired
        # straggler must not get the whole batch refused (items were
        # admitted within batch_wait_timeout_s of each other, so the
        # spread is small).
        span = next((s for _, _, s, _dl in batch.items if s), None)
        deadline_ts = max((dl for _, _, _s, dl in batch.items), default=0.0)

        def deliver(results):
            for (_, fut, _s, _dl), value in zip(batch.items, results):
                fut._set_value(value)

        def deliver_error(err):
            for _, fut, _s, _dl in batch.items:
                fut._set_error(err)

        def run():
            prev = enter_span(*span) if span else None
            prev_dl = overload.set_ambient_deadline(deadline_ts)
            try:
                _route_with_retry(
                    self._state,
                    lambda replica: replica.handle_batch.remote(
                        self._method, payload, model_id, time.time()
                    ),
                    deliver,
                    deliver_error,
                    model_id=model_id or None,
                )
            finally:
                overload.set_ambient_deadline(prev_dl)
                if span:
                    exit_span(prev)

        threading.Thread(target=run, daemon=True).start()

    # ---- introspection -----------------------------------------------------

    def num_replicas(self) -> int:
        with self._state.lock:
            return len(self._state.replicas)

    def queue_depths(self) -> Dict[Any, int]:
        with self._state.lock:
            return dict(self._state.outstanding)
