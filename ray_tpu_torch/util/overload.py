"""Overload-control primitives: deadlines, adaptive concurrency limits,
circuit breakers and retry budgets (counterpart of
``ray_tpu/util/overload.py``, step for step the same).

Ref analogues: the reference serve stack's end-to-end request timeouts
(``request_timeout_s`` propagated proxy -> router -> replica), its
queue-length-based proxy admission, and the SRE-canon overload patterns
the serve layer composes them with — AIMD concurrency limiting fed by
observed latency (Netflix concurrency-limits), per-endpoint circuit
breaking with half-open probes (envoy outlier detection) and token-bucket
retry budgets capping retry amplification (finagle's RetryBudget).

One module owns the mechanisms; policy (which knob feeds which limiter)
lives with the callers:

- **Deadline propagation** — an ambient per-thread absolute deadline
  (``time.time()`` based so it survives process hops). Ingresses install
  it, ``core/actor.py``/``core/remote_function.py`` stamp it onto every
  submission made under it, and ``core/worker_main.py`` re-installs it
  around user code on the executing worker — so a nested call three
  deployments deep still carries the original request's remaining
  budget, and an expired request is REFUSED before it ever occupies a
  worker thread (or the card).
- :class:`AIMDLimiter` + :class:`AdmissionGate` — adaptive concurrency
  with a bounded wait queue behind it; excess sheds *before* queueing.
- :class:`CircuitBreaker` — rolling error/latency window per endpoint,
  jittered-exponential half-open probe schedule via
  :class:`~ray_tpu_torch.util.backoff.Backoff`.
- :class:`RetryBudget` — retries spend tokens deposited by requests, so
  a dying backend sees load shrink instead of multiply.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional

from ..core.exceptions import DeadlineExceededError, OverloadedError
from .backoff import Backoff

# --------------------------------------------------------------- deadlines

_tls = threading.local()


def ambient_deadline() -> float:
    """The absolute wall-clock deadline (``time.time()`` seconds)
    governing the current thread's work; ``0.0`` = none."""
    return getattr(_tls, "deadline_ts", 0.0)


def set_ambient_deadline(deadline_ts: float) -> float:
    """Install ``deadline_ts`` as this thread's deadline (0 clears);
    returns the previous value so callers can restore it."""
    prev = getattr(_tls, "deadline_ts", 0.0)
    _tls.deadline_ts = float(deadline_ts or 0.0)
    return prev


class deadline_scope:
    """``with deadline_scope(ts):`` — install/restore idiom for the
    ambient deadline (0 clears for the scope's duration)."""

    def __init__(self, deadline_ts: float):
        self._ts = float(deadline_ts or 0.0)
        self._prev = 0.0

    def __enter__(self):
        self._prev = set_ambient_deadline(self._ts)
        return self

    def __exit__(self, *exc):
        set_ambient_deadline(self._prev)
        return False


def remaining(default: Optional[float] = None) -> Optional[float]:
    """Seconds left in the ambient budget (clamped at 0), or ``default``
    when no deadline is installed. The drop-in replacement for the
    hard-coded ``timeout=`` constants the serve layer used to carry."""
    dl = ambient_deadline()
    if not dl:
        return default
    return max(0.0, dl - time.time())


def check_deadline(what: str = "") -> None:
    """Cooperative cancellation point: raise
    :class:`DeadlineExceededError` if the ambient budget is spent.
    Replicas call it before execution (refuse expired queued work) and
    long-running user code may call it mid-computation."""
    dl = ambient_deadline()
    if dl and time.time() >= dl:
        raise DeadlineExceededError(
            f"deadline exceeded{f' in {what}' if what else ''} "
            f"(budget expired {time.time() - dl:.3f}s ago)"
        )


# ------------------------------------------------- adaptive concurrency

class AIMDLimiter:
    """Additive-increase / multiplicative-decrease concurrency limit fed
    by observed latency DEGRADATION. A completion is an overload signal
    when it is slower than ``max(latency_target_s, degradation_ratio *
    rolling baseline)`` — the baseline tracks the service's own natural
    latency (fast downward, slow upward, so sustained queueing cannot
    inflate it), which keeps a slow-but-healthy service (a 3s model
    forward pass) growing its limit while genuine queueing (latency
    inflating vs its own baseline) still shrinks it. Overload
    multiplies the limit by ``decrease_ratio`` (debounced to once per
    ``decrease_interval_s`` so one burst of in-flight stragglers costs
    one step, not a collapse); other completions grow it by
    ``increase/limit`` (one full step per limit-worth)."""

    def __init__(self, *, initial: int = 32, min_limit: int = 1,
                 max_limit: int = 1024, latency_target_s: float = 2.0,
                 increase: float = 1.0, decrease_ratio: float = 0.7,
                 decrease_interval_s: float = 0.1,
                 degradation_ratio: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self._min = max(1, int(min_limit))
        self._max = max(self._min, int(max_limit))
        self._limit = float(min(max(int(initial), self._min), self._max))
        self._target = float(latency_target_s)
        self._increase = float(increase)
        self._ratio = min(1.0, max(0.1, float(decrease_ratio)))
        self._interval = float(decrease_interval_s)
        self._degradation = max(1.0, float(degradation_ratio))
        self._clock = clock
        self._lock = threading.Lock()
        self._inflight = 0
        self._last_decrease = 0.0
        self._ewma = 0.0
        self._baseline = 0.0
        self.sheds = 0

    @property
    def limit(self) -> int:
        return int(self._limit)

    @property
    def inflight(self) -> int:
        return self._inflight

    @property
    def ewma_latency_s(self) -> float:
        return self._ewma

    def try_acquire(self) -> bool:
        with self._lock:
            if self._inflight < int(self._limit):
                self._inflight += 1
                return True
            self.sheds += 1
            return False

    def _decrease(self, now: float) -> None:
        if now - self._last_decrease >= self._interval:
            self._limit = max(float(self._min), self._limit * self._ratio)
            self._last_decrease = now

    def on_reject(self) -> None:
        """Downstream pushed back (queue full, replica shed): treat as
        an overload signal even though nothing completed."""
        with self._lock:
            self._decrease(self._clock())

    def release(self, latency_s: Optional[float] = None,
                overloaded: bool = False) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
            degraded = False
            if latency_s is not None:
                self._ewma = (latency_s if self._ewma == 0.0
                              else 0.8 * self._ewma + 0.2 * latency_s)
                # Baseline follows improvements quickly and degradation
                # slowly: a queueing episode cannot talk its way into
                # the baseline before the limiter reacts to it.
                if self._baseline == 0.0:
                    self._baseline = latency_s
                elif latency_s < self._baseline:
                    self._baseline += 0.2 * (latency_s - self._baseline)
                else:
                    self._baseline += 0.02 * (latency_s - self._baseline)
                degraded = latency_s > max(
                    self._target, self._degradation * self._baseline
                )
            if overloaded or degraded:
                self._decrease(self._clock())
            elif latency_s is not None:
                self._limit = min(
                    float(self._max),
                    self._limit + self._increase / max(1.0, self._limit),
                )


class AdmissionGate:
    """An :class:`AIMDLimiter` with a BOUNDED wait queue behind it.

    ``acquire`` admits immediately while the limiter has room; past the
    limit the caller queues — but only up to ``max_queue`` waiters, and
    a queued request is EVICTED by age the moment its deadline passes
    (or after ``max_wait_s``). Everything beyond sheds instantly with
    :class:`OverloadedError` carrying a ``retry_after_s`` hint — the
    proxy turns that into ``503 + Retry-After`` *before* any work
    queues, which is what keeps an overloaded ingress at a bounded p99
    instead of melting."""

    def __init__(self, limiter: AIMDLimiter, *, max_queue: int = 64,
                 max_wait_s: float = 10.0,
                 default_retry_after_s: float = 1.0):
        self.limiter = limiter
        self._max_queue = max(0, int(max_queue))
        self._max_wait = float(max_wait_s)
        self._default_retry = float(default_retry_after_s)
        self._cv = threading.Condition()
        self._waiting = 0
        self.shed_full = 0
        self.shed_expired = 0

    @property
    def queued(self) -> int:
        return self._waiting

    def retry_after_s(self) -> float:
        ewma = self.limiter.ewma_latency_s
        return max(0.1, min(30.0, 2.0 * ewma)) if ewma else \
            self._default_retry

    def acquire(self, deadline_ts: float = 0.0) -> None:
        if self.limiter.try_acquire():
            return
        with self._cv:
            if self._waiting >= self._max_queue:
                self.shed_full += 1
                self.limiter.on_reject()
                raise OverloadedError(
                    f"admission queue full ({self._waiting} waiting, "
                    f"limit {self.limiter.limit})",
                    retry_after_s=self.retry_after_s(),
                )
            self._waiting += 1
        try:
            started = time.monotonic()
            while True:
                if self.limiter.try_acquire():
                    return
                now = time.time()
                if deadline_ts and now >= deadline_ts:
                    self.shed_expired += 1
                    raise OverloadedError(
                        "shed from admission queue: request deadline "
                        "expired before a slot freed",
                        retry_after_s=self.retry_after_s(),
                    )
                if time.monotonic() - started >= self._max_wait:
                    self.shed_expired += 1
                    raise OverloadedError(
                        f"shed from admission queue after "
                        f"{self._max_wait:.1f}s",
                        retry_after_s=self.retry_after_s(),
                    )
                with self._cv:
                    self._cv.wait(0.02)
        finally:
            with self._cv:
                self._waiting -= 1

    def release(self, latency_s: Optional[float] = None,
                overloaded: bool = False) -> None:
        self.limiter.release(latency_s, overloaded=overloaded)
        with self._cv:
            self._cv.notify()


def gate_from_config(cfg) -> "AdmissionGate":
    """The ingress admission gate (HTTP proxy + gRPC share this): AIMD
    concurrency limit fed by observed end-to-end latency, bounded wait
    queue with age-based eviction behind it. Excess sheds with
    retry-after BEFORE any work queues."""
    return AdmissionGate(
        AIMDLimiter(
            initial=cfg.serve_proxy_concurrency,
            min_limit=1,
            max_limit=cfg.serve_proxy_concurrency,
            latency_target_s=cfg.serve_aimd_latency_target_s,
        ),
        max_queue=cfg.serve_shed_queue_len,
    )


class GateRegistry:
    """Per-key admission gates constructed on first use (the HTTP and
    gRPC ingresses keep one per deployment)."""

    def __init__(self, factory: Callable[[str], AdmissionGate]):
        self._factory = factory
        self._gates: Dict[str, AdmissionGate] = {}
        self._lock = threading.Lock()

    def get(self, name: str) -> AdmissionGate:
        with self._lock:
            gate = self._gates.get(name)
            if gate is None:
                gate = self._factory(name)
                self._gates[name] = gate
            return gate

    def snapshot(self) -> Dict[str, AdmissionGate]:
        with self._lock:
            return dict(self._gates)

    def clear(self) -> None:
        with self._lock:
            self._gates.clear()


# --------------------------------------------------------- circuit breaker

BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

# Numeric encoding for the breaker-state gauge.
BREAKER_STATE_VALUES = {
    BREAKER_CLOSED: 0.0, BREAKER_HALF_OPEN: 1.0, BREAKER_OPEN: 2.0,
}


class CircuitBreaker:
    """Per-endpoint breaker over a rolling error/latency window.

    CLOSED: outcomes accumulate in a ``window_s`` deque; once at least
    ``min_volume`` outcomes show an error rate >= ``error_threshold``
    (completions slower than ``latency_trip_s``, when set, count as
    errors) the breaker OPENS. OPEN: ``probe_due`` turns true after a
    jittered-exponential delay (:class:`Backoff`, so a flapping endpoint
    gets probed less and less often); the router then claims ONE
    half-open probe with ``begin_probe``. HALF_OPEN: the probe's
    ``record`` closes (success, backoff resets) or re-opens (failure,
    next probe further out). A probe lost for ``probe_timeout_s``
    (caller died) becomes claimable again."""

    def __init__(self, *, error_threshold: float = 0.5,
                 min_volume: int = 5, window_s: float = 10.0,
                 open_base_s: float = 1.0, open_max_s: float = 30.0,
                 probe_timeout_s: float = 15.0,
                 latency_trip_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic,
                 seed: Optional[int] = None,
                 on_transition: Optional[Callable[[str], None]] = None):
        self._threshold = min(1.0, max(0.0, float(error_threshold)))
        self._min_volume = max(1, int(min_volume))
        self._window = float(window_s)
        self._latency_trip = float(latency_trip_s)
        self._probe_timeout = float(probe_timeout_s)
        self._bo = Backoff(base=open_base_s, factor=2.0,
                           max_delay=open_max_s, jitter=0.25, seed=seed)
        self._clock = clock
        self._lock = threading.Lock()
        self._events: deque = deque()  # (ts, ok)
        self._state = BREAKER_CLOSED
        self._next_probe_at = 0.0
        self._probe_started = 0.0
        self._on_transition = on_transition
        self.opens = 0

    @property
    def state(self) -> str:
        return self._state

    def allow(self) -> bool:
        """True iff the endpoint is routable without claiming a probe."""
        return self._state == BREAKER_CLOSED

    def probe_due(self) -> bool:
        with self._lock:
            now = self._clock()
            if self._state == BREAKER_OPEN:
                return now >= self._next_probe_at
            if self._state == BREAKER_HALF_OPEN:
                # The claimed probe never reported back: reclaimable.
                return now - self._probe_started >= self._probe_timeout
            return False

    def begin_probe(self) -> None:
        """Claim the single half-open probe slot (router sends exactly
        one request to the sick endpoint)."""
        with self._lock:
            self._state = BREAKER_HALF_OPEN
            self._probe_started = self._clock()
        self._notify(BREAKER_HALF_OPEN)

    def record(self, ok: bool, latency_s: Optional[float] = None) -> None:
        transition = None
        with self._lock:
            now = self._clock()
            if self._latency_trip > 0 and ok and latency_s is not None \
                    and latency_s > self._latency_trip:
                ok = False  # too slow counts against the endpoint
            if self._state == BREAKER_HALF_OPEN:
                if ok:
                    self._state = BREAKER_CLOSED
                    self._events.clear()
                    self._bo.reset()
                    transition = BREAKER_CLOSED
                else:
                    self._state = BREAKER_OPEN
                    self._next_probe_at = now + self._bo.next_delay()
                    transition = BREAKER_OPEN
            elif self._state == BREAKER_CLOSED:
                self._events.append((now, ok))
                while self._events and \
                        now - self._events[0][0] > self._window:
                    self._events.popleft()
                volume = len(self._events)
                errors = sum(1 for _, e_ok in self._events if not e_ok)
                if volume >= self._min_volume and \
                        errors / volume >= self._threshold:
                    self._state = BREAKER_OPEN
                    self.opens += 1
                    self._next_probe_at = now + self._bo.next_delay()
                    transition = BREAKER_OPEN
            # OPEN: a straggler completion from before the open; ignore.
        if transition is not None:
            self._notify(transition)

    def _notify(self, state: str) -> None:
        if self._on_transition is not None:
            try:
                self._on_transition(state)
            except Exception:
                pass  # breaker correctness never depends on observers


# ------------------------------------------------------------ retry budget

class RetryBudget:
    """Token-bucket retry budget: each first-try request deposits
    ``ratio`` tokens, each retry withdraws one — cluster-wide retry
    volume stays <= ``ratio`` of request volume (plus the ``reserve``
    float that keeps low-traffic retries alive), so retries cannot
    amplify an outage."""

    def __init__(self, *, ratio: float = 0.2, reserve: float = 3.0,
                 cap: float = 100.0):
        self._ratio = max(0.0, float(ratio))
        self._cap = max(1.0, float(cap))
        self._tokens = min(self._cap, max(0.0, float(reserve)))
        self._lock = threading.Lock()

    @property
    def tokens(self) -> float:
        return self._tokens

    def record_request(self) -> None:
        with self._lock:
            self._tokens = min(self._cap, self._tokens + self._ratio)

    def try_spend(self, cost: float = 1.0) -> bool:
        with self._lock:
            if self._tokens >= cost:
                self._tokens -= cost
                return True
            return False
