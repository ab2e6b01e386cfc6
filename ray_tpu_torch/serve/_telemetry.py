"""Serve data-path metrics (shared singletons; counterpart of
``ray_tpu/serve/_telemetry.py`` with its names, tags and buckets).

Ref analogue: serve/_private/metrics_utils.py + the request metrics the
reference's proxy/replica record (ray_serve_*_request_latency_ms etc.).
One module owns the metric objects so the proxy, handle and replica all
record into the SAME series through ``util/metrics.py``, and
``util/prometheus.render()`` exposes them unchanged. The port's registry
is process-local: the proxy's and the handles' series live in the
driver, a replica's in its worker process.

- ``ray_tpu_serve_request_latency_seconds{deployment,protocol}``
  end-to-end latency observed at the ingress (HTTP);
- ``ray_tpu_serve_requests_total{deployment,protocol,code}``
  status/error accounting at the ingress;
- ``ray_tpu_serve_ongoing_requests{deployment}`` /
  ``ray_tpu_serve_queue_depth{deployment}`` router-side in-flight total
  and deepest per-replica queue (the autoscaler's input signals);
- ``ray_tpu_serve_queue_wait_seconds{deployment}`` submit-to-execution
  wait measured at the replica;
- ``ray_tpu_serve_replica_processing_seconds{deployment,method}`` user
  code execution time, and
  ``ray_tpu_serve_replica_ongoing_requests{deployment}``.
"""

from __future__ import annotations

import time
from typing import Optional

from ..util.metrics import Counter, Gauge, Histogram

# Prometheus' default latency buckets: sub-5ms cache hits through
# multi-second LLM generations land in distinct buckets.
LATENCY_BOUNDARIES = [
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
]

REQUEST_LATENCY = Histogram(
    "ray_tpu_serve_request_latency_seconds",
    "End-to-end request latency observed at the serve ingress.",
    boundaries=LATENCY_BOUNDARIES,
    tag_keys=("deployment", "protocol"),
)
REQUESTS_TOTAL = Counter(
    "ray_tpu_serve_requests_total",
    "Requests finished at the serve ingress, by status code.",
    tag_keys=("deployment", "protocol", "code"),
)
# Gauges carry an IDENTITY tag (handle/replica) beside the deployment:
# gauges merge last-writer-wins across processes in get_metrics_report,
# so two replicas sharing one tag set would clobber each other — sum
# over the identity tag at query time for the deployment total.
ONGOING_REQUESTS = Gauge(
    "ray_tpu_serve_ongoing_requests",
    "Requests currently in flight from this handle to replicas "
    "(sum over `handle` for the deployment total).",
    tag_keys=("deployment", "handle"),
)
QUEUE_DEPTH = Gauge(
    "ray_tpu_serve_queue_depth",
    "Deepest per-replica outstanding-request queue seen by this "
    "handle's router.",
    tag_keys=("deployment", "handle"),
)
QUEUE_WAIT = Histogram(
    "ray_tpu_serve_queue_wait_seconds",
    "Handle-submit to replica-execution wait time (wall clocks on both "
    "hosts: cross-machine readings include NTP skew).",
    boundaries=LATENCY_BOUNDARIES,
    tag_keys=("deployment",),
)
REPLICA_PROCESSING = Histogram(
    "ray_tpu_serve_replica_processing_seconds",
    "User-code execution time on the replica.",
    boundaries=LATENCY_BOUNDARIES,
    tag_keys=("deployment", "method"),
)
REPLICA_ONGOING = Gauge(
    "ray_tpu_serve_replica_ongoing_requests",
    "Requests currently executing on one replica (sum over `replica` "
    "for the deployment total).",
    tag_keys=("deployment", "replica"),
)
# --- overload-control plane (util/overload.py mechanisms) -----------------
SHED_TOTAL = Counter(
    "ray_tpu_serve_shed_total",
    "Requests shed by overload control before execution "
    "(scope: proxy=ingress admission gate, replica=adaptive "
    "concurrency limit, router=all replica breakers open, "
    "retry_budget=retry suppressed).",
    tag_keys=("deployment", "scope"),
)
DEADLINE_EXCEEDED_TOTAL = Counter(
    "ray_tpu_serve_deadline_exceeded_total",
    "Requests whose end-to-end deadline budget expired "
    "(where: replica=refused/cancelled on the replica, "
    "caller=timed out waiting, ingress=observed at the proxy).",
    tag_keys=("deployment", "where"),
)
BREAKER_STATE = Gauge(
    "ray_tpu_serve_breaker_state",
    "Per-replica circuit-breaker state as seen by one handle's router "
    "(0=closed, 1=half-open, 2=open; identity tags `handle`+`replica` — "
    "max over `handle` for a replica's worst view).",
    tag_keys=("deployment", "handle", "replica"),
)
RETRIES_TOTAL = Counter(
    "ray_tpu_serve_retries_total",
    "Handle-level request retries spent from the retry budget.",
    tag_keys=("deployment",),
)


def observe_ingress(deployment: str, protocol: str, code,
                    started: float, ended: Optional[float] = None,
                    trace_id: Optional[str] = None) -> None:
    """One finished ingress request: latency histogram + status counter.
    ``trace_id`` lands as the bucket's OpenMetrics exemplar, so a slow
    bucket leads to its offending trace in one hop."""
    ended = time.time() if ended is None else ended
    tags = {"deployment": deployment, "protocol": protocol}
    REQUEST_LATENCY.observe(max(0.0, ended - started), tags=tags,
                            exemplar=trace_id)
    REQUESTS_TOTAL.inc(1, tags={**tags, "code": str(code)})


def update_router_gauges(deployment: str, handle_id: str,
                         outstanding) -> None:
    """Refresh in-flight/queue-depth gauges from a router's per-replica
    outstanding map. Published from the router's long-poll loop (~every
    0.5s), NOT from the per-request begin/end hot path — gauges need
    freshness, not per-event precision."""
    tags = {"deployment": deployment, "handle": handle_id}
    ONGOING_REQUESTS.set(float(sum(outstanding.values())), tags=tags)
    QUEUE_DEPTH.set(
        float(max(outstanding.values(), default=0)), tags=tags
    )


def observe_shed(deployment: str, scope: str) -> None:
    """One request shed before execution (proxy gate, replica limiter,
    all-breakers-open router, or a suppressed retry). Inside an active
    request span the decision also lands as a zero-duration span event,
    so the shed shows up in the request's recorded waterfall."""
    from ..util.timeline import span_event

    SHED_TOTAL.inc(1, tags={"deployment": deployment or "anonymous",
                            "scope": scope})
    span_event(f"shed:{scope}:{deployment or 'anonymous'}")


def observe_deadline_exceeded(deployment: str, where: str) -> None:
    from ..util.timeline import span_event

    DEADLINE_EXCEEDED_TOTAL.inc(
        1, tags={"deployment": deployment or "anonymous", "where": where}
    )
    span_event(f"deadline:{where}:{deployment or 'anonymous'}")


def observe_retry(deployment: str) -> None:
    RETRIES_TOTAL.inc(1, tags={"deployment": deployment or "anonymous"})


def record_breaker_state(deployment: str, handle_id: str, replica: str,
                         state: str) -> None:
    """Published on breaker TRANSITIONS only (open/half-open/close are
    rare), not per request. A transition observed during a traced
    request additionally lands as a span event in its waterfall."""
    from ..util.timeline import span_event
    from ..util.overload import BREAKER_STATE_VALUES

    BREAKER_STATE.set(
        BREAKER_STATE_VALUES.get(state, 0.0),
        tags={"deployment": deployment or "anonymous",
              "handle": handle_id, "replica": replica},
    )
    span_event(f"breaker:{state}:{replica}")


def observe_replica_request(deployment: str, method: str,
                            submit_ts: float, started: float,
                            ended: float) -> None:
    """Queue-wait + execution time for one replica-side request.

    Queue wait subtracts the handle host's ``time.time()`` stamp from
    the replica host's — on one machine that is the true router+actor
    queue delay; across machines it includes clock skew (clamped at 0),
    the standard trade-off of cross-process wall-clock timing."""
    dep = deployment or "anonymous"
    if submit_ts:
        QUEUE_WAIT.observe(
            max(0.0, started - submit_ts), tags={"deployment": dep}
        )
    REPLICA_PROCESSING.observe(
        max(0.0, ended - started),
        tags={"deployment": dep, "method": method},
    )
