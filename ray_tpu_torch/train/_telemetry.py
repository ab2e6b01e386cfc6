"""Train gang lifecycle metrics (counterpart of
``ray_tpu/train/_telemetry.py``, same names and tags), recorded by the
supervisor in the driver's process-local registry.

- ``ray_tpu_train_restarts_total``: whole-gang restarts the supervisor
  executed (tag ``reason``: error | hang | preempt).
- ``ray_tpu_train_gang_aborts_total``: prompt gang aborts — a rank died
  or its heartbeat went stale past ``train_rank_timeout_s`` and the
  surviving ranks were killed out of their collectives.
- ``ray_tpu_train_recovery_seconds``: failure detection → the restarted
  gang's first successful report (the paper's gang-restart latency).
- ``ray_tpu_train_preemptions_total``: cooperative drain preemptions
  (the gang checkpointed and surrendered a draining node).
"""

from __future__ import annotations

from ..util.metrics import Counter, Gauge, Histogram

TRAIN_RESTARTS = Counter(
    "ray_tpu_train_restarts_total",
    "Whole-gang restarts executed by the train supervisor",
    tag_keys=("reason",),
)

TRAIN_GANG_ABORTS = Counter(
    "ray_tpu_train_gang_aborts_total",
    "Prompt gang aborts (dead/hung rank detected; survivors killed)",
    tag_keys=("reason",),
)

TRAIN_RECOVERY_SECONDS = Histogram(
    "ray_tpu_train_recovery_seconds",
    "Failure detection to the restarted gang's first report",
    boundaries=[0.5, 1, 2, 5, 10, 30, 60, 120, 300],
)

TRAIN_PREEMPTIONS = Counter(
    "ray_tpu_train_preemptions_total",
    "Cooperative drain preemptions (gang checkpointed and moved)",
)

TRAIN_GANG_SIZE = Gauge(
    "ray_tpu_train_gang_size",
    "World size of the currently-running train gang",
)
