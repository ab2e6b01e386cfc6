"""Runtime flags (counterpart of the fields of ``ray_tpu/core/config.py``
that the single-node runtime and the trainer read).

A typed dataclass of flags, each overridable through a ``RAY_TPU_<NAME>``
environment variable or the ``system_config`` dict passed to ``init``,
with the JAX package's names and defaults.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any


def _env_override(name: str, default: Any) -> Any:
    raw = os.environ.get(f"RAY_TPU_{name.upper()}")
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


@dataclasses.dataclass
class Config:
    # CPU-typed workers started with the runtime (ref: worker_pool
    # prestart).
    num_prestart_workers: int = 2
    # Bytes the objects held by the driver are counted against (0 = no
    # capacity: the data plane's store policy never holds back).
    object_store_memory: int = 0
    # How long a task or actor whose resources fit no node may stay
    # queued before it fails (0 = fail fast).
    infeasible_grace_s: float = 0.0
    # A train rank whose KV heartbeat is older than this is declared dead
    # and the supervisor aborts the whole gang.
    train_rank_timeout_s: float = 30.0
    # How often each rank publishes its heartbeat and step counter.
    train_heartbeat_interval_s: float = 2.0
    # --- serve overload control (util/overload.py mechanisms) -------------
    # Default end-to-end budget for one serve request: seeds the deadline
    # that propagates ingress -> handle -> replica (and nested calls).
    serve_default_request_timeout_s: float = 120.0
    # Proxy admission: AIMD concurrency ceiling per deployment, and the
    # bounded wait queue behind it (requests beyond limit+queue shed with
    # 503 + Retry-After; queued requests are evicted by age when their
    # deadline expires).
    serve_proxy_concurrency: int = 128
    serve_shed_queue_len: int = 64
    # Latency floor feeding the AIMD limiters (proxy + replica): a
    # completion is an overload signal (limit shrinks multiplicatively)
    # when slower than max(this, 2x the service's rolling latency
    # baseline).
    serve_aimd_latency_target_s: float = 2.0
    # Per-replica circuit breaker: error-rate threshold over the rolling
    # window, minimum observations before it can trip, and the base
    # open-state delay before the first half-open probe (doubles with
    # jitter on every failed probe, util/backoff.py).
    serve_breaker_error_threshold: float = 0.5
    serve_breaker_min_volume: int = 5
    serve_breaker_open_s: float = 1.0
    # A replica whose breaker handles report OPEN continuously for this
    # long is ejected by the controller (surge-replace, then drain +
    # kill). <= 0 disables ejection.
    serve_breaker_eject_s: float = 30.0
    # Retry-budget deposit per first-try request (retries spend 1 token
    # each): handle retry volume stays <= this fraction of traffic.
    serve_retry_budget_ratio: float = 0.2

    def __post_init__(self):
        for f in dataclasses.fields(self):
            setattr(self, f.name, _env_override(f.name, getattr(self, f.name)))

    def apply_overrides(self, system_config: dict | None):
        if not system_config:
            return
        for k, v in system_config.items():
            if not hasattr(self, k):
                raise ValueError(f"Unknown system config key: {k}")
            setattr(self, k, v)


_global_config: Config | None = None


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config()
    return _global_config


def reset_config():
    global _global_config
    _global_config = None
