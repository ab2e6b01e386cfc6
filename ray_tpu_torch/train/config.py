"""Train/run configuration dataclasses (counterpart of
``ray_tpu/train/config.py``): ``ScalingConfig`` with ``use_gpu`` where the
JAX package has ``use_tpu``. ``use_gpu`` is on unless the caller turns it
off, where ``use_tpu`` is off unless the caller turns it on: the port's
ranks train on the card by default."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class ScalingConfig:
    """How many workers and what each needs. ``use_gpu`` workers (the
    default) ask for ``{"GPU": 1}`` and run in GPU-typed worker processes
    that see their card; ``use_gpu=False`` workers ask for ``{"CPU": 1}``
    and train on the CPU."""

    num_workers: int = 1
    use_gpu: bool = True
    resources_per_worker: Optional[Dict[str, float]] = None

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        if self.use_gpu:
            res.setdefault("GPU", 1)
        else:
            res.setdefault("CPU", 1)
        return res


@dataclasses.dataclass
class CheckpointConfig:
    """Top-k checkpoint retention."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclasses.dataclass
class FailureConfig:
    """Whole-group restarts from the last committed checkpoint on a
    worker failure."""

    max_failures: int = 0


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig
    )
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig
    )


@dataclasses.dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional["Checkpoint"]  # noqa: F821
    error: Optional[BaseException] = None
    metrics_history: Optional[list] = None

    @property
    def best_checkpoint(self):
        return self.checkpoint
