"""ray_tpu_torch.train: the fused training step for the Llama family and
its AdamW (the counterparts of ``ray_tpu/train/compiled_step.py`` and
``optax.adamw``), crash-safe checkpoints, sharded or whole
(``checkpoint``), the predictor that scores a checkpoint and the batch
predictor that scores a Dataset with it in an actor pool (``predictor``),
and the trainer: ``TorchTrainer`` runs a train loop in a gang of worker
processes on the port's runtime, restarting it from its last committed
checkpoint, with the session functions (``report``, ``get_checkpoint``,
``get_world_rank``...) and the configs of ``ray_tpu.train``.

As ``import ray_tpu.train`` stays free of JAX, importing this package
imports no torch: the session and the trainer do not need it, so a train
rank whose loop does not use torch starts without it. The torch-backed
names below load on first use.
"""

import importlib

from ..util import usage_stats as _usage
from .config import (  # noqa: F401
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from .session import (  # noqa: F401
    PreemptionSignal,
    get_checkpoint,
    get_dataset_shard,
    get_session,
    get_world_rank,
    get_world_size,
    preemption_requested,
    report,
)
from .trainer import TorchTrainer, TrainWorkerGroupError  # noqa: F401

_LAZY = {
    "Checkpoint": "checkpoint",
    "CheckpointManager": "checkpoint",
    "default_storage_path": "checkpoint",
    "latest_committed": "checkpoint",
    "CompiledTrainStep": "compiled_step",
    "AdamState": "optim",
    "AdamW": "optim",
    "BatchPredictor": "predictor",
    "Predictor": "predictor",
    "TorchPredictor": "predictor",
    "get_device": "torch",
    "prepare_model": "torch",
    "prepare_data_loader": "torch",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{module}", __name__), name)


def __dir__():
    return sorted(list(globals()) + list(_LAZY))


_usage.record_library_usage("train")
