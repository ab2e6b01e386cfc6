"""ray_tpu_torch.train: the fused training step for the Llama family and
its AdamW (the counterparts of ``ray_tpu/train/compiled_step.py`` and
``optax.adamw``), crash-safe checkpoints, sharded or whole
(``checkpoint``), and the predictor that scores a checkpoint
(``predictor``)."""

from ..util import usage_stats as _usage
from .checkpoint import (  # noqa: F401
    Checkpoint,
    CheckpointManager,
    default_storage_path,
    latest_committed,
)
from .compiled_step import CompiledTrainStep  # noqa: F401
from .optim import AdamState, AdamW  # noqa: F401
from .predictor import Predictor, TorchPredictor  # noqa: F401

_usage.record_library_usage("train")
