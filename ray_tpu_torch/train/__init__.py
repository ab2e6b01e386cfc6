"""ray_tpu_torch.train: the fused training step for the Llama family and
its AdamW (the counterparts of ``ray_tpu/train/compiled_step.py`` and
``optax.adamw``)."""

from .compiled_step import CompiledTrainStep  # noqa: F401
from .optim import AdamState, AdamW  # noqa: F401
