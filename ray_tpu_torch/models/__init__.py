"""ray_tpu_torch.models: the Llama family in PyTorch (dense and MoE, with
the training loss), the KV-cache generation paths, and the numpy converters
for JAX parameter trees and optax state."""

from .convert import adam_state_from_numpy, params_from_numpy  # noqa: F401
from .llama import (  # noqa: F401
    LlamaConfig,
    causal_lm_loss,
    forward,
    init_params,
    num_params,
)
