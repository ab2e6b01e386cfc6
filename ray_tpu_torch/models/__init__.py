"""ray_tpu_torch.models: the Llama family in PyTorch (dense and MoE, with
the training loss), the KV-cache generation paths, ResNet, and the numpy
converters for JAX parameter trees, optax state and flax ResNet
variables."""

from .convert import (  # noqa: F401
    adam_state_from_numpy,
    params_from_numpy,
    resnet_variables_from_numpy,
)
from .llama import (  # noqa: F401
    LlamaConfig,
    causal_lm_loss,
    forward,
    init_params,
    num_params,
)
from .resnet import (  # noqa: F401
    ResNet,
    ResNetBlock,
    create_train_state,
    resnet18,
    resnet50,
)
