"""ray_tpu_torch.serve: online serving on the port's runtime (counterpart
of ``ray_tpu/serve``): deployments run as replica actors in worker
processes of their own, under a named controller actor that deploys,
scales, rolls, health-checks and replaces them; handles route requests to
replicas (power of two choices, retries, breakers, batching, streaming);
an HTTP proxy in the driver serves JSON and server-sent events. The
continuous-batching LLM engine (``LLMEngine``) and its deployment
(``LLMDeployment``) serve a Llama model on the H100; a GPU replica asks
for ``ray_actor_options={"num_gpus": 1}``.

Importing this package does not import torch: ``LLMDeployment`` and
``LLMEngine`` load ``serve/llm.py`` when first named, so a CPU replica
of a plain deployment starts without it.
"""

from ..util import usage_stats as _usage
from .api import (  # noqa: F401
    batch,
    delete,
    deployment,
    details,
    get_deployment_handle,
    get_multiplexed_model_id,
    multiplexed,
    run,
    scale,
    shutdown,
    status,
)
from .deployment import AutoscalingConfig, Deployment  # noqa: F401
from .handle import DeploymentHandle, ServeFuture  # noqa: F401

_usage.record_library_usage("serve")


def __getattr__(name):
    if name in ("LLMDeployment", "LLMEngine"):
        from . import llm

        return getattr(llm, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
