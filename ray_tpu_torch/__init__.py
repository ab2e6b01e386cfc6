"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu.

The JAX package ``ray_tpu`` stays the reference; this package keeps its
module names (``core``, ``ops``, ``models``, ``parallel``, ``serve``,
``train``, ``data``, ``rllib``) and computes with PyTorch on an NVIDIA
H100, with hand-written CUDA kernels in place of the Pallas TPU kernels.
It imports nothing from ``ray_tpu`` and never imports JAX.

The core API below is ``ray_tpu``'s (``ray_tpu/__init__.py``) for what is
ported: a single-node runtime whose CPU and GPU tasks and actors run in
worker processes of their own (``core``). Importing this package does not
import torch, so a CPU worker starts without it.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise.
"""

from .core import (  # noqa: F401
    ActorClass,
    ActorDiedError,
    ActorHandle,
    GetTimeoutError,
    ObjectRef,
    ObjectRefGenerator,
    RayTpuError,
    SpmdActorGroup,
    SpmdGroupError,
    TaskError,
    WorkerCrashedError,
    available_resources,
    cluster_resources,
    get,
    get_actor,
    get_runtime_context,
    init,
    is_initialized,
    kill,
    kv_get,
    kv_put,
    nodes,
    put,
    remote,
    shutdown,
    wait,
)


def __getattr__(name):
    # resolve_device imports torch, which a CPU worker must not pay for.
    if name == "resolve_device":
        from ._device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
