"""ray_tpu_torch.core: the port's single-node task/actor/object runtime
(counterpart of the head-mode, single-node surface of ``ray_tpu.core``:
``init``, ``remote``, ``get``, ``wait``, ``put``, ``kill``, placement
groups, the KV, ``SpmdActorGroup``, streaming returns). CPU and GPU tasks and actors run in
worker processes of their own; see ``runtime.py``."""

from .actor import ActorClass, ActorHandle, ActorMethod, get_actor  # noqa: F401
from .api import (  # noqa: F401
    available_resources,
    cluster_resources,
    get,
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
from .exceptions import (  # noqa: F401
    ActorDiedError,
    DeadlineExceededError,
    GetTimeoutError,
    OverloadedError,
    RayTpuError,
    RuntimeNotInitializedError,
    TaskError,
    WorkerCrashedError,
)
from .placement_group import (  # noqa: F401
    PlacementGroup,
    placement_group,
    remove_placement_group,
)
from .reference import ObjectRef  # noqa: F401
from .remote_function import RemoteFunction  # noqa: F401
from .runtime_context import get_runtime_context  # noqa: F401
from .scheduling_strategies import PlacementGroupSchedulingStrategy  # noqa: F401
from .spmd import SpmdActorGroup, SpmdGroupError  # noqa: F401
from .streaming import ObjectRefGenerator  # noqa: F401
