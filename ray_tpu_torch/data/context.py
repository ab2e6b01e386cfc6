"""DataContext: execution knobs (counterpart of
``ray_tpu/data/context.py``; ref: python/ray/data/context.py DataContext
singleton), with the JAX package's fields and defaults."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class DataContext:
    # target_max_block_size and prefetch_batches are accepted and read by
    # nothing, as in the JAX package: blocks keep the size their source
    # gives them, and the device feed is always one batch ahead.
    target_max_block_size: int = 128 * 1024 * 1024
    # Streaming backpressure: max concurrently in-flight block tasks per
    # operator chain (ref analogue: ConcurrencyCapBackpressurePolicy in
    # _internal/execution/backpressure_policy/).
    max_in_flight_tasks: int = 8
    # Resource-aware backpressure: stages stop SUBMITTING new block tasks
    # while the objects the driver holds fill more than this fraction of
    # ``init(object_store_memory=)`` — a slow consumer therefore bounds
    # producer memory. <= 0 disables.
    store_usage_cap_fraction: float = 0.8
    prefetch_batches: int = 2
    use_remote_tasks: bool = True
    # Shuffle plan: None = auto (push-based merge stage at >=16 input
    # blocks — ref: _internal/push_based_shuffle.py), True/False forces.
    push_based_shuffle: "bool | None" = None

    _instance = None

    @classmethod
    def get_current(cls) -> "DataContext":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance
