"""Placement groups: an all-or-nothing reservation of resource bundles
(counterpart of ``ray_tpu/core/placement_group.py``).

On one node every bundle lands on that node: ``PACK``, ``SPREAD`` and
``STRICT_PACK`` reserve the bundles together once they all fit, and
``STRICT_SPREAD``, which needs a node a bundle, can hold one bundle only;
with more it stays pending, as it does in the JAX package on a one-node
cluster. A task or actor given a
:class:`~.scheduling_strategies.PlacementGroupSchedulingStrategy` takes
its resources from its bundle.
"""

from __future__ import annotations

import uuid
from typing import Dict, List

from .resources import check_whole_gpus
from .runtime_context import current_runtime
from .scheduling_strategies import PlacementGroupSchedulingStrategy  # noqa: F401

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    """Client handle; picklable."""

    def __init__(self, pg_id: str, bundles: List[Dict[str, float]],
                 strategy: str = "PACK", name: str = ""):
        self.id = pg_id
        self._bundles = bundles
        self.strategy = strategy
        self.name = name

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self._bundles)

    @property
    def bundle_count(self) -> int:
        return len(self._bundles)

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        """Block until every bundle is reserved; False on timeout."""
        return current_runtime().pg_wait(self.id, timeout_seconds)

    def __repr__(self):
        return (f"PlacementGroup(id={self.id[:8]}, bundles={self._bundles}, "
                f"strategy={self.strategy})")


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "") -> PlacementGroup:
    """Reserve ``bundles``; returns at once (use ``.wait()``)."""
    if strategy not in VALID_STRATEGIES:
        raise ValueError(
            f"strategy must be one of {VALID_STRATEGIES}, got {strategy!r}"
        )
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    for b in bundles:
        if not b or any(v < 0 for v in b.values()):
            raise ValueError(f"invalid bundle {b!r}")
        check_whole_gpus(b)
    pg_id = uuid.uuid4().hex
    bundles = [dict(b) for b in bundles]
    current_runtime().pg_create(pg_id, bundles, strategy, name)
    return PlacementGroup(pg_id, bundles, strategy, name)


def remove_placement_group(pg: PlacementGroup):
    """Release the group's reservation; actors placed in it are killed."""
    current_runtime().pg_remove(pg.id)
