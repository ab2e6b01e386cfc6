"""User-facing scheduling strategies (counterpart of
``ray_tpu/core/scheduling_strategies.py``). On one node the string
strategies ``"DEFAULT"`` and ``"SPREAD"`` place the same way; the one that
changes placement is :class:`PlacementGroupSchedulingStrategy`."""

from __future__ import annotations


class PlacementGroupSchedulingStrategy:
    """Run inside a placement group's reserved bundles.
    ``placement_group_bundle_index=-1`` means any bundle with room."""

    def __init__(self, placement_group,
                 placement_group_bundle_index: int = -1):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index

    @property
    def pg_id(self) -> str:
        return self.placement_group.id
