"""Fixed-point resource arithmetic and resource sets (counterpart of
``ray_tpu/core/resources.py``). The names are ``"CPU"``, ``"GPU"`` (where
JAX has ``"TPU"``) and any custom resource; fractional amounts are exact
in fixed point (scale 1e4). ``"GPU"`` is counted in whole cards."""

from __future__ import annotations

from typing import Dict, Mapping

RESOURCE_SCALE = 10_000

CPU = "CPU"
GPU = "GPU"


def to_fixed(value: float) -> int:
    return round(value * RESOURCE_SCALE)


def from_fixed(value: int) -> float:
    return value / RESOURCE_SCALE


def check_whole_gpus(amounts: Mapping[str, float]) -> None:
    """Raise ``ValueError`` unless ``amounts`` asks for whole cards: a
    task, actor or bundle holds its cards alone."""
    gpus = amounts.get(GPU, 0)
    if gpus < 0 or gpus != int(gpus):
        raise ValueError(f"GPU must be a whole number of cards, got {gpus}")


class ResourceSet:
    """A non-negative bag of named resources in fixed-point units."""

    __slots__ = ("_amounts",)

    def __init__(self, amounts: Mapping[str, float] | None = None, *,
                 _fixed=None):
        if _fixed is not None:
            self._amounts: Dict[str, int] = {k: v for k, v in _fixed.items()
                                             if v != 0}
        else:
            self._amounts = {
                k: to_fixed(v) for k, v in (amounts or {}).items() if v != 0
            }

    def to_dict(self) -> Dict[str, float]:
        return {k: from_fixed(v) for k, v in self._amounts.items()}

    def get(self, name: str) -> float:
        return from_fixed(self._amounts.get(name, 0))

    def is_empty(self) -> bool:
        return not self._amounts

    def is_subset_of(self, other: "ResourceSet") -> bool:
        return all(v <= other._amounts.get(k, 0)
                   for k, v in self._amounts.items())

    def __add__(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._amounts)
        for k, v in other._amounts.items():
            out[k] = out.get(k, 0) + v
        return ResourceSet(_fixed=out)

    def __sub__(self, other: "ResourceSet") -> "ResourceSet":
        out = dict(self._amounts)
        for k, v in other._amounts.items():
            out[k] = out.get(k, 0) - v
            if out[k] < 0:
                raise ValueError(
                    f"Resource {k} would go negative: {from_fixed(out[k])}"
                )
        return ResourceSet(_fixed=out)

    def __eq__(self, other):
        return isinstance(other, ResourceSet) and \
            self._amounts == other._amounts

    def __repr__(self):
        return f"ResourceSet({self.to_dict()})"


class NodeResources:
    """Total and available resources of one node (or of one placement
    group bundle), with acquire and release."""

    def __init__(self, total: ResourceSet):
        self.total = total
        self.available = ResourceSet(_fixed=dict(total._amounts))

    def can_fit(self, request: ResourceSet) -> bool:
        return request.is_subset_of(self.available)

    def is_feasible(self, request: ResourceSet) -> bool:
        return request.is_subset_of(self.total)

    def acquire(self, request: ResourceSet) -> bool:
        if not self.can_fit(request):
            return False
        self.available = self.available - request
        return True

    def release(self, request: ResourceSet):
        self.available = self.available + request
