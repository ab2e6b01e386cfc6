"""Logical-axis sharding rules (counterpart of
``ray_tpu/parallel/sharding.py``).

Model code names each tensor dim with a *logical* axis ("batch", "embed",
"heads", ...) and a rules table maps it to mesh axes. JAX hands the result
to GSPMD, which places the arrays and inserts the collectives. The port is
explicit SPMD instead: every rank holds plain local tensors, the slice of
each global tensor that the spec gives it (:func:`shard_pytree`), and the
model calls the collectives of ``collectives.py`` at fixed points. The
flash kernels take raw pointers, so they see local tensors either way.

A spec here is a tuple with one entry per dim: a mesh-axis name, a tuple of
names (the dim is split over their product, the first the major one), or
None (not split), as JAX's ``PartitionSpec`` holds them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch

from .mesh import mesh_axis_size

# (logical axis, mesh axis or tuple of mesh axes or None)
Rule = Tuple[str, Union[str, Tuple[str, ...], None]]
Spec = Tuple[Union[str, Tuple[str, ...], None], ...]

# Default rules for transformer training:
#  - batch splits over dp+fsdp (each fsdp rank sees different data)
#  - sequence splits over sp (ring attention axis)
#  - attention heads + mlp hidden split over tp (Megatron-style)
#  - embed (params' fsdp shard dim) splits over fsdp: ZeRO-3-equivalent
#  - experts split over ep
#  - layer stages split over pp (for stacked-layer pipeline params)
DEFAULT_RULES: Tuple[Rule, ...] = (
    ("batch", ("dp", "fsdp")),
    ("seq", "sp"),
    ("kv_seq", "sp"),
    ("embed", "fsdp"),
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("head_dim", None),
    ("mlp", "tp"),
    ("vocab", "tp"),
    ("expert", "ep"),
    ("layers", "pp"),
    ("norm", None),
)


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    rules: Sequence[Rule] = DEFAULT_RULES,
) -> Spec:
    """Map logical axis names to a spec via the rules table. A mesh axis
    may be consumed at most once per spec (first match wins)."""
    table = dict(rules)
    used: set = set()
    out = []
    for name in logical_axes:
        mesh_axis = table.get(name) if name is not None else None
        if mesh_axis is None:
            out.append(None)
            continue
        axes = (mesh_axis,) if isinstance(mesh_axis, str) else tuple(mesh_axis)
        free = tuple(a for a in axes if a not in used)
        if not free:
            out.append(None)
            continue
        used.update(free)
        out.append(free if len(free) > 1 else free[0])
    return tuple(out)


def prune_spec(mesh, spec: Spec) -> Spec:
    """Drop mesh axes of size 1 from a spec (they split nothing; pruning
    keeps specs readable and avoids missing-axis errors on small meshes)."""
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, str):
            out.append(entry if mesh_axis_size(mesh, entry) > 1 else None)
        else:
            kept = tuple(a for a in entry if mesh_axis_size(mesh, a) > 1)
            out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: which slice of a global tensor this rank holds."""

    mesh: Any
    spec: Spec

    def coords(self, dim: int) -> Tuple[int, int]:
        """(this rank's index, number of pieces) along ``dim``."""
        entry = self.spec[dim] if dim < len(self.spec) else None
        index, count = 0, 1
        for axis in entry_axes(entry):
            n = mesh_axis_size(self.mesh, axis)
            index = index * n + self.mesh.get_local_rank(axis)
            count *= n
        return index, count

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """The local shape of a global tensor; a dim its pieces do not
        divide raises."""
        out = []
        for dim, size in enumerate(global_shape):
            count = self.coords(dim)[1]
            if size % count:
                raise ValueError(
                    f"dim {dim} of size {size} does not split into {count} "
                    f"pieces (spec {self.spec})")
            out.append(size // count)
        return tuple(out)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the global tensor ``x`` (a view)."""
        shape = self.shard_shape(x.shape)
        for dim, size in enumerate(shape):
            x = x.narrow(dim, self.coords(dim)[0] * size, size)
        return x


def named_sharding(mesh, logical_axes: Sequence[Optional[str]],
                   rules: Sequence[Rule] = DEFAULT_RULES) -> NamedSharding:
    return NamedSharding(mesh, prune_spec(mesh, logical_to_spec(logical_axes,
                                                               rules)))


def with_logical_constraint(
    x: torch.Tensor,
    logical_axes: Sequence[Optional[str]],
    *,
    mesh=None,
    rules: Sequence[Rule] = DEFAULT_RULES,
    global_shape: Optional[Sequence[int]] = None,
) -> torch.Tensor:
    """Check that ``x`` is laid out as ``logical_axes`` say, and return it
    unchanged. In JAX this is a sharding constraint that XLA satisfies by
    resharding; here every tensor is already this rank's local piece and
    nothing moves: the check is that ``x`` has one dim per logical axis
    and, given ``global_shape``, the local shape of that global tensor
    (the MoE layer checks its expert buffers, [E/ep, C, M] of the global
    [E, C, M], against ("expert", None, None) this way). Without a mesh it
    returns ``x`` unchecked, as JAX does."""
    if mesh is None:
        return x
    if x.dim() != len(logical_axes):
        raise ValueError(f"a tensor of {x.dim()} dims against logical axes "
                         f"{tuple(logical_axes)}")
    if global_shape is not None:
        want = named_sharding(mesh, logical_axes, rules).shard_shape(
            global_shape)
        if tuple(x.shape) != want:
            raise ValueError(
                f"local shape {tuple(x.shape)} of {tuple(global_shape)} "
                f"under {tuple(logical_axes)}: want {want}")
    return x


def is_logical_axes(x) -> bool:
    """True for a leaf of a logical-axes tree: a tuple of axis names (str)
    and Nones, e.g. ("layers", "embed", "heads", "head_dim")."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) for e in x
    )


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of a tree of dicts (the parameter trees),
    with matching trees ``rest`` whose leaves may be logical-axes tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_shardings(mesh, logical_axes_tree, rules=DEFAULT_RULES):
    """A tree of logical-axis tuples mapped to a tree of NamedShardings."""
    return tree_map(lambda axes: named_sharding(mesh, axes, rules),
                    logical_axes_tree)


def shard_pytree(tree, mesh, logical_axes_tree, rules=DEFAULT_RULES):
    """A tree of global tensors cut to this rank's local shards (contiguous
    copies), following a matching tree of logical-axis tuples."""
    return tree_map(
        lambda x, axes: named_sharding(mesh, axes,
                                       rules).local(x).contiguous(),
        tree, logical_axes_tree)


def constrain_pytree(tree, mesh, logical_axes_tree, rules=DEFAULT_RULES):
    """:func:`with_logical_constraint` over a whole tree of local tensors
    (the counterpart of JAX's in-graph placement of parameters and
    optimizer state): checks each leaf's rank and returns the tree."""
    return tree_map(
        lambda x, axes: with_logical_constraint(x, axes, mesh=mesh,
                                                rules=rules),
        tree, logical_axes_tree)
