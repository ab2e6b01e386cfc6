"""Collective communication (counterpart of
``ray_tpu/parallel/collectives.py``).

1. Collectives over a named mesh axis (``allreduce``, ``allgather``, ...),
   the counterparts of the ``jax.lax`` collectives that JAX calls inside
   ``shard_map``. Each takes the axis name, or a tuple of names, and finds
   the mesh in its ``mesh=`` keyword or in the innermost
   :func:`use_mesh` block. They run ``torch.distributed`` on the mesh dim's
   process group (NCCL on the card, gloo on the CPU), also when the group
   holds one rank. Each is differentiable where JAX's is, with JAX's
   transpose as its backward (as ``shard_map`` with ``check_vma=False``
   differentiates): an all-reduce's backward all-reduces, an all-gather's
   reduce-scatters and the other way round, an all-to-all's swaps its axes,
   a permutation's runs the inverse permutation. So one backward pass on
   every rank gives each rank the gradient of the sum of all ranks' outputs.
   ``max`` and ``min`` are not differentiable, as in JAX.
2. A host-level :class:`CollectiveGroup` (barrier, object broadcast) over a
   ``torch.distributed`` store.

Over a tuple of axes a collective runs on each axis's group in turn (the
first axis the major one of the combined index, as in JAX), so only the
mesh's own per-dim groups are used.

Each public call counts once in ``ray_tpu_device_collective_calls_total``
and its tensors' bytes (this rank's input) in
``ray_tpu_device_collective_bytes_total``, under JAX's op names
(``util/device_metrics.record_collective``). JAX counts an in-graph op once
per trace; the port runs eagerly, so it counts every call. A call over a
tuple of axes counts once, as one call does in JAX (it runs one
``torch.distributed`` call per axis). ``allreduce_`` counts as
``allreduce``, ``broadcast_flat`` (and ``broadcast``) as one
``broadcast`` with the bytes of all its tensors, and ``shift`` as the
``ppermute`` it calls. A backward pass's collectives are not counted: they
are the transposes that JAX's trace holds without a call of its own.
"""

from __future__ import annotations

import contextlib
import contextvars
import pickle
import time
from typing import Any, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..util.device_metrics import record_collective as _count
from .mesh import mesh_axis_size

AxisName = Union[str, Sequence[str]]

_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Collectives inside the block run on ``mesh`` unless given another."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def _mesh(mesh):
    mesh = mesh if mesh is not None else _MESH.get()
    if mesh is None:
        raise RuntimeError("no mesh: pass mesh= or run inside use_mesh(mesh)")
    return mesh


def _axes(axis: AxisName) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _nbytes(*xs: torch.Tensor) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def _one_axis(axis: AxisName, what: str) -> str:
    axes = _axes(axis)
    if len(axes) != 1:
        raise ValueError(f"{what} runs over one mesh axis, not {axes}")
    return axes[0]


# ---------------------------------------------------------- autograd ops

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllReduceExtremum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, op):
        out = x.contiguous().clone()
        dist.all_reduce(out, op=op, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "allreduce with op 'max' or 'min' is not differentiable (nor is "
            "JAX's pmax/pmin)")


# The gathered tensor comes out contiguous in x's own layout (pieces in
# rank order along ``dim``), so what consumes it (a matmul) runs as it would
# on the unsharded tensor; a transposed view would change the GEMM kernel
# and its rounding, and a transposing copy is slow.
def _gather(x, group, n, dim):
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    if dim == 0:
        return out
    return torch.cat(out.chunk(n), dim=dim)


def _scatter(x, group, n, dim):
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"into {n}")
    pieces = x.contiguous() if dim == 0 else torch.cat(x.chunk(n, dim=dim))
    out = pieces.new_empty((pieces.shape[0] // n,) + tuple(pieces.shape[1:]))
    dist.reduce_scatter_tensor(out, pieces, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.args = (group, n, dim)
        return _gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.args = (group, n, dim)
        return _scatter(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


def _permute(x, group, me, perm):
    """Send to each ``dst`` of a (src == me, dst) pair and receive from each
    ``src`` of a (src, dst == me) pair; zeros where no pair sends here."""
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, me, perm):
        ctx.args = (group, me, tuple((d, s) for s, d in perm))
        return _permute(x, group, me, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, *ctx.args), None, None, None


def _all_to_all(x, group, n, split_axis, concat_axis):
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of size "
                         f"{x.shape[split_axis]} does not split into {n}")
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


def _segments(xs):
    """Byte offset of each tensor in one packed buffer (16-byte aligned,
    so each piece views back as its dtype) and the buffer's length."""
    offsets, n = [], 0
    for x in xs:
        offsets.append(n)
        n += -(-x.numel() * x.element_size() // 16) * 16
    return offsets, n


def _pack(xs):
    """The tensors' bytes in one buffer, laid out as :func:`_segments`: a
    view of a lone tensor that needs no padding, else a copy."""
    if len(xs) == 1 and xs[0].numel() * xs[0].element_size() % 16 == 0:
        return xs[0].contiguous().reshape(-1).view(torch.uint8)
    pieces = []
    for x in xs:
        b = x.contiguous().reshape(-1).view(torch.uint8)
        pieces.append(b)
        if b.numel() % 16:
            pieces.append(b.new_zeros(16 - b.numel() % 16))
    return torch.cat(pieces)


class _Broadcast(torch.autograd.Function):
    """Every rank of ``group`` takes the values of the rank with index
    ``root``, for several tensors in one call: the root packs their bytes
    into one buffer, and every rank views its pieces back out. The
    backward sums each gradient onto the root (JAX's transpose of a masked
    psum), one reduce for each dtype, and gives the other ranks none."""

    @staticmethod
    def forward(ctx, group, me, root, *xs):
        ctx.args = (group, me, root)
        src = dist.get_global_rank(group, root)
        if me == root:
            dist.broadcast(_pack(xs), src, group=group)
            return xs  # autograd hands out views: the root unpacks nothing
        offsets, n = _segments(xs)
        flat = torch.empty(n, dtype=torch.uint8, device=xs[0].device)
        dist.broadcast(flat, src, group=group)
        return tuple(
            flat[o:o + x.numel() * x.element_size()].view(x.dtype).view(
                x.shape) for x, o in zip(xs, offsets))

    @staticmethod
    def backward(ctx, *gs):
        group, me, root = ctx.args
        dst = dist.get_global_rank(group, root)
        by_dtype = {}
        for i, g in enumerate(gs):
            by_dtype.setdefault(g.dtype, []).append(i)
        out = [None] * len(gs)
        for idx in by_dtype.values():  # the same order on every rank
            flat = torch.cat([gs[i].reshape(-1) for i in idx])
            dist.reduce(flat, dst, group=group)
            if me == root:
                pieces = flat.split([gs[i].numel() for i in idx])
                for i, piece in zip(idx, pieces):
                    out[i] = piece.view(gs[i].shape)
        return (None, None, None, *out)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.args = (group, n, concat_axis, split_axis)
        return _all_to_all(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


# ----------------------------------------------------------- named-axis API

def allreduce(x: torch.Tensor, axis: AxisName = "dp", op: str = "sum", *,
              mesh=None) -> torch.Tensor:
    mesh = _mesh(mesh)
    axes = _axes(axis)
    _count("allreduce", _nbytes(x))
    if op in ("sum", "mean"):
        for a in axes:
            x = _AllReduceSum.apply(x, mesh.get_group(a))
        return x / axis_size(axes, mesh=mesh) if op == "mean" else x
    if op in ("max", "min"):
        red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.MIN
        for a in axes:
            x = _AllReduceExtremum.apply(x, mesh.get_group(a), red)
        return x
    raise ValueError(f"unsupported reduce op {op!r}")


def allreduce_(x: torch.Tensor, axis: AxisName, *, mesh=None) -> None:
    """Sum ``x`` over the axes in place, outside autograd (for gradient
    buffers)."""
    mesh = _mesh(mesh)
    _count("allreduce", _nbytes(x))
    for a in _axes(axis):
        dist.all_reduce(x, group=mesh.get_group(a))


def allgather(x: torch.Tensor, axis: AxisName = "dp", *, tiled: bool = True,
              gather_dim: int = 0, mesh=None) -> torch.Tensor:
    """Concatenate (``tiled``) or stack every rank's ``x`` along
    ``gather_dim``, in axis-index order."""
    mesh = _mesh(mesh)
    _count("allgather", _nbytes(x))
    if not tiled:
        x = x.unsqueeze(gather_dim)
    for a in reversed(_axes(axis)):  # the minor axis first
        x = _AllGather.apply(x, mesh.get_group(a), axis_size(a, mesh=mesh),
                             gather_dim)
    return x


def reducescatter(x: torch.Tensor, axis: AxisName = "dp", *,
                  scatter_dim: int = 0, mesh=None) -> torch.Tensor:
    """Sum over the axis, each rank keeping its piece of ``scatter_dim``
    (tiled)."""
    mesh = _mesh(mesh)
    _count("reducescatter", _nbytes(x))
    for a in _axes(axis):  # the major axis first
        x = _ReduceScatter.apply(x, mesh.get_group(a),
                                 axis_size(a, mesh=mesh), scatter_dim)
    return x


def _root_digits(mesh, axis: AxisName, root: int):
    """(axis, the root's index along it) for each axis, the minor first."""
    digits = []
    for a in reversed(_axes(axis)):
        root, digit = divmod(root, mesh_axis_size(mesh, a))
        digits.append((a, digit))
    return digits


def broadcast(x: torch.Tensor, axis: AxisName = "dp", root: int = 0, *,
              mesh=None) -> torch.Tensor:
    """Every rank takes the value of the rank whose index along the axis is
    ``root`` (JAX's sum over the axis of x masked to the root, with its
    gradient: the sum of the ranks' gradients on the root, zeros
    elsewhere). Over a tuple of axes the minor axis goes first, each from
    its digit of ``root``."""
    return broadcast_flat([x], axis, root, mesh=mesh)[0]


# A tensor below this many bytes travels packed with the others: copying
# it into the packed buffer (~0.17 ms for 256 MB at 3 TB/s, read and
# written) costs less than a collective call of its own on the host
# (0.1-0.3 ms, PERF.md section 6); a larger one travels alone, uncopied.
PACK_BYTES = 1 << 28


def broadcast_flat(xs: Sequence[torch.Tensor], axis: AxisName = "dp",
                   root: int = 0, *, mesh=None) -> Tuple[torch.Tensor, ...]:
    """:func:`broadcast` of every tensor of ``xs`` (which may differ in
    shape and dtype), for each axis in one collective call for all the
    tensors under ``PACK_BYTES`` (their bytes packed into one buffer) and
    one for each larger tensor; each call's backward reduces one buffer
    for each dtype of its gradients."""
    mesh = _mesh(mesh)
    _count("broadcast", _nbytes(*xs))
    out = list(xs)
    small = [i for i, x in enumerate(out)
             if x.numel() * x.element_size() < PACK_BYTES]
    calls = [small] + [[i] for i in range(len(out)) if i not in small]
    for idx in filter(None, calls):
        ys = tuple(out[i] for i in idx)
        for a, digit in _root_digits(mesh, axis, root):
            ys = _Broadcast.apply(mesh.get_group(a), mesh.get_local_rank(a),
                                  digit, *ys)
        for i, y in zip(idx, ys):
            out[i] = y
    return tuple(out)


def ppermute(x: torch.Tensor, axis: AxisName, perm, *,
             mesh=None) -> torch.Tensor:
    """Send x from axis index ``src`` to ``dst`` for each pair of ``perm``;
    a rank no pair sends to gets zeros."""
    mesh = _mesh(mesh)
    _count("ppermute", _nbytes(x))
    a = _one_axis(axis, "ppermute")
    perm = tuple((int(s), int(d)) for s, d in perm)
    return _Permute.apply(x, mesh.get_group(a), mesh.get_local_rank(a), perm)


def shift(x: torch.Tensor, axis: AxisName, offset: int = 1, *,
          mesh=None) -> torch.Tensor:
    """Rotate values around the ring by ``offset`` (the KV-rotation
    primitive of ring attention)."""
    n = axis_size(axis, mesh=mesh)
    return ppermute(x, axis, [(i, (i + offset) % n) for i in range(n)],
                    mesh=mesh)


def all_to_all(x: torch.Tensor, axis: AxisName, *, split_axis: int,
               concat_axis: int, tiled: bool = True,
               mesh=None) -> torch.Tensor:
    """Split ``split_axis`` into one piece per rank, send piece j to rank j,
    and concatenate what arrives along ``concat_axis`` (tiled only)."""
    if not tiled:
        raise ValueError("all_to_all is tiled only")
    mesh = _mesh(mesh)
    _count("all_to_all", _nbytes(x))
    a = _one_axis(axis, "all_to_all")
    return _AllToAll.apply(x, mesh.get_group(a), axis_size(a, mesh=mesh),
                           split_axis, concat_axis)


def axis_index(axis: AxisName = "dp", *, mesh=None) -> int:
    """This rank's index along the axis (over a tuple: the combined index,
    the first axis the major one)."""
    mesh = _mesh(mesh)
    index = 0
    for a in _axes(axis):
        index = index * mesh_axis_size(mesh, a) + mesh.get_local_rank(a)
    return index


def axis_size(axis: AxisName = "dp", *, mesh=None) -> int:
    mesh = _mesh(mesh)
    n = 1
    for a in _axes(axis):
        n *= mesh_axis_size(mesh, a)
    return n


# ------------------------------------------------------------- host level

class CollectiveGroup:
    """Host-side barrier and object broadcast between the processes of an
    SPMD group, on a ``torch.distributed`` store (default: the process
    group's). The JAX package keeps these keys in its runtime's KV store,
    which the port has not copied (ROADMAP Queue 1 item 8); the keys and
    timeouts are the same."""

    def __init__(self, group_name: str, world_size: int, rank: int,
                 store: Optional[dist.Store] = None):
        self.group_name = group_name
        self.world_size = world_size
        self.rank = rank
        self._store = store
        self._epoch = 0

    def _kv(self) -> dist.Store:
        if self._store is None:
            self._store = dist.distributed_c10d._get_default_store()
        return self._store

    def barrier(self, timeout_s: float = 120.0):
        _count("host_barrier")
        store = self._kv()
        self._epoch += 1
        prefix = f"__collective__/{self.group_name}/barrier/{self._epoch}/"
        store.set(prefix + str(self.rank), b"1")
        keys = [prefix + str(r) for r in range(self.world_size)]
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if store.check(keys):
                return
            time.sleep(0.01)
        raise TimeoutError(
            f"collective barrier {self.group_name!r} timed out "
            f"({self.world_size} ranks expected)"
        )

    def broadcast_obj(self, obj: Any = None, root: int = 0,
                      timeout_s: float = 120.0):
        store = self._kv()
        key = f"__collective__/{self.group_name}/bcast/{self._epoch}"
        if self.rank == root:
            blob = pickle.dumps(obj)
            _count("host_broadcast", len(blob))
            store.set(key, blob)
            return obj
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if store.check([key]):
                return pickle.loads(store.get(key))
            time.sleep(0.01)
        raise TimeoutError(f"broadcast in {self.group_name!r} timed out")


def init_collective_group(world_size: int, rank: int,
                          group_name: str = "default",
                          store: Optional[dist.Store] = None,
                          ) -> CollectiveGroup:
    return CollectiveGroup(group_name, world_size, rank, store)
