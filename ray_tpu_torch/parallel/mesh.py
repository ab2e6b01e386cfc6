"""The device mesh (counterpart of ``ray_tpu/parallel/mesh.py``).

One ``torch.distributed.device_mesh.DeviceMesh`` over the process group's
ranks, one rank a device, whose named dims carry every parallelism strategy:

    dp    data parallel (replica groups)
    fsdp  fully sharded data parallel (parameters sharded, ZeRO-3 style)
    ep    expert parallel (MoE expert placement)
    pp    pipeline parallel (layer stages)
    sp    sequence/context parallel (the ring attention axis)
    tp    tensor parallel (innermost: the nearest neighbours)

``tp`` is last, so a tensor-parallel group is consecutive ranks, which on
one host are the cards joined most closely.

The process group comes from the caller: a multi-process program calls
``torch.distributed.init_process_group`` (its address, world size and rank
given explicitly) before :func:`make_mesh`. A program that has not made one
gets a world of one process, which :func:`make_mesh` starts on a localhost
store; ``torch.distributed.destroy_process_group()`` ends it. A mesh of
CUDA devices runs on NCCL and a mesh of CPU devices on gloo: a CUDA mesh in
a world without NCCL raises instead of running on gloo.
"""

from __future__ import annotations

import dataclasses
import math
import socket
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .._device import DeviceLike, resolve_device

AXIS_ORDER: Tuple[str, ...] = ("dp", "fsdp", "ep", "pp", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes per parallelism axis; -1 on at most one axis means "absorb all
    remaining devices"."""

    dp: int = -1
    fsdp: int = 1
    ep: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1

    def sizes(self) -> Tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXIS_ORDER)

    def resolve(self, n_devices: int) -> "MeshConfig":
        sizes = list(self.sizes())
        wildcard = [i for i, s in enumerate(sizes) if s == -1]
        if len(wildcard) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = math.prod(s for s in sizes if s != -1)
        if wildcard:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}"
                )
            sizes[wildcard[0]] = n_devices // fixed
        elif fixed > n_devices:
            raise ValueError(
                f"mesh {dict(zip(AXIS_ORDER, sizes))} needs {fixed} devices, "
                f"have {n_devices}"
            )
        # fixed < n_devices with all axes explicit: use a device subset.
        return MeshConfig(**dict(zip(AXIS_ORDER, sizes)))


_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _world(device_type: str) -> int:
    """The process group's size, after starting a world of one process on
    a localhost store if there is none; raises if the group's backend
    cannot carry ``device_type``'s tensors."""
    backend = _BACKENDS[device_type]
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}", rank=0,
            world_size=1)
    have = str(dist.get_backend())
    if backend not in have:
        raise RuntimeError(
            f"a {device_type} mesh needs a {backend} process group; this one "
            f"runs {have}")
    return dist.get_world_size()


def make_mesh(config: Optional[MeshConfig] = None, *,
              device: DeviceLike = None, **axis_sizes: int) -> DeviceMesh:
    """Build the global mesh over the process group's ranks.

    make_mesh(dp=2, tp=4) or make_mesh(MeshConfig(...)). Unspecified axes
    default to 1; dp absorbs leftover ranks unless explicitly set.
    ``device=None`` means the CUDA card (NCCL); ``device="cpu"`` gloo.
    A mesh that needs more ranks than the world has raises, as
    :meth:`MeshConfig.resolve` does; one that needs fewer takes the first
    ranks."""
    if config is None:
        config = MeshConfig(**axis_sizes) if axis_sizes else MeshConfig()
    device_type = resolve_device(device).type
    if device_type not in _BACKENDS:
        raise ValueError(f"a mesh runs on cuda or cpu, not {device_type}")
    config = config.resolve(_world(device_type))
    shape = config.sizes()
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXIS_ORDER)


def single_device_mesh(device: DeviceLike = None) -> DeviceMesh:
    """A mesh of every axis 1 on rank 0's device."""
    return make_mesh(MeshConfig(dp=1), device=device)


def mesh_axis_size(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes across which the global batch is split (dp + fsdp: fsdp ranks
    see distinct data shards, ZeRO-style)."""
    return (tuple(a for a in ("dp", "fsdp") if mesh_axis_size(mesh, a) > 1)
            or ("dp",))


def num_data_shards(mesh) -> int:
    return mesh_axis_size(mesh, "dp") * mesh_axis_size(mesh, "fsdp")
