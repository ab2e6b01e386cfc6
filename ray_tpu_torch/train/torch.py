"""Train-loop utilities (counterpart of ``ray_tpu/train/torch.py``):
``get_device``, ``prepare_model`` and ``prepare_data_loader``. The
trainer itself is :class:`~.trainer.TorchTrainer`."""

from __future__ import annotations

import torch

from .._device import resolve_device
from . import session as _session_mod


def get_device() -> torch.device:
    """The device this rank trains on: the CPU in a rank whose
    ``ScalingConfig`` has ``use_gpu=False``; otherwise (a ``use_gpu`` rank,
    or outside a session) the card this process sees, raising without
    one."""
    sess = _session_mod._session
    if sess is not None and not sess.use_gpu:
        return torch.device("cpu")
    return resolve_device(None)


def prepare_model(model: torch.nn.Module) -> torch.nn.Module:
    """Move the model to the rank's device and, at world size above 1,
    wrap it in ``DistributedDataParallel``."""
    import torch.distributed as dist

    device = get_device()
    model = model.to(device)
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel

        ids = [device.index] if device.type == "cuda" else None
        return DistributedDataParallel(model, device_ids=ids)
    return model


def prepare_data_loader(data_loader):
    """Shard a DataLoader across ranks with a DistributedSampler."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return data_loader
    from torch.utils.data import DataLoader
    from torch.utils.data.distributed import DistributedSampler

    if isinstance(data_loader.sampler, DistributedSampler):
        return data_loader
    return DataLoader(
        data_loader.dataset,
        batch_size=data_loader.batch_size,
        sampler=DistributedSampler(data_loader.dataset),
        num_workers=data_loader.num_workers,
        collate_fn=data_loader.collate_fn,
        pin_memory=data_loader.pin_memory,
        drop_last=data_loader.drop_last,
    )
