"""File write sinks (counterpart of the parts of ``ray_tpu/data/datasink.py``
that need no pyarrow: ``.npy`` files).

Ref analogue: python/ray/data/dataset.py write_numpy over
_internal/datasource/numpy_datasink.py. Each block is written by its own
remote task directly from wherever it lives (the write is distributed —
data never funnels through the driver), producing one
``part-NNNNN.<ext>`` file per block, the reference's file layout.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..core import api as _api
from .streaming_executor import ExecStats, execute_refs, use_remote


def _write_block(block, path: str, fmt: str, index: int) -> str:
    if fmt != "npy":
        raise ValueError(f"unknown sink format {fmt!r}")
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"part-{index:05d}.{fmt}")
    if len(block) == 1:
        np.save(fname, next(iter(block.values())))
    else:
        fname = fname[:-len(".npy")] + ".npz"
        np.savez(fname, **block)
    return fname


def write_blocks(dataset, path: str, fmt: str) -> List[str]:
    """Stream the dataset's blocks through per-block write tasks; returns
    the written file paths."""
    path = os.path.abspath(path)
    stats = ExecStats()
    dataset._last_stats = stats
    items = execute_refs(dataset._sources, dataset._stages, stats)
    if not use_remote():
        return [_write_block(b, path, fmt, i) for i, b in enumerate(items)]
    writer = _api.remote(_write_block)
    return _api.get([writer.remote(item, path, fmt, i)
                     for i, item in enumerate(items)])
