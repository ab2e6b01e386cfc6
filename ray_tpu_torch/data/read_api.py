"""Data sources (counterpart of the parts of ``ray_tpu/data/read_api.py``
that need no pyarrow, pandas or outside service).

Ref analogue: python/ray/data/read_api.py (read_binary_files, from_items,
range, from_numpy, read_numpy, from_torch). Each block, or each file,
becomes one source: a module-level callable class holding its arguments,
so a read travels by reference and executes lazily inside the fused block
task.
"""

from __future__ import annotations

import builtins
import glob as _glob
import os
from typing import Any, Dict, List

import numpy as np

from .block import from_numpy_dict, from_rows
from .dataset import Dataset

# This module defines its own `range` (the Dataset source, matching the
# reference API name) — internal loops use the builtin via this alias.
_range = builtins.range


def _expand_paths(paths) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(
                sorted(
                    os.path.join(p, f)
                    for f in os.listdir(p)
                    if not f.startswith(".")
                )
            )
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths}")
    return out


class _ItemsSource:
    def __init__(self, items: List[Any]):
        self.items = items

    def __call__(self):
        return from_rows(
            [r if isinstance(r, dict) else {"item": r} for r in self.items])


class _RangeSource:
    def __init__(self, lo: int, hi: int):
        self.lo = lo
        self.hi = hi

    def __call__(self):
        return from_numpy_dict(
            {"id": np.arange(self.lo, self.hi, dtype=np.int64)})


class _ArraySource:
    def __init__(self, column: str, array: np.ndarray):
        self.column = column
        self.array = array

    def __call__(self):
        return from_numpy_dict({self.column: self.array})


class _NumpyFileSource:
    def __init__(self, path: str):
        self.path = path

    def __call__(self):
        return from_numpy_dict({"data": np.load(self.path)})


class _BinaryFileSource:
    def __init__(self, path: str, include_paths: bool):
        self.path = path
        self.include_paths = include_paths

    def __call__(self):
        with open(self.path, "rb") as f:
            data = f.read()
        row: Dict[str, Any] = {"bytes": data}
        if self.include_paths:
            row["path"] = self.path
        return from_rows([row])


def from_items(items: List[Any], *, override_num_blocks: int = 8) -> Dataset:
    n = min(override_num_blocks, max(1, len(items)))
    chunks = [items[i::n] for i in _range(n)]
    return Dataset([_ItemsSource(c) for c in chunks if c])


def range(n: int, *, override_num_blocks: int = 8) -> Dataset:  # noqa: A001
    nb = min(override_num_blocks, max(1, n))
    bounds = np.linspace(0, n, nb + 1, dtype=np.int64)
    return Dataset(
        [_RangeSource(int(lo), int(hi))
         for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]
    )


def from_numpy(arr: np.ndarray, *, column: str = "data",
               override_num_blocks: int = 8) -> Dataset:
    nb = min(override_num_blocks, max(1, len(arr)))
    return Dataset([_ArraySource(column, c)
                    for c in np.array_split(arr, nb) if len(c)])


def read_numpy(paths, **kw) -> Dataset:
    return Dataset([_NumpyFileSource(p) for p in _expand_paths(paths)])


def read_binary_files(paths, *, include_paths: bool = False) -> Dataset:
    return Dataset([_BinaryFileSource(p, include_paths)
                    for p in _expand_paths(paths)])


def from_torch(torch_dataset, *, override_num_blocks: int = 8
               ) -> Dataset:
    """Materialize a torch map-style Dataset (ref: ray.data.from_torch).
    Rows become {"item": value} with tensors converted to numpy."""

    def to_row(x):
        if hasattr(x, "numpy"):
            x = x.numpy()
        elif isinstance(x, (tuple, list)):
            x = type(x)(v.numpy() if hasattr(v, "numpy") else v for v in x)
        return {"item": x if isinstance(x, (tuple, list)) else np.asarray(x)}

    rows = [to_row(torch_dataset[i]) for i in _range(len(torch_dataset))]
    return from_items(rows, override_num_blocks=override_num_blocks)
