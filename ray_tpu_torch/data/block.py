"""Blocks: the unit of distributed data (counterpart of
``ray_tpu/data/block.py``).

The JAX package's Block is a ``pyarrow.Table``; the port has no pyarrow,
so a Block here is a columnar ``Dict[str, np.ndarray]`` whose columns all
have the same length. A tensor column is an n-dimensional array (its
first axis the rows). Strings, bytes and the nulls that ``from_rows``'
union of keys leaves are object arrays of Python values (``None`` for a
null), which is what the JAX package's arrow columns give back through
``to_numpy``. :class:`BlockAccessor` hands out read-only views, as the
JAX package's arrow views are read-only: copy before writing in place.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, NamedTuple, Tuple

import numpy as np

Block = Dict[str, np.ndarray]


def _column(values) -> np.ndarray:
    arr = np.asarray(values)
    if arr.dtype.kind in "US":  # arrow's string/binary: Python objects
        arr = arr.astype(object)
    return arr


def from_numpy_dict(data: Dict[str, Any]) -> Block:
    """Build a block from named arrays (tensor columns allowed)."""
    out: Block = {}
    n = None
    for name, values in data.items():
        arr = _column(values)
        if arr.ndim == 0:
            raise ValueError(f"column {name!r} is a scalar, not a column")
        n = len(arr) if n is None else n
        if len(arr) != n:
            raise ValueError("column length mismatch")
        out[name] = arr
    return out


def _object_column(values: list) -> np.ndarray:
    arr = np.empty(len(values), dtype=object)
    arr[:] = values
    return arr


def from_rows(rows: List[Dict[str, Any]]) -> Block:
    """Rows to a block. The columns are the UNION of the rows' keys, in
    first-seen order (the first row alone would drop fields it lacks); a
    row without a key holds None there."""
    if not rows:
        return {}
    names: List[str] = []
    for r in rows:
        for k in r:
            if k not in names:
                names.append(k)
    out: Block = {}
    for k in names:
        v = [r.get(k) for r in rows]
        if any(isinstance(x, (bytes, bytearray)) for x in v):
            # bytes stay bytes (numpy's |S strips trailing NULs); str
            # values beside them encode as utf-8.
            out[k] = _object_column(
                [None if x is None
                 else x.encode() if isinstance(x, str) else bytes(x)
                 for x in v])
            continue
        try:
            arr = _column(v)
        except ValueError:  # ragged nested values
            arr = None
        out[k] = arr if arr is not None and arr.dtype != object \
            else _object_column(v)
    return out


class Schema(NamedTuple):
    """Column names with each column's dtype and per-row shape."""

    names: List[str]
    types: List[Tuple[np.dtype, Tuple[int, ...]]]

    def __repr__(self):
        cols = ", ".join(f"{n}: {d}{list(s) if s else ''}"
                         for n, (d, s) in zip(self.names, self.types))
        return f"Schema({cols})"


class BlockAccessor:
    """Read-side view over a block (ref: data/block.py BlockAccessor)."""

    def __init__(self, block: Block):
        self.block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    def num_rows(self) -> int:
        for arr in self.block.values():
            return len(arr)
        return 0

    def size_bytes(self) -> int:
        return sum(arr.nbytes for arr in self.block.values())

    def schema(self) -> Schema:
        return Schema(list(self.block),
                      [(a.dtype, a.shape[1:]) for a in self.block.values()])

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """The columns as read-only views (a new dict: adding or removing
        keys does not touch the block)."""
        out = {}
        for name, arr in self.block.items():
            view = arr.view()
            view.flags.writeable = False
            out[name] = view
        return out

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        cols = self.to_numpy()
        for i in range(self.num_rows()):
            yield {k: v[i] for k, v in cols.items()}

    def slice(self, start: int, end: int) -> Block:
        return {k: v[start:end] for k, v in self.block.items()}

    def take(self, idx) -> Block:
        idx = np.asarray(idx, dtype=np.int64)
        return {k: v[idx] for k, v in self.block.items()}


def concat_blocks(blocks: List[Block]) -> Block:
    """One block of ``blocks``' rows in order, with the first non-empty
    block's columns."""
    blocks = [b for b in blocks if BlockAccessor(b).num_rows() > 0] \
        or blocks[:1]
    if len(blocks) == 1:
        return blocks[0]
    return {k: np.concatenate([b[k] for b in blocks])
            for k in blocks[0]}


def normalize_to_block(data: Any) -> Block:
    """Accept a batch in any supported user format."""
    if isinstance(data, dict):
        return from_numpy_dict(data)
    if isinstance(data, np.ndarray):
        return from_numpy_dict({"data": data})
    if isinstance(data, list):
        return from_rows(
            [r if isinstance(r, dict) else {"item": r} for r in data])
    raise TypeError(f"cannot convert {type(data)} to a Block")


def batch_to_format(block: Block, batch_format: str):
    """``"numpy"`` (or ``"default"``): ``{name: array}``; ``"rows"``: a
    list of row dicts. ``"pandas"`` and ``"pyarrow"`` need packages the
    port does without, and raise."""
    acc = BlockAccessor(block)
    if batch_format in ("numpy", "default"):
        return acc.to_numpy()
    if batch_format == "rows":
        return list(acc.iter_rows())
    if batch_format in ("pandas", "pyarrow", "arrow"):
        package = "pandas" if batch_format == "pandas" else "pyarrow"
        raise ValueError(
            f"batch_format={batch_format!r} needs {package}, which the "
            "port does not use; take 'numpy' or 'rows'")
    raise ValueError(f"unknown batch_format {batch_format!r}")
