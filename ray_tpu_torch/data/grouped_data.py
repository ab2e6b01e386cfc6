"""GroupedData aggregates (counterpart of ``ray_tpu/data/grouped_data.py``;
ref analogue: python/ray/data/grouped_data.py +
data/aggregate/_aggregate.py — count/sum/min/max/mean/std + map_groups).

Aggregates run DISTRIBUTED as a combiner tree: each block reduces to a
tiny per-key partial table inside its own task (one streaming pass, all
five moments at once), and only those partials merge on the driver —
the input never materializes centrally. ``map_groups`` (which needs whole
groups) hash-shuffles rows by key across tasks first (shuffle.py), then
applies the UDF per group within each partition.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from .block import BlockAccessor, concat_blocks, from_rows, normalize_to_block


def _partial_agg(batch: Dict[str, np.ndarray], key: str, on):
    """Per-block combiner: per-key (count, sum, sumsq, min, max).

    Integer columns accumulate sums in int64 (no float precision loss);
    non-numeric columns (strings) support min/max/count only — their
    sum/sumsq partials are None."""
    keys = batch[key]
    raw = (np.asarray(batch[on]) if on is not None
           else np.zeros(len(keys)))
    uniq, inv = np.unique(keys, return_inverse=True)
    inv = inv.reshape(-1)
    n = len(uniq)
    numeric = raw.dtype.kind in "biuf"
    out: Dict = {
        key: uniq,
        "_count": np.bincount(inv, minlength=n).astype(np.int64),
    }
    if numeric:
        if raw.dtype.kind in "biu":
            sums = np.zeros(n, dtype=np.int64)
            np.add.at(sums, inv, raw.astype(np.int64))
        else:
            sums = np.bincount(inv, weights=raw.astype(np.float64),
                               minlength=n)
        out["_sum"] = sums
        out["_sumsq"] = np.bincount(
            inv, weights=raw.astype(np.float64) ** 2, minlength=n
        )
        mins = np.full(n, np.inf)
        maxs = np.full(n, -np.inf)
        np.minimum.at(mins, inv, raw.astype(np.float64))
        np.maximum.at(maxs, inv, raw.astype(np.float64))
        if raw.dtype.kind in "biu":
            mins = mins.astype(np.int64)
            maxs = maxs.astype(np.int64)
        out["_min"] = mins
        out["_max"] = maxs
    else:
        # Lexicographic min/max per group; sums undefined.
        out["_sum"] = np.asarray([None] * n, dtype=object)
        out["_sumsq"] = np.asarray([None] * n, dtype=object)
        out["_min"] = np.asarray(
            [raw[inv == g].min() for g in range(n)], dtype=object
        )
        out["_max"] = np.asarray(
            [raw[inv == g].max() for g in range(n)], dtype=object
        )
    return out


class _PartialAgg:
    """The per-block combiner as a map_batches function."""

    def __init__(self, key: str, on):
        self.key = key
        self.on = on

    def __call__(self, batch):
        return _partial_agg(batch, self.key, self.on)


class _ApplyGroups:
    """Runs inside the shuffle's reduce step: every row of a key lives in
    exactly one hash partition, so per-partition grouping is globally
    correct."""

    def __init__(self, fn, key):
        self.fn = fn
        self.key = key

    def __call__(self, block):
        cols = BlockAccessor(block).to_numpy()
        keys = cols[self.key]
        out = []
        for k in np.unique(keys):
            idx = np.nonzero(keys == k)[0]
            group = {c: v[idx] for c, v in cols.items()}
            out.append(normalize_to_block(self.fn(group)))
        if not out:
            return block
        return concat_blocks(out)


def _sum(m, on):
    if m["sum"] is None:
        raise TypeError(f"sum() on non-numeric column {on!r}")
    return m["sum"]


def _mean(m, on):
    if m["sum"] is None:
        raise TypeError(f"mean() on non-numeric column {on!r}")
    return float(m["sum"]) / max(m["count"], 1)


def _std(m, on):
    if m["sum"] is None:
        raise TypeError(f"std() on non-numeric column {on!r}")
    mean = float(m["sum"]) / max(m["count"], 1)
    var = m["sumsq"] / max(m["count"], 1) - mean * mean
    return float(np.sqrt(max(var, 0.0)))


class GroupedData:
    def __init__(self, dataset, key: str):
        self._dataset = dataset
        self._key = key

    # ---- distributed combiner-tree aggregates ----

    def _partials(self, on):
        key = self._key
        # batch_size=None: one combiner pass per block.
        rows = self._dataset.map_batches(
            _PartialAgg(key, on), batch_size=None
        ).take_all()
        merged: Dict = {}
        for r in rows:
            k = r[key]
            k = k.item() if hasattr(k, "item") else k
            m = merged.setdefault(
                k, {"count": 0, "sum": None, "sumsq": 0.0,
                    "min": None, "max": None}
            )
            m["count"] += int(r["_count"])
            if r["_sum"] is not None:
                m["sum"] = (r["_sum"] if m["sum"] is None
                            else m["sum"] + r["_sum"])
                m["sumsq"] += float(r["_sumsq"])
            m["min"] = (r["_min"] if m["min"] is None
                        else min(m["min"], r["_min"]))
            m["max"] = (r["_max"] if m["max"] is None
                        else max(m["max"], r["_max"]))
        return merged

    def _finalize(self, on, name, fn):
        from .dataset import Dataset

        rows = [
            {self._key: k, f"{name}({on})": fn(m, on)}
            for k, m in sorted(self._partials(on).items())
        ]
        return Dataset.from_blocks([from_rows(rows)])

    def count(self):
        from .dataset import Dataset

        rows = [
            {self._key: k, "count()": int(m["count"])}
            for k, m in sorted(self._partials(None).items())
        ]
        return Dataset.from_blocks([from_rows(rows)])

    def sum(self, on: str):
        return self._finalize(on, "sum", _sum)

    def min(self, on: str):
        return self._finalize(on, "min", lambda m, _: m["min"])

    def max(self, on: str):
        return self._finalize(on, "max", lambda m, _: m["max"])

    def mean(self, on: str):
        return self._finalize(on, "mean", _mean)

    def std(self, on: str):
        return self._finalize(on, "std", _std)

    # ---- whole-group UDFs (hash shuffle) ----

    def map_groups(self, fn: Callable):
        from .dataset import Dataset

        ds = self._dataset
        if ds._use_remote():
            num = max(1, ds.num_blocks())
            return ds._shuffled(
                num, "hash", self._key,
                postprocess=_ApplyGroups(fn, self._key)
            )
        # Local: group over the materialized table.
        return Dataset.from_blocks(
            [_ApplyGroups(fn, self._key)(ds._materialize_table())]
        )
