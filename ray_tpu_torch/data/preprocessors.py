"""Dataset preprocessors (counterpart of ``ray_tpu/data/preprocessors.py``,
numpy only). The per-block statistics are module-level callables, so a
fit runs as remote tasks under the port's runtime.

Ref analogue: python/ray/data/preprocessor.py Preprocessor (fit/transform
statefulness) + data/preprocessors/{scaler,encoder,concatenator,chain}.py.
``fit`` computes statistics WITH the dataset's own distributed aggregates
(blocks stream through remote tasks; only the per-column stats come back
to the driver); ``transform`` appends a fused per-batch op to the plan.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Preprocessor:
    """Base: fit() learns state from a Dataset, transform() applies it
    lazily as a map_batches stage."""

    _fitted = False

    def fit(self, ds) -> "Preprocessor":
        self._fit(ds)
        self._fitted = True
        return self

    def transform(self, ds):
        if not self._fitted and self._needs_fit():
            raise RuntimeError(
                f"{type(self).__name__} must be fit before transform"
            )
        return ds.map_batches(self._transform_numpy)

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def transform_batch(self, batch: Dict[str, np.ndarray]):
        """Apply to one in-memory batch (serving-time path; ref:
        preprocessor.py transform_batch)."""
        return self._transform_numpy(dict(batch))

    # -- subclass hooks --

    def _needs_fit(self) -> bool:
        return True

    def _fit(self, ds) -> None:
        raise NotImplementedError

    def _transform_numpy(self, batch: Dict[str, np.ndarray]):
        raise NotImplementedError


class _ColumnMoments:
    """Per block: each column's sum/sumsq/min/max/count."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)

    def __call__(self, batch: Dict[str, np.ndarray]):
        out = {}
        for c in self.columns:
            v = batch[c].astype(np.float64)
            out[f"{c}/sum"] = np.asarray([v.sum()])
            out[f"{c}/sumsq"] = np.asarray([(v * v).sum()])
            out[f"{c}/min"] = np.asarray(
                [v.min() if v.size else np.inf]
            )
            out[f"{c}/max"] = np.asarray(
                [v.max() if v.size else -np.inf]
            )
            out[f"{c}/count"] = np.asarray([float(v.size)])
        return out


class _Uniques:
    """Per block: one column's distinct values."""

    def __init__(self, column: str):
        self.column = column

    def __call__(self, batch):
        return {"u": np.unique(batch[self.column])}


def _col_stats(ds, columns: List[str]) -> Dict[str, Dict[str, float]]:
    """One streaming pass computing per-column aggregates
    (sum/sumsq/min/max/count — one fused pass covers every scaler)."""
    parts = ds.map_batches(_ColumnMoments(columns),
                           batch_size=None).to_numpy()
    stats: Dict[str, Dict[str, float]] = {}
    for c in columns:
        stats[c] = {
            "sum": float(parts[f"{c}/sum"].sum()),
            "sumsq": float(parts[f"{c}/sumsq"].sum()),
            "min": float(parts[f"{c}/min"].min()),
            "max": float(parts[f"{c}/max"].max()),
            "count": float(parts[f"{c}/count"].sum()),
        }
    return stats


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (ref: preprocessors/scaler.py)."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds) -> None:
        stats = _col_stats(ds, self.columns)
        for c, s in stats.items():
            mean = s["sum"] / max(s["count"], 1.0)
            var = s["sumsq"] / max(s["count"], 1.0) - mean * mean
            self.stats_[c] = (mean, float(np.sqrt(max(var, 0.0))))

    def _transform_numpy(self, batch):
        for c, (mean, std) in self.stats_.items():
            if c in batch:
                batch[c] = (batch[c] - mean) / (std or 1.0)
        return batch


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.stats_: Dict[str, tuple] = {}

    def _fit(self, ds) -> None:
        stats = _col_stats(ds, self.columns)
        for c, s in stats.items():
            self.stats_[c] = (s["min"], s["max"])

    def _transform_numpy(self, batch):
        for c, (lo, hi) in self.stats_.items():
            if c in batch:
                span = (hi - lo) or 1.0
                batch[c] = (batch[c] - lo) / span
        return batch


class LabelEncoder(Preprocessor):
    """Categorical column -> dense int codes (ref: encoder.py)."""

    def __init__(self, label_column: str):
        self.label_column = label_column
        self.classes_: Optional[np.ndarray] = None

    def _fit(self, ds) -> None:
        parts = ds.map_batches(_Uniques(self.label_column),
                               batch_size=None).to_numpy()
        self.classes_ = np.unique(parts["u"])

    def _transform_numpy(self, batch):
        c = self.label_column
        batch[c] = np.searchsorted(self.classes_, batch[c])
        return batch


class OneHotEncoder(Preprocessor):
    """Categorical columns -> one-hot float matrices."""

    def __init__(self, columns: List[str]):
        self.columns = list(columns)
        self.classes_: Dict[str, np.ndarray] = {}

    def _fit(self, ds) -> None:
        for c in self.columns:
            parts = ds.map_batches(_Uniques(c), batch_size=None).to_numpy()
            self.classes_[c] = np.unique(parts["u"])

    def _transform_numpy(self, batch):
        for c, classes in self.classes_.items():
            codes = np.searchsorted(classes, batch[c])
            eye = np.eye(len(classes), dtype=np.float32)
            batch[c] = eye[codes]
        return batch


class Concatenator(Preprocessor):
    """Concatenate feature columns into one 2-D matrix column (ref:
    preprocessors/concatenator.py — the trainer-ingest adapter)."""

    def __init__(self, columns: List[str], *, output_column_name: str =
                 "concat_out", dtype=np.float32):
        self.columns = list(columns)
        self.output_column_name = output_column_name
        self.dtype = dtype

    def _needs_fit(self) -> bool:
        return False

    def _fit(self, ds) -> None:
        pass

    def _transform_numpy(self, batch):
        mats = []
        for c in self.columns:
            v = np.asarray(batch.pop(c))
            if v.ndim == 1:
                v = v[:, None]
            mats.append(v.astype(self.dtype))
        batch[self.output_column_name] = np.concatenate(mats, axis=1)
        return batch


class Chain(Preprocessor):
    """Sequential composition of preprocessors (ref: chain.py)."""

    def __init__(self, *preprocessors: Preprocessor):
        self.preprocessors = list(preprocessors)

    def fit(self, ds) -> "Chain":
        # Each stage fits on the data as transformed by the previous ones.
        cur = ds
        for p in self.preprocessors:
            p.fit(cur)
            cur = p.transform(cur)
        self._fitted = True
        return self

    def _fit(self, ds) -> None:  # pragma: no cover - fit() overridden
        pass

    def transform(self, ds):
        for p in self.preprocessors:
            ds = p.transform(ds)
        return ds

    def _transform_numpy(self, batch):
        for p in self.preprocessors:
            batch = p._transform_numpy(batch)
        return batch
