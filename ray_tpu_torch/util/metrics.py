"""User-defined metrics (counterpart of ``ray_tpu/util/metrics.py``).

``Counter``, ``Gauge`` and ``Histogram`` record into one registry per
process, with the JAX package's names, kinds, tag keys and histogram
layout, and ``with_tags`` returns a bound recorder for hot paths.

The registry is process-local. The JAX package flushes each process's
registry to its runtime's KV store from a flusher thread, and
``get_metrics_report()`` aggregates every process's blob. The port's
runtime has no such KV flush, so nothing is flushed, no thread is
started, and ``get_metrics_report()`` reports this process's
registry in the JAX report's shape: ``{name: {"type", "series", "help"}}``.
"""

from __future__ import annotations

import copy
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple


class _Registry:
    def __init__(self):
        self.lock = threading.Lock()
        # name -> ("counter"|"gauge"|"histogram", {tags_key: value})
        self.metrics: Dict[str, Tuple[str, Dict]] = {}
        # name -> (kind, description), recorded at metric construction:
        # the `# HELP` lines and the metric-name lint read it.
        self.meta: Dict[str, Tuple[str, str]] = {}
        # Names re-declared or re-recorded under a conflicting kind.
        self.kind_conflicts: Dict[str, Tuple[str, str]] = {}
        self._warned_kinds: set = set()

    def declare(self, name: str, kind: str, description: str):
        with self.lock:
            old = self.meta.get(name)
            if old is not None and old[0] != kind:
                self.kind_conflicts[name] = (old[0], kind)
                self._warn_kind_conflict(name, old[0], kind)
                return
            if old is None or (description and not old[1]):
                self.meta[name] = (kind, description)

    def _warn_kind_conflict(self, name: str, old: str, new: str):
        # Caller holds self.lock.
        if name in self._warned_kinds:
            return
        self._warned_kinds.add(name)
        warnings.warn(
            f"metric {name!r} already registered as a {old}; ignoring "
            f"records under conflicting kind {new!r} (the series would "
            f"be corrupted)",
            UserWarning,
            stacklevel=3,
        )

    def record(self, name: str, kind: str, tags_key: tuple, update):
        with self.lock:
            kind_, series = self.metrics.setdefault(name, (kind, {}))
            if kind_ != kind:
                # A second metric object reused the name with another kind:
                # its update would write, say, a float into a histogram's
                # series. Warn once and drop.
                self.kind_conflicts[name] = (kind_, kind)
                self._warn_kind_conflict(name, kind_, kind)
                return
            series[tags_key] = update(series.get(tags_key))


_registry = _Registry()


class _Metric:
    KIND = ""

    def __init__(self, name: str, description: str = "",
                 tag_keys: Tuple[str, ...] = ()):
        self._name = name
        self._description = description
        self._tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        _registry.declare(name, self.KIND, description)

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> tuple:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        return tuple(sorted(merged.items()))


class _BoundCounter:
    """Pre-resolved (name, tags-key) counter handle; see
    ``Counter.with_tags``."""

    __slots__ = ("_name", "_key")

    def __init__(self, name: str, key: tuple):
        self._name = name
        self._key = key

    def inc(self, value: float = 1.0):
        _registry.record(
            self._name, "counter", self._key,
            lambda cur: (cur or 0.0) + value,
        )


class _BoundGauge:
    __slots__ = ("_name", "_key")

    def __init__(self, name: str, key: tuple):
        self._name = name
        self._key = key

    def set(self, value: float):
        _registry.record(self._name, "gauge", self._key, lambda cur: value)


class _BoundHistogram:
    __slots__ = ("_name", "_key", "_bounds")

    def __init__(self, name: str, key: tuple, bounds: List[float]):
        self._name = name
        self._key = key
        self._bounds = bounds

    def observe(self, value: float, exemplar: Optional[str] = None):
        Histogram._observe(self._name, self._bounds, self._key, value,
                           exemplar)


class Counter(_Metric):
    KIND = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None):
        _registry.record(
            self._name, self.KIND, self._key(tags),
            lambda cur: (cur or 0.0) + value,
        )

    def with_tags(self, **tags) -> _BoundCounter:
        """Resolve the tag set once and return a slim recorder: hot paths
        (the decode step's tap) skip the dict merge and sort that every
        ``inc`` pays otherwise."""
        return _BoundCounter(self._name, self._key(tags))


class Gauge(_Metric):
    KIND = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        _registry.record(
            self._name, self.KIND, self._key(tags), lambda cur: value
        )

    def with_tags(self, **tags) -> _BoundGauge:
        """Pre-resolved handle; see ``Counter.with_tags``."""
        return _BoundGauge(self._name, self._key(tags))


class Histogram(_Metric):
    KIND = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[List[float]] = None,
                 tag_keys: Tuple[str, ...] = ()):
        super().__init__(name, description, tag_keys)
        self._boundaries = sorted(boundaries or
                                  [0.01, 0.1, 1.0, 10.0, 100.0])

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None,
                exemplar: Optional[str] = None):
        """``exemplar`` is a trace id attached to the bucket this value
        lands in (OpenMetrics exemplar: the latest observation wins)."""
        self._observe(self._name, self._boundaries, self._key(tags),
                      value, exemplar)

    def with_tags(self, **tags) -> _BoundHistogram:
        """Pre-resolved handle; see ``Counter.with_tags``."""
        return _BoundHistogram(self._name, self._key(tags),
                               self._boundaries)

    @staticmethod
    def _observe(name: str, bounds: List[float], key: tuple, value: float,
                 exemplar: Optional[str] = None):
        ex_ts = time.time() if exemplar else 0.0

        def update(cur):
            cur = cur or {"count": 0, "sum": 0.0, "bounds": list(bounds),
                          "buckets": [0] * (len(bounds) + 1)}
            le: Any = "+Inf"
            for i, b in enumerate(bounds):
                if value <= b:
                    cur["buckets"][i] += 1
                    le = b
                    break
            else:
                cur["buckets"][-1] += 1
            cur["count"] += 1
            cur["sum"] += value
            if exemplar:
                cur.setdefault("exemplars", {})[le] = {
                    "trace_id": exemplar, "value": value, "ts": ex_ts,
                }
            return cur

        _registry.record(name, "histogram", key, update)


def declared_metrics() -> Dict[str, Tuple[str, str]]:
    """Every metric declared in this process: name -> (kind, description).
    The metric-name lint (``tools/check_metric_names.py``) reads this."""
    with _registry.lock:
        return dict(_registry.meta)


def declaration_conflicts() -> Dict[str, Tuple[str, str]]:
    """Names registered under two different kinds: name -> (old, new)."""
    with _registry.lock:
        return dict(_registry.kind_conflicts)


def _merge_histogram(cur: Dict, value: Dict) -> Dict:
    """Merge two histogram series points. Identical boundaries sum bucket
    by bucket; different boundaries merge on the union of bounds: each
    source bucket (b_{i-1}, b_i] lands in the union bucket whose upper
    edge is b_i, so cumulative counts stay exact at every original
    boundary. Exemplars merge by their ``le`` bound, the newest winning."""
    if cur.get("bounds", []) == value.get("bounds", []):
        return {
            "count": cur["count"] + value["count"],
            "sum": cur["sum"] + value["sum"],
            "bounds": list(cur.get("bounds", [])),
            "buckets": [
                a + b for a, b in zip(cur["buckets"], value["buckets"])
            ],
            **_merged_exemplars(cur, value),
        }
    bounds = sorted(set(cur.get("bounds", [])) | set(value.get("bounds", [])))
    index = {b: i for i, b in enumerate(bounds)}

    def rebucket(src: Dict) -> List[float]:
        out = [0] * (len(bounds) + 1)
        src_bounds = src.get("bounds", [])
        for i, c in enumerate(src["buckets"]):
            if i < len(src_bounds):
                out[index[src_bounds[i]]] += c
            else:
                out[-1] += c  # the overflow bucket maps to the union's
        return out

    return {
        "count": cur["count"] + value["count"],
        "sum": cur["sum"] + value["sum"],
        "bounds": bounds,
        "buckets": [a + b for a, b in zip(rebucket(cur), rebucket(value))],
        **_merged_exemplars(cur, value),
    }


def _merged_exemplars(cur: Dict, value: Dict) -> Dict:
    """Union of two points' exemplar maps (the newest ts wins per ``le``);
    {} when neither carries any, so the merged point has no "exemplars"
    key, like an unobserved series."""
    a = cur.get("exemplars") or {}
    b = value.get("exemplars") or {}
    if not a and not b:
        return {}
    merged = dict(a)
    for le, ex in b.items():
        old = merged.get(le)
        if old is None or ex.get("ts", 0.0) >= old.get("ts", 0.0):
            merged[le] = ex
    return {"exemplars": merged}


def merge_snapshot(out: Dict[str, Dict], snapshot: Dict) -> None:
    """Fold one registry snapshot (:func:`local_snapshot`) into a report
    accumulator: counters and histograms sum, gauges keep the latest
    write per tag set."""
    for name, item in snapshot.items():
        kind, series = item[0], item[1]
        help_ = item[2] if len(item) > 2 else ""
        entry = out.setdefault(
            name, {"type": kind, "series": {}, "help": ""}
        )
        if help_ and not entry.get("help"):
            entry["help"] = help_
        for tags_key, value in series.items():
            cur = entry["series"].get(tags_key)
            if kind == "counter":
                entry["series"][tags_key] = (cur or 0.0) + value
            elif kind == "gauge":
                entry["series"][tags_key] = value
            elif cur is None:  # histogram, first sighting
                entry["series"][tags_key] = dict(value)
            else:
                entry["series"][tags_key] = _merge_histogram(cur, value)


def local_snapshot() -> Dict[str, Tuple]:
    """This process's registry: name -> (kind, {tags_key: value}, help),
    a copy that later records leave unchanged."""
    with _registry.lock:
        return {
            name: (kind, copy.deepcopy(series) if kind == "histogram"
                   else dict(series),
                   _registry.meta.get(name, ("", ""))[1])
            for name, (kind, series) in _registry.metrics.items()
        }


def get_metrics_report() -> Dict[str, Dict]:
    """This process's metrics in the JAX package's report shape:
    ``{name: {"type", "series": {tags_key: value}, "help"}}``."""
    out: Dict[str, Dict] = {}
    merge_snapshot(out, local_snapshot())
    return out
