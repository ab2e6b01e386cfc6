"""DataIterator: a per-worker shard view of a Dataset (counterpart of
``ray_tpu/data/iterator.py``).

Ref analogue: python/ray/data/iterator.py DataIterator (iter_batches:98,
iter_torch_batches:242). Picklable (it carries the lazy plan, by
reference) so trainers ship it to their ranks; blocks execute where the
iterator is consumed. Flat plans shard by source stride; DAG plans
(union/zip) stream through ONE shared ``_SplitCoordinator`` actor that
executes the plan once and deals blocks round-robin (ref analogue: the
OutputSplitter behind Dataset.streaming_split) — nothing materializes up
front, and a full shard buffer stalls the upstream pull so backpressure
propagates through the split. The coordinator is created with
``max_concurrency=n + 1``: each shard's ``next_for`` call blocks on its
own thread until its buffer holds a block.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, Iterator

from ..core import api as _api


class _SplitCoordinator:
    """Actor: executes a (DAG) plan's block stream once and serves
    shards round-robin with small bounded buffers. The puller thread
    blocks while its next target's buffer is full, so a slow shard
    backpressures the whole stream instead of buffering it."""

    def __init__(self, dataset, num_shards: int, maxbuf: int = 4):
        self._ds = dataset
        self._n = num_shards
        self._maxbuf = maxbuf
        self._bufs = [collections.deque() for _ in range(num_shards)]
        self._cv = threading.Condition()
        self._done = False
        self._error = None
        self._puller = threading.Thread(target=self._pull, daemon=True)
        self._puller.start()

    def _pull(self):
        try:
            target = 0
            for ref in self._ds.iter_blocks_refs():
                with self._cv:
                    while len(self._bufs[target]) >= self._maxbuf:
                        self._cv.wait(timeout=1.0)
                    self._bufs[target].append(ref)
                    self._cv.notify_all()
                target = (target + 1) % self._n
        except Exception as e:  # noqa: BLE001 — raised in every shard
            self._error = e
        finally:
            with self._cv:
                self._done = True
                self._cv.notify_all()

    def next_for(self, shard: int):
        """Next block ref for ``shard`` (None = exhausted)."""
        with self._cv:
            while not self._bufs[shard] and not self._done:
                self._cv.wait(timeout=1.0)
            if self._error is not None:
                raise self._error
            if self._bufs[shard]:
                self._cv.notify_all()  # the puller may wait for this room
                return self._bufs[shard].popleft()
            return None


class _CoordinatorShard:
    """The block stream of one coordinator shard."""

    def __init__(self, coord, shard_index: int):
        self._coord = coord
        self._shard_index = shard_index

    def iter_blocks(self):
        while True:
            ref = _api.get(self._coord.next_for.remote(self._shard_index),
                           timeout=600)
            if ref is None:
                return
            yield _api.get(ref)


class DataIterator:
    def __init__(self, dataset, shard_index: int, num_shards: int,
                 coordinator=None):
        self._dataset = dataset
        self.shard_index = shard_index
        self.num_shards = num_shards
        self._coordinator = coordinator

    def _shard(self):
        from .dataset import Dataset

        ds = self._dataset
        if self._coordinator is not None:
            # Stream through the shared coordinator: reuse Dataset's
            # batching by standing the shard's pulled blocks in for the
            # plan's execution.
            shard = _CoordinatorShard(self._coordinator, self.shard_index)
            out = Dataset([], _pin=ds._pin)
            out._iter_blocks = shard.iter_blocks  # type: ignore
            return out
        return Dataset(
            ds._sources[self.shard_index:: self.num_shards],
            list(ds._stages), _pin=ds._pin,
        )

    def iter_batches(self, **kw) -> Iterator[Any]:
        return self._shard().iter_batches(**kw)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        return self._shard().iter_rows()

    def iter_torch_batches(self, **kw) -> Iterator[Any]:
        """``Dataset.iter_torch_batches`` over this shard: on the card
        unless ``device="cpu"``."""
        return self._shard().iter_torch_batches(**kw)

    def count(self) -> int:
        return self._shard().count()

    def materialize(self):
        if self._coordinator is not None:
            from .dataset import Dataset

            return Dataset.from_blocks(list(self._shard()._iter_blocks()))
        return self._shard().materialize()

    def __repr__(self):
        return (f"DataIterator(shard={self.shard_index}/"
                f"{self.num_shards})")
