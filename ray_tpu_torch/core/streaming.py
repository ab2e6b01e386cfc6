"""Streaming generator returns (counterpart of ``ray_tpu/core/streaming.py``).

A task or actor method called with ``num_returns="streaming"`` returns an
:class:`ObjectRefGenerator`. Each value the call yields becomes an object
as soon as it is produced, and ``next()`` returns the next item's
``ObjectRef`` once that item exists, so the consumer reads results while
the producer still runs. An exception raised by the producer reaches the
consumer at the point where it was raised, after the items yielded before
it. Dropping the generator frees the items it never took.

The JAX package's producer seals each item in the object store and writes
a KV record that the consumer polls. The port's objects live in the
driver, so the worker sends each item over its connection to the driver
and the consumer waits on the driver's stream record
(``DriverRuntime.stream_next``), which a worker consumer reaches through
one request an item.
"""

from __future__ import annotations

import pickle
from typing import Optional

from .reference import ObjectRef
from .runtime_context import current_runtime


class ObjectRefGenerator:
    """Iterator over a streaming call's yielded ObjectRefs (ref:
    ObjectRefGenerator). ``next()`` returns the NEXT item's ObjectRef as
    soon as the producer made it; iteration ends when the producer's
    generator is exhausted, and a producer's exception is raised in its
    place. ``completed`` resolves to the item count (and surfaces the
    call's exception, if any)."""

    def __init__(self, completion_ref: ObjectRef):
        self._rt = current_runtime()
        self._completion_ref = completion_ref
        self._next = 0
        self._open = True
        # Optional per-item production deadline (serve SSE guard).
        self.item_timeout_s: Optional[float] = None

    @property
    def completed(self) -> ObjectRef:
        """The call's completion ref (item count / error carrier)."""
        return self._completion_ref

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        if not self._open:
            raise StopIteration
        kind, value = self._rt.stream_next(self._completion_ref.hex(),
                                           self._next, self.item_timeout_s)
        if kind == "item":
            self._next += 1
            return value
        self._open = False
        if kind == "error":
            raise pickle.loads(value).as_raisable()
        raise StopIteration

    def __del__(self):
        # Abandoned mid-stream: free the items never taken. The runtime
        # only queues (worker) or frees under its re-entrant lock (driver).
        if self._open:
            try:
                self._rt.stream_drop(self._completion_ref.hex())
            except Exception:  # interpreter shutdown: nothing left to free
                pass

    def __repr__(self):
        return (f"ObjectRefGenerator({self._completion_ref.hex()[:8]}, "
                f"next={self._next})")
