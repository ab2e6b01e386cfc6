"""Device ingest: host batches onto the card one batch ahead (the
counterpart of ``Dataset.iter_jax_batches``, ``ray_tpu/data/dataset.py``).

:func:`iter_device_batches` takes any iterable of ``{name: np.ndarray}``
batches (what ``Dataset.iter_batches(batch_format="numpy")`` yields) and
puts each batch on the device before it hands over the previous one, the
JAX package's one-batch prefetch.

On the card a batch is staged in pinned host memory, in a ring of two
reused pinned buffers per key, and copied with ``non_blocking=True`` on a
side stream; the consumer's current stream waits on that copy's event
when it takes the batch, and each tensor is marked as used by the
consumer's stream (``record_stream``), so the allocator does not hand its
memory to the next copy while the consumer still reads it. A pinned
buffer is refilled only after its previous copy has completed. A large
array is copied into its pinned buffer by several host threads: one
thread's copy runs slower than a copy from pageable memory to the card.

On the CPU ``torch.from_numpy`` aliases a writable contiguous array of the
canonical dtype (JAX's dlpack ``zero_copy`` path); read-only arrays, such
as a dataset's store views, are copied first, as ``iter_torch_batches``
does.

Dtypes follow JAX's with 64-bit mode off: float64 becomes float32, int64
int32, uint64 uint32 and complex128 complex64. ``dtypes`` (a torch dtype,
or a dict of them by key) overrides that, as in ``iter_torch_batches``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device

Batch = Dict[str, torch.Tensor]

# JAX's canonical dtypes with 64-bit mode off.
_CANONICAL = {np.dtype(np.float64): np.dtype(np.float32),
              np.dtype(np.int64): np.dtype(np.int32),
              np.dtype(np.uint64): np.dtype(np.uint32),
              np.dtype(np.complex128): np.dtype(np.complex64)}


def canonical_dtype(dtype) -> np.dtype:
    """The dtype that JAX gives an array of ``dtype`` with x64 off."""
    dtype = np.dtype(dtype)
    return _CANONICAL.get(dtype, dtype)


# An array of at least this many bytes is filled into its pinned buffer
# by FILL_THREADS threads, each copying a slice of its first axis (numpy
# releases the GIL while it copies).
FILL_BYTES = 8 << 20
FILL_THREADS = min(8, os.cpu_count() or 1)


def _fill(host: np.ndarray, arr: np.ndarray, pool: ThreadPoolExecutor):
    """``host[...] = arr`` (cast to ``host``'s dtype), by slices of the
    first axis on ``pool``'s threads when ``arr`` is large."""
    n = min(FILL_THREADS, arr.shape[0] if arr.ndim else 1)
    if arr.nbytes < FILL_BYTES or n < 2:
        np.copyto(host, arr, casting="unsafe")
        return
    edges = np.linspace(0, arr.shape[0], n + 1).astype(int)
    for done in [pool.submit(np.copyto, host[a:b], arr[a:b],
                             casting="unsafe")
                 for a, b in zip(edges[:-1], edges[1:])]:
        done.result()


def _override(dtypes, key: str) -> Optional[torch.dtype]:
    return dtypes.get(key) if isinstance(dtypes, dict) else dtypes


def _cpu_batch(batch: Dict[str, Any], dtypes, alias: bool) -> Batch:
    out = {}
    for key, value in batch.items():
        arr = np.asarray(value)
        want = canonical_dtype(arr.dtype)
        if not (alias and arr.dtype == want and arr.flags.writeable
                and arr.flags.c_contiguous):
            arr = np.array(arr, dtype=want, order="C")  # a writable copy
        t = torch.from_numpy(arr)
        cast = _override(dtypes, key)
        out[key] = t if cast is None else t.to(cast)
    return out


class _CudaStager:
    """Pinned staging and side-stream copies for one iteration."""

    def __init__(self, device: torch.device, dtypes):
        self.device = device
        self.dtypes = dtypes
        self.stream = torch.cuda.Stream(device)
        # Two slots, used in turn; each holds a pinned byte buffer per key
        # and the event of the last copy out of its buffers.
        self.buffers = [{}, {}]
        self.events = [None, None]
        self.turn = 0
        self.pool = ThreadPoolExecutor(FILL_THREADS)  # threads start on use

    def close(self) -> None:
        self.pool.shutdown()

    def _pinned(self, slot: int, key: str, nbytes: int) -> torch.Tensor:
        buf = self.buffers[slot].get(key)
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self.buffers[slot][key] = buf
        return buf[:nbytes]

    def put(self, batch: Dict[str, Any]):
        """Stage ``batch`` and queue its copies; returns (batch on the
        card, the copies' event)."""
        slot, self.turn = self.turn, self.turn ^ 1
        if self.events[slot] is not None:
            self.events[slot].synchronize()  # the buffers' last copy is done
        out = {}
        with torch.cuda.stream(self.stream):
            for key, value in batch.items():
                arr = np.asarray(value)
                want = canonical_dtype(arr.dtype)
                staged = self._pinned(slot, key, arr.size * want.itemsize)
                host = staged.numpy().view(want).reshape(arr.shape)
                _fill(host, arr, self.pool)
                # Copied out of the pinned tensor itself, so that its
                # allocator also holds the block until the copy is done.
                src = staged.view(torch.from_numpy(host).dtype)
                t = src.view(arr.shape).to(self.device, non_blocking=True)
                cast = _override(self.dtypes, key)
                out[key] = t if cast is None else t.to(cast)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[slot] = event
        return out, event

    def take(self, pending) -> Batch:
        """Hand a staged batch to the consumer's current stream."""
        out, event = pending
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(event)
        for t in out.values():
            t.record_stream(consumer)
        return out


def _one_ahead(batches: Iterable, put, take, close=None) -> Iterator[Batch]:
    try:
        prev = None
        for batch in batches:
            nxt = put(batch)  # queue this batch before yielding the previous
            if prev is not None:
                yield take(prev)
            prev = nxt
        if prev is not None:
            yield take(prev)
    finally:
        if close is not None:
            close()


def iter_device_batches(batches: Iterable[Dict[str, Any]], *,
                        device: DeviceLike = None, dtypes=None,
                        zero_copy: Optional[bool] = None,
                        ) -> Iterator[Batch]:
    """Yield each batch of ``batches`` as ``{name: tensor}`` on ``device``
    (default: the CUDA card, which raises without one; ``"cpu"`` when
    asked), the next batch already on its way.

    ``zero_copy`` (default: on the CPU) lets the CPU path alias the numpy
    arrays; ``False`` copies them. On the card the data moves either way,
    so it is ignored there, as JAX ignores it off the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        stager = _CudaStager(dev, dtypes)
        return _one_ahead(batches, stager.put, stager.take, stager.close)
    if dev.type != "cpu":
        raise ValueError(f"ingest runs on cuda or cpu, not {dev.type}")
    alias = zero_copy is not False
    return _one_ahead(batches, lambda b: _cpu_batch(b, dtypes, alias),
                      lambda b: b)
