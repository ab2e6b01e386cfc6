"""CUDA device telemetry (counterpart of ``ray_tpu/util/device_metrics.py``).

The same series as the JAX package, with its names, help texts and tag
keys, so one dashboard reads both: device memory in use, peak and limit
and the allocator's fragmentation per device, step compiles and their
seconds, and collective calls and bytes. Everything records into
``util/metrics.py``, so ``util/prometheus.render()`` exposes it. The node
tag is "local" (the port's metrics are process-local); a device is tagged
``gpu:<index>``, JAX's name for a GPU platform.

Sampling is passive: :func:`sample` does nothing in a process that has
not initialised CUDA, so sampling is never what starts the backend.
Callers on natural edges (a compile, a render) call :func:`maybe_sample`,
which queries the allocator at most once per interval.

A "compile" in the port is the first call of a step with a new signature
(:func:`instrumented_step`), because that is when JAX traces and compiles
and when the port's first-use work happens (a kernel build, cuBLAS and
cuDNN plan choice).
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, Dict, Hashable, List, Optional

import torch

from .metrics import Counter, Gauge

DEVICE_COUNT = Gauge(
    "ray_tpu_device_count",
    "Local JAX devices visible to this process.",
    tag_keys=("node", "platform"),
)
MEMORY_IN_USE = Gauge(
    "ray_tpu_device_memory_bytes_in_use",
    "Device (HBM) bytes currently allocated, per device.",
    tag_keys=("node", "device"),
)
MEMORY_PEAK = Gauge(
    "ray_tpu_device_memory_peak_bytes",
    "Peak device (HBM) bytes allocated, per device.",
    tag_keys=("node", "device"),
)
MEMORY_LIMIT = Gauge(
    "ray_tpu_device_memory_limit_bytes",
    "Device (HBM) capacity visible to the allocator, per device.",
    tag_keys=("node", "device"),
)
MEMORY_FRAGMENTATION = Gauge(
    "ray_tpu_device_memory_fragmentation_ratio",
    "Allocator fragmentation per device: reserved-but-not-live fraction "
    "of the arena (1 - live/reserved at peak). High values mean the "
    "allocator holds far more HBM than live buffers need — the failure "
    "mode that OOMs deep scan schedules.",
    tag_keys=("node", "device"),
)
JIT_COMPILES = Counter(
    "ray_tpu_device_jit_compiles_total",
    "XLA compilations observed through instrumented_jit().",
    tag_keys=("node", "fn"),
)
JIT_COMPILE_SECONDS = Counter(
    "ray_tpu_device_jit_compile_seconds_total",
    "Wall seconds spent in calls that triggered an XLA compile.",
    tag_keys=("node", "fn"),
)
COLLECTIVE_CALLS = Counter(
    "ray_tpu_device_collective_calls_total",
    "Collective ops issued through parallel.collectives (in-graph ops "
    "count once per trace, host-level ops once per call).",
    tag_keys=("node", "op"),
)
COLLECTIVE_BYTES = Counter(
    "ray_tpu_device_collective_bytes_total",
    "Payload bytes moved by host-level collectives (barrier/broadcast "
    "over the control-plane KV).",
    tag_keys=("node", "op"),
)

_lock = threading.Lock()
_last_sample = 0.0


def node_tag() -> str:
    """The node tag: "local" (off-cluster, as the JAX package tags a
    process without a runtime)."""
    return "local"


def fragmentation_from_stats(stats: Dict[str, Any]) -> Optional[float]:
    """Allocator fragmentation ratio from a :func:`hbm_snapshot`-style
    dict, or None when it holds too little. Preference order:

    1. ``peak_bytes_in_use`` vs ``peak_bytes_reserved``: the reserved
       arena the allocator grew to against the live bytes it held at peak.
    2. ``bytes_in_use`` vs ``bytes_reserved``: the instantaneous pair.
    3. ``largest_free_block_bytes`` vs free bytes under ``bytes_limit``:
       how shattered the remaining arena is.
    """
    peak_live = stats.get("peak_bytes_in_use")
    peak_reserved = stats.get("peak_bytes_reserved")
    if peak_reserved and peak_live is not None and peak_reserved > 0:
        return max(0.0, 1.0 - float(peak_live) / float(peak_reserved))
    live = stats.get("bytes_in_use")
    reserved = stats.get("bytes_reserved")
    if reserved and live is not None and reserved > 0:
        return max(0.0, 1.0 - float(live) / float(reserved))
    limit = stats.get("bytes_limit") or stats.get("bytes_reservable_limit")
    largest_free = stats.get("largest_free_block_bytes")
    if limit and live is not None and largest_free is not None:
        free = float(limit) - float(live)
        if free > 0:
            return max(0.0, 1.0 - float(largest_free) / free)
    return None


# hbm_snapshot key <- torch.cuda.memory_stats key. A key is 0 until the
# allocator's first allocation on the device creates it.
_STATS = {
    "bytes_in_use": "allocated_bytes.all.current",
    "peak_bytes_in_use": "allocated_bytes.all.peak",
    "bytes_reserved": "reserved_bytes.all.current",
    "peak_bytes_reserved": "reserved_bytes.all.peak",
    "num_allocs": "allocation.all.allocated",
}


def _bytes_limit(index: int) -> int:
    """The card's total memory (the total of ``torch.cuda.mem_get_info``,
    read from the device's cached properties), times the process's memory
    fraction where one is set."""
    total = torch.cuda.get_device_properties(index).total_memory
    return int(total * torch.cuda.get_per_process_memory_fraction(index))


def _snapshot(index: int) -> Dict[str, Any]:
    stats = torch.cuda.memory_stats(index)
    out: Dict[str, Any] = {k: int(stats.get(src, 0))
                           for k, src in _STATS.items()}
    out["bytes_limit"] = _bytes_limit(index)
    frag = fragmentation_from_stats(out)
    if frag is not None:
        out["fragmentation"] = round(frag, 4)
    return out


def hbm_snapshot(device=None) -> Dict[str, Any]:
    """One CUDA device's allocator state as a plain dict, with the JAX
    package's keys: ``bytes_in_use`` and ``peak_bytes_in_use`` (allocated
    bytes now and at peak), ``bytes_reserved`` and ``peak_bytes_reserved``
    (the caching allocator's reserved bytes), ``bytes_limit``,
    ``num_allocs`` (allocations made) and ``fragmentation``. Peaks are
    since the last ``torch.cuda.reset_peak_memory_stats``.

    PyTorch gives no ``largest_free_block_bytes``, ``largest_alloc_size``
    or ``bytes_reservable_limit``, so those keys are left out. {} for a CPU
    device, as JAX gives on the CPU, and for ``device=None`` in a process
    that has not initialised CUDA (``None`` means the current CUDA device)."""
    if device is None:
        if not torch.cuda.is_initialized():
            return {}
        device = torch.cuda.current_device()
    device = torch.device("cuda", device) if isinstance(device, int) \
        else torch.device(device)
    if device.type != "cuda":
        return {}
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _snapshot(index)


def _process_devices() -> List[int]:
    """The CUDA devices this process uses: the current one and any other
    whose allocator here has reserved memory (the counterpart of JAX's
    ``jax.local_devices()``). In a world of one process a card, every
    card is visible to every rank, but a rank's allocator has nothing on
    the other ranks' cards: reading them would publish 0 bytes in use
    under their names. Reading the allocator's stats starts nothing on a
    device."""
    current = torch.cuda.current_device()
    return [i for i in range(torch.cuda.device_count())
            if i == current or torch.cuda.memory_stats(i).get(
                "reserved_bytes.all.peak", 0)]


def sample(force: bool = False) -> List[Dict[str, Any]]:
    """Publish the memory gauges of each CUDA device this process uses
    (:func:`_process_devices`) and return one dict per device
    (``device``, ``platform`` and the gauges' values). Unless ``force``,
    does nothing in a process that has not initialised CUDA: sampling
    must not be what starts the backend."""
    if not force and not torch.cuda.is_initialized():
        return []
    if not torch.cuda.device_count():
        return []
    node = node_tag()
    out: List[Dict[str, Any]] = []
    for index in _process_devices():
        dev_tag = f"gpu:{index}"
        snap = _snapshot(index)
        tags = {"node": node, "device": dev_tag}
        MEMORY_IN_USE.set(float(snap["bytes_in_use"]), tags=tags)
        MEMORY_PEAK.set(float(snap["peak_bytes_in_use"]), tags=tags)
        MEMORY_LIMIT.set(float(snap["bytes_limit"]), tags=tags)
        info: Dict[str, Any] = {
            "device": dev_tag, "platform": "gpu",
            "bytes_in_use": snap["bytes_in_use"],
            "peak_bytes_in_use": snap["peak_bytes_in_use"],
            "bytes_limit": snap["bytes_limit"],
        }
        if "fragmentation" in snap:
            frag = fragmentation_from_stats(snap)
            MEMORY_FRAGMENTATION.set(frag, tags=tags)
            info["fragmentation"] = snap["fragmentation"]
        out.append(info)
    DEVICE_COUNT.set(float(len(out)), tags={"node": node, "platform": "gpu"})
    return out


def maybe_sample(min_interval_s: float = 5.0) -> None:
    """Throttled :func:`sample` for hot paths (a train step, a render): at
    most one allocator query per interval."""
    global _last_sample
    now = time.monotonic()
    with _lock:
        if now - _last_sample < min_interval_s:
            return
        _last_sample = now
    sample()


# op -> (calls, bytes) bound recorders: a collective is counted on the
# step's hot path, so its tags are resolved once.
_collective_recorders: Dict[str, tuple] = {}


def record_collective(op: str, nbytes: Optional[int] = None) -> None:
    """Count one collective call (and its payload bytes when known).
    Called by ``parallel/collectives.py`` once per Python-level call."""
    rec = _collective_recorders.get(op)
    if rec is None:
        tags = {"node": node_tag(), "op": op}
        rec = _collective_recorders[op] = (
            COLLECTIVE_CALLS.with_tags(**tags),
            COLLECTIVE_BYTES.with_tags(**tags))
    rec[0].inc(1)
    if nbytes:
        rec[1].inc(float(nbytes))


def tensor_signature(*args, **kwargs) -> Hashable:
    """The default step signature: shape, dtype and device of each
    top-level tensor argument, in order (nested trees are not walked)."""
    return tuple((tuple(a.shape), a.dtype, a.device)
                 for a in (*args, *kwargs.values())
                 if isinstance(a, torch.Tensor))


def _synchronize() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def instrumented_step(fn: Callable, *, sample_memory: bool = False,
                      tap_stride: int = 1,
                      signature: Optional[Callable[..., Hashable]] = None):
    """``fn`` with compile telemetry (the counterpart of JAX's
    ``instrumented_jit``). A call whose signature (``signature(*args,
    **kwargs)``, default :func:`tensor_signature`) is new counts as a
    compile: ``ray_tpu_device_jit_compiles_total{fn}`` grows by one and
    the window's slowest call's wall seconds go to
    ``ray_tpu_device_jit_compile_seconds_total{fn}``. That call is
    synchronised with the card once, so its seconds hold its device work
    and any first-use build or plan choice; no other call synchronises.
    The series are tagged by ``fn.__name__``.

    ``tap_stride=N`` keeps a ring of N calls: the wrapper counts calls
    down, remembers the window's slowest call, and publishes once per
    window (the decode loop's wiring, one call per generated token).
    ``wrapped.flush_taps()`` publishes at a burst boundary (the engine
    calls it when its loop goes idle, in ``stats()`` and at shutdown), so
    the series lag by at most one burst. The steady per-call cost is the
    signature, one set lookup, two clock reads and a countdown: no lock,
    no device synchronisation, no walk of the parameter tree.

    ``sample_memory=True`` also publishes the device memory gauges after
    every compile and, throttled through :func:`maybe_sample`, at each
    flush (the train step's wiring).

    ``wrapped.__wrapped_fn__`` is ``fn``; ``wrapped.cache_size()`` is the
    number of signatures seen (JAX: the jitted function's executables)."""
    sig = signature or tensor_signature
    fn_name = fn.__name__
    seen: set = set()
    # [signatures published, bound compiles, bound seconds, countdown,
    # window's slowest call], as JAX keeps them. A flush (the window's end
    # or another thread's stats()/shutdown()) holds flush_lock, so two
    # flushes cannot count one compile twice; the per-call path takes no
    # lock.
    state = [0, None, None, tap_stride, 0.0]
    flush_lock = threading.Lock()

    def flush_taps():
        """Publish the window's compiles (signatures seen since the last
        flush) and reset the ring. Safe from any thread."""
        with flush_lock:
            state[3] = tap_stride
            after = len(seen)
            window_dt, state[4] = state[4], 0.0
            if after > state[0]:
                if state[1] is None:
                    tags = {"node": node_tag(), "fn": fn_name}
                    state[1] = JIT_COMPILES.with_tags(**tags)
                    state[2] = JIT_COMPILE_SECONDS.with_tags(**tags)
                state[1].inc(after - state[0])
                state[2].inc(window_dt)
                state[0] = after
                if sample_memory:
                    sample()
            elif sample_memory:
                maybe_sample()

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        key = sig(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if key not in seen:
            _synchronize()
            seen.add(key)
        dt = time.perf_counter() - t0
        if dt > state[4]:
            state[4] = dt
        state[3] -= 1
        if state[3] <= 0:
            flush_taps()
        return out

    wrapped.__wrapped_fn__ = fn
    wrapped.flush_taps = flush_taps
    wrapped.cache_size = lambda: len(seen)
    return wrapped
