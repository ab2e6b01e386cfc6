"""Spans and the chrome-trace timeline (counterpart of the span half of
``ray_tpu/core/timeline.py``).

A span context is a (trace_id, span_id) pair installed per thread
(:func:`enter_span`/:func:`exit_span`). :func:`record_span` and
:func:`span_event` record only under an active context: a step or a
checkpoint outside a trace records nothing, as in the JAX package.
``RAY_TPU_NO_TRACE=1`` (or :func:`set_enabled`) turns recording off.

The buffer is process-local, a ``deque`` with the JAX package's cap. The
JAX package flushes each worker's buffer to its runtime's KV store and
``timeline()`` merges every worker's; the port's runtime does not, so
``timeline()`` returns this process's spans, with the JAX events' fields.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

MAX_EVENTS_PER_WORKER = 10_000

_ctx = threading.local()
_ENABLED = os.environ.get("RAY_TPU_NO_TRACE") != "1"


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> bool:
    """Flip span recording; returns the previous state."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    return prev


# A per-process random prefix (drawn again after fork) and a counter keep
# span ids unique at the cost of a dict lookup and an increment.
_span_seed = {"prefix": ""}
_span_counter = itertools.count(1)


def _reset_span_seed():
    global _span_counter
    _span_seed["prefix"] = ""
    _span_counter = itertools.count(1)


os.register_at_fork(after_in_child=_reset_span_seed)


def new_span_id() -> str:
    prefix = _span_seed["prefix"]
    if not prefix:
        prefix = _span_seed["prefix"] = os.urandom(4).hex()
    return prefix + format(next(_span_counter) & 0xFFFFFFFF, "08x")


def new_trace_id() -> str:
    return uuid.uuid4().hex  # 32 hex chars, the W3C trace-id width


def parse_traceparent(header: Optional[str]):
    """Parse a W3C ``traceparent`` header into (trace_id, span_id), or
    None if absent/malformed. Lets an upstream service own the trace root
    so the serve spans join its trace instead of starting an orphan
    one."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    trace_id, span_id = parts[1].lower(), parts[2].lower()
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
            return None
    except ValueError:
        return None
    return trace_id, span_id


def format_traceparent(trace_id: str, span_id: str) -> str:
    """Render a (trace_id, span_id) context as a W3C traceparent value
    (ids are zero-padded/truncated to wire width)."""
    tid = (trace_id + "0" * 32)[:32]
    sid = (span_id + "0" * 16)[:16]
    return f"00-{tid}-{sid}-01"


def current_span():
    """(trace_id, span_id) of the active span in this thread, or None."""
    return getattr(_ctx, "span", None)


def enter_span(trace_id: str, span_id: str):
    """Install a span as this thread's context; returns the previous
    context (pass it back to :func:`exit_span`)."""
    prev = getattr(_ctx, "span", None)
    _ctx.span = (trace_id, span_id)
    return prev


def exit_span(prev) -> None:
    _ctx.span = prev


class _Buffer:
    """This process's recorded spans, the oldest evicted at the cap."""

    def __init__(self):
        self._events: deque = deque(maxlen=MAX_EVENTS_PER_WORKER)
        self._lock = threading.Lock()

    def record(self, name: str, start: float, end: float,
               trace_id: str = "", span_id: str = "",
               parent_id: str = "") -> None:
        with self._lock:
            self._events.append({
                "name": name, "ts": start, "dur": end - start,
                "task_id": "", "trace_id": trace_id, "span_id": span_id,
                "parent_id": parent_id,
            })

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)


_buffer = _Buffer()


def span_event(name: str) -> None:
    """Zero-duration marker span under the thread's active span; nothing
    without one or with recording off."""
    if not _ENABLED:
        return
    ctx = current_span()
    if ctx is None:
        return
    now = time.time()
    _buffer.record(name, now, now, trace_id=ctx[0], span_id=new_span_id(),
                   parent_id=ctx[1])


def record_span(name: str, start: float, end: float,
                parent: Optional[tuple] = None,
                span_id: Optional[str] = None) -> Optional[str]:
    """Record one completed span (``start``/``end`` in ``time.time()``
    seconds) under ``parent`` ((trace_id, span_id); default: the thread's
    active context), with ``span_id`` if given (a root span whose id was
    handed out while it ran) else a new one. Returns the span id, or None
    when nothing was recorded (no context, or recording off)."""
    if not _ENABLED:
        return None
    ctx = parent if parent is not None else current_span()
    if ctx is None:
        return None
    sid = span_id or new_span_id()
    _buffer.record(name, start, end, trace_id=ctx[0], span_id=sid,
                   parent_id=ctx[1])
    return sid


def timeline(filename: Optional[str] = None) -> List[Dict[str, Any]]:
    """This process's spans as chrome-trace complete events (µs ``ts`` and
    ``dur``, the ids in ``args``), written to ``filename`` as JSON if given
    (open it in chrome://tracing or Perfetto)."""
    pid = os.getpid()
    trace = [{
        "name": ev["name"],
        "ph": "X",  # complete event
        "ts": ev["ts"] * 1e6,
        "dur": ev["dur"] * 1e6,
        "pid": "node:local",
        "tid": f"worker:{pid}",
        "args": {
            "task_id": ev["task_id"],
            "trace_id": ev["trace_id"],
            "span_id": ev["span_id"],
            "parent_id": ev["parent_id"],
        },
    } for ev in _buffer.events()]
    if filename:
        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace
