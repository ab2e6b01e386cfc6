"""Structured lifecycle events (counterpart of ``ray_tpu/util/events.py``).

Emit sites call :func:`emit` with a severity and a source from the enums
below, which are the JAX package's; each event is the JAX record
(``event_id``, ``ts``, ``severity``, ``source``, ``message``, ids, the
active span's ``trace_id``/``span_id``, ``pid``, ``custom_fields``).

The log is process-local, as the port's metrics are: events stay in this
process's bounded ring (oldest dropped first) and
:func:`list_events` reads them. The JAX package flushes each process's
ring to a head-side store through its GCS; the port's runtime has no such
plane, so a worker's events stay in the worker. The train supervisor's
events (gang aborts, restarts, recovery) are emitted in the driver.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

DEBUG = "DEBUG"
INFO = "INFO"
WARNING = "WARNING"
ERROR = "ERROR"
FATAL = "FATAL"
SEVERITIES = (DEBUG, INFO, WARNING, ERROR, FATAL)

GCS = "GCS"
RAYLET = "RAYLET"
WORKER = "WORKER"
TASK = "TASK"
ACTOR = "ACTOR"
OBJECT_STORE = "OBJECT_STORE"
AUTOSCALER = "AUTOSCALER"
SERVE = "SERVE"
JOB = "JOB"
CHAOS = "CHAOS"
TRAIN = "TRAIN"
NODE = "NODE"
SLO = "SLO"
SYSTEM = "SYSTEM"
SOURCES = (GCS, RAYLET, WORKER, TASK, ACTOR, OBJECT_STORE, AUTOSCALER,
           SERVE, JOB, CHAOS, TRAIN, NODE, SLO, SYSTEM)

BUFFER_SIZE = 1000


def make_event(severity: str, source: str, message: str, *,
               node_id: Optional[str] = None,
               job_id: Optional[str] = None,
               task_id: Optional[str] = None,
               actor_id: Optional[str] = None,
               trace_id: Optional[str] = None,
               span_id: Optional[str] = None,
               custom_fields: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Any]:
    """Build one typed event record; an unknown severity or source
    raises."""
    if severity not in SEVERITIES:
        raise ValueError(
            f"unknown event severity {severity!r} (one of {SEVERITIES})")
    if source not in SOURCES:
        raise ValueError(
            f"unknown event source {source!r} (one of {SOURCES})")
    return {
        "event_id": uuid.uuid4().hex[:16],
        "ts": time.time(),
        "severity": severity,
        "source": source,
        "message": message,
        "node_id": node_id,
        "job_id": job_id,
        "task_id": task_id,
        "actor_id": actor_id,
        "trace_id": trace_id,
        "span_id": span_id,
        "pid": os.getpid(),
        "custom_fields": dict(custom_fields or {}),
    }


_lock = threading.Lock()
_ring: deque = deque(maxlen=BUFFER_SIZE)


def emit(severity: str, source: str, message: str, *,
         node_id: Optional[str] = None,
         job_id: Optional[str] = None,
         task_id: Optional[str] = None,
         actor_id: Optional[str] = None,
         custom_fields: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Record one event in this process's ring (the oldest goes first when
    it is full); returns the event."""
    if node_id is None:
        from ..core import runtime_context

        rt = runtime_context.current_runtime_or_none()
        node_id = getattr(rt, "node_id", None)
    from .timeline import current_span

    ctx = current_span()
    trace_id, span_id = (ctx[0], ctx[1] or None) if ctx else (None, None)
    event = make_event(
        severity, source, message, node_id=node_id, job_id=job_id,
        task_id=task_id, actor_id=actor_id, trace_id=trace_id,
        span_id=span_id, custom_fields=custom_fields,
    )
    with _lock:
        _ring.append(event)
    return event


def list_events(severity: Optional[str] = None,
                source: Optional[str] = None,
                limit: int = 1000) -> List[Dict[str, Any]]:
    """This process's events oldest-first, optionally filtered; ``limit``
    keeps the newest matches."""
    with _lock:
        rows = [e for e in _ring
                if (severity is None or e["severity"] == severity)
                and (source is None or e["source"] == source)]
    return rows[-limit:] if limit and limit > 0 else rows
