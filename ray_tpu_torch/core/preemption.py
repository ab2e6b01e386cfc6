"""Worker-side preemption signal (copy of ``ray_tpu/core/preemption.py``).

When a node begins draining, :func:`signal_local_drain` records it in every
worker process of that node, and long-running worker code, above all the
train gang (``TrainSession.preemption``), polls :func:`local_drain` at its
own safe points (step boundaries) and winds down cooperatively:
checkpoint, report, surrender the node. A drain rollback clears the signal
(:func:`clear_local_drain`). The single-node runtime has no drain plane:
nothing calls :func:`signal_local_drain` but the worker code itself, so the
gang's preemption path is reached only that way.

This module is deliberately tiny and dependency-free: it is imported
inside training loops."""

from __future__ import annotations

import threading
import time
from typing import Optional

_lock = threading.Lock()
_drain_node_hex: Optional[str] = None
_drain_since: float = 0.0


def signal_local_drain(node_hex: str) -> None:
    """This worker's host node began draining."""
    global _drain_node_hex, _drain_since
    with _lock:
        if _drain_node_hex is None:
            _drain_since = time.time()
        _drain_node_hex = node_hex or "?"


def clear_local_drain() -> None:
    """The drain was aborted (``node_undrain``): back to normal."""
    global _drain_node_hex, _drain_since
    with _lock:
        _drain_node_hex = None
        _drain_since = 0.0


def local_drain() -> Optional[dict]:
    """``{"node_id", "since"}`` when this worker's node is draining,
    else ``None``. Cheap enough to poll every training step."""
    with _lock:
        if _drain_node_hex is None:
            return None
        return {"node_id": _drain_node_hex, "since": _drain_since}
