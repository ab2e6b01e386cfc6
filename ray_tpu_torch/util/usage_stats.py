"""Usage stats: which of the port's libraries a process used
(counterpart of ``ray_tpu/util/usage_stats.py``).

The report has the JAX package's shape (schema version, versions, the
libraries touched, extra tags), with ``torch_version`` and
``cuda_version`` in place of ``jax_version``. Without a runtime there is
no ``num_nodes`` or ``total_resources``, and nothing writes the report
out or records extra tags: in the JAX package the runtime's ``init`` does
both, and the port's runtime does neither. ``train``, ``serve`` and
``data`` record their use when imported, as in the JAX package. Recording
imports no torch, so a CPU worker that imports ``train`` stays light.
"""

from __future__ import annotations

import platform
import threading
import time
from typing import Any, Dict

_lock = threading.Lock()
_libraries: set = set()


def record_library_usage(name: str) -> None:
    """Mark a library as used in this process."""
    with _lock:
        _libraries.add(name)


def build_report() -> Dict[str, Any]:
    import torch

    from .._version import __version__

    report: Dict[str, Any] = {
        "schema_version": "0.1",
        "ray_tpu_version": __version__,
        "python_version": platform.python_version(),
        "os": platform.system().lower(),
        "collected_at": time.time(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,  # None in a CPU-only build
        "extra_usage_tags": [],
    }
    with _lock:
        report["libraries_used"] = sorted(_libraries)
    return report
