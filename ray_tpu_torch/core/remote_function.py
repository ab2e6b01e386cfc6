"""``@remote`` functions (counterpart of ``ray_tpu/core/remote_function.py``).

Options: ``num_cpus`` (default 1), ``num_gpus``, ``resources``,
``scheduling_strategy``, ``max_retries`` (of a worker crash; default
``DEFAULT_MAX_RETRIES``), ``num_returns`` (``"streaming"``: an
:class:`~.streaming.ObjectRefGenerator`, never retried) and ``name``.
Every task carries the caller's ambient deadline (``util/overload``). A
task asking for
``"GPU"`` (whole cards) runs in a GPU-typed worker that sees its assigned
cards; every other task runs in a CPU-typed worker that sees none.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

from .resources import CPU, GPU, ResourceSet, check_whole_gpus
from .runtime_context import current_runtime

# Retries of a task whose worker process died.
DEFAULT_MAX_RETRIES = 3


def wrap_returns(refs, num_returns):
    """What ``.remote()`` returns for the result refs of a submission."""
    if num_returns == "streaming":
        from .streaming import ObjectRefGenerator

        return ObjectRefGenerator(refs[0])
    return refs[0] if num_returns == 1 else refs


def _build_resources(opts: Dict[str, Any],
                     default_num_cpus: float) -> ResourceSet:
    amounts = dict(opts.get("resources") or {})
    num_cpus = opts.get("num_cpus")
    amounts[CPU] = default_num_cpus if num_cpus is None else num_cpus
    num_gpus = opts.get("num_gpus")
    if num_gpus:
        amounts[GPU] = num_gpus
    check_whole_gpus(amounts)
    return ResourceSet(amounts)


class RemoteFunction:
    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        self._fn = fn
        self._options = dict(options or {})
        functools.update_wrapper(self, fn)

    def options(self, **opts) -> "RemoteFunction":
        merged = dict(self._options)
        merged.update(opts)
        return RemoteFunction(self._fn, merged)

    def remote(self, *args, **kwargs):
        from ..util.overload import ambient_deadline

        rt = current_runtime()
        num_returns = self._options.get("num_returns", 1)
        max_retries = self._options.get("max_retries", DEFAULT_MAX_RETRIES)
        refs = rt.submit(dict(
            kind="task",
            fn=rt.ensure_function(self._fn),
            name=self._options.get("name",
                                   getattr(self._fn, "__name__", "task")),
            num_returns=num_returns,
            resources=_build_resources(self._options, default_num_cpus=1),
            strategy=self._options.get("scheduling_strategy"),
            max_retries=max_retries,
            deadline=ambient_deadline(),
        ), args, kwargs)
        return wrap_returns(refs, num_returns)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function '{getattr(self._fn, '__name__', '?')}' cannot "
            "be called directly; use '.remote()'."
        )
