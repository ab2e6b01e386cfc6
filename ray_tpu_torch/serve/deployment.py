"""Deployment definitions (counterpart of ``ray_tpu/serve/deployment.py``).

Ref analogue: python/ray/serve/deployment.py + api.py — @serve.deployment
decorator producing a Deployment; ``.bind(*args)`` captures init args
(the reference's graph-build API); ``.options()`` overrides config.

The port has no SLO engine (the JAX package's ``util/slo.py``, which
evaluates an objective on the head node and drives SLO-aware scaling), so
a deployment given ``slo=`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple


@dataclasses.dataclass
class AutoscalingConfig:
    """Ref: serve/config.py AutoscalingConfig (queue-depth driven)."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 2.0
    downscale_delay_s: float = 10.0


class Deployment:
    def __init__(
        self,
        func_or_class: Callable,
        name: str,
        *,
        num_replicas: int = 1,
        max_concurrent_queries: int = 8,
        ray_actor_options: Optional[Dict[str, Any]] = None,
        autoscaling_config: Optional[AutoscalingConfig] = None,
        slo: Optional[Dict[str, Any]] = None,
    ):
        self.func_or_class = func_or_class
        self.name = name
        self.num_replicas = num_replicas
        self.max_concurrent_queries = max_concurrent_queries
        self.ray_actor_options = ray_actor_options or {}
        self.autoscaling_config = autoscaling_config
        if slo is not None:
            raise NotImplementedError(
                "deployment(slo=...) needs the SLO engine (ray_tpu/util/"
                "slo.py and the controller's SLO-driven scaling), which "
                "ray_tpu_torch does not have yet")
        self.slo = slo
        self._init_args: Tuple = ()
        self._init_kwargs: Dict[str, Any] = {}

    def options(self, **kw) -> "Deployment":
        d = Deployment(
            self.func_or_class,
            kw.pop("name", self.name),
            num_replicas=kw.pop("num_replicas", self.num_replicas),
            max_concurrent_queries=kw.pop(
                "max_concurrent_queries", self.max_concurrent_queries
            ),
            ray_actor_options=kw.pop(
                "ray_actor_options", dict(self.ray_actor_options)
            ),
            autoscaling_config=kw.pop(
                "autoscaling_config", self.autoscaling_config
            ),
            slo=kw.pop("slo", self.slo),
        )
        if kw:
            raise TypeError(f"unknown deployment options: {list(kw)}")
        d._init_args = self._init_args
        d._init_kwargs = self._init_kwargs
        return d

    def bind(self, *args, **kwargs) -> "Deployment":
        d = self.options()
        d._init_args = args
        d._init_kwargs = kwargs
        return d


def deployment(_func_or_class=None, *, name: Optional[str] = None, **kw):
    """@serve.deployment decorator (ref: serve/api.py deployment)."""

    def wrap(target):
        return Deployment(target, name or target.__name__, **kw)

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap
