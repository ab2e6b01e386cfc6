"""AlgorithmConfig: the chained-setter config that every algorithm's
config extends.

Ref analogue: rllib/algorithms/algorithm_config.py AlgorithmConfig. The
counterpart of ``ray_tpu/rllib/algorithm.py``'s config half. ``Algorithm``
itself (EnvRunner actors, ``train()``) stands on the actor runtime; the
port has a single-node runtime (``ray_tpu_torch.core``) but not yet the
algorithm loops on it, so ``build()`` raises; the learners and
``EnvRunner`` are driven directly until then.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional

NO_RUNTIME = (
    "{} needs RLlib's algorithm loops on the actor runtime (EnvRunner "
    "actors, get), which ray_tpu_torch has not ported yet; drive the "
    "learner and EnvRunner directly"
)


class AlgorithmConfig:
    def __init__(self):
        self.env: Optional[Any] = None
        self.env_config: Dict[str, Any] = {}
        self.num_env_runners: int = 2
        self.rollout_fragment_length: int = 200
        self.lr: float = 3e-4
        self.gamma: float = 0.99
        self.lambda_: float = 0.95
        self.train_batch_size: int = 400
        self.minibatch_size: int = 128
        self.num_epochs: int = 8
        self.hidden_size: int = 64
        self.seed: int = 0

    def environment(self, env=None, *, env_config=None) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = env_config
        return self

    def env_runners(self, *, num_env_runners=None,
                    rollout_fragment_length=None) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kw) -> "AlgorithmConfig":
        for k, v in kw.items():
            key = "lambda_" if k == "lambda" else k
            if not hasattr(self, key):
                raise ValueError(f"unknown training param {k!r}")
            setattr(self, key, v)
        return self

    def debugging(self, *, seed=None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def env_creator(self) -> Callable[[], Any]:
        env = self.env
        cfg = dict(self.env_config)
        if callable(env):
            return lambda: env(**cfg) if cfg else env()
        if isinstance(env, str):
            def make():
                import gymnasium

                return gymnasium.make(env, **cfg)

            return make
        raise ValueError("config.environment(env=...) must be set to a "
                         "callable or gymnasium env id")

    def build(self):
        raise NotImplementedError(
            NO_RUNTIME.format(f"{type(self).__name__}.build()"))
