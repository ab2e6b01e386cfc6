"""Algorithm + AlgorithmConfig (counterpart of
``ray_tpu/rllib/algorithm.py``).

Ref analogue: rllib/algorithms/algorithm.py Algorithm (:190,
training_step:1616) and algorithm_config.py AlgorithmConfig builder.
``train()`` = one iteration: parallel EnvRunner sampling (CPU actors of the
port's runtime) -> learner update (PyTorch, on the card in the driver) ->
weight broadcast.

Everything a runner actor is handed travels by reference (the runtime
pickles with the standard ``pickle``): the env creator and the policy
factory are instances of the module-level classes below, and the env is a
class or function a worker can import. A lambda, a local or a ``__main__``
env raises ``TypeError`` naming it when ``build()`` starts the runners.
This module imports no torch: a runner's worker loads it for those two
classes.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional

import numpy as np


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
        if callable(self.env) or isinstance(self.env, str):
            return _EnvCreator(self.env, dict(self.env_config))
        raise ValueError("config.environment(env=...) must be set to a "
                         "callable or gymnasium env id")

    def build(self, device=None) -> "Algorithm":
        raise NotImplementedError


class _EnvCreator:
    """``env(**env_config)`` for a callable env, ``gymnasium.make(env,
    **env_config)`` for an env id: the JAX package's closures as a
    picklable object."""

    def __init__(self, env, env_config: Dict[str, Any]):
        self.env = env
        self.env_config = env_config

    def __call__(self):
        if isinstance(self.env, str):
            import gymnasium

            return gymnasium.make(self.env, **self.env_config)
        return self.env(**self.env_config) if self.env_config \
            else self.env()


class _PolicyFactory:
    """``cls(*args, **kwargs)``: a runner's policy, built in its worker
    (the JAX package's default-argument closures)."""

    def __init__(self, cls, *args, **kwargs):
        self.cls = cls
        self.args = args
        self.kwargs = kwargs

    def __call__(self):
        return self.cls(*self.args, **self.kwargs)


def probe_env(creator):
    """(obs_dim, action space) of one env the creator makes, closed
    after."""
    probe = creator()
    obs_dim = int(np.prod(probe.observation_space.shape))
    space = probe.action_space
    if hasattr(probe, "close"):
        probe.close()
    return obs_dim, space


def stop_actors(actors) -> None:
    """Kill each actor; one that is gone already is skipped."""
    import ray_tpu_torch as rt

    for a in actors:
        try:
            rt.kill(a)
        except Exception:  # noqa: BLE001 — the runtime may be down
            pass


def linear_epsilon(config, env_steps: int) -> float:
    """The config's epsilon, decayed linearly over
    ``epsilon_timesteps`` env steps."""
    frac = min(1.0, env_steps / max(1, config.epsilon_timesteps))
    return config.epsilon_initial + frac * (
        config.epsilon_final - config.epsilon_initial
    )


def episode_result(ep_stats) -> Dict[str, Any]:
    """The mean of the runners' recent episode rewards (those that
    finished one) and the episodes they finished."""
    means = [s["episode_reward_mean"] for s in ep_stats
             if s["episodes_total"] > 0]
    return {
        "episode_reward_mean": float(np.mean(means)) if means else 0.0,
        "episodes_total": sum(s["episodes_total"] for s in ep_stats),
    }


class Algorithm:
    """Base: owns EnvRunner actors + a learner; subclasses implement
    training_step(). ``device`` is the learner's (default: the card,
    which must exist; ``"cpu"`` for tests); the runners are CPU actors."""

    def __init__(self, config: AlgorithmConfig, device=None):
        import ray_tpu_torch as rt
        from .._device import resolve_device

        self.config = config
        self.iteration = 0
        self.device = resolve_device(device)
        creator = config.env_creator()
        obs_dim, space = probe_env(creator)
        if hasattr(space, "n"):        # Discrete
            num_actions = int(space.n)
            self._continuous = False
            self._action_low = self._action_high = None
        else:                          # Box (continuous control)
            num_actions = int(np.prod(space.shape))
            self._continuous = True
            self._action_low = np.asarray(space.low, dtype=np.float32)
            self._action_high = np.asarray(space.high, dtype=np.float32)
        self._obs_dim, self._num_actions = obs_dim, num_actions

        policy_factory = self._make_policy_factory(obs_dim, num_actions)
        runner_cls = rt.remote(self._runner_class())
        self.runners = [
            runner_cls.remote(
                creator, policy_factory,
                seed=config.seed + i,
                rollout_fragment_length=config.rollout_fragment_length,
                gamma=config.gamma, lam=config.lambda_,
            )
            for i in range(config.num_env_runners)
        ]
        self.learner = self._build_learner(policy_factory())

    def _require_discrete(self):
        """Guard for discrete-only algorithms: a Box action space must
        fail fast, not silently train a categorical policy over
        np.prod(shape) pseudo-actions."""
        if getattr(self, "_continuous", False):
            raise ValueError(
                f"{type(self).__name__} supports discrete action spaces "
                f"only; use SAC for continuous control"
            )

    def _make_policy_factory(self, obs_dim: int, num_actions: int):
        from .policy import MLPPolicy

        self._require_discrete()
        c = self.config
        return _PolicyFactory(MLPPolicy, obs_dim, num_actions,
                              c.hidden_size, c.seed)

    def _runner_class(self):
        from .env_runner import EnvRunner

        return EnvRunner

    def _build_learner(self, policy):
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def train(self) -> Dict[str, Any]:
        self.iteration += 1
        result = self.training_step()
        result["training_iteration"] = self.iteration
        return result

    def sample_all(self):
        """One fragment from every runner, in runner order."""
        import ray_tpu_torch as rt

        return rt.get([r.sample.remote() for r in self.runners])

    def broadcast(self, weights) -> None:
        """Hand every runner the learner's weights and wait for them."""
        import ray_tpu_torch as rt

        rt.get([r.set_weights.remote(weights) for r in self.runners])

    def episode_stats(self) -> Dict[str, Any]:
        import ray_tpu_torch as rt

        return episode_result(
            rt.get([r.episode_stats.remote() for r in self.runners]))

    def get_weights(self):
        return self.learner.get_weights()

    def stop(self):
        stop_actors(self.runners)
