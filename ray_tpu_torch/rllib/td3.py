"""TD3: twin-delayed deterministic policy gradient (counterpart of
``ray_tpu/rllib/td3.py``).

Ref analogue: rllib/algorithms/td3 — DDPG plus the three TD3 fixes
(Fujimoto 2018): twin critics with min-target, target-policy smoothing
(clipped noise on the target action), and delayed actor updates. The
smoothing noise comes from the learner's numpy ``RandomState(seed + 3)``,
drawn in the JAX package's order, so both packages see the same noise.
The replay loop is DDPG's (``ddpg.continuous_loop``) with the actor step
every ``policy_delay`` updates.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .._device import DeviceLike
from .algorithm import Algorithm, AlgorithmConfig
from .core import (
    DeterministicActorModule,
    QModule,
    TwinCriticLearner,
    to_device,
)
from .ddpg import (
    continuous_loop,
    deterministic_policy_factory,
    transitions,
)
from .env_runner import TransitionEnvRunner
from .replay_buffers import ReplayBuffer
from .sample_batch import SampleBatch


class TD3Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.buffer_size: int = 100_000
        self.num_steps_sampled_before_learning_starts: int = 500
        self.num_updates_per_iteration: int = 64
        self.tau: float = 0.005
        self.policy_delay: int = 2
        self.target_noise: float = 0.2
        self.target_noise_clip: float = 0.5
        self.exploration_noise: float = 0.1

    def build(self, device: DeviceLike = None) -> "TD3":
        return TD3(self.copy(), device)


class TD3Learner(TwinCriticLearner):
    """TD3's critic loss (min-target + target-policy smoothing) on the
    shared twin-critic machinery; the actor step is DELAYED by the
    caller (``do_actor``)."""

    def __init__(self, policy, cfg, obs_dim: int, act_dim: int,
                 low, high, device: DeviceLike = None):
        super().__init__(
            policy.get_weights(), obs_dim=obs_dim, act_dim=act_dim,
            hidden=cfg.hidden_size, lr=cfg.lr, tau=cfg.tau,
            seed=cfg.seed, device=device,
        )
        self._gamma = cfg.gamma
        self._noise = cfg.target_noise
        self._noise_clip = cfg.target_noise_clip
        self._low = to_device(np.asarray(low, np.float32), self.device)
        self._high = to_device(np.asarray(high, np.float32), self.device)
        self._rng = np.random.RandomState(cfg.seed + 3)

    # Actions are stored in ENV units; critics consume [-1, 1].
    def _from_env(self, a):
        u = (a - self._low) / (self._high - self._low) * 2.0 - 1.0
        return torch.clamp(u, -1.0, 1.0)

    def compute_loss(self, params, target, batch):
        obs, nxt = batch["obs"], batch["next_obs"]
        act = self._from_env(batch["actions"])
        with torch.no_grad():
            # Target-policy smoothing: clipped noise on the target action.
            a2 = DeterministicActorModule.forward(target["actor"], nxt)
            noise = torch.clamp(batch["eps"] * self._noise,
                                -self._noise_clip, self._noise_clip)
            a2 = torch.clamp(a2 + noise, -1.0, 1.0)
            tq = torch.minimum(
                QModule.forward(target["q1"], nxt, a2),
                QModule.forward(target["q2"], nxt, a2),
            )
            backup = batch["rew"] + self._gamma * (1.0 - batch["done"]) * tq
        q1 = QModule.forward(params["q1"], obs, act)
        q2 = QModule.forward(params["q2"], obs, act)
        critic_loss = ((q1 - backup) ** 2 + (q2 - backup) ** 2).mean()
        return critic_loss, {
            "critic_loss": critic_loss,
            "q1_mean": q1.mean(),
        }

    def learn_on_batch(self, batch: SampleBatch, *, do_actor: bool
                       ) -> Dict[str, Any]:
        """One critic step (+ the delayed actor step). Stats stay ON THE
        DEVICE — the caller float()s once per iteration."""
        np_batch = transitions(batch)
        np_batch["eps"] = self._rng.randn(
            batch.count, self._act_dim).astype(np.float32)
        stats = self.update_device(np_batch)
        if do_actor:
            stats = {**stats, **self.actor_update(np_batch)}
        return stats


class TD3(Algorithm):
    def _make_policy_factory(self, obs_dim: int, act_dim: int):
        return deterministic_policy_factory(self, "TD3")

    def _runner_class(self):
        return TransitionEnvRunner

    def _build_learner(self, policy):
        c = self.config
        self.buffer = ReplayBuffer(c.buffer_size, seed=c.seed)
        self._env_steps = 0
        return TD3Learner(policy, c, self._obs_dim, self._num_actions,
                          self._action_low, self._action_high,
                          device=self.device)

    def training_step(self) -> Dict[str, Any]:
        delay = self.config.policy_delay
        return continuous_loop(
            self, lambda i, mb: self.learner.learn_on_batch(
                mb, do_actor=(i % delay == 0)))
