"""DDPG's learner: deep deterministic policy gradient (counterpart of
``ray_tpu/rllib/ddpg.py``'s ``DDPGConfig`` and ``DDPGLearner``).

Ref analogue: rllib/algorithms/ddpg (Lillicrap 2015) — the TD3
predecessor: ONE critic, no target-policy smoothing, actor updated
every critic step, on ``TwinCriticLearner`` with ``critics=1``. The
algorithm's replay loop waits for the actor runtime.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .._device import DeviceLike
from .algorithm import AlgorithmConfig
from .core import (
    DeterministicActorModule,
    QModule,
    TwinCriticLearner,
    to_device,
)
from .env_runner import NEXT_OBS
from .sample_batch import ACTIONS, DONES, OBS, REWARDS, SampleBatch


class DDPGConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.buffer_size: int = 100_000
        self.num_steps_sampled_before_learning_starts: int = 500
        self.num_updates_per_iteration: int = 64
        self.tau: float = 0.005
        self.exploration_noise: float = 0.1


def transitions(batch: SampleBatch) -> Dict[str, np.ndarray]:
    """A replay minibatch in the critic losses' layout."""
    return {
        "obs": batch[OBS],
        "actions": np.asarray(batch[ACTIONS], np.float32),
        "rew": batch[REWARDS],
        "done": np.asarray(batch[DONES], np.float32),
        "next_obs": batch[NEXT_OBS],
    }


class DDPGLearner(TwinCriticLearner):
    """Single-critic TD loss: backup = r + gamma*(1-d)*Q'(s', pi'(s'))
    — no twin-min, no smoothing noise (those are TD3's additions)."""

    def __init__(self, policy, cfg, obs_dim: int, act_dim: int,
                 low, high, device: DeviceLike = None):
        super().__init__(
            policy.get_weights(), obs_dim=obs_dim, act_dim=act_dim,
            hidden=cfg.hidden_size, lr=cfg.lr, tau=cfg.tau,
            seed=cfg.seed, critics=1, device=device,
        )
        self._gamma = cfg.gamma
        self._low = to_device(np.asarray(low, np.float32), self.device)
        self._high = to_device(np.asarray(high, np.float32), self.device)

    # Actions are stored in ENV units; critics consume [-1, 1].
    def _from_env(self, a):
        u = (a - self._low) / (self._high - self._low) * 2.0 - 1.0
        return torch.clamp(u, -1.0, 1.0)

    def compute_loss(self, params, target, batch):
        obs, nxt = batch["obs"], batch["next_obs"]
        act = self._from_env(batch["actions"])
        with torch.no_grad():
            a2 = DeterministicActorModule.forward(target["actor"], nxt)
            tq = QModule.forward(target["q1"], nxt, a2)
            backup = batch["rew"] + self._gamma * (1.0 - batch["done"]) * tq
        q = QModule.forward(params["q1"], obs, act)
        critic_loss = ((q - backup) ** 2).mean()
        return critic_loss, {
            "critic_loss": critic_loss,
            "q_mean": q.mean(),
        }

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, Any]:
        """One critic step + one actor step (every step — no delay).
        Stats stay ON THE DEVICE; callers float() once per iteration."""
        np_batch = transitions(batch)
        stats = self.update_device(np_batch)
        return {**stats, **self.actor_update(np_batch)}
