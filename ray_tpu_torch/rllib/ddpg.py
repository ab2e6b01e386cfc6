"""DDPG: deep deterministic policy gradient (counterpart of
``ray_tpu/rllib/ddpg.py``).

Ref analogue: rllib/algorithms/ddpg (Lillicrap 2015) — the TD3
predecessor: ONE critic, no target-policy smoothing, actor updated
every critic step, on ``TwinCriticLearner`` with ``critics=1``. Replay
is fed by transition runners on CPU actors. ``continuous_loop`` below is
the replay loop DDPG, TD3 and SAC share.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from .._device import DeviceLike
from .algorithm import Algorithm, AlgorithmConfig, _PolicyFactory
from .core import (
    DeterministicActorModule,
    QModule,
    TwinCriticLearner,
    to_device,
    to_floats,
)
from .env_runner import NEXT_OBS, TransitionEnvRunner
from .replay_buffers import ReplayBuffer
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

    def build(self, device: DeviceLike = None) -> "DDPG":
        return DDPG(self.copy(), device)


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


def deterministic_policy_factory(algo, name: str):
    """The noisy deterministic policy's factory for a Box env (DDPG's and
    TD3's); a discrete env raises."""
    from .policy import DeterministicPolicy

    if not getattr(algo, "_continuous", False):
        raise ValueError(
            f"{name} supports Box (continuous) action spaces only"
        )
    c = algo.config
    return _PolicyFactory(
        DeterministicPolicy, algo._obs_dim, algo._num_actions,
        algo._action_low, algo._action_high, c.hidden_size, c.seed,
        exploration_noise=c.exploration_noise,
    )


def continuous_loop(algo, update: Callable[[int, SampleBatch], Dict]
                    ) -> Dict[str, Any]:
    """One iteration of the replay loop DDPG, TD3 and SAC share: every
    runner's fragment into the buffer, then (past the warm-up) the
    configured number of ``update(i, minibatch)`` calls (device stats),
    ONE host sync for their stats, and the actor's weights to the
    runners."""
    c = algo.config
    for b in algo.sample_all():
        algo.buffer.add(b)
        algo._env_steps += b.count

    stats: Dict[str, Any] = {}
    num_updates = 0
    if algo._env_steps >= c.num_steps_sampled_before_learning_starts:
        for i in range(c.num_updates_per_iteration):
            # Merge (not replace): TD3's delayed actor step only runs
            # every policy_delay updates — its stats must survive the
            # critic-only updates after it.
            stats.update(update(i, algo.buffer.sample(c.minibatch_size)))
            num_updates += 1
        stats = to_floats(stats)
        algo.broadcast(algo.learner.get_weights())

    return {
        **algo.episode_stats(),
        "num_env_steps_sampled": algo._env_steps,
        "num_learner_updates": num_updates,
        "buffer_size": len(algo.buffer),
        **stats,
    }


class DDPG(Algorithm):
    def _make_policy_factory(self, obs_dim: int, act_dim: int):
        return deterministic_policy_factory(self, "DDPG")

    def _runner_class(self):
        return TransitionEnvRunner

    def _build_learner(self, policy):
        c = self.config
        self.buffer = ReplayBuffer(c.buffer_size, seed=c.seed)
        self._env_steps = 0
        return DDPGLearner(policy, c, self._obs_dim, self._num_actions,
                           self._action_low, self._action_high,
                           device=self.device)

    def training_step(self) -> Dict[str, Any]:
        return continuous_loop(
            self, lambda i, mb: self.learner.learn_on_batch(mb))
