"""EnvRunner: environment stepping on CPU actors.

Ref analogue: rllib/env/single_agent_env_runner.py (new stack) /
evaluation/rollout_worker.py RolloutWorker (:159, sample:653). Receives
policy weights, steps a gymnasium-style env, returns SampleBatches. The
learner on the card never touches the env (env stepping is the CPU hot
loop; learning is the card's).

A copy of ``ray_tpu/rllib/env_runner.py`` (numpy); every runner of this
module starts in a worker without torch.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np

from .sample_batch import (
    ACTIONS,
    BOOTSTRAP_OBS,
    DONES,
    LOGPS,
    OBS,
    REWARDS,
    SampleBatch,
    VALUES,
    compute_gae,
)


class EnvRunner:
    def __init__(self, env_creator: Callable[[], Any], policy_factory,
                 seed: int = 0, rollout_fragment_length: int = 200,
                 gamma: float = 0.99, lam: float = 0.95):
        self.env = env_creator()
        self.policy = policy_factory()
        self.rng = np.random.RandomState(seed)
        self.fragment = rollout_fragment_length
        self.gamma = gamma
        self.lam = lam
        self._obs, _ = self.env.reset(seed=seed)
        self._episode_reward = 0.0
        self._episode_len = 0
        self._episode_rewards = []

    def set_weights(self, weights):
        self.policy.set_weights(weights)

    def sample(self) -> SampleBatch:
        obs_l, act_l, rew_l, done_l, logp_l, val_l = [], [], [], [], [], []
        for _ in range(self.fragment):
            action, logp, value = self.policy.compute_action(
                np.asarray(self._obs, dtype=np.float32), self.rng
            )
            nxt, reward, terminated, truncated, _ = self.env.step(action)
            done = bool(terminated or truncated)
            obs_l.append(np.asarray(self._obs, dtype=np.float32))
            act_l.append(action)
            rew_l.append(float(reward))
            done_l.append(done)
            logp_l.append(float(logp))
            val_l.append(float(value))
            self._episode_reward += float(reward)
            self._episode_len += 1
            if done:
                self._episode_rewards.append(self._episode_reward)
                self._episode_reward = 0.0
                self._episode_len = 0
                self._obs, _ = self.env.reset()
            else:
                self._obs = nxt
        last_value = 0.0
        if not done_l[-1]:
            _, _, last_value = self.policy.compute_action(
                np.asarray(self._obs, dtype=np.float32), self.rng
            )
        batch = SampleBatch({
            OBS: np.stack(obs_l),
            ACTIONS: np.asarray(act_l),
            REWARDS: np.asarray(rew_l, dtype=np.float32),
            DONES: np.asarray(done_l),
            LOGPS: np.asarray(logp_l, dtype=np.float32),
            VALUES: np.asarray(val_l, dtype=np.float32),
            # Post-fragment observation for the learner's value bootstrap
            # (if the fragment ended on done, V(s_{T+1}) is masked by
            # (1-done) anyway, so the reset obs here is harmless).
            BOOTSTRAP_OBS: np.asarray(self._obs, dtype=np.float32),
        })
        batch.update(compute_gae(
            batch[REWARDS], batch[VALUES], batch[DONES], float(last_value),
            gamma=self.gamma, lam=self.lam,
        ))
        return batch

    def episode_stats(self) -> Dict[str, float]:
        recent = self._episode_rewards[-20:]
        out = {
            "episodes_total": len(self._episode_rewards),
            "episode_reward_mean": float(np.mean(recent)) if recent else 0.0,
        }
        return out


NEXT_OBS = "next_obs"
BOUNDARY = "boundary"  # episode ended here (terminated OR truncated)


class TransitionEnvRunner(EnvRunner):
    """Off-policy variant: collects raw (s, a, r, s', done) transitions for
    a replay buffer instead of GAE-postprocessed fragments (ref analogue:
    the rollout path feeding EpisodeReplayBuffer in the DQN stack)."""

    def set_epsilon(self, epsilon: float):
        self.policy.set_epsilon(epsilon)

    def set_exploration_noise(self, noise: float):
        """Gaussian-noise scale for deterministic policies (the Ape-X
        DDPG ladder)."""
        self.policy.exploration_noise = float(noise)

    def sample(self) -> SampleBatch:
        obs_l, act_l, rew_l, done_l, next_l, bound_l = \
            [], [], [], [], [], []
        for _ in range(self.fragment):
            action, _, _ = self.policy.compute_action(
                np.asarray(self._obs, dtype=np.float32), self.rng
            )
            nxt, reward, terminated, truncated, _ = self.env.step(action)
            done = bool(terminated or truncated)
            obs_l.append(np.asarray(self._obs, dtype=np.float32).reshape(-1))
            act_l.append(action)
            rew_l.append(float(reward))
            # Bootstrapping must stop at TERMINATION but not truncation
            # (time limits are not environment death); multi-step
            # lookaheads must stop at BOTH (the env resets either way).
            done_l.append(bool(terminated))
            bound_l.append(done)
            next_l.append(np.asarray(nxt, dtype=np.float32).reshape(-1))
            self._episode_reward += float(reward)
            self._episode_len += 1
            if done:
                self._episode_rewards.append(self._episode_reward)
                self._episode_reward = 0.0
                self._episode_len = 0
                self._obs, _ = self.env.reset()
            else:
                self._obs = nxt
        return SampleBatch({
            OBS: np.stack(obs_l),
            ACTIONS: np.asarray(act_l),
            REWARDS: np.asarray(rew_l, dtype=np.float32),
            DONES: np.asarray(done_l),
            BOUNDARY: np.asarray(bound_l),
            NEXT_OBS: np.stack(next_l),
        })
