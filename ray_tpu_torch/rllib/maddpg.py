"""MADDPG: multi-agent DDPG with centralized critics (counterpart of
``ray_tpu/rllib/maddpg.py``).

Ref analogue: rllib/algorithms/maddpg (Lowe 2017). Execution is
decentralized (each agent's deterministic actor sees its own observation);
training is centralized: each agent's critic Q_i(o_all, a_all) sees every
agent's observation and action, with the other agents' next actions from
their target actors. One update sums the critics' and the actors'
gradients into one Adam step over the whole tree, then polyaks every
target. The runner actors (the dict multi-agent env convention with Box
actions) are the JAX package's, copied.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from .algorithm import AlgorithmConfig, episode_result, stop_actors
from .core import (
    DeterministicActorModule,
    Learner,
    QModule,
    polyak_,
    to_device,
    to_floats,
    tree_map,
    tree_to_numpy,
    value_and_grad,
)
from .policy import init_mlp_params
from .replay_buffers import ReplayBuffer
from .sample_batch import SampleBatch


class MADDPGConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.buffer_size: int = 50_000
        self.num_steps_sampled_before_learning_starts: int = 500
        self.num_updates_per_iteration: int = 48
        self.tau: float = 0.01
        self.exploration_noise: float = 0.2
        # probed/declared dims
        self.act_dim: int = 0   # per-agent Box action dim (required)

    def build(self, device: DeviceLike = None) -> "MADDPG":
        return MADDPG(self.copy(), device)


def _joint(x):  # [B, A, D] -> [B, A*D]
    return x.reshape(x.shape[0], -1)


class MADDPGLearner(Learner):
    """params: {actor_<i>, q_<i>} per agent, every subtree with a polyak
    target. One step: the critics on the joint transition, each actor
    maximising its own centralized Q with the other agents' logged actions
    held fixed."""

    def __init__(self, n_agents: int, obs_dim: int, act_dim: int,
                 hidden: int, lr: float, tau: float, gamma: float,
                 seed: int, device: DeviceLike = None):
        joint_obs = n_agents * obs_dim
        joint_act = n_agents * act_dim
        params: Dict[str, Any] = {}
        for i in range(n_agents):
            params[f"actor_{i}"] = DeterministicActorModule(
                obs_dim, act_dim, hidden, seed + i
            ).init_params()
            params[f"q_{i}"] = QModule(
                joint_obs, joint_act, hidden, seed + 100 + i
            ).init_params()
        super().__init__(params, lr=lr, target_keys=tuple(params),
                         tau=tau, device=device)
        self._n = n_agents
        self._gamma = gamma
        self._obs_dim = obs_dim
        self._act_dim = act_dim

    def _critic_loss(self, params, target, batch):
        n = self._n
        with torch.no_grad():
            # The next joint action from ALL target actors.
            a2 = torch.stack([
                DeterministicActorModule.forward(
                    target[f"actor_{j}"], batch["next_obs"][:, j])
                for j in range(n)
            ], dim=1)
        total, stats = 0.0, {}
        for i in range(n):
            with torch.no_grad():
                tq = QModule.forward(target[f"q_{i}"],
                                     _joint(batch["next_obs"]), _joint(a2))
                backup = batch["rew"][:, i] + self._gamma * (
                    1.0 - batch["done"]) * tq
            q = QModule.forward(params[f"q_{i}"], _joint(batch["obs"]),
                                _joint(batch["actions"]))
            li = ((q - backup) ** 2).mean()
            total = total + li
            stats[f"critic_loss_{i}"] = li
        return total, stats

    def _actor_loss(self, params, batch):
        n, total = self._n, 0.0
        for i in range(n):
            # Agent i's own action from its actor; the others' logged
            # actions and Q_i's weights are constants here.
            acts = [DeterministicActorModule.forward(
                        params[f"actor_{j}"], batch["obs"][:, j])
                    if j == i else batch["actions"][:, j]
                    for j in range(n)]
            q_i = tree_map(torch.Tensor.detach, params[f"q_{i}"])
            q = QModule.forward(q_i, _joint(batch["obs"]),
                                _joint(torch.stack(acts, dim=1)))
            total = total - q.mean()
        return total

    def _losses(self, params, target, batch):
        closs, stats = self._critic_loss(params, target, batch)
        aloss = self._actor_loss(params, batch)
        # The actor loss reaches only the actors and the critic loss only
        # the critics: one backward of the sum is the sum of the two
        # gradients.
        return closs + aloss, {**stats, "actor_loss": aloss.detach(),
                               "critic_loss": closs.detach()}

    def learn_on_batch(self, np_batch) -> Dict[str, Any]:
        """One step; the stats stay on the device."""
        batch = {k: to_device(v, self.device) for k, v in np_batch.items()}
        (_, stats), grads = value_and_grad(self._losses, self._params,
                                           self._target, batch)
        self._opt.update(self._params, grads, self._opt_state)
        for k in self._target_keys:
            polyak_(self._target[k], self._params[k], self._tau)
        self.num_updates += 1
        return {k: v.detach() for k, v in stats.items()}

    def actor_weights(self) -> List[Any]:
        return [tree_to_numpy(self._params[f"actor_{i}"])
                for i in range(self._n)]


class _MADDPGEnvRunner:
    """Steps the dict env with per-agent deterministic actors and
    exploration noise; emits joint transitions."""

    def __init__(self, env_creator, agent_ids, obs_dim, act_dim,
                 low, high, hidden, noise, seed: int = 0,
                 rollout_fragment_length: int = 200):
        self.env = env_creator()
        self.agent_ids = list(agent_ids)
        rng = np.random.RandomState(seed)
        self.weights = [
            {
                "trunk": init_mlp_params(rng, [obs_dim, hidden, hidden]),
                "mu": init_mlp_params(rng, [hidden, act_dim]),
            }
            for _ in self.agent_ids
        ]
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)
        self.noise = noise
        self.act_dim = act_dim
        self.rng = np.random.RandomState(seed)
        self.fragment = rollout_fragment_length
        self._obs, _ = self.env.reset(seed=seed)
        self._episode_reward = 0.0
        self._episode_rewards: List[float] = []

    def set_weights(self, weights: List[Any]):
        self.weights = weights

    def _act(self, i: int, obs: np.ndarray) -> np.ndarray:
        h = obs.reshape(-1)
        for W, b in self.weights[i]["trunk"]:
            h = np.tanh(h @ W + b)
        (Wm, bm), = self.weights[i]["mu"]
        u = np.tanh(h @ Wm + bm)
        u = np.clip(u + self.noise * self.rng.randn(self.act_dim),
                    -1.0, 1.0)
        return (self.low + (u + 1.0) * 0.5
                * (self.high - self.low)).astype(np.float32)

    def _stack(self, obs_dict):
        return np.stack([
            np.asarray(obs_dict[a], np.float32).reshape(-1)
            for a in self.agent_ids
        ])

    def sample(self) -> SampleBatch:
        obs_l, act_l, rew_l, done_l, next_l = [], [], [], [], []
        for _ in range(self.fragment):
            joint = self._stack(self._obs)
            # Critics train on [-1,1] actions; env gets scaled ones.
            unit_actions = []
            env_actions = {}
            for i, a in enumerate(self.agent_ids):
                env_a = self._act(i, joint[i])
                u = (env_a - self.low) / (self.high - self.low) \
                    * 2.0 - 1.0
                unit_actions.append(u.astype(np.float32))
                env_actions[a] = env_a
            nxt, rew, term, trunc, _ = self.env.step(env_actions)
            done = bool(term.get("__all__")) or bool(
                trunc.get("__all__")
            )
            obs_l.append(joint)
            act_l.append(np.stack(unit_actions))
            rew_l.append([float(rew[a]) for a in self.agent_ids])
            done_l.append(bool(term.get("__all__")))
            next_l.append(self._stack(nxt))
            self._episode_reward += float(sum(rew.values()))
            if done:
                self._episode_rewards.append(self._episode_reward)
                self._episode_reward = 0.0
                self._obs, _ = self.env.reset()
            else:
                self._obs = nxt
        return SampleBatch({
            "obs": np.stack(obs_l),            # [T, A, obs]
            "actions": np.stack(act_l),        # [T, A, act] in [-1,1]
            "rew": np.asarray(rew_l, np.float32),   # [T, A]
            "done": np.asarray(done_l, np.float32),
            "next_obs": np.stack(next_l),
        })

    def episode_stats(self) -> Dict[str, float]:
        recent = self._episode_rewards[-20:]
        return {
            "episodes_total": len(self._episode_rewards),
            "episode_reward_mean": float(np.mean(recent))
            if recent else 0.0,
        }


class MADDPG:
    def __init__(self, config: MADDPGConfig, device: DeviceLike = None):
        import ray_tpu_torch as rt

        self.config = config
        self.iteration = 0
        self.device = resolve_device(device)
        c = config
        creator = c.env_creator()
        probe = creator()
        obs0, _ = probe.reset(seed=0)
        self.agent_ids = sorted(obs0.keys())
        n = len(self.agent_ids)
        obs_dim = int(np.prod(np.asarray(
            obs0[self.agent_ids[0]]).shape))
        if hasattr(probe, "close"):
            probe.close()
        low = -np.ones(c.act_dim, np.float32)
        high = np.ones(c.act_dim, np.float32)
        if hasattr(probe, "action_low"):
            low = np.asarray(probe.action_low, np.float32)
            high = np.asarray(probe.action_high, np.float32)
        self._n, self._obs_dim = n, obs_dim

        runner_cls = rt.remote(_MADDPGEnvRunner)
        self.runners = [
            runner_cls.remote(
                creator, self.agent_ids, obs_dim, c.act_dim, low, high,
                c.hidden_size, c.exploration_noise, seed=c.seed + i,
                rollout_fragment_length=c.rollout_fragment_length,
            )
            for i in range(c.num_env_runners)
        ]
        self.learner = MADDPGLearner(
            n, obs_dim, c.act_dim, c.hidden_size, c.lr, c.tau,
            c.gamma, c.seed, device=self.device,
        )
        self.buffer = ReplayBuffer(c.buffer_size, seed=c.seed)
        self._env_steps = 0

    def train(self) -> Dict[str, Any]:
        import ray_tpu_torch as rt

        self.iteration += 1
        c = self.config
        batches = rt.get([r.sample.remote() for r in self.runners])
        for b in batches:
            self.buffer.add(b)
            self._env_steps += b.count

        stats: Dict[str, Any] = {}
        num_updates = 0
        if self._env_steps >= c.num_steps_sampled_before_learning_starts:
            for _ in range(c.num_updates_per_iteration):
                mb = self.buffer.sample(c.minibatch_size)
                stats = self.learner.learn_on_batch({
                    "obs": mb["obs"], "actions": mb["actions"],
                    "rew": mb["rew"], "done": mb["done"],
                    "next_obs": mb["next_obs"],
                })
                num_updates += 1
            stats = to_floats(stats)
            weights = self.learner.actor_weights()
            rt.get([r.set_weights.remote(weights) for r in self.runners])

        ep = episode_result(
            rt.get([r.episode_stats.remote() for r in self.runners]))
        return {
            "training_iteration": self.iteration,
            **ep,
            "num_env_steps_sampled": self._env_steps,
            "num_learner_updates": num_updates,
            **stats,
        }

    def get_weights(self):
        return self.learner.actor_weights()

    def stop(self):
        stop_actors(self.runners)
