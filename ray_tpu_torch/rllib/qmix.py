"""QMIX: cooperative multi-agent Q-learning with monotonic value mixing
(counterpart of ``ray_tpu/rllib/qmix.py``).

Ref analogue: rllib/algorithms/qmix (Rashid 2018). Agents share one
utility network Q_a(o_a, .); a mixing hypernetwork combines the chosen
per-agent utilities into Q_tot conditioned on the global state, kept
monotonic by abs() weights, so the per-agent argmax is the team's. TD
target: y = r_team + gamma (1-d) Q_tot'(s', max_a Q_a'(o'_a, .)), with the
whole tree's target hard-synced by ``sync_target``. The runner actors
(the dict multi-agent env convention, every agent present each step) are
the JAX package's, copied.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from .algorithm import (
    AlgorithmConfig,
    _PolicyFactory,
    episode_result,
    linear_epsilon,
    stop_actors,
)
from .core import (
    Learner,
    RLModule,
    clone_tree,
    take,
    to_floats,
    tree_to_numpy,
)
from .policy import QPolicy, init_mlp_params
from .replay_buffers import ReplayBuffer
from .sample_batch import SampleBatch


class QMIXConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.buffer_size: int = 50_000
        self.num_steps_sampled_before_learning_starts: int = 500
        self.target_network_update_freq: int = 500
        self.num_updates_per_iteration: int = 32
        self.mixing_embed_dim: int = 16
        self.epsilon_initial: float = 1.0
        self.epsilon_final: float = 0.05
        self.epsilon_timesteps: int = 8_000
        # agent ids (sorted) + per-agent spaces; probed from the env
        self.obs_dim: int = 0
        self.num_actions: int = 0

    def build(self, device: DeviceLike = None) -> "QMIX":
        return QMIX(self.copy(), device)


class QMIXLearner(Learner):
    """params: {agent: {trunk, q}, mix: hypernet linears}. The target is
    the whole tree, copied by ``sync_target()`` (periodic hard copies like
    DQN's, not polyak)."""

    def __init__(self, agent_params, *, n_agents: int, obs_dim: int,
                 num_actions: int, state_dim: int, embed: int,
                 lr: float, gamma: float, seed: int,
                 device: DeviceLike = None):
        rng = np.random.RandomState(seed + 7)
        params = {
            "agent": agent_params,
            "mix": {
                "hw1": init_mlp_params(rng,
                                       [state_dim, n_agents * embed]),
                "hb1": init_mlp_params(rng, [state_dim, embed]),
                "hw2": init_mlp_params(rng, [state_dim, embed]),
                "hb2": init_mlp_params(rng, [state_dim, embed, 1]),
            },
        }
        super().__init__(params, lr=lr, device=device)
        self._gamma = gamma
        self._shape = (n_agents, embed, num_actions)
        self._target_full = clone_tree(self._params)

    @staticmethod
    def agent_q(agent, obs):
        """Q_a for stacked per-agent obs [B, A, obs_dim] -> [B, A, n]."""
        (Wq, bq), = agent["q"]
        return RLModule.mlp(agent["trunk"], obs) @ Wq + bq

    def _mix(self, mix, state, qa):
        """Monotonic mixing: qa [B, A] + state [B, S] -> Q_tot [B]."""
        A, H, _ = self._shape
        (W1, c1), = mix["hw1"]
        (Wb1, cb1), = mix["hb1"]
        (W2, c2), = mix["hw2"]
        w1 = torch.abs(state @ W1 + c1).reshape(-1, A, H)
        b1 = (state @ Wb1 + cb1)[:, None, :]
        hidden = F.elu(qa[:, None, :] @ w1 + b1)        # [B, 1, H]
        w2 = torch.abs(state @ W2 + c2)[:, :, None]     # [B, H, 1]
        # b2: 2-layer state-conditioned scalar (Rashid 2018 eq. 6).
        (Wv1, cv1), (Wv2, cv2) = mix["hb2"]
        b2 = torch.tanh(state @ Wv1 + cv1) @ Wv2 + cv2
        return (hidden @ w2)[:, 0, 0] + b2[:, 0]

    def compute_loss(self, params, target, batch):
        qa_all = self.agent_q(params["agent"], batch["obs"])
        q_chosen = take(qa_all, batch["actions"])       # [B, A]
        q_tot = self._mix(params["mix"], batch["state"], q_chosen)
        # Target: per-agent greedy utilities mixed by the target net.
        with torch.no_grad():
            tgt = self._target_full
            qa_next = self.agent_q(tgt["agent"], batch["next_obs"])
            q_next = qa_next.max(dim=-1).values          # [B, A]
            tq_tot = self._mix(tgt["mix"], batch["next_state"], q_next)
            y = batch["rew"] + self._gamma * (1.0 - batch["done"]) * tq_tot
        td = q_tot - y
        loss = (td * td).mean()
        return loss, {"td_loss": loss, "q_tot_mean": q_tot.mean()}

    def update_qmix(self, np_batch) -> Dict[str, Any]:
        """One step against the hard-synced target tree; the stats stay on
        the device."""
        return self.update_device(np_batch)

    def sync_target(self):
        self._target_full = clone_tree(self._params)

    def agent_weights(self):
        """Per-agent utility net weights for the rollout QPolicies."""
        return tree_to_numpy(self._params["agent"])


class _QMIXEnvRunner:
    """Steps the dict env with shared epsilon-greedy agent policies;
    emits joint transitions (obs/actions stacked over the sorted agent
    axis, team reward summed)."""

    def __init__(self, env_creator, policy_factory, agent_ids,
                 seed: int = 0, rollout_fragment_length: int = 200,
                 **_):
        self.env = env_creator()
        self.policy = policy_factory()   # ONE shared utility net
        self.agent_ids = list(agent_ids)
        self.rng = np.random.RandomState(seed)
        self.fragment = rollout_fragment_length
        self._obs, _ = self.env.reset(seed=seed)
        self._episode_reward = 0.0
        self._episode_rewards: List[float] = []

    def set_weights(self, weights):
        self.policy.set_weights(weights)

    def set_epsilon(self, eps: float):
        self.policy.set_epsilon(eps)

    def _stack(self, obs_dict):
        return np.stack([
            np.asarray(obs_dict[a], np.float32).reshape(-1)
            for a in self.agent_ids
        ])

    def sample(self) -> SampleBatch:
        obs_l, act_l, rew_l, done_l, next_l = [], [], [], [], []
        for _ in range(self.fragment):
            joint = self._stack(self._obs)
            actions = {
                a: self.policy.compute_action(joint[i], self.rng)[0]
                for i, a in enumerate(self.agent_ids)
            }
            nxt, rew, term, trunc, _ = self.env.step(actions)
            done = bool(term.get("__all__")) or bool(
                trunc.get("__all__")
            )
            team_r = float(sum(rew.values()))
            obs_l.append(joint)
            act_l.append([actions[a] for a in self.agent_ids])
            rew_l.append(team_r)
            done_l.append(bool(term.get("__all__")))
            next_l.append(self._stack(nxt))
            self._episode_reward += team_r
            if done:
                self._episode_rewards.append(self._episode_reward)
                self._episode_reward = 0.0
                self._obs, _ = self.env.reset()
            else:
                self._obs = nxt
        return SampleBatch({
            "obs": np.stack(obs_l),          # [T, A, obs_dim]
            "actions": np.asarray(act_l, np.int32),
            "rew": np.asarray(rew_l, np.float32),
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


class QMIX:
    def __init__(self, config: QMIXConfig, device: DeviceLike = None):
        import ray_tpu_torch as rt

        self.config = config
        self.iteration = 0
        self.device = resolve_device(device)
        c = config
        creator = c.env_creator()
        probe = creator()
        obs0, _ = probe.reset(seed=0)
        self.agent_ids = sorted(obs0.keys())
        n_agents = len(self.agent_ids)
        obs_dim = c.obs_dim or int(
            np.prod(np.asarray(obs0[self.agent_ids[0]]).shape)
        )
        if not c.num_actions:
            raise ValueError("QMIXConfig.training(num_actions=...) "
                             "required")
        if hasattr(probe, "close"):
            probe.close()
        self._n_agents, self._obs_dim = n_agents, obs_dim
        state_dim = n_agents * obs_dim

        policy_factory = _PolicyFactory(QPolicy, obs_dim, c.num_actions,
                                        c.hidden_size, c.seed)
        runner_cls = rt.remote(_QMIXEnvRunner)
        self.runners = [
            runner_cls.remote(
                creator, policy_factory, self.agent_ids,
                seed=c.seed + i,
                rollout_fragment_length=c.rollout_fragment_length,
            )
            for i in range(c.num_env_runners)
        ]
        self.learner = QMIXLearner(
            policy_factory().get_weights(),
            n_agents=n_agents, obs_dim=obs_dim,
            num_actions=c.num_actions, state_dim=state_dim,
            embed=c.mixing_embed_dim, lr=c.lr, gamma=c.gamma,
            seed=c.seed, device=self.device,
        )
        self.buffer = ReplayBuffer(c.buffer_size, seed=c.seed)
        self._env_steps = 0
        self._last_target_sync = 0

    def _epsilon(self) -> float:
        return linear_epsilon(self.config, self._env_steps)

    def train(self) -> Dict[str, Any]:
        import ray_tpu_torch as rt

        self.iteration += 1
        c = self.config
        eps = self._epsilon()
        rt.get([r.set_epsilon.remote(eps) for r in self.runners])
        batches = rt.get([r.sample.remote() for r in self.runners])
        for b in batches:
            self.buffer.add(b)
            self._env_steps += b.count

        stats: Dict[str, Any] = {}
        num_updates = 0
        if self._env_steps >= c.num_steps_sampled_before_learning_starts:
            for _ in range(c.num_updates_per_iteration):
                mb = self.buffer.sample(c.minibatch_size)
                obs = np.asarray(mb["obs"], np.float32)
                nxt = np.asarray(mb["next_obs"], np.float32)
                stats = self.learner.update_qmix({
                    "obs": obs,
                    "state": obs.reshape(len(obs), -1),
                    "actions": np.asarray(mb["actions"], np.int32),
                    "rew": np.asarray(mb["rew"], np.float32),
                    "done": np.asarray(mb["done"], np.float32),
                    "next_obs": nxt,
                    "next_state": nxt.reshape(len(nxt), -1),
                })
                num_updates += 1
            stats = to_floats(stats)
            if (self._env_steps - self._last_target_sync
                    >= c.target_network_update_freq):
                self.learner.sync_target()
                self._last_target_sync = self._env_steps
            weights = self.learner.agent_weights()
            rt.get([r.set_weights.remote(weights) for r in self.runners])

        ep = episode_result(
            rt.get([r.episode_stats.remote() for r in self.runners]))
        return {
            "training_iteration": self.iteration,
            **ep,
            "num_env_steps_sampled": self._env_steps,
            "num_learner_updates": num_updates,
            "epsilon": eps,
            **stats,
        }

    def get_weights(self):
        return self.learner.agent_weights()

    def stop(self):
        stop_actors(self.runners)
