"""R2D2: recurrent experience replay in distributed RL (counterpart of
``ray_tpu/rllib/r2d2.py``).

Ref analogue: rllib/algorithms/r2d2 (Kapturowski 2019). The Q-network is
an LSTM; replay stores fixed-length sequences with the recurrent state
captured at sequence start, and the learner unrolls the online and target
nets over each sequence from that state under a masked double-Q TD loss.
The rollout side (the numpy LSTM cell, the policy, the runner actors) is
the JAX package's, copied. The learner unrolls the cell as a loop of T
steps on the card, in float32, with the gates in the order i, f, g, o and
one bias.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..train.optim import AdamW
from .algorithm import (
    AlgorithmConfig,
    _PolicyFactory,
    episode_result,
    linear_epsilon,
    probe_env,
    stop_actors,
)
from .core import (
    clone_tree,
    take,
    to_device,
    tree_to_device,
    tree_to_numpy,
    value_and_grad,
)
from .policy import init_mlp_params
from .replay_buffers import ReplayBuffer
from .sample_batch import SampleBatch


def _lstm_step_np(w, x, h, c):
    z = x @ w["wx"] + h @ w["wh"] + w["b"]
    H = h.shape[-1]
    i = 1.0 / (1.0 + np.exp(-z[..., :H]))
    f = 1.0 / (1.0 + np.exp(-z[..., H:2 * H]))
    g = np.tanh(z[..., 2 * H:3 * H])
    o = 1.0 / (1.0 + np.exp(-z[..., 3 * H:]))
    c2 = f * c + i * g
    h2 = o * np.tanh(c2)
    return h2, c2


class R2D2Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.buffer_size: int = 2_000       # sequences
        self.num_steps_sampled_before_learning_starts: int = 400
        self.target_network_update_freq: int = 600
        self.num_updates_per_iteration: int = 24
        self.seq_len: int = 12
        self.lstm_size: int = 32
        self.epsilon_initial: float = 1.0
        self.epsilon_final: float = 0.05
        self.epsilon_timesteps: int = 6_000
        self.minibatch_size = 32            # sequences per batch

    def build(self, device: DeviceLike = None) -> "R2D2":
        return R2D2(self.copy(), device)


def _init_params(obs_dim: int, num_actions: int, hidden: int,
                 seed: int) -> Dict[str, Any]:
    rng = np.random.RandomState(seed)
    scale = 1.0 / np.sqrt(obs_dim + hidden)
    return {
        "wx": (rng.randn(obs_dim, 4 * hidden) * scale
               ).astype(np.float32),
        "wh": (rng.randn(hidden, 4 * hidden) * scale
               ).astype(np.float32),
        "b": np.zeros(4 * hidden, np.float32),
        "q": init_mlp_params(rng, [hidden, num_actions]),
    }


class _R2D2Policy:
    """numpy LSTM inference with carried hidden state."""

    def __init__(self, obs_dim, num_actions, hidden, seed):
        self.weights = _init_params(obs_dim, num_actions, hidden, seed)
        self.hidden = hidden
        self.num_actions = num_actions
        self.epsilon = 1.0
        self.reset_state()

    def reset_state(self):
        self.h = np.zeros(self.hidden, np.float32)
        self.c = np.zeros(self.hidden, np.float32)

    def set_weights(self, weights):
        self.weights = weights

    def set_epsilon(self, eps):
        self.epsilon = float(eps)

    def state(self):
        return self.h.copy(), self.c.copy()

    def compute_action(self, obs, rng):
        self.h, self.c = _lstm_step_np(
            self.weights, np.asarray(obs, np.float32).reshape(-1),
            self.h, self.c,
        )
        if rng.rand() < self.epsilon:
            return int(rng.randint(self.num_actions)), 0.0, 0.0
        (Wq, bq), = self.weights["q"]
        return int(np.argmax(self.h @ Wq + bq)), 0.0, 0.0


class _R2D2EnvRunner:
    """Collects padded fixed-length sequences with stored initial
    recurrent state; resets the LSTM at episode boundaries."""

    def __init__(self, env_creator, policy_factory, seed=0,
                 rollout_fragment_length=200, seq_len=12, **_):
        self.env = env_creator()
        self.policy = policy_factory()
        self.rng = np.random.RandomState(seed)
        self.fragment = rollout_fragment_length
        self.L = seq_len
        self._obs, _ = self.env.reset(seed=seed)
        self.policy.reset_state()
        self._episode_reward = 0.0
        self._episode_rewards: List[float] = []

    def set_weights(self, w):
        self.policy.set_weights(w)

    def set_epsilon(self, e):
        self.policy.set_epsilon(e)

    def sample(self) -> SampleBatch:
        L = self.L
        seqs: List[Dict[str, np.ndarray]] = []
        cur = self._new_seq()
        steps = 0
        while steps < self.fragment:
            obs = np.asarray(self._obs, np.float32).reshape(-1)
            a, _, _ = self.policy.compute_action(obs, self.rng)
            nxt, r, term, trunc, _ = self.env.step(a)
            done = bool(term or trunc)
            cur["obs"].append(obs)
            cur["actions"].append(a)
            cur["rewards"].append(float(r))
            cur["dones"].append(bool(term))
            self._episode_reward += float(r)
            steps += 1
            if done:
                self._episode_rewards.append(self._episode_reward)
                self._episode_reward = 0.0
                self._obs, _ = self.env.reset()
                self.policy.reset_state()
                cur["obs"].append(
                    np.asarray(nxt, np.float32).reshape(-1)
                )
                seqs.append(self._finish(cur, L))
                cur = self._new_seq()
            else:
                self._obs = nxt
                if len(cur["actions"]) == L:
                    cur["obs"].append(
                        np.asarray(self._obs, np.float32).reshape(-1)
                    )
                    seqs.append(self._finish(cur, L))
                    cur = self._new_seq()
        if cur["actions"]:
            cur["obs"].append(
                np.asarray(self._obs, np.float32).reshape(-1)
            )
            seqs.append(self._finish(cur, L))
        return SampleBatch({
            k: np.stack([s[k] for s in seqs])
            for k in seqs[0]
        })

    def _new_seq(self):
        h, c = self.policy.state()
        return {"obs": [], "actions": [], "rewards": [], "dones": [],
                "h0": h, "c0": c}

    def _finish(self, cur, L):
        n = len(cur["actions"])
        obs_dim = cur["obs"][0].shape[0]
        obs = np.zeros((L + 1, obs_dim), np.float32)
        obs[:n + 1] = np.stack(cur["obs"])
        out = {
            "obs": obs,
            "actions": np.zeros(L, np.int32),
            "rewards": np.zeros(L, np.float32),
            "dones": np.zeros(L, np.float32),
            "mask": np.zeros(L, np.float32),
            "h0": cur["h0"], "c0": cur["c0"],
        }
        out["actions"][:n] = cur["actions"]
        out["rewards"][:n] = cur["rewards"]
        out["dones"][:n] = np.asarray(cur["dones"], np.float32)
        out["mask"][:n] = 1.0
        return out

    def episode_stats(self) -> Dict[str, float]:
        recent = self._episode_rewards[-20:]
        return {
            "episodes_total": len(self._episode_rewards),
            "episode_reward_mean": float(np.mean(recent))
            if recent else 0.0,
        }


def lstm_unroll(w, obs, h0, c0):
    """The hidden states of the LSTM ``w`` (``wx``, ``wh``, ``b``) over
    ``obs`` [B, T, D] from (h0, c0) [B, H]: [B, T, H]. The input product
    of every step is one GEMM; the recurrence is a loop of T cells."""
    H = h0.shape[-1]
    xw = obs @ w["wx"]                                  # [B, T, 4H]
    h, c, hs = h0, c0, []
    for t in range(obs.shape[1]):
        z = xw[:, t] + h @ w["wh"] + w["b"]
        i = torch.sigmoid(z[..., :H])
        f = torch.sigmoid(z[..., H:2 * H])
        g = torch.tanh(z[..., 2 * H:3 * H])
        o = torch.sigmoid(z[..., 3 * H:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


class R2D2Learner:
    """Sequence double-Q learner: the online and target LSTMs unrolled
    from the stored initial state, a masked TD loss."""

    def __init__(self, obs_dim, num_actions, hidden, lr, gamma, seed,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._params = tree_to_device(
            _init_params(obs_dim, num_actions, hidden, seed), self.device)
        self._target = clone_tree(self._params)
        self._opt = AdamW(lr, weight_decay=0.0)  # optax.adam(lr)
        self._opt_state = self._opt.init(self._params)
        self._gamma = gamma

    @staticmethod
    def q_unroll(w, obs, h0, c0):
        """obs [B, T, D] -> q [B, T, A]."""
        (Wq, bq), = w["q"]
        return lstm_unroll(w, obs, h0, c0) @ Wq + bq

    @staticmethod
    def next_actions(q_all):
        """The online net's pick at each next step (double Q): the first
        of tied maxima, as ``jnp.argmax`` takes."""
        return torch.argmax(q_all[:, 1:], dim=-1)

    def _loss(self, params, target, batch):
        q_all = self.q_unroll(params, batch["obs"], batch["h0"],
                              batch["c0"])                  # [B, T+1, A]
        q_sa = take(q_all[:, :-1], batch["actions"])        # [B, L]
        with torch.no_grad():
            tq_all = self.q_unroll(target, batch["obs"], batch["h0"],
                                   batch["c0"])
            best = self.next_actions(q_all)
            q_next = take(tq_all[:, 1:], best)
            y = batch["rewards"] + self._gamma * (
                1.0 - batch["dones"]) * q_next
        mask = batch["mask"]
        td = (q_sa - y) * mask
        loss = (td * td).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss, None

    def learn_on_batch(self, mb) -> float:
        batch = {k: to_device(mb[k], self.device) for k in
                 ("obs", "actions", "rewards", "dones", "mask", "h0", "c0")}
        (loss, _), grads = value_and_grad(
            self._loss, self._params, self._target, batch)
        self._opt.update(self._params, grads, self._opt_state)
        return float(loss)

    def sync_target(self):
        self._target = clone_tree(self._params)

    def get_weights(self):
        return tree_to_numpy(self._params)

    def set_weights(self, weights):
        self._params = tree_to_device(weights, self.device)


class R2D2:
    def __init__(self, config: R2D2Config, device: DeviceLike = None):
        import ray_tpu_torch as rt

        self.config = config
        self.iteration = 0
        self.device = resolve_device(device)
        c = config
        creator = c.env_creator()
        obs_dim, space = probe_env(creator)
        if not hasattr(space, "n"):
            raise ValueError("R2D2 supports discrete action spaces")
        num_actions = int(space.n)
        self._obs_dim, self._num_actions = obs_dim, num_actions

        policy_factory = _PolicyFactory(_R2D2Policy, obs_dim, num_actions,
                                        c.lstm_size, c.seed)
        runner_cls = rt.remote(_R2D2EnvRunner)
        self.runners = [
            runner_cls.remote(
                creator, policy_factory, seed=c.seed + i,
                rollout_fragment_length=c.rollout_fragment_length,
                seq_len=c.seq_len,
            )
            for i in range(c.num_env_runners)
        ]
        self.learner = R2D2Learner(
            obs_dim, num_actions, c.lstm_size, c.lr, c.gamma, c.seed,
            device=self.device,
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
            self._env_steps += int(b["mask"].sum())

        loss = float("nan")
        num_updates = 0
        if self._env_steps >= c.num_steps_sampled_before_learning_starts:
            for _ in range(c.num_updates_per_iteration):
                mb = self.buffer.sample(c.minibatch_size)
                loss = self.learner.learn_on_batch(mb)
                num_updates += 1
            if (self._env_steps - self._last_target_sync
                    >= c.target_network_update_freq):
                self.learner.sync_target()
                self._last_target_sync = self._env_steps
            w = self.learner.get_weights()
            rt.get([r.set_weights.remote(w) for r in self.runners])

        ep = episode_result(
            rt.get([r.episode_stats.remote() for r in self.runners]))
        return {
            "training_iteration": self.iteration,
            **ep,
            "num_env_steps_sampled": self._env_steps,
            "num_learner_updates": num_updates,
            "epsilon": eps,
            "loss": loss,
        }

    def get_weights(self):
        return self.learner.get_weights()

    def stop(self):
        stop_actors(self.runners)
