"""Policies.

Ref analogue: rllib/policy/ + new-stack rl_module. The rollout-side policy
is pure numpy (env stepping stays light and off the card); the Learner
trains the same parameter tree with PyTorch on the card and hands the
weights back as numpy. A copy of ``ray_tpu/rllib/policy.py``: both
packages draw the same initial weights from the same seed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def init_mlp_params(
    rng: np.random.RandomState, sizes: List[int]
) -> List[Tuple[np.ndarray, np.ndarray]]:
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        W = rng.randn(fan_in, fan_out).astype(np.float32) * np.sqrt(
            2.0 / fan_in
        )
        b = np.zeros(fan_out, dtype=np.float32)
        params.append((W, b))
    return params


class MLPPolicy:
    """Discrete-action actor-critic MLP; numpy inference."""

    def __init__(self, obs_dim: int, num_actions: int, hidden: int = 64,
                 seed: int = 0):
        rng = np.random.RandomState(seed)
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.weights: Dict[str, List] = {
            "trunk": init_mlp_params(rng, [obs_dim, hidden, hidden]),
            "pi": init_mlp_params(rng, [hidden, num_actions]),
            "vf": init_mlp_params(rng, [hidden, 1]),
        }

    def set_weights(self, weights):
        self.weights = weights

    def get_weights(self):
        return self.weights

    def _trunk(self, x: np.ndarray) -> np.ndarray:
        for W, b in self.weights["trunk"]:
            x = np.tanh(x @ W + b)
        return x

    def logits_and_value(self, obs: np.ndarray):
        h = self._trunk(obs)
        (Wp, bp), = self.weights["pi"]
        (Wv, bv), = self.weights["vf"]
        return h @ Wp + bp, (h @ Wv + bv)[..., 0]

    def compute_action(self, obs: np.ndarray, rng: np.random.RandomState):
        # The net is sized with np.prod(observation_space.shape); flatten so
        # multi-dimensional observation spaces work.
        logits, value = self.logits_and_value(np.asarray(obs).reshape(-1)[None])
        logits = logits[0] - logits[0].max()
        probs = np.exp(logits)
        probs /= probs.sum()
        action = int(rng.choice(self.num_actions, p=probs))
        logp = float(np.log(probs[action] + 1e-12))
        return action, logp, float(value[0])


class QPolicy:
    """Discrete-action Q-network MLP; numpy inference with epsilon-greedy
    exploration (ref analogue: the DQN RLModule's inference path +
    EpsilonGreedy exploration, rllib/utils/exploration/epsilon_greedy.py)."""

    def __init__(self, obs_dim: int, num_actions: int, hidden: int = 64,
                 seed: int = 0):
        rng = np.random.RandomState(seed)
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.epsilon = 1.0
        self.weights: Dict[str, List] = {
            "trunk": init_mlp_params(rng, [obs_dim, hidden, hidden]),
            "q": init_mlp_params(rng, [hidden, num_actions]),
        }

    def set_weights(self, weights):
        self.weights = weights

    def get_weights(self):
        return self.weights

    def set_epsilon(self, epsilon: float):
        self.epsilon = float(epsilon)

    def q_values(self, obs: np.ndarray) -> np.ndarray:
        h = obs
        for W, b in self.weights["trunk"]:
            h = np.tanh(h @ W + b)
        (Wq, bq), = self.weights["q"]
        return h @ Wq + bq

    def compute_action(self, obs: np.ndarray, rng: np.random.RandomState):
        if rng.rand() < self.epsilon:
            action = int(rng.randint(self.num_actions))
        else:
            q = self.q_values(np.asarray(obs).reshape(-1)[None])[0]
            action = int(np.argmax(q))
        # (action, logp, value) signature shared with MLPPolicy so runners
        # are interchangeable; Q-learning has no logp/value at sample time.
        return action, 0.0, 0.0


class DuelingQPolicy(QPolicy):
    """Dueling-architecture Q network (Wang 2016, ref analogue: the
    reference DQN stack's dueling head): Q(s,a) = V(s) + A(s,a) -
    mean_a A(s,a); numpy inference, epsilon-greedy shared with
    QPolicy."""

    def __init__(self, obs_dim: int, num_actions: int, hidden: int = 64,
                 seed: int = 0):
        rng = np.random.RandomState(seed)
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.epsilon = 1.0
        self.weights: Dict[str, List] = {
            "trunk": init_mlp_params(rng, [obs_dim, hidden, hidden]),
            "v": init_mlp_params(rng, [hidden, 1]),
            "a": init_mlp_params(rng, [hidden, num_actions]),
        }

    def q_values(self, obs: np.ndarray) -> np.ndarray:
        h = obs
        for W, b in self.weights["trunk"]:
            h = np.tanh(h @ W + b)
        (Wv, bv), = self.weights["v"]
        (Wa, ba), = self.weights["a"]
        v = h @ Wv + bv
        a = h @ Wa + ba
        return v + a - a.mean(axis=-1, keepdims=True)


class DeterministicPolicy:
    """Continuous-control deterministic actor (TD3-style): tanh(mu)
    scaled to the Box bounds, plus Gaussian EXPLORATION noise applied at
    sample time only (ref analogue: the TD3 policy's deterministic
    action + GaussianNoise exploration)."""

    def __init__(self, obs_dim: int, act_dim: int, low, high,
                 hidden: int = 64, seed: int = 0,
                 exploration_noise: float = 0.1):
        rng = np.random.RandomState(seed)
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.low = np.asarray(low, dtype=np.float32)
        self.high = np.asarray(high, dtype=np.float32)
        self.exploration_noise = exploration_noise
        self.weights: Dict[str, List] = {
            "trunk": init_mlp_params(rng, [obs_dim, hidden, hidden]),
            "mu": init_mlp_params(rng, [hidden, act_dim]),
        }

    def set_weights(self, weights):
        self.weights = weights

    def get_weights(self):
        return self.weights

    def compute_action(self, obs: np.ndarray, rng: np.random.RandomState):
        h = obs.reshape(-1)
        for W, b in self.weights["trunk"]:
            h = np.tanh(h @ W + b)
        (Wm, bm), = self.weights["mu"]
        u = np.tanh(h @ Wm + bm)
        u = np.clip(
            u + self.exploration_noise * rng.randn(self.act_dim),
            -1.0, 1.0,
        )
        action = self.low + (u + 1.0) * 0.5 * (self.high - self.low)
        return action.astype(np.float32), 0.0, 0.0


class SquashedGaussianPolicy:
    """Continuous-control actor: tanh-squashed Gaussian over a Box action
    space, numpy inference for rollouts (ref analogue: the SAC policy's
    SquashedGaussian action distribution)."""

    def __init__(self, obs_dim: int, act_dim: int, low, high,
                 hidden: int = 64, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.low = np.asarray(low, dtype=np.float32)
        self.high = np.asarray(high, dtype=np.float32)
        self.weights: Dict[str, List] = {
            "trunk": init_mlp_params(rng, [obs_dim, hidden, hidden]),
            "mu": init_mlp_params(rng, [hidden, act_dim]),
            "log_std": init_mlp_params(rng, [hidden, act_dim]),
        }

    def set_weights(self, weights):
        self.weights = weights

    def get_weights(self):
        return self.weights

    def compute_action(self, obs: np.ndarray, rng: np.random.RandomState):
        h = obs.reshape(-1)  # flatten multi-dim Box observations
        for W, b in self.weights["trunk"]:
            h = np.tanh(h @ W + b)
        (Wm, bm), = self.weights["mu"]
        (Ws, bs), = self.weights["log_std"]
        mu = h @ Wm + bm
        log_std = np.clip(h @ Ws + bs, -5.0, 2.0)
        u = np.tanh(mu + np.exp(log_std) * rng.randn(self.act_dim))
        action = self.low + (u + 1.0) * 0.5 * (self.high - self.low)
        return action.astype(np.float32), 0.0, 0.0
