"""SAC: off-policy maximum-entropy actor-critic for continuous control
(counterpart of ``ray_tpu/rllib/sac.py``).

Ref analogue: rllib/algorithms/sac/ (sac.py + sac_torch_policy.py) —
twin Q networks with polyak-averaged targets, a tanh-squashed Gaussian
actor, and automatic temperature tuning against a target entropy
(Haarnoja 2018). One update steps both critics, the actor and the
temperature from one loss on the card. The reparameterisation noise comes
from the learner's numpy ``RandomState(seed + 2)`` in the JAX package's
order. The replay loop is DDPG's (``ddpg.continuous_loop``).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..train.optim import AdamW
from .algorithm import Algorithm, AlgorithmConfig, _PolicyFactory
from .core import (
    QModule,
    RLModule,
    clone_tree,
    polyak_,
    to_device,
    to_floats,
    tree_map,
    tree_to_device,
    tree_to_numpy,
    value_and_grad,
)
from .ddpg import continuous_loop
from .env_runner import NEXT_OBS, TransitionEnvRunner
from .policy import init_mlp_params
from .replay_buffers import ReplayBuffer
from .sample_batch import ACTIONS, DONES, OBS, REWARDS, SampleBatch

_LOG_STD_MIN, _LOG_STD_MAX = -5.0, 2.0


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.buffer_size: int = 100_000
        self.num_steps_sampled_before_learning_starts: int = 500
        self.num_updates_per_iteration: int = 64
        self.tau: float = 0.005          # polyak coefficient
        self.initial_alpha: float = 0.2
        self.target_entropy: float | None = None  # default: -act_dim

    def build(self, device: DeviceLike = None) -> "SAC":
        return SAC(self.copy(), device)


def _mlp_init(rng, sizes):
    """The JAX package's draws for one MLP (``init_mlp_params``), as a
    numpy tree; the learner puts it on its device."""
    return init_mlp_params(rng, sizes)


def actor_sample(ap, obs, eps):
    """(tanh-squashed action, its log-probability) of the
    reparameterised sample ``mu + std * eps``."""
    h = RLModule.mlp(ap["trunk"], obs)
    (Wm, bm), = ap["mu"]
    (Ws, bs), = ap["log_std"]
    mu = h @ Wm + bm
    log_std = torch.clamp(h @ Ws + bs, _LOG_STD_MIN, _LOG_STD_MAX)
    std = torch.exp(log_std)
    pre = mu + std * eps
    u = torch.tanh(pre)
    # Gaussian logp + tanh change-of-variables correction.
    logp = (
        -0.5 * (((pre - mu) / std) ** 2
                + 2 * log_std + np.log(2 * np.pi))
    ).sum(-1)
    logp = logp - (2 * (np.log(2.0) - pre
                        - F.softplus(-2 * pre))).sum(-1)
    return u, logp


class SACLearner:
    """One step: critic TD update against the entropy-regularised target,
    actor update through the reparameterised sample, temperature update
    toward the target entropy, polyak target sync."""

    def __init__(self, policy, cfg, obs_dim: int, act_dim: int,
                 low: np.ndarray, high: np.ndarray,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        dev = self.device
        hidden = cfg.hidden_size
        rng = np.random.RandomState(cfg.seed + 1)
        self._low = to_device(np.asarray(low, np.float32), dev)
        self._high = to_device(np.asarray(high, np.float32), dev)
        self._target_entropy = (cfg.target_entropy
                                if cfg.target_entropy is not None
                                else -float(act_dim))

        def make_q():
            return {"trunk": _mlp_init(rng, [obs_dim + act_dim,
                                             hidden, hidden]),
                    "q": _mlp_init(rng, [hidden, 1])}

        self._params = tree_to_device({
            "actor": policy.get_weights(),
            "q1": make_q(),
            "q2": make_q(),
            "log_alpha": np.asarray(np.log(cfg.initial_alpha), np.float32),
        }, dev)
        # Copies: the optimizer updates the critics in place.
        self._target = {"q1": clone_tree(self._params["q1"]),
                        "q2": clone_tree(self._params["q2"])}
        self._opt = AdamW(cfg.lr, weight_decay=0.0)  # optax.adam(lr)
        self._opt_state = self._opt.init(self._params)
        self._tau = cfg.tau
        self._gamma = cfg.gamma
        self._rng = np.random.RandomState(cfg.seed + 2)
        self._act_dim = act_dim

    def _from_env(self, a):
        u = (a - self._low) / (self._high - self._low) * 2.0 - 1.0
        return torch.clamp(u, -0.999, 0.999)

    def _losses(self, params, target, obs, act_env, rew, done, nxt,
                eps1, eps2):
        alpha = torch.exp(params["log_alpha"])
        alpha_c = alpha.detach()
        act = self._from_env(act_env)
        # Critic target: r + gamma (min target Q - alpha logp), a constant.
        with torch.no_grad():
            u2, logp2 = actor_sample(params["actor"], nxt, eps2)
            tq = torch.minimum(
                QModule.forward(target["q1"], nxt, u2),
                QModule.forward(target["q2"], nxt, u2),
            ) - alpha_c * logp2
            backup = rew + self._gamma * (1.0 - done) * tq
        q1 = QModule.forward(params["q1"], obs, act)
        q2 = QModule.forward(params["q2"], obs, act)
        critic_loss = ((q1 - backup) ** 2 + (q2 - backup) ** 2).mean()
        # Actor: maximise min Q of the reparameterised action, with both
        # critics held constant.
        u, logp = actor_sample(params["actor"], obs, eps1)
        q1c, q2c = (tree_map(torch.Tensor.detach, params[k])
                    for k in ("q1", "q2"))
        q_pi = torch.minimum(QModule.forward(q1c, obs, u),
                             QModule.forward(q2c, obs, u))
        actor_loss = (alpha_c * logp - q_pi).mean()
        # Temperature toward the target entropy.
        alpha_loss = -(params["log_alpha"] * (
            logp + self._target_entropy).detach()).mean()
        total = critic_loss + actor_loss + alpha_loss
        return total, {"critic_loss": critic_loss.detach(),
                       "actor_loss": actor_loss.detach(),
                       "alpha": alpha_c}

    def update_device(self, batch: SampleBatch) -> Dict[str, Any]:
        """One step; the stats stay on the device."""
        dev = self.device
        n = batch.count
        eps1 = self._rng.randn(n, self._act_dim).astype(np.float32)
        eps2 = self._rng.randn(n, self._act_dim).astype(np.float32)
        (loss, stats), grads = value_and_grad(
            self._losses, self._params, self._target,
            to_device(batch[OBS], dev),
            to_device(np.asarray(batch[ACTIONS], np.float32), dev),
            to_device(batch[REWARDS], dev),
            to_device(np.asarray(batch[DONES], np.float32), dev),
            to_device(batch[NEXT_OBS], dev),
            to_device(eps1, dev), to_device(eps2, dev))
        self._opt.update(self._params, grads, self._opt_state)
        for k in ("q1", "q2"):
            polyak_(self._target[k], self._params[k], self._tau)
        return {"loss": loss, **stats}

    def update(self, batch: SampleBatch) -> Dict[str, Any]:
        return to_floats(self.update_device(batch))

    def get_weights(self):
        return tree_to_numpy(self._params["actor"])


class SAC(Algorithm):
    def _make_policy_factory(self, obs_dim: int, act_dim: int):
        from .policy import SquashedGaussianPolicy

        if not getattr(self, "_continuous", False):
            raise ValueError(
                "SAC supports Box (continuous) action spaces only; use "
                "PPO/DQN/IMPALA for discrete envs"
            )
        c = self.config
        return _PolicyFactory(SquashedGaussianPolicy, obs_dim, act_dim,
                              self._action_low, self._action_high,
                              c.hidden_size, c.seed)

    def _runner_class(self):
        return TransitionEnvRunner

    def _build_learner(self, policy):
        c = self.config
        self.buffer = ReplayBuffer(c.buffer_size, seed=c.seed)
        self._env_steps = 0
        return SACLearner(policy, c, self._obs_dim, self._num_actions,
                          self._action_low, self._action_high,
                          device=self.device)

    def training_step(self) -> Dict[str, Any]:
        return continuous_loop(
            self, lambda i, mb: self.learner.update_device(mb))
