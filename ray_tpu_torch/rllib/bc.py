"""BC: offline behaviour cloning from logged experience (counterpart of
``ray_tpu/rllib/bc.py``).

Ref analogue: rllib/algorithms/bc (+ the offline data stack in
rllib/offline/): instead of EnvRunners, training consumes logged (obs,
action) rows from any dataset object with
``iter_batches(batch_size=, batch_format="numpy")``, streaming minibatches
into a supervised update on the card. Discrete actions train a categorical
policy (cross-entropy); continuous actions train a squashed-Gaussian mean
(tanh-MSE), so the weights drop into the rollout policies the online
algorithms use.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..train.optim import AdamW
from .algorithm import AlgorithmConfig
from .core import RLModule, to_device, tree_to_device, tree_to_numpy, \
    value_and_grad
from .ppo import action_logp


class BCConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.dataset = None          # a dataset of logged rows
        self.obs_column = "obs"
        self.action_column = "action"
        # "discrete" (int actions -> categorical CE) or "continuous"
        # (float vectors -> tanh-squashed mean regression).
        self.action_space: str = "discrete"
        self.num_actions: Optional[int] = None   # discrete only
        self.action_low = None                   # continuous only
        self.action_high = None

    def offline_data(self, dataset, *, obs_column="obs",
                     action_column="action") -> "BCConfig":
        self.dataset = dataset
        self.obs_column = obs_column
        self.action_column = action_column
        return self

    def build(self, device: DeviceLike = None) -> "BC":
        if self.dataset is None:
            raise ValueError("BCConfig.offline_data(dataset=...) required")
        return BC(self.copy(), device=device)


class BC:
    """Offline trainer: train() = one pass of minibatch updates over the
    dataset's batch iterator."""

    def __init__(self, config: BCConfig, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        self.iteration = 0
        c = config
        probe = next(iter(
            c.dataset.iter_batches(batch_size=1, batch_format="numpy")
        ))
        obs = np.asarray(probe[c.obs_column])
        self._obs_dim = int(np.prod(obs.shape[1:]))
        if c.action_space == "discrete":
            if c.num_actions is None:
                raise ValueError("discrete BC needs num_actions")
            self._act_dim = int(c.num_actions)
        else:
            act = np.asarray(probe[c.action_column])
            self._act_dim = int(np.prod(act.shape[1:])) or 1
        self._build_learner()

    # ---- learner -----------------------------------------------------------

    def _build_learner(self):
        from .policy import MLPPolicy, SquashedGaussianPolicy

        c = self.config
        if c.action_space == "discrete":
            self._policy = MLPPolicy(self._obs_dim, self._act_dim,
                                     c.hidden_size, c.seed)
        else:
            low = (np.asarray(c.action_low, np.float32)
                   if c.action_low is not None
                   else -np.ones(self._act_dim, np.float32))
            high = (np.asarray(c.action_high, np.float32)
                    if c.action_high is not None
                    else np.ones(self._act_dim, np.float32))
            self._policy = SquashedGaussianPolicy(
                self._obs_dim, self._act_dim, low, high,
                c.hidden_size, c.seed,
            )
            self._low = to_device(low, self.device)
            self._high = to_device(high, self.device)
        self._params = tree_to_device(self._policy.get_weights(),
                                      self.device)
        self._opt = AdamW(c.lr, weight_decay=0.0)  # optax.adam(lr)
        self._opt_state = self._opt.init(self._params)
        self._discrete = c.action_space == "discrete"

    def _loss(self, p, obs, act):
        h = RLModule.mlp(p["trunk"], obs)
        if self._discrete:
            (W, b), = p["pi"]
            _, logp = action_logp(h @ W + b, act)
            return -logp.mean(), None
        # Only the mean trains: log_std's leaves get a zero gradient.
        (Wm, bm), = p["mu"]
        mu = torch.tanh(h @ Wm + bm)
        target = (act - self._low) / (self._high - self._low) * 2 - 1
        return ((mu - target) ** 2).mean(), None

    def learn_on_batch(self, obs: np.ndarray, act: np.ndarray
                       ) -> torch.Tensor:
        """One Adam step on one minibatch; the loss stays on the
        device."""
        (loss, _), grads = value_and_grad(
            self._loss, self._params, to_device(obs, self.device),
            to_device(act, self.device))
        self._opt.update(self._params, grads, self._opt_state)
        return loss

    # ---- training ----------------------------------------------------------

    def train(self) -> Dict[str, Any]:
        c = self.config
        self.iteration += 1
        losses = []
        rows = 0
        for batch in c.dataset.iter_batches(
            batch_size=c.minibatch_size, batch_format="numpy"
        ):
            obs = np.asarray(batch[c.obs_column], np.float32)
            obs = obs.reshape(len(obs), -1)
            act = np.asarray(batch[c.action_column])
            losses.append(self.learn_on_batch(obs, act))
            rows += len(obs)
        # One read to the host for the pass, not one a minibatch.
        losses = torch.stack(losses).tolist() if losses else []
        return {
            "training_iteration": self.iteration,
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "num_rows_trained": rows,
        }

    def get_weights(self):
        weights = tree_to_numpy(self._params)
        if self.config.action_space == "continuous":
            # BC trains only the mean; rollouts of the cloned policy
            # should be near-deterministic, so export a tight std
            # (log_std head -> constant -3) instead of the random init.
            (W, b), = weights["log_std"]
            weights["log_std"] = [
                (np.zeros_like(W), np.full_like(b, -3.0))
            ]
        self._policy.set_weights(weights)
        return weights

    def set_weights(self, weights):
        self._params = tree_to_device(weights, self.device)

    def get_policy(self):
        """Rollout-ready policy carrying the trained weights."""
        self.get_weights()
        return self._policy

    def stop(self):
        pass
