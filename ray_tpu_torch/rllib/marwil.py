"""MARWIL: monotonic advantage re-weighted imitation learning, offline
(counterpart of ``ray_tpu/rllib/marwil.py``).

Ref analogue: rllib/algorithms/marwil (Wang 2018): behaviour cloning
weighted by exp(beta * advantage), with a learned value head for V(s) and
the advantage A = R - V(s) against the logged return column. ``beta = 0``
is plain BC. Discrete actions; the learner trains the shared
``ActorCriticModule`` tree on the card, so the result drops into
``MLPPolicy`` rollouts. ``MARWIL.train()`` is one pass of minibatch
updates over any dataset object with
``iter_batches(batch_size=, batch_format="numpy")``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .._device import DeviceLike
from .algorithm import AlgorithmConfig
from .core import ActorCriticModule, Learner
from .ppo import action_logp


class MARWILConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.dataset = None          # a dataset of logged rows
        self.obs_column = "obs"
        self.action_column = "action"
        self.return_column = "return"  # per-row monte-carlo return R_t
        self.beta: float = 1.0         # 0.0 -> plain BC
        self.vf_coeff: float = 1.0
        self.num_actions: Optional[int] = None
        # Advantages are normalized by a running estimate of E[A^2]
        # (the paper's c^2 normalizer) so beta is scale-free.
        self.moving_average_sqd_adv_norm_update_rate: float = 1e-2

    def offline_data(self, dataset, *, obs_column="obs",
                     action_column="action",
                     return_column="return") -> "MARWILConfig":
        self.dataset = dataset
        self.obs_column = obs_column
        self.action_column = action_column
        self.return_column = return_column
        return self

    def build(self, device: DeviceLike = None) -> "MARWIL":
        if self.dataset is None:
            raise ValueError(
                "MARWILConfig.offline_data(dataset=...) required"
            )
        if self.num_actions is None:
            raise ValueError("MARWILConfig.training(num_actions=...) "
                             "required (discrete)")
        return MARWIL(self.copy(), device=device)


class MARWILLearner(Learner):
    """Loss = -E[exp(beta * A / c) * logp(a|s)] + c_v * mse(V, R),
    with A = R - V(s) (no gradient through the policy term's weight) and
    c the running sqrt(E[A^2]) normalizer carried in the batch."""

    def __init__(self, params, *, lr: float, beta: float,
                 vf_coeff: float, device: DeviceLike = None):
        super().__init__(params, lr=lr, device=device)
        self._beta = beta
        self._vf_coeff = vf_coeff

    def compute_loss(self, params, target, batch):
        logits, values = ActorCriticModule.forward(params, batch["obs"])
        _, logp = action_logp(logits, batch["actions"])
        adv = batch["returns"] - values
        vf_loss = (adv ** 2).mean()
        with torch.no_grad():
            # The exponent is clipped to [-10, 10] for numerical safety.
            w = torch.exp(torch.clamp(
                self._beta * adv / batch["adv_norm"], -10.0, 10.0))
            sqd_adv = (adv ** 2).mean()
        pi_loss = -(w * logp).mean()
        return pi_loss + self._vf_coeff * vf_loss, {
            "policy_loss": pi_loss,
            "vf_loss": vf_loss,
            "mean_weight": w.mean(),
            "sqd_adv": sqd_adv,
        }


class MARWIL:
    """Offline trainer: train() = one pass of minibatch updates over the
    dataset's batch iterator (same loop shape as BC)."""

    def __init__(self, config: MARWILConfig, device: DeviceLike = None):
        c = config
        self.config = c
        self.iteration = 0
        probe = next(iter(
            c.dataset.iter_batches(batch_size=1, batch_format="numpy")
        ))
        obs = np.asarray(probe[c.obs_column])
        self._obs_dim = int(np.prod(obs.shape[1:]))
        module = ActorCriticModule(self._obs_dim, int(c.num_actions),
                                   c.hidden_size, c.seed)
        self.learner = MARWILLearner(
            module.init_params(), lr=c.lr, beta=c.beta,
            vf_coeff=c.vf_coeff, device=device,
        )
        self._sqd_adv_norm = 1.0  # running E[A^2]

    def train(self) -> Dict[str, Any]:
        c = self.config
        self.iteration += 1
        stats: Dict[str, Any] = {}
        rows = 0
        rate = c.moving_average_sqd_adv_norm_update_rate
        for batch in c.dataset.iter_batches(
            batch_size=c.minibatch_size, batch_format="numpy"
        ):
            obs = np.asarray(batch[c.obs_column], np.float32)
            obs = obs.reshape(len(obs), -1)
            stats = self.learner.update_device({
                "obs": obs,
                "actions": np.asarray(batch[c.action_column], np.int32),
                "returns": np.asarray(batch[c.return_column],
                                      np.float32),
                "adv_norm": np.float32(
                    np.sqrt(self._sqd_adv_norm) + 1e-8
                ),
            })
            # The running normalizer needs the batch's E[A^2]: one scalar
            # read to the host per minibatch, as in the JAX package.
            self._sqd_adv_norm += rate * (
                float(stats["sqd_adv"]) - self._sqd_adv_norm
            )
            rows += len(obs)
        out = {k: float(v) for k, v in stats.items()}
        out.update({
            "training_iteration": self.iteration,
            "num_rows_trained": rows,
            "sqd_adv_norm": self._sqd_adv_norm,
        })
        return out

    def get_weights(self):
        return self.learner.get_weights()

    def get_policy(self):
        """Rollout-ready MLPPolicy carrying the trained weights."""
        from .policy import MLPPolicy

        c = self.config
        policy = MLPPolicy(self._obs_dim, int(c.num_actions),
                           c.hidden_size, c.seed)
        policy.set_weights(self.get_weights())
        return policy

    def stop(self):
        pass
