"""A2C: synchronous advantage actor-critic (counterpart of
``ray_tpu/rllib/a2c.py``).

Ref analogue: rllib/algorithms/a2c. One gradient pass per sampled batch —
vanilla policy gradient on GAE advantages + value regression + entropy
bonus, no surrogate clipping and no epoch reuse. Shares the GAE EnvRunner
plane with PPO. The batch layout of a minibatch is the learner's
``update_minibatch`` (PG's learner has its own).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .._device import DeviceLike
from .algorithm import Algorithm, AlgorithmConfig
from .core import ActorCriticModule, Learner, to_floats
from .ppo import action_logp, entropy, normalized
from .sample_batch import ACTIONS, ADVANTAGES, OBS, RETURNS, SampleBatch


class A2CConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01

    def build(self, device: DeviceLike = None) -> "A2C":
        return A2C(self.copy(), device)


class A2CLearner(Learner):
    """Plain policy-gradient loss: -logp*adv + c_v*mse(V,R) - c_e*H."""

    def __init__(self, policy, lr: float, vf_coeff: float,
                 ent_coeff: float, device: DeviceLike = None):
        super().__init__(policy.get_weights(), lr=lr, device=device)
        self._vf_coeff = vf_coeff
        self._ent_coeff = ent_coeff

    def compute_loss(self, params, target, batch):
        logits, values = ActorCriticModule.forward(params, batch["obs"])
        logp_all, logp = action_logp(logits, batch["actions"])
        pi_loss = -(logp * normalized(batch["adv"])).mean()
        vf_loss = ((values - batch["returns"]) ** 2).mean()
        ent = entropy(logp_all)
        total = (pi_loss + self._vf_coeff * vf_loss
                 - self._ent_coeff * ent)
        return total, {
            "policy_loss": pi_loss,
            "vf_loss": vf_loss,
            "entropy": ent,
        }

    def update_minibatch(self, mb: SampleBatch) -> Dict[str, torch.Tensor]:
        """One step on a fresh minibatch; stats on the device."""
        return self.update_device({
            "obs": mb[OBS],
            "actions": np.asarray(mb[ACTIONS], dtype=np.int32),
            "adv": mb[ADVANTAGES],
            "returns": mb[RETURNS],
        })


class A2C(Algorithm):
    def _build_learner(self, policy):
        c = self.config
        return A2CLearner(policy, c.lr, c.vf_loss_coeff, c.entropy_coeff,
                          device=self.device)

    def training_step(self) -> Dict[str, Any]:
        c = self.config
        batches: List[SampleBatch] = []
        while sum(b.count for b in batches) < c.train_batch_size:
            batches.extend(self.sample_all())
        batch = SampleBatch.concat(batches)

        # ONE synchronous gradient pass over the fresh batch (minibatched
        # for memory, still a single epoch — on-policy).
        stats: Dict[str, Any] = {}
        for mb in batch.minibatches(min(c.minibatch_size, batch.count)):
            stats = self.learner.update_minibatch(mb)
        stats = to_floats(stats)

        self.broadcast(self.learner.get_weights())
        return {
            **self.episode_stats(),
            "num_env_steps_sampled": batch.count,
            **stats,
        }
