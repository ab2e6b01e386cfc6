"""A2C's learner: synchronous advantage actor-critic (counterpart of
``ray_tpu/rllib/a2c.py``'s ``A2CConfig``, ``A2CLearner`` and the batch
layout of ``A2C.update_minibatch``).

Ref analogue: rllib/algorithms/a2c. One gradient pass per sampled batch —
vanilla policy gradient on GAE advantages + value regression + entropy
bonus, no surrogate clipping and no epoch reuse. The algorithm's loop
waits for the actor runtime; ``update_minibatch`` is its per-minibatch
call, kept on the learner.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .._device import DeviceLike
from .algorithm import AlgorithmConfig
from .core import ActorCriticModule, Learner
from .ppo import action_logp, entropy, normalized
from .sample_batch import ACTIONS, ADVANTAGES, OBS, RETURNS, SampleBatch


class A2CConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01


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
