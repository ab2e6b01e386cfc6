"""PG: vanilla policy gradient, REINFORCE (counterpart of
``ray_tpu/rllib/pg.py``).

Ref analogue: rllib/algorithms/pg — no critic, no clipping, no epochs;
the gradient is grad log pi(a|s) * R_t with the runner's returns. ``PG``
is A2C's synchronous driver with this learner.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .._device import DeviceLike
from .a2c import A2C
from .algorithm import AlgorithmConfig
from .core import ActorCriticModule, Learner
from .ppo import action_logp, normalized
from .sample_batch import ACTIONS, OBS, RETURNS, SampleBatch


class PGConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3

    def build(self, device: DeviceLike = None) -> "PG":
        return PG(self.copy(), device)


class PGLearner(Learner):
    """-E[log pi(a|s) * R] — returns as the signal, no baseline. The value
    head is in the tree (the rollout policy's) and gets zero gradients."""

    def __init__(self, policy, lr: float, device: DeviceLike = None):
        super().__init__(policy.get_weights(), lr=lr, device=device)

    def compute_loss(self, params, target, batch):
        logits, _ = ActorCriticModule.forward(params, batch["obs"])
        _, logp = action_logp(logits, batch["actions"])
        pi_loss = -(logp * normalized(batch["returns"])).mean()
        return pi_loss, {"policy_loss": pi_loss}

    def update_minibatch(self, mb: SampleBatch) -> Dict[str, torch.Tensor]:
        """PG's layout of ``A2C.update_minibatch``: no advantages."""
        return self.update_device({
            "obs": mb[OBS],
            "actions": np.asarray(mb[ACTIONS], dtype=np.int32),
            "returns": mb[RETURNS],
        })


class PG(A2C):
    """Shares A2C's synchronous driver; only the loss differs."""

    def _build_learner(self, policy):
        return PGLearner(policy, self.config.lr, device=self.device)
