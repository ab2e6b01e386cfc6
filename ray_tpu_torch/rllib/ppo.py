"""PPO: clipped-surrogate policy optimization (counterpart of
``ray_tpu/rllib/ppo.py``).

Ref analogue: rllib/algorithms/ppo/ (ppo.py:392 training_step, the torch
learner). The learner runs on the card in the driver; the rollout plane
stays numpy on CPU EnvRunner actors.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike
from .algorithm import Algorithm, AlgorithmConfig
from .core import ActorCriticModule, Learner, to_floats
from .sample_batch import (
    ACTIONS,
    ADVANTAGES,
    LOGPS,
    OBS,
    RETURNS,
    SampleBatch,
)


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.clip_param: float = 0.2
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01

    def build(self, device: DeviceLike = None) -> "PPO":
        return PPO(self.copy(), device)


def normalized(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / (std + 1e-8) with JAX's std: the population std
    (ddof 0), where torch's ``std()`` defaults to ddof 1."""
    return (x - x.mean()) / (x.std(correction=0) + 1e-8)


def action_logp(logits: torch.Tensor, actions: torch.Tensor):
    """(log-softmax over the actions, the log-probability of ``actions``).
    Actions arrive as int32; ``gather`` wants int64."""
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(1, actions.long()[:, None])[:, 0]
    return logp_all, logp


def entropy(logp_all: torch.Tensor) -> torch.Tensor:
    return -(torch.exp(logp_all) * logp_all).sum(-1).mean()


class PPOLearner(Learner):
    """Clipped-surrogate loss on the shared Learner layer (ref:
    ppo_learner / Learner.compute_loss). ``is_ratio_clip`` (APPO)
    additionally caps the importance ratio against stale behavior
    policies before the PPO clip."""

    def __init__(self, policy, lr: float, clip: float, vf_coeff: float,
                 ent_coeff: float, is_ratio_clip: float = None,
                 device: DeviceLike = None):
        super().__init__(policy.get_weights(), lr=lr, device=device)
        self._clip = clip
        self._vf_coeff = vf_coeff
        self._ent_coeff = ent_coeff
        self._is_clip = is_ratio_clip

    def compute_loss(self, params, target, batch):
        logits, values = ActorCriticModule.forward(params, batch["obs"])
        logp_all, logp = action_logp(logits, batch["actions"])
        ratio = torch.exp(logp - batch["old_logp"])
        stats = {}
        if self._is_clip is not None:
            # Stale-policy guard FIRST, then the PPO clip (APPO).
            ratio = torch.clamp(ratio, max=self._is_clip)
            stats["mean_is_ratio"] = ratio.mean()
        adv_n = normalized(batch["adv"])
        surr = torch.minimum(
            ratio * adv_n,
            torch.clamp(ratio, 1 - self._clip, 1 + self._clip) * adv_n,
        )
        pi_loss = -surr.mean()
        vf_loss = ((values - batch["returns"]) ** 2).mean()
        ent = entropy(logp_all)
        total = (pi_loss + self._vf_coeff * vf_loss
                 - self._ent_coeff * ent)
        stats.update({
            "policy_loss": pi_loss,
            "vf_loss": vf_loss,
            "entropy": ent,
        })
        return total, stats

    def update_epochs(self, batch: SampleBatch, *, epochs: int,
                      minibatch_size: int, rng: np.random.RandomState
                      ) -> Dict[str, float]:
        stats: Dict[str, Any] = {}
        for _ in range(epochs):
            shuffled = batch.shuffle(rng)
            for mb in shuffled.minibatches(
                min(minibatch_size, batch.count)
            ):
                # Device-side stats: ONE host sync after all epochs.
                stats = self.update_device({
                    "obs": mb[OBS],
                    "actions": np.asarray(mb[ACTIONS], dtype=np.int32),
                    "old_logp": mb[LOGPS],
                    "adv": mb[ADVANTAGES],
                    "returns": mb[RETURNS],
                })
        return to_floats(stats)


class PPO(Algorithm):
    def _build_learner(self, policy):
        c = self.config
        self._rng = np.random.RandomState(c.seed)
        return PPOLearner(
            policy, c.lr, c.clip_param, c.vf_loss_coeff, c.entropy_coeff,
            device=self.device,
        )

    def training_step(self) -> Dict[str, Any]:
        c = self.config
        batches: List[SampleBatch] = []
        while sum(b.count for b in batches) < c.train_batch_size:
            batches.extend(self.sample_all())
        batch = SampleBatch.concat(batches)
        learner_stats = self.learner.update_epochs(
            batch, epochs=c.num_epochs, minibatch_size=c.minibatch_size,
            rng=self._rng,
        )
        self.broadcast(self.learner.get_weights())
        return {
            **self.episode_stats(),
            "num_env_steps_sampled": batch.count,
            **learner_stats,
        }
