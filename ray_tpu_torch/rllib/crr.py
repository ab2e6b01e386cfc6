"""CRR: critic-regularized regression, offline continuous control
(counterpart of ``ray_tpu/rllib/crr.py``).

Ref analogue: rllib/algorithms/crr (Wang 2020). Twin critics learn a TD
backup from the logged transitions (CQL's loss without its penalty); the
actor is trained by advantage-filtered behaviour cloning: it regresses
pi(s) toward the dataset action, weighted by
    f(A) = 1[A > 0]          ("binary" mode)
    f(A) = exp(A / beta)      ("exp" mode, exponent clipped to [-5, 5])
with A(s, a) = Q1(s, a) - Q1(s, pi(s)). As in the JAX package it regresses
the shared deterministic actor, so the weights drop into the TD3/CQL
rollout policies. ``CRR.train()`` streams minibatches from any dataset
object with ``iter_batches(batch_size=, batch_format="numpy",
drop_last=)``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .._device import DeviceLike
from .algorithm import AlgorithmConfig
from .core import (
    DeterministicActorModule,
    QModule,
    TwinCriticLearner,
    polyak_,
    to_device,
    to_floats,
    value_and_grad,
)
from .cql import transitions_batch, twin_td_loss


class CRRConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.dataset = None
        self.obs_column = "obs"
        self.action_column = "action"
        self.reward_column = "reward"
        self.next_obs_column = "next_obs"
        self.done_column = "done"
        self.tau: float = 0.005
        self.weight_type: str = "exp"   # "exp" | "binary"
        self.beta: float = 1.0          # exp temperature
        self.epochs_per_iteration: int = 1

    _COLUMN_KEYS = ("obs_column", "action_column", "reward_column",
                    "next_obs_column", "done_column")

    def offline_data(self, dataset, **columns) -> "CRRConfig":
        self.dataset = dataset
        for k, v in columns.items():
            if k not in self._COLUMN_KEYS:
                raise ValueError(
                    f"unknown offline_data column {k!r} "
                    f"(allowed: {self._COLUMN_KEYS})"
                )
            setattr(self, k, v)
        return self

    def build(self, device: DeviceLike = None) -> "CRR":
        if self.dataset is None:
            raise ValueError("CRRConfig.offline_data(dataset=...) "
                             "required")
        return CRR(self.copy(), device=device)


class CRRLearner(TwinCriticLearner):
    """Critic: twin TD toward the target actor's next action. Actor:
    advantage-weighted regression toward the logged action, with its own
    Adam state and actor polyak (it replaces the base actor step, which
    would maximise Q)."""

    def __init__(self, cfg, obs_dim: int, act_dim: int,
                 device: DeviceLike = None):
        super().__init__(
            DeterministicActorModule(
                obs_dim, act_dim, cfg.hidden_size, cfg.seed
            ).init_params(),
            obs_dim=obs_dim, act_dim=act_dim, hidden=cfg.hidden_size,
            lr=cfg.lr, tau=cfg.tau, seed=cfg.seed, device=device,
        )
        self._gamma = cfg.gamma
        self._beta = cfg.beta
        self._binary = cfg.weight_type == "binary"

    def compute_loss(self, params, target, batch):
        td_loss, q1, _ = twin_td_loss(params, target, batch, self._gamma)
        return td_loss, {"td_loss": td_loss, "q1_mean": q1.mean()}

    @staticmethod
    @torch.no_grad()
    def advantage(q1, obs, act, pi):
        """A(s, a) = Q1(s, a) - Q1(s, pi(s)), a constant to the actor."""
        return QModule.forward(q1, obs, act) - QModule.forward(q1, obs, pi)

    def _crr_actor_loss(self, params, obs, act):
        pi = DeterministicActorModule.forward(params["actor"], obs)
        adv = self.advantage(params["q1"], obs, act, pi.detach())
        if self._binary:
            w = (adv > 0).float()
        else:
            w = torch.exp(torch.clamp(adv / self._beta, -5.0, 5.0))
        mse = ((pi - act) ** 2).sum(-1)
        return (w * mse).mean(), w.mean()

    def actor_update(self, batch) -> Dict[str, Any]:
        """Advantage-weighted regression toward the dataset action; the
        stats stay on the device."""
        obs = to_device(batch["obs"], self.device)
        act = to_device(batch["act"], self.device)
        (loss, wmean), grads = value_and_grad(
            self._crr_actor_loss, self._params, obs, act, wrt=("actor",))
        self._opt.update({"actor": self._params["actor"]}, grads,
                         self._aopt_state)
        polyak_(self._target["actor"], self._params["actor"], self._tau)
        return {"actor_loss": loss, "mean_weight": wmean}

    def learn_on_batch(self, np_batch) -> Dict[str, Any]:
        stats = self.update_device(np_batch)
        return {**stats, **self.actor_update(np_batch)}


class CRR:
    """Offline trainer: epochs of minibatch updates streamed from the
    dataset (same loop shape as CQL)."""

    def __init__(self, config: CRRConfig, device: DeviceLike = None):
        c = config
        self.config = c
        self.iteration = 0
        probe = next(iter(
            c.dataset.iter_batches(batch_size=1, batch_format="numpy")
        ))
        obs = np.asarray(probe[c.obs_column])
        act = np.asarray(probe[c.action_column])
        self._obs_dim = int(np.prod(obs.shape[1:])) or 1
        self._act_dim = int(np.prod(act.shape[1:])) or 1
        self.learner = CRRLearner(c, self._obs_dim, self._act_dim,
                                  device=device)

    def train(self) -> Dict[str, Any]:
        c = self.config
        self.iteration += 1
        stats: Dict[str, Any] = {}
        updates = 0
        for _ in range(c.epochs_per_iteration):
            for batch in c.dataset.iter_batches(
                batch_size=c.minibatch_size, batch_format="numpy",
                drop_last=True,
            ):
                stats = self.learner.learn_on_batch(
                    transitions_batch(batch, c))
                updates += 1
        return {
            "training_iteration": self.iteration,
            "num_learner_updates": updates,
            **to_floats(stats),
        }

    def get_weights(self):
        return self.learner.get_weights()

    def stop(self):
        pass
