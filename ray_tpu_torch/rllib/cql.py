"""CQL: conservative Q-learning, offline continuous control (counterpart
of ``ray_tpu/rllib/cql.py``).

Ref analogue: rllib/algorithms/cql (Kumar 2020): twin critics and a
deterministic actor trained purely from logged transitions, with the
conservative penalty ``alpha_cql * (logsumexp_a Q(s, a) - Q(s, a_data))``
added to the critic loss, so the policy cannot exploit over-estimated
values of actions the data never showed. Built on the shared
``TwinCriticLearner``. There are no EnvRunners: ``CQL.train()`` streams
minibatches from any dataset object with ``count()`` and
``iter_batches(batch_size=, batch_format="numpy", drop_last=)``. The
random actions of the penalty are numpy draws from
``RandomState(seed + 3)``, in the JAX package's order, so both packages
see the same ones.
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
    to_floats,
)


class CQLConfig(AlgorithmConfig):
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
        self.cql_alpha: float = 1.0        # conservative penalty weight
        self.num_random_actions: int = 8   # logsumexp sample count
        self.epochs_per_iteration: int = 1

    _COLUMN_KEYS = ("obs_column", "action_column", "reward_column",
                    "next_obs_column", "done_column")

    def offline_data(self, dataset, **columns) -> "CQLConfig":
        self.dataset = dataset
        for k, v in columns.items():
            if k not in self._COLUMN_KEYS:
                raise ValueError(
                    f"unknown offline_data column {k!r} "
                    f"(allowed: {self._COLUMN_KEYS})"
                )
            setattr(self, k, v)
        return self

    def build(self, device: DeviceLike = None) -> "CQL":
        if self.dataset is None:
            raise ValueError("CQLConfig.offline_data(dataset=...) required")
        return CQL(self.copy(), device=device)


def transitions_batch(batch, c) -> Dict[str, np.ndarray]:
    """One dataset minibatch as the twin-critic learners' float32
    columns (obs, act, rew, next_obs, done), flattened per row."""
    n = len(batch[c.obs_column])
    return {
        "obs": np.asarray(batch[c.obs_column], np.float32).reshape(n, -1),
        "act": np.asarray(batch[c.action_column],
                          np.float32).reshape(n, -1),
        "rew": np.asarray(batch[c.reward_column], np.float32),
        "next_obs": np.asarray(batch[c.next_obs_column],
                               np.float32).reshape(n, -1),
        "done": np.asarray(batch[c.done_column], np.float32),
    }


def twin_td_loss(params, target, batch, gamma):
    """The twin critics' TD loss toward the target actor's next action
    (TD3 without smoothing): (loss, q1, q2)."""
    obs, act = batch["obs"], batch["act"]
    nxt, rew, done = batch["next_obs"], batch["rew"], batch["done"]
    with torch.no_grad():
        a2 = DeterministicActorModule.forward(target["actor"], nxt)
        tq = torch.minimum(
            QModule.forward(target["q1"], nxt, a2),
            QModule.forward(target["q2"], nxt, a2),
        )
        backup = rew + gamma * (1.0 - done) * tq
    q1 = QModule.forward(params["q1"], obs, act)
    q2 = QModule.forward(params["q2"], obs, act)
    return ((q1 - backup) ** 2 + (q2 - backup) ** 2).mean(), q1, q2


class CQLLearner(TwinCriticLearner):
    """Twin-critic TD loss + conservative penalty on the shared
    TwinCriticLearner machinery; the actor maximizes Q1 every step."""

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
        self._cql_alpha = cfg.cql_alpha
        self._nrand = cfg.num_random_actions
        self._rng = np.random.RandomState(cfg.seed + 3)

    def compute_loss(self, params, target, batch):
        obs = batch["obs"]
        td, q1, q2 = twin_td_loss(params, target, batch, self._gamma)
        # Conservative penalty: logsumexp over the random and policy
        # actions minus Q on the dataset actions, for each critic.
        B = obs.shape[0]
        rand = batch["rand_actions"]          # [B, nrand, act_dim]
        pol = DeterministicActorModule.forward(params["actor"], obs)
        cand = torch.cat([rand, pol[:, None, :]], dim=1)
        n_cand = cand.shape[1]
        obs_rep = obs[:, None, :].expand(B, n_cand, obs.shape[1]
                                         ).reshape(B * n_cand, -1)
        cand_flat = cand.reshape(B * n_cand, -1)

        def lse(qp, q_data):
            qs = QModule.forward(qp, obs_rep, cand_flat).reshape(B, n_cand)
            return (torch.logsumexp(qs, dim=1) - q_data).mean()

        cql = lse(params["q1"], q1) + lse(params["q2"], q2)
        total = td + self._cql_alpha * cql
        return total, {
            "td_loss": td,
            "cql_penalty": cql,
            "q1_mean": q1.mean(),
        }

    def learn_on_batch(self, np_batch) -> Dict[str, Any]:
        """The critic step, then the actor step; the stats stay on the
        device."""
        B = len(np_batch["obs"])
        np_batch = dict(np_batch)
        np_batch["rand_actions"] = self._rng.uniform(
            -1.0, 1.0, size=(B, self._nrand, self._act_dim)
        ).astype(np.float32)
        stats = self.update_device(np_batch)
        return {**stats, **self.actor_update(np_batch)}


class CQL:
    """Offline trainer: train() = epochs of minibatch updates streamed
    from the dataset (no environment interaction)."""

    def __init__(self, config: CQLConfig, device: DeviceLike = None):
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
        self.learner = CQLLearner(c, self._obs_dim, self._act_dim,
                                  device=device)

    def train(self) -> Dict[str, Any]:
        c = self.config
        self.iteration += 1
        stats: Dict[str, Any] = {}
        updates = 0
        if c.dataset.count() < c.minibatch_size:
            raise ValueError(
                f"dataset has {c.dataset.count()} rows < minibatch_size"
                f"={c.minibatch_size}; no training would happen"
            )
        for _ in range(c.epochs_per_iteration):
            for batch in c.dataset.iter_batches(
                batch_size=c.minibatch_size, batch_format="numpy",
                drop_last=True,
            ):
                stats = self.learner.learn_on_batch(
                    transitions_batch(batch, c))
                updates += 1
        stats = to_floats(stats)
        return {
            "training_iteration": self.iteration,
            "num_learner_updates": updates,
            **stats,
        }

    def get_weights(self):
        return self.learner.get_weights()

    def stop(self):
        pass
