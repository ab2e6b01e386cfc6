"""DQN: off-policy Q-learning with replay and a target network
(counterpart of ``ray_tpu/rllib/dqn.py``).

Ref analogue: rllib/algorithms/dqn/ (dqn.py training_step:623, double-Q +
target network sync). Sampling stays on CPU EnvRunner actors
(epsilon-greedy); the learner is a double-DQN TD update on the card, with
plain or dueling heads (the head layout follows the params tree), n-step
returns folded into the stored transitions, and uniform or prioritized
replay (per-row importance weights).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..train.optim import AdamW
from .algorithm import (
    Algorithm,
    AlgorithmConfig,
    _PolicyFactory,
    linear_epsilon,
)
from .core import (
    clone_tree,
    to_device,
    tree_to_device,
    tree_to_numpy,
    value_and_grad,
)
from .env_runner import NEXT_OBS, TransitionEnvRunner
from .replay_buffers import PrioritizedReplayBuffer, ReplayBuffer
from .sample_batch import ACTIONS, DONES, OBS, REWARDS, SampleBatch


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.buffer_size: int = 50_000
        self.num_steps_sampled_before_learning_starts: int = 1_000
        self.target_network_update_freq: int = 500  # env steps
        self.num_updates_per_iteration: int = 32
        self.epsilon_initial: float = 1.0
        self.epsilon_final: float = 0.05
        self.epsilon_timesteps: int = 10_000  # linear decay horizon
        self.double_q: bool = True
        self.dueling: bool = False
        self.n_step: int = 1
        self.prioritized_replay: bool = False
        self.prioritized_replay_alpha: float = 0.6
        self.prioritized_replay_beta: float = 0.4

    def build(self, device: DeviceLike = None) -> "DQN":
        return DQN(self.copy(), device)


DISCOUNT = "discount"  # per-row bootstrap discount gamma^k * (1-done)


def nstep_returns(batch: SampleBatch, n: int, gamma: float
                  ) -> SampleBatch:
    """Fold an n-step lookahead into a sequential fragment batch:
    reward_t <- sum_{k<n} gamma^k r_{t+k}, next_obs_t <- obs_{t+n},
    and a DISCOUNT column gamma^{k_used}*(1-done) for the bootstrap.
    The lookahead stops at any EPISODE BOUNDARY — termination or
    truncation (the runner resets either way; crossing one would blend
    the next episode into the target) — while the bootstrap mask uses
    DONES alone, so truncated episodes still bootstrap. The fragment
    tail bootstraps early (the reference accepts the same
    fragment-boundary truncation). Numpy, as in the JAX package."""
    from .env_runner import BOUNDARY

    rew = np.asarray(batch[REWARDS], np.float64)
    done = np.asarray(batch[DONES], bool)
    boundary = (np.asarray(batch[BOUNDARY], bool)
                if BOUNDARY in batch else done)
    nxt = np.asarray(batch[NEXT_OBS])
    T = len(rew)
    r_n = np.zeros(T, np.float32)
    nxt_n = nxt.copy()
    disc = np.zeros(T, np.float32)
    for t in range(T):
        acc, g = 0.0, 1.0
        k = 0
        while True:
            acc += g * rew[t + k]
            g *= gamma
            if boundary[t + k] or k + 1 >= n or t + k + 1 >= T:
                break
            k += 1
        r_n[t] = acc
        nxt_n[t] = nxt[t + k]
        disc[t] = 0.0 if done[t + k] else g
    out = SampleBatch(dict(batch))
    out[REWARDS] = r_n
    out[NEXT_OBS] = nxt_n
    out[DISCOUNT] = disc
    return out


def q_forward(params, obs):
    """Q-values of every action: a plain ``q`` head, or the dueling
    V + A - mean(A) when the tree has ``v`` and ``a``."""
    h = obs
    for W, b in params["trunk"]:
        h = torch.tanh(h @ W + b)
    if "q" in params:
        (Wq, bq), = params["q"]
        return h @ Wq + bq
    (Wv, bv), = params["v"]
    (Wa, ba), = params["a"]
    v = h @ Wv + bv
    a = h @ Wa + ba
    return v + a - a.mean(dim=-1, keepdim=True)


class DQNLearner:
    """Double-DQN learner on the card with a lagged target network; plain
    or dueling heads."""

    def __init__(self, policy, lr: float, double_q: bool,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._params = tree_to_device(policy.get_weights(), self.device)
        self._target = clone_tree(self._params)
        self._opt = AdamW(lr, weight_decay=0.0)  # optax.adam(lr)
        self._opt_state = self._opt.init(self._params)
        self._double_q = double_q

    def best_next_actions(self, params, target, next_obs):
        """The actions the backup evaluates: chosen by the online net
        (double Q, van Hasselt 2016) or by the target net. ``argmax``
        takes the first of tied maxima, as ``jnp.argmax`` does."""
        q_next_target = q_forward(target, next_obs)
        chooser = (q_forward(params, next_obs) if self._double_q
                   else q_next_target)
        return torch.argmax(chooser, dim=1), q_next_target

    def _loss(self, params, target, obs, actions, rewards, discount,
              next_obs, weights):
        q = q_forward(params, obs)
        q_sa = q.gather(1, actions.long()[:, None])[:, 0]
        with torch.no_grad():
            best, q_next_target = self.best_next_actions(params, target,
                                                         next_obs)
            q_next = q_next_target.gather(1, best[:, None])[:, 0]
            targets = rewards + discount * q_next
        td = q_sa - targets
        loss = (weights * td * td).mean()
        return loss, td.detach()

    def update(self, batch: SampleBatch) -> Dict[str, Any]:
        """One step: the loss, and the TD errors as a numpy copy (for the
        prioritized buffer's ``update_priorities``)."""
        dev = self.device
        weights = batch.get("weights")
        w = (to_device(weights, dev) if weights is not None
             else torch.ones(batch.count, dtype=torch.float32, device=dev))
        (loss, td), grads = value_and_grad(
            self._loss, self._params, self._target,
            to_device(batch[OBS], dev),
            to_device(np.asarray(batch[ACTIONS], np.int32), dev),
            to_device(batch[REWARDS], dev), to_device(batch[DISCOUNT], dev),
            to_device(batch[NEXT_OBS], dev), w)
        self._opt.update(self._params, grads, self._opt_state)
        return {"loss": float(loss), "td_error": td.cpu().numpy().copy()}

    def sync_target(self):
        self._target = clone_tree(self._params)

    def get_weights(self):
        return tree_to_numpy(self._params)


class DQN(Algorithm):
    def _make_policy_factory(self, obs_dim: int, num_actions: int):
        self._require_discrete()
        from .policy import DuelingQPolicy, QPolicy

        c = self.config
        cls = DuelingQPolicy if c.dueling else QPolicy
        return _PolicyFactory(cls, obs_dim, num_actions, c.hidden_size,
                              c.seed)

    def _runner_class(self):
        return TransitionEnvRunner

    def _build_learner(self, policy):
        c = self.config
        self._rng = np.random.RandomState(c.seed)
        if c.prioritized_replay:
            self.buffer: ReplayBuffer = PrioritizedReplayBuffer(
                c.buffer_size, alpha=c.prioritized_replay_alpha,
                beta=c.prioritized_replay_beta, seed=c.seed,
            )
        else:
            self.buffer = ReplayBuffer(c.buffer_size, seed=c.seed)
        self._env_steps = 0
        self._last_target_sync = 0
        return DQNLearner(policy, c.lr, c.double_q, device=self.device)

    def _epsilon(self) -> float:
        return linear_epsilon(self.config, self._env_steps)

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch as rt

        c = self.config
        # 1) sample transitions from every runner at the current epsilon.
        eps = self._epsilon()
        rt.get([r.set_epsilon.remote(eps) for r in self.runners])
        batches: List[SampleBatch] = self.sample_all()
        for b in batches:
            self._env_steps += b.count
            self.buffer.add(nstep_returns(b, c.n_step, c.gamma))

        stats: Dict[str, Any] = {}
        num_updates = 0
        if self._env_steps >= c.num_steps_sampled_before_learning_starts:
            # 2) learner updates on replayed minibatches.
            for _ in range(c.num_updates_per_iteration):
                mb = self.buffer.sample(c.minibatch_size)
                out = self.learner.update(mb)
                stats["loss"] = out["loss"]
                if isinstance(self.buffer, PrioritizedReplayBuffer):
                    self.buffer.update_priorities(
                        mb["batch_indexes"], out["td_error"]
                    )
                num_updates += 1
            # 3) lagged target sync by env-step budget.
            if (self._env_steps - self._last_target_sync
                    >= c.target_network_update_freq):
                self.learner.sync_target()
                self._last_target_sync = self._env_steps
            # 4) broadcast fresh weights to the rollout plane.
            self.broadcast(self.learner.get_weights())

        return {
            **self.episode_stats(),
            "num_env_steps_sampled": self._env_steps,
            "num_learner_updates": num_updates,
            "epsilon": eps,
            "buffer_size": len(self.buffer),
            **stats,
        }
