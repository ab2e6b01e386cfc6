"""SlateQ: Q-learning for slate recommendation (counterpart of
``ray_tpu/rllib/slateq.py``).

Ref analogue: rllib/algorithms/slateq (Ie 2019). The action is a slate of
k items out of a catalog; Q(s, slate) decomposes under the single-choice
user model into per-item values,
    Q(s, A) = sum_{i in A} P(choice = i | s, A) * Q_item(s, i),
with P a conditional logit over item scores and a no-click option of
score 0. Q_item is an MLP over [user, item] trained by a SARSA-style
backup on the clicked item; the next slate is the top k of
v_i * Q_item(s, i). The rollout side (the runner actors) is the JAX
package's numpy, copied.

Env protocol (recsys convention):
  reset() -> (user_obs, info)
  step(slate: list[int]) -> (user_obs, reward, terminated, truncated,
                             {"clicked": item_id or -1})
  env.num_items: catalog size; env.slate_size: k;
  env.item_features: [num_items, d_item] array.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..train.optim import AdamW
from .algorithm import (
    AlgorithmConfig,
    _PolicyFactory,
    episode_result,
    linear_epsilon,
    stop_actors,
)
from .core import (
    RLModule,
    clone_tree,
    take,
    to_device,
    tree_to_device,
    tree_to_numpy,
    value_and_grad,
)
from .policy import init_mlp_params
from .replay_buffers import ReplayBuffer
from .sample_batch import SampleBatch


class SlateQConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.buffer_size: int = 20_000
        self.num_steps_sampled_before_learning_starts: int = 300
        self.num_updates_per_iteration: int = 32
        self.target_network_update_freq: int = 500
        self.epsilon_initial: float = 1.0
        self.epsilon_final: float = 0.05
        self.epsilon_timesteps: int = 5_000

    def build(self, device: DeviceLike = None) -> "SlateQ":
        return SlateQ(self.copy(), device)


def _item_scores(weights, user, items):
    """Choice-model scores v_i = user . W . item (numpy)."""
    (W, b), = weights["choice"]
    return (user @ W + b) @ items.T


def _q_items(weights, user, items):
    """Q_item(s, i) for every item: MLP over [user, item] (numpy)."""
    n = len(items)
    x = np.concatenate(
        [np.repeat(user[None], n, 0), items], axis=1
    )
    h = x
    for W, b in weights["trunk"]:
        h = np.tanh(h @ W + b)
    (Wq, bq), = weights["q"]
    return (h @ Wq + bq)[:, 0]


class _SlatePolicy:
    """Greedy slate by v_i * Q_i with epsilon exploration."""

    def __init__(self, user_dim, item_dim, num_items, slate_size,
                 hidden, seed):
        rng = np.random.RandomState(seed)
        self.weights = {
            "trunk": init_mlp_params(
                rng, [user_dim + item_dim, hidden, hidden]
            ),
            "q": init_mlp_params(rng, [hidden, 1]),
            "choice": init_mlp_params(rng, [user_dim, item_dim]),
        }
        self.k = slate_size
        self.num_items = num_items
        self.epsilon = 1.0

    def set_weights(self, w):
        self.weights = w

    def get_weights(self):
        return self.weights

    def set_epsilon(self, e):
        self.epsilon = float(e)

    def compute_slate(self, user, items, rng) -> List[int]:
        if rng.rand() < self.epsilon:
            return list(rng.choice(self.num_items, self.k,
                                   replace=False))
        v = _item_scores(self.weights, user, items)
        q = _q_items(self.weights, user, items)
        return list(np.argsort(-(v * q))[:self.k])


class _SlateEnvRunner:
    """Steps a recsys env; emits (user, slate, clicked, reward,
    next_user, done) transitions."""

    def __init__(self, env_creator, policy_factory, seed=0,
                 rollout_fragment_length=100, **_):
        self.env = env_creator()
        self.policy = policy_factory()
        self.items = np.asarray(self.env.item_features, np.float32)
        self.rng = np.random.RandomState(seed)
        self.fragment = rollout_fragment_length
        self._obs, _ = self.env.reset(seed=seed)
        self._episode_reward = 0.0
        self._episode_rewards: List[float] = []

    def set_weights(self, w):
        self.policy.set_weights(w)

    def set_epsilon(self, e):
        self.policy.set_epsilon(e)

    def sample(self) -> SampleBatch:
        users, slates, clicks, rews, nxts, dones = \
            [], [], [], [], [], []
        for _ in range(self.fragment):
            user = np.asarray(self._obs, np.float32).reshape(-1)
            slate = self.policy.compute_slate(user, self.items,
                                              self.rng)
            nxt, r, term, trunc, info = self.env.step(slate)
            users.append(user)
            slates.append(slate)
            clicks.append(int(info.get("clicked", -1)))
            rews.append(float(r))
            nxts.append(np.asarray(nxt, np.float32).reshape(-1))
            dones.append(bool(term))
            self._episode_reward += float(r)
            if term or trunc:
                self._episode_rewards.append(self._episode_reward)
                self._episode_reward = 0.0
                self._obs, _ = self.env.reset()
            else:
                self._obs = nxt
        return SampleBatch({
            "user": np.stack(users),
            "slate": np.asarray(slates, np.int32),
            "clicked": np.asarray(clicks, np.int32),
            "rew": np.asarray(rews, np.float32),
            "next_user": np.stack(nxts),
            "done": np.asarray(dones, np.float32),
        })

    def episode_stats(self) -> Dict[str, float]:
        recent = self._episode_rewards[-20:]
        return {
            "episodes_total": len(self._episode_rewards),
            "episode_reward_mean": float(np.mean(recent))
            if recent else 0.0,
        }


def top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest entries of each row, largest first,
    with ties broken toward the lower index as ``jax.lax.top_k`` breaks
    them: a stable descending sort (``torch.topk`` leaves the order of
    ties unspecified)."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][:, :k]


def click_positions(slate: np.ndarray, clicked: np.ndarray) -> np.ndarray:
    """The position of the clicked item within its slate; k = no click."""
    slate = np.asarray(slate, np.int64)
    clicked = np.asarray(clicked, np.int64)
    pos = np.full(len(clicked), slate.shape[1], np.int32)
    hit = slate == clicked[:, None]
    rows, cols = np.nonzero(hit)
    pos[rows] = cols
    return pos


class SlateQLearner:
    """SARSA-on-the-clicked-item update with the slate decomposition
    target, and the choice model's click likelihood."""

    def __init__(self, policy, items: np.ndarray, slate_size: int,
                 lr: float, gamma: float, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._params = tree_to_device(policy.get_weights(), self.device)
        self._target = clone_tree(self._params)
        self._opt = AdamW(lr, weight_decay=0.0)  # optax.adam(lr)
        self._opt_state = self._opt.init(self._params)
        self._items = to_device(np.asarray(items, np.float32), self.device)
        self._k = slate_size
        self._gamma = gamma

    def q_items(self, p, users):
        """[B, N]: Q_item for every catalog item."""
        B, N = users.shape[0], self._items.shape[0]
        x = torch.cat([users[:, None, :].expand(B, N, users.shape[1]),
                       self._items[None].expand(B, N,
                                                self._items.shape[1])],
                      dim=-1).reshape(B * N, -1)
        (Wq, bq), = p["q"]
        return (RLModule.mlp(p["trunk"], x) @ Wq + bq).reshape(B, N)

    def scores(self, p, users):
        (W, b), = p["choice"]
        return (users @ W + b) @ self._items.T

    def next_slates(self, tgt, next_users):
        """(the target's greedy next slates [B, k], v [B, N], Q [B, N])."""
        nq_all = self.q_items(tgt, next_users)
        nv = self.scores(tgt, next_users)
        return top_k(nv * nq_all, self._k), nv, nq_all

    def _loss(self, p, tgt, batch):
        users, clicked = batch["user"], batch["clicked"]
        # Predicted Q of the clicked item (only clicked steps carry a
        # gradient: the no-click mask).
        q_c = take(self.q_items(p, users), torch.clamp(clicked, min=0))
        with torch.no_grad():
            # Target: the next greedy slate's expected value under the
            # conditional-logit choice model, the no-click option at 0.
            top, nv, nq_all = self.next_slates(tgt, batch["next_user"])
            v_top = nv.gather(1, top)
            q_top = nq_all.gather(1, top)
            vmax = v_top.max(-1, keepdim=True).values
            ex = torch.exp(v_top - vmax)
            denom = ex.sum(-1) + torch.exp(-vmax[:, 0])
            slate_value = (ex * q_top).sum(-1) / denom
            y = batch["rew"] + self._gamma * (1 - batch["done"]) \
                * slate_value
        mask = (clicked >= 0).float()
        td = (q_c - y) * mask
        td_loss = (td * td).sum() / torch.clamp(mask.sum(), min=1.0)
        # Choice-model likelihood on the click logs (the Q loss never
        # touches the choice head), the no-click logit 0.
        v_slate = self.scores(p, users).gather(1, batch["slate"].long())
        choice_logits = torch.cat(
            [v_slate, torch.zeros_like(v_slate[:, :1])], dim=1)
        ce = -take(F.log_softmax(choice_logits, dim=-1),
                   batch["click_pos"]).mean()
        return td_loss + ce, (td_loss.detach(), ce.detach())

    def learn_on_batch(self, mb) -> float:
        dev = self.device
        batch = {
            "user": to_device(mb["user"], dev),
            "slate": to_device(np.asarray(mb["slate"], np.int32), dev),
            "clicked": to_device(np.asarray(mb["clicked"], np.int32), dev),
            "click_pos": to_device(
                click_positions(mb["slate"], mb["clicked"]), dev),
            "rew": to_device(mb["rew"], dev),
            "next_user": to_device(mb["next_user"], dev),
            "done": to_device(mb["done"], dev),
        }
        (loss, _), grads = value_and_grad(
            self._loss, self._params, self._target, batch)
        self._opt.update(self._params, grads, self._opt_state)
        return float(loss)

    def sync_target(self):
        self._target = clone_tree(self._params)

    def get_weights(self):
        return tree_to_numpy(self._params)

    def set_weights(self, weights):
        self._params = tree_to_device(weights, self.device)


class SlateQ:
    def __init__(self, config: SlateQConfig, device: DeviceLike = None):
        import ray_tpu_torch as rt

        self.config = config
        self.iteration = 0
        self.device = resolve_device(device)
        c = config
        creator = c.env_creator()
        probe = creator()
        user0, _ = probe.reset(seed=0)
        user_dim = int(np.asarray(user0).reshape(-1).shape[0])
        items = np.asarray(probe.item_features, np.float32)
        self._slate_size = int(probe.slate_size)
        num_items = int(probe.num_items)
        if hasattr(probe, "close"):
            probe.close()

        policy_factory = _PolicyFactory(
            _SlatePolicy, user_dim, items.shape[1], num_items,
            self._slate_size, c.hidden_size, c.seed)
        runner_cls = rt.remote(_SlateEnvRunner)
        self.runners = [
            runner_cls.remote(
                creator, policy_factory, seed=c.seed + i,
                rollout_fragment_length=c.rollout_fragment_length,
            )
            for i in range(c.num_env_runners)
        ]
        self.learner = SlateQLearner(
            policy_factory(), items, self._slate_size, c.lr, c.gamma,
            device=self.device,
        )
        self.buffer = ReplayBuffer(c.buffer_size, seed=c.seed)
        self._env_steps = 0
        self._last_target_sync = 0

    def _epsilon(self) -> float:
        return linear_epsilon(self.config, self._env_steps)

    def train(self) -> Dict[str, Any]:
        import ray_tpu_torch as rt

        self.iteration += 1
        c = self.config
        eps = self._epsilon()
        rt.get([r.set_epsilon.remote(eps) for r in self.runners])
        batches = rt.get([r.sample.remote() for r in self.runners])
        for b in batches:
            self.buffer.add(b)
            self._env_steps += b.count

        loss = float("nan")
        num_updates = 0
        if self._env_steps >= c.num_steps_sampled_before_learning_starts:
            for _ in range(c.num_updates_per_iteration):
                loss = self.learner.learn_on_batch(
                    self.buffer.sample(c.minibatch_size)
                )
                num_updates += 1
            if (self._env_steps - self._last_target_sync
                    >= c.target_network_update_freq):
                self.learner.sync_target()
                self._last_target_sync = self._env_steps
            w = self.learner.get_weights()
            rt.get([r.set_weights.remote(w) for r in self.runners])

        ep = episode_result(
            rt.get([r.episode_stats.remote() for r in self.runners]))
        return {
            "training_iteration": self.iteration,
            **ep,
            "num_env_steps_sampled": self._env_steps,
            "num_learner_updates": num_updates,
            "epsilon": eps,
            "loss": loss,
        }

    def get_weights(self):
        return self.learner.get_weights()

    def stop(self):
        stop_actors(self.runners)
