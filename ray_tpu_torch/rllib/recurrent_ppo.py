"""Recurrent PPO: LSTM policies for partially observable tasks
(counterpart of ``ray_tpu/rllib/recurrent_ppo.py``).

Ref analogue: the reference PPO's ``use_lstm`` model option. The rollout
policy is an LSTM actor-critic in numpy with carried hidden state; the
runner actors compute GAE over the flat fragment and chop it into
stored-state sequences that never cross an episode boundary (both copied
from the JAX package). The learner unrolls the LSTM over each sequence on
the card (R2D2's loop of cells) under a masked clipped-surrogate loss.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..train.optim import AdamW
from .algorithm import (
    Algorithm,
    AlgorithmConfig,
    _PolicyFactory,
    probe_env,
)
from .core import (
    take,
    to_device,
    tree_to_device,
    tree_to_numpy,
    value_and_grad,
)
from .policy import init_mlp_params
from .r2d2 import _lstm_step_np, lstm_unroll
from .sample_batch import SampleBatch, compute_gae


class RecurrentPPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.clip_param: float = 0.2
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01
        self.lstm_size: int = 32
        self.seq_len: int = 8
        self.num_epochs = 4

    def build(self, device: DeviceLike = None) -> "RecurrentPPO":
        return RecurrentPPO(self.copy(), device)


def _init_params(obs_dim, num_actions, hidden, seed):
    rng = np.random.RandomState(seed)
    scale = 1.0 / np.sqrt(obs_dim + hidden)
    return {
        "wx": (rng.randn(obs_dim, 4 * hidden) * scale
               ).astype(np.float32),
        "wh": (rng.randn(hidden, 4 * hidden) * scale
               ).astype(np.float32),
        "b": np.zeros(4 * hidden, np.float32),
        "pi": init_mlp_params(rng, [hidden, num_actions]),
        "vf": init_mlp_params(rng, [hidden, 1]),
    }


class _LSTMAcPolicy:
    """numpy LSTM actor-critic with carried hidden state."""

    def __init__(self, obs_dim, num_actions, hidden, seed):
        self.weights = _init_params(obs_dim, num_actions, hidden, seed)
        self.hidden = hidden
        self.num_actions = num_actions
        self.reset_state()

    def reset_state(self):
        self.h = np.zeros(self.hidden, np.float32)
        self.c = np.zeros(self.hidden, np.float32)

    def state(self):
        return self.h.copy(), self.c.copy()

    def set_weights(self, w):
        self.weights = w

    def get_weights(self):
        return self.weights

    def compute_action(self, obs, rng):
        self.h, self.c = _lstm_step_np(
            self.weights, np.asarray(obs, np.float32).reshape(-1),
            self.h, self.c,
        )
        (Wp, bp), = self.weights["pi"]
        (Wv, bv), = self.weights["vf"]
        logits = self.h @ Wp + bp
        logits = logits - logits.max()
        probs = np.exp(logits)
        probs /= probs.sum()
        a = int(rng.choice(self.num_actions, p=probs))
        return a, float(np.log(probs[a] + 1e-12)), \
            float((self.h @ Wv + bv)[0])


class _RecurrentEnvRunner:
    """On-policy sequence collection: flat fragment stepping (GAE over
    the flat arrays), then chopped into stored-state sequences."""

    def __init__(self, env_creator, policy_factory, seed=0,
                 rollout_fragment_length=128, gamma=0.99, lam=0.95,
                 seq_len=8, **_):
        self.env = env_creator()
        self.policy = policy_factory()
        self.rng = np.random.RandomState(seed)
        self.fragment = rollout_fragment_length
        self.gamma, self.lam = gamma, lam
        self.L = seq_len
        self._obs, _ = self.env.reset(seed=seed)
        self.policy.reset_state()
        self._episode_reward = 0.0
        self._episode_rewards: List[float] = []

    def set_weights(self, w):
        self.policy.set_weights(w)

    def sample(self) -> SampleBatch:
        L = self.L
        obs_l, act_l, rew_l, done_l, logp_l, val_l = \
            [], [], [], [], [], []
        # (start_index, h0, c0) per sequence.
        seq_marks = [(0, *self.policy.state())]
        for t in range(self.fragment):
            obs = np.asarray(self._obs, np.float32).reshape(-1)
            a, logp, v = self.policy.compute_action(obs, self.rng)
            nxt, r, term, trunc, _ = self.env.step(a)
            done = bool(term or trunc)
            obs_l.append(obs)
            act_l.append(a)
            rew_l.append(float(r))
            done_l.append(bool(term))
            logp_l.append(logp)
            val_l.append(v)
            self._episode_reward += float(r)
            boundary = False
            if done:
                self._episode_rewards.append(self._episode_reward)
                self._episode_reward = 0.0
                self._obs, _ = self.env.reset()
                self.policy.reset_state()
                boundary = True
            else:
                self._obs = nxt
            steps_in_seq = t + 1 - seq_marks[-1][0]
            if (boundary or steps_in_seq == L) and \
                    t + 1 < self.fragment:
                seq_marks.append((t + 1, *self.policy.state()))
        # Bootstrap value for the fragment tail.
        last_value = 0.0
        if not done_l[-1]:
            h, c = self.policy.state()
            h2, _ = _lstm_step_np(
                self.policy.weights,
                np.asarray(self._obs, np.float32).reshape(-1), h, c,
            )
            (Wv, bv), = self.policy.weights["vf"]
            last_value = float((h2 @ Wv + bv)[0])
        gae = compute_gae(
            np.asarray(rew_l, np.float32),
            np.asarray(val_l, np.float32),
            np.asarray(done_l), last_value,
            gamma=self.gamma, lam=self.lam,
        )
        # Chop the flat columns into padded stored-state sequences.
        obs_dim = obs_l[0].shape[0]
        starts = [m[0] for m in seq_marks] + [self.fragment]
        seqs = []
        for i, (start, h0, c0) in enumerate(seq_marks):
            end = min(starts[i + 1], start + L)
            n = end - start
            if n <= 0:
                continue
            s = {
                "obs": np.zeros((L, obs_dim), np.float32),
                "actions": np.zeros(L, np.int32),
                "old_logp": np.zeros(L, np.float32),
                "adv": np.zeros(L, np.float32),
                "returns": np.zeros(L, np.float32),
                "mask": np.zeros(L, np.float32),
                "h0": h0, "c0": c0,
            }
            s["obs"][:n] = np.stack(obs_l[start:end])
            s["actions"][:n] = act_l[start:end]
            s["old_logp"][:n] = logp_l[start:end]
            s["adv"][:n] = gae["advantages"][start:end]
            s["returns"][:n] = gae["returns"][start:end]
            s["mask"][:n] = 1.0
            seqs.append(s)
        return SampleBatch({
            k: np.stack([s[k] for s in seqs]) for k in seqs[0]
        })

    def episode_stats(self) -> Dict[str, float]:
        recent = self._episode_rewards[-20:]
        return {
            "episodes_total": len(self._episode_rewards),
            "episode_reward_mean": float(np.mean(recent))
            if recent else 0.0,
        }


class RecurrentPPOLearner:
    """Masked clipped-surrogate loss over unrolled sequences."""

    def __init__(self, obs_dim, num_actions, cfg,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._params = tree_to_device(
            _init_params(obs_dim, num_actions, cfg.lstm_size, cfg.seed),
            self.device)
        self._opt = AdamW(cfg.lr, weight_decay=0.0)  # optax.adam(lr)
        self._opt_state = self._opt.init(self._params)
        self._clip = cfg.clip_param
        self._vf_c, self._ent_c = cfg.vf_loss_coeff, cfg.entropy_coeff

    def _loss(self, p, batch):
        hs = lstm_unroll(p, batch["obs"], batch["h0"], batch["c0"])
        (Wp, bp), = p["pi"]
        (Wv, bv), = p["vf"]
        logits = hs @ Wp + bp
        values = (hs @ Wv + bv)[..., 0]
        logp_all = F.log_softmax(logits, dim=-1)
        logp = take(logp_all, batch["actions"])
        mask = batch["mask"]
        msum = torch.clamp(mask.sum(), min=1.0)
        # The advantage normalised under the mask: the biased std + 1e-8.
        adv = batch["adv"]
        amean = (adv * mask).sum() / msum
        astd = torch.sqrt((((adv - amean) * mask) ** 2).sum() / msum) \
            + 1e-8
        adv_n = (adv - amean) / astd
        ratio = torch.exp(logp - batch["old_logp"])
        surr = torch.minimum(
            ratio * adv_n,
            torch.clamp(ratio, 1 - self._clip, 1 + self._clip) * adv_n,
        )
        pi_loss = -(surr * mask).sum() / msum
        vf_loss = (((values - batch["returns"]) ** 2) * mask).sum() / msum
        ent = (-(torch.exp(logp_all) * logp_all).sum(-1) * mask
               ).sum() / msum
        return pi_loss + self._vf_c * vf_loss - self._ent_c * ent, None

    def learn_on_batch(self, mb) -> float:
        batch = {k: to_device(v, self.device) for k, v in mb.items()}
        (loss, _), grads = value_and_grad(self._loss, self._params, batch)
        self._opt.update(self._params, grads, self._opt_state)
        return float(loss)

    def get_weights(self):
        return tree_to_numpy(self._params)

    def set_weights(self, weights):
        self._params = tree_to_device(weights, self.device)


class RecurrentPPO(Algorithm):
    def _make_policy_factory(self, obs_dim: int, num_actions: int):
        self._require_discrete()
        c = self.config
        return _PolicyFactory(_LSTMAcPolicy, obs_dim, num_actions,
                              c.lstm_size, c.seed)

    def _runner_class(self):
        return _RecurrentEnvRunner

    def __init__(self, config, device: DeviceLike = None):
        import ray_tpu_torch as rt

        # Custom runner construction (needs seq_len), so build the
        # gang here instead of the base constructor's loop.
        self.config = config
        self.iteration = 0
        self.device = resolve_device(device)
        c = config
        creator = c.env_creator()
        obs_dim, space = probe_env(creator)
        if not hasattr(space, "n"):
            raise ValueError(
                "RecurrentPPO supports discrete action spaces"
            )
        num_actions = int(space.n)
        self._obs_dim, self._num_actions = obs_dim, num_actions
        self._continuous = False

        policy_factory = self._make_policy_factory(obs_dim,
                                                   num_actions)
        runner_cls = rt.remote(_RecurrentEnvRunner)
        self.runners = [
            runner_cls.remote(
                creator, policy_factory, seed=c.seed + i,
                rollout_fragment_length=c.rollout_fragment_length,
                gamma=c.gamma, lam=c.lambda_, seq_len=c.seq_len,
            )
            for i in range(c.num_env_runners)
        ]
        self.learner = RecurrentPPOLearner(obs_dim, num_actions, c,
                                           device=self.device)
        self._rng = np.random.RandomState(c.seed)

    def training_step(self) -> Dict[str, Any]:
        c = self.config
        batch = SampleBatch.concat(self.sample_all())
        loss = float("nan")
        for _ in range(c.num_epochs):
            sh = batch.shuffle(self._rng)
            for mb in sh.minibatches(
                max(1, min(c.minibatch_size // c.seq_len, sh.count))
            ):
                loss = self.learner.learn_on_batch(dict(mb))
        self.broadcast(self.learner.get_weights())
        return {
            **self.episode_stats(),
            "num_env_steps_sampled":
                self.iteration * c.num_env_runners
                * c.rollout_fragment_length,
            "loss": loss,
        }
