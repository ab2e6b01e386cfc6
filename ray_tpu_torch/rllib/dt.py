"""DT: Decision Transformer, offline RL as sequence modelling
(counterpart of ``ray_tpu/rllib/dt.py``).

Ref analogue: rllib/algorithms/dt (Chen 2021). Trajectories become token
sequences (R_t, s_t, a_t) with returns-to-go; a small causal transformer
on the card learns to predict the action at each state token from the
context before it; at inference the desired return conditions R_0 and the
return-to-go falls by the observed rewards.

The transformer is plain PyTorch ops that follow the JAX package's math:
a pre-norm block without learned scale (biased variance, eps 1e-5), the
causal mask filled with -1e9, and GELU's tanh approximation (``jax.nn.gelu``'s
default). Its shapes (D = 64, 2 heads, 3K = 24 tokens) are far below what
the flash kernels are built for, and JAX runs it outside Pallas too.

Offline input: any dataset object with
``iter_batches(batch_size=, batch_format="numpy")`` whose rows carry
``episode_id``/``t``/``obs``/``action``/``reward`` columns; the algorithm
groups rows into episodes, computes returns-to-go, and samples length-K
context windows as training batches. Discrete actions.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .._device import DeviceLike, resolve_device
from ..train.optim import AdamW
from .algorithm import AlgorithmConfig
from .core import (
    take,
    to_device,
    tree_to_device,
    tree_to_numpy,
    value_and_grad,
)
from .policy import init_mlp_params


class DTConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.dataset = None
        self.obs_column = "obs"
        self.action_column = "action"
        self.reward_column = "reward"
        self.episode_column = "episode_id"
        self.time_column = "t"
        self.num_actions: Optional[int] = None
        self.context_length: int = 8      # K
        self.embed_dim: int = 64
        self.num_layers: int = 2
        self.num_heads: int = 2
        self.max_ep_len: int = 512
        self.batches_per_iteration: int = 32

    def offline_data(self, dataset, **columns) -> "DTConfig":
        self.dataset = dataset
        allowed = ("obs_column", "action_column", "reward_column",
                   "episode_column", "time_column")
        for k, v in columns.items():
            if k not in allowed:
                raise ValueError(f"unknown offline_data column {k!r} "
                                 f"(allowed: {allowed})")
            setattr(self, k, v)
        return self

    def build(self, device: DeviceLike = None) -> "DT":
        if self.dataset is None:
            raise ValueError("DTConfig.offline_data(dataset=...) "
                             "required")
        if self.num_actions is None:
            raise ValueError("DTConfig.training(num_actions=...) "
                             "required (discrete)")
        return DT(self.copy(), device=device)


def _init_dt_params(cfg: DTConfig, obs_dim: int) -> Dict[str, Any]:
    rng = np.random.RandomState(cfg.seed)
    D = cfg.embed_dim

    def lin(n_in, n_out):
        return init_mlp_params(rng, [n_in, n_out])

    params: Dict[str, Any] = {
        "state_emb": lin(obs_dim, D),
        "rtg_emb": lin(1, D),
        "act_emb": (rng.randn(cfg.num_actions + 1, D)
                    * 0.02).astype(np.float32),  # +1 = BOS/pad id
        "time_emb": (rng.randn(cfg.max_ep_len, D)
                     * 0.02).astype(np.float32),
        "head": lin(D, cfg.num_actions),
    }
    for layer in range(cfg.num_layers):
        params[f"attn_{layer}"] = {
            "qkv": lin(D, 3 * D),
            "proj": lin(D, D),
        }
        params[f"mlp_{layer}"] = {
            "up": lin(D, 4 * D),
            "down": lin(4 * D, D),
        }
    return params


def _dense(p, x):
    (W, b), = p
    return x @ W + b


def _norm(x):
    """(x - mean) / sqrt(var + 1e-5) over the last axis, with the biased
    variance ``jnp.var`` takes; no learned scale."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + 1e-5)


class DTLearner:
    """Causal-transformer action-prediction loss on the card."""

    def __init__(self, cfg: DTConfig, obs_dim: int,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._params = tree_to_device(_init_dt_params(cfg, obs_dim),
                                      self.device)
        self._opt = AdamW(cfg.lr, weight_decay=0.0)  # optax.adam(lr)
        self._opt_state = self._opt.init(self._params)
        self._D, self._H = cfg.embed_dim, cfg.num_heads
        self._L, self._K = cfg.num_layers, cfg.context_length
        T = 3 * self._K
        self._causal = torch.tril(torch.ones(
            (T, T), dtype=torch.bool, device=self.device))

    def _block(self, p_attn, p_mlp, x):
        B, T, D = x.shape
        H = self._H
        qkv = _dense(p_attn["qkv"], _norm(x))
        q, k, v = (t.reshape(B, T, H, D // H).transpose(1, 2)
                   for t in qkv.split(D, dim=-1))
        att = (q @ k.transpose(2, 3)) / np.sqrt(D // H)
        att = att.masked_fill(~self._causal, -1e9)
        att = torch.softmax(att, dim=-1)
        y = (att @ v).transpose(1, 2).reshape(B, T, D)
        x = x + _dense(p_attn["proj"], y)
        h = _dense(p_mlp["up"], _norm(x))
        return x + _dense(p_mlp["down"], F.gelu(h, approximate="tanh"))

    def forward(self, p, rtg, obs, act_in, timesteps):
        """rtg [B,K,1], obs [B,K,Do], act_in [B,K] (previous actions,
        BOS-shifted) -> logits [B,K,A] at the state tokens."""
        B, K, D = obs.shape[0], self._K, self._D
        te = p["time_emb"][timesteps.long()]            # [B,K,D]
        tok_r = _dense(p["rtg_emb"], rtg) + te
        tok_s = _dense(p["state_emb"], obs) + te
        tok_a = p["act_emb"][act_in.long()] + te
        # Interleave (r, s, a) -> [B, 3K, D].
        x = torch.stack([tok_r, tok_s, tok_a], dim=2).reshape(B, 3 * K, D)
        for layer in range(self._L):
            x = self._block(p[f"attn_{layer}"], p[f"mlp_{layer}"], x)
        x = _norm(x)
        # State tokens sit at positions 3t+1.
        return _dense(p["head"], x[:, 1::3])

    def _loss(self, p, batch):
        logits = self.forward(p, batch["rtg"], batch["obs"],
                              batch["act_in"], batch["timesteps"])
        nll = -take(F.log_softmax(logits, dim=-1), batch["actions"])
        mask = batch["mask"]
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0), None

    def train_batch_device(self, np_batch) -> torch.Tensor:
        """One step; the loss stays on the device."""
        batch = {k: to_device(v, self.device) for k, v in np_batch.items()}
        (loss, _), grads = value_and_grad(self._loss, self._params, batch)
        self._opt.update(self._params, grads, self._opt_state)
        return loss

    def train_batch(self, np_batch) -> float:
        return float(self.train_batch_device(np_batch))

    @torch.no_grad()
    def predict_logits(self, rtg, obs, act_in, timesteps):
        dev = self.device
        return self.forward(self._params, to_device(rtg, dev),
                            to_device(obs, dev), to_device(act_in, dev),
                            to_device(timesteps, dev)).cpu().numpy()

    def get_weights(self):
        return tree_to_numpy(self._params)

    def set_weights(self, weights):
        self._params = tree_to_device(weights, self.device)


class DT:
    def __init__(self, config: DTConfig, device: DeviceLike = None):
        c = config
        self.config = c
        self.iteration = 0
        self._rng = np.random.RandomState(c.seed)
        self._episodes = self._load_episodes()
        obs0 = self._episodes[0]["obs"]
        self._obs_dim = int(obs0.shape[-1])
        self.learner = DTLearner(c, self._obs_dim, device=device)

    def _load_episodes(self) -> List[Dict[str, np.ndarray]]:
        c = self.config
        by_ep: Dict[Any, List[tuple]] = {}
        for batch in c.dataset.iter_batches(batch_size=1024,
                                            batch_format="numpy"):
            n = len(batch[c.episode_column])
            for i in range(n):
                by_ep.setdefault(
                    batch[c.episode_column][i].item()
                    if hasattr(batch[c.episode_column][i], "item")
                    else batch[c.episode_column][i],
                    [],
                ).append((
                    int(batch[c.time_column][i]),
                    np.asarray(batch[c.obs_column][i],
                               np.float32).reshape(-1),
                    int(batch[c.action_column][i]),
                    float(batch[c.reward_column][i]),
                ))
        episodes = []
        for rows in by_ep.values():
            rows.sort(key=lambda r: r[0])
            obs = np.stack([r[1] for r in rows])
            acts = np.asarray([r[2] for r in rows], np.int32)
            rews = np.asarray([r[3] for r in rows], np.float32)
            rtg = np.cumsum(rews[::-1])[::-1].astype(np.float32)
            episodes.append({"obs": obs, "actions": acts,
                             "rewards": rews, "rtg": rtg})
        if not episodes:
            raise ValueError("offline dataset contains no episodes")
        return episodes

    def _sample_batch(self) -> Dict[str, np.ndarray]:
        c = self.config
        K = c.context_length
        B = c.minibatch_size
        bos = c.num_actions   # BOS/pad action id
        out = {
            "obs": np.zeros((B, K, self._obs_dim), np.float32),
            "actions": np.zeros((B, K), np.int32),
            "act_in": np.full((B, K), bos, np.int32),
            "rtg": np.zeros((B, K, 1), np.float32),
            "timesteps": np.zeros((B, K), np.int32),
            "mask": np.zeros((B, K), np.float32),
        }
        for b in range(B):
            ep = self._episodes[self._rng.randint(len(self._episodes))]
            T = len(ep["actions"])
            start = self._rng.randint(T)
            end = min(T, start + K)
            n = end - start
            out["obs"][b, :n] = ep["obs"][start:end]
            out["actions"][b, :n] = ep["actions"][start:end]
            if start > 0:
                out["act_in"][b, 0] = ep["actions"][start - 1]
            out["act_in"][b, 1:n] = ep["actions"][start:end - 1]
            out["rtg"][b, :n, 0] = ep["rtg"][start:end]
            out["timesteps"][b, :n] = np.arange(
                start, end
            ) % self.config.max_ep_len
            out["mask"][b, :n] = 1.0
        return out

    def train(self) -> Dict[str, Any]:
        self.iteration += 1
        c = self.config
        loss = None
        for _ in range(c.batches_per_iteration):
            loss = self.learner.train_batch_device(self._sample_batch())
        return {
            "training_iteration": self.iteration,
            # The last batch's loss: one read to the host an iteration.
            "loss": float(loss) if loss is not None else float("nan"),
            "num_episodes": len(self._episodes),
        }

    def compute_action(self, history: Dict[str, List[Any]],
                       target_return: float) -> int:
        """Next action given the running episode ``history``
        ({"obs": [...], "actions": [...], "rewards": [...]}) and the
        conditioning target return (ref: DT inference — rtg decremented
        by observed rewards)."""
        c = self.config
        K = c.context_length
        obs_hist = [np.asarray(o, np.float32).reshape(-1)
                    for o in history["obs"]]
        act_hist = list(history.get("actions", []))
        rew_hist = list(history.get("rewards", []))
        t0 = max(0, len(obs_hist) - K)
        window = obs_hist[t0:]
        n = len(window)
        bos = c.num_actions
        obs = np.zeros((1, K, self._obs_dim), np.float32)
        act_in = np.full((1, K), bos, np.int32)
        rtgs = np.zeros((1, K, 1), np.float32)
        ts = np.zeros((1, K), np.int32)
        obs[0, :n] = np.stack(window)
        rtg_seq = []
        run = target_return
        for r in rew_hist:
            rtg_seq.append(run)
            run -= r
        rtg_seq.append(run)
        rtg_win = rtg_seq[t0:t0 + n]
        rtgs[0, :len(rtg_win), 0] = rtg_win
        if t0 > 0:
            act_in[0, 0] = act_hist[t0 - 1]
        for i, a in enumerate(act_hist[t0:]):
            if i + 1 < K:
                act_in[0, i + 1] = a
        ts[0, :n] = (np.arange(t0, t0 + n) % c.max_ep_len)
        logits = self.learner.predict_logits(rtgs, obs, act_in, ts)
        return int(np.argmax(logits[0, n - 1]))

    def get_weights(self):
        return self.learner.get_weights()

    def stop(self):
        pass
