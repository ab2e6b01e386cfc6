"""A3C: asynchronous advantage actor-critic (counterpart of
``ray_tpu/rllib/a3c.py``).

Ref analogue: rllib/algorithms/a3c (Mnih 2016). The asynchrony is the
point: each rollout worker computes actor-critic gradients on its own
fresh fragment and the central learner applies them AS THEY ARRIVE — no
barrier, no averaging — then sends that worker the refreshed weights.
Slow workers therefore compute gradients against slightly stale
parameters (the HOGWILD-style tolerance the paper relies on). Reuses
DD-PPO's embedded worker-learner plane (CPU actors) with the A2C loss;
the canonical parameters and their Adam live in the driver, on the card
unless ``build(device="cpu")``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from .._device import DeviceLike, resolve_device
from ..train.optim import AdamW
from .a2c import A2CLearner
from .algorithm import AlgorithmConfig, episode_result, stop_actors
from .core import tree_to_device, tree_to_numpy
from .ddppo import WORKER_DEVICE, _WorkerLearner, discrete_policy_factory


class A3CConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01
        self.grads_per_iteration: int = 8

    def build(self, device: DeviceLike = None) -> "A3C":
        return A3C(self.copy(), device)


class _A3CWorker(_WorkerLearner):
    """Worker computing A2C gradients on its own rollouts."""

    def __init__(self, env_creator, policy_factory, *, lr, vf_coeff,
                 ent_coeff, seed=0, rollout_fragment_length=200,
                 gamma=0.99, lam=0.95):
        # Reuse the DD-PPO worker shell with the A2C loss.
        super().__init__(
            env_creator, policy_factory, lr=lr, clip=0.2,
            vf_coeff=vf_coeff, ent_coeff=ent_coeff, seed=seed,
            rollout_fragment_length=rollout_fragment_length,
            gamma=gamma, lam=lam,
        )

    def _make_learner(self, lr, clip, vf_coeff, ent_coeff):
        return A2CLearner(self.policy, lr, vf_coeff, ent_coeff,
                          device=WORKER_DEVICE)

    def set_weights(self, weights):
        self._learner.set_weights(weights)
        self.policy.set_weights(weights)


class A3C:
    def __init__(self, config: A3CConfig, device: DeviceLike = None):
        import ray_tpu_torch as rt

        self.config = config
        self.iteration = 0
        self.device = resolve_device(device)
        c = config
        creator = c.env_creator()
        policy_factory = discrete_policy_factory(creator, "A3C", c)
        worker_cls = rt.remote(_A3CWorker)
        self.workers = [
            worker_cls.remote(
                creator, policy_factory,
                lr=c.lr, vf_coeff=c.vf_loss_coeff,
                ent_coeff=c.entropy_coeff, seed=c.seed + i,
                rollout_fragment_length=c.rollout_fragment_length,
                gamma=c.gamma, lam=c.lambda_,
            )
            for i in range(c.num_env_runners)
        ]
        # Central parameter server: the driver holds the canonical
        # params + optimizer and applies gradients as they land.
        self._params = tree_to_device(policy_factory().get_weights(),
                                      self.device)
        self._opt = AdamW(c.lr, weight_decay=0.0)  # optax.adam(lr)
        self._opt_state = self._opt.init(self._params)
        self._env_steps = 0
        self._inflight: Dict[Any, int] = {}

    def _weights(self):
        return tree_to_numpy(self._params)

    def train(self) -> Dict[str, Any]:
        import ray_tpu_torch as rt

        self.iteration += 1
        c = self.config
        if not self._inflight:
            w = self._weights()
            rt.get([wk.set_weights.remote(w) for wk in self.workers])
            for i, wk in enumerate(self.workers):
                self._inflight[wk.sample_and_grad.remote()] = i

        losses: List[float] = []
        applied = 0
        while applied < c.grads_per_iteration:
            ready, _ = rt.wait(list(self._inflight), num_returns=1,
                               timeout=30.0)
            if not ready:
                break
            ref = ready[0]
            i = self._inflight.pop(ref)
            out = rt.get(ref)
            # Apply THIS worker's gradient immediately (async, possibly
            # stale — the A3C contract).
            self._opt.update(self._params,
                             tree_to_device(out["grads"], self.device),
                             self._opt_state)
            self._env_steps += out["count"]
            losses.append(out["loss"])
            applied += 1
            # Refresh only this worker and re-arm it.
            self.workers[i].set_weights.remote(self._weights())
            self._inflight[self.workers[i].sample_and_grad.remote()] = i

        ep = episode_result(
            rt.get([wk.episode_stats.remote() for wk in self.workers]))
        return {
            "training_iteration": self.iteration,
            **ep,
            "num_env_steps_sampled": self._env_steps,
            "num_grads_applied": applied,
            "loss": float(np.mean(losses)) if losses else float("nan"),
        }

    def get_weights(self):
        return self._weights()

    def stop(self):
        self._inflight = {}
        stop_actors(self.workers)
