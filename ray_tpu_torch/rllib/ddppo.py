"""DD-PPO: decentralized distributed PPO (counterpart of
``ray_tpu/rllib/ddppo.py``).

Ref analogue: rllib/algorithms/ddppo (Wijmans 2019). Standard PPO ships
all rollouts to one central learner; DD-PPO gives EVERY rollout worker its
own learner — each worker samples its env, computes PPO gradients on its
OWN batch, and the gradients are averaged across workers each round (the
reference allreduces inside the workers; here the worker-learners return
gradient trees as numpy and the driver averages and broadcasts them —
the same data flow, with the driver standing in for the allreduce).

The workers are CPU actors, as the JAX package's are, so their learners
run with ``device="cpu"``: that is the design, not a fallback. Every
worker draws its policy from the same seed and applies the same averaged
gradient with its own Adam, so all workers hold the same weights after
every round (the DD-PPO invariant).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from .._device import DeviceLike
from .algorithm import _PolicyFactory, episode_result, probe_env, stop_actors
from .core import (
    to_device,
    tree_map,
    tree_to_device,
    tree_to_numpy,
    value_and_grad,
)
from .env_runner import EnvRunner
from .ppo import PPOConfig, PPOLearner
from .sample_batch import ACTIONS, ADVANTAGES, LOGPS, OBS, RETURNS

WORKER_DEVICE = "cpu"  # the workers are CPU actors


class DDPPOConfig(PPOConfig):
    def __init__(self):
        super().__init__()
        self.num_env_runners = 2
        self.sgd_rounds_per_iteration: int = 4

    def build(self, device: DeviceLike = None) -> "DDPPO":
        """``device`` is accepted for the other configs' sake: DD-PPO's
        learners live in its CPU workers, and the driver holds none."""
        return DDPPO(self.copy())


class _WorkerLearner(EnvRunner):
    """Rollout worker WITH an embedded PPO learner: samples its env,
    computes clipped-surrogate gradients on its own fresh batch, and
    applies externally averaged updates (ref: the per-worker learner in
    ddppo.py — "no central bottleneck")."""

    def __init__(self, env_creator, policy_factory, *, lr, clip,
                 vf_coeff, ent_coeff, seed=0,
                 rollout_fragment_length=200, gamma=0.99, lam=0.95):
        super().__init__(env_creator, policy_factory, seed,
                         rollout_fragment_length, gamma, lam)
        self._learner = self._make_learner(lr, clip, vf_coeff, ent_coeff)
        self._np_rng = np.random.RandomState(seed + 7)

    def _make_learner(self, lr, clip, vf_coeff, ent_coeff):
        return PPOLearner(self.policy, lr, clip, vf_coeff, ent_coeff,
                          device=WORKER_DEVICE)

    def sample_and_grad(self) -> Dict[str, Any]:
        """One round: fresh rollout -> gradient tree on it."""
        learner = self._learner
        batch = self.sample()
        dev = learner.device
        tb = {
            "obs": to_device(batch[OBS], dev),
            "actions": to_device(np.asarray(batch[ACTIONS], np.int32), dev),
            "old_logp": to_device(batch[LOGPS], dev),
            "adv": to_device(batch[ADVANTAGES], dev),
            "returns": to_device(batch[RETURNS], dev),
        }
        (loss, _), grads = value_and_grad(
            learner.compute_loss, learner._params, {}, tb)
        return {
            "grads": tree_to_numpy(grads),
            "loss": float(loss),
            "count": batch.count,
        }

    def apply_gradients(self, avg_grads) -> None:
        """Apply the averaged gradient with the local optimizer (every
        worker holds identical params + opt state, so updates stay in
        lockstep — the DD-PPO invariant)."""
        learner = self._learner
        learner._opt.update(learner._params,
                            tree_to_device(avg_grads, learner.device),
                            learner._opt_state)
        self.policy.set_weights(learner.get_weights())

    def get_weights(self):
        return self._learner.get_weights()


def mean_tree(trees):
    """The leafwise mean of numpy trees of one shape."""
    return tree_map(lambda *gs: np.mean(np.stack(gs), axis=0), *trees)


def discrete_policy_factory(creator, name: str, config):
    """The MLP policy factory for a discrete env, with the SAME seed for
    every worker (DD-PPO needs identical initial params everywhere)."""
    from .policy import MLPPolicy

    obs_dim, space = probe_env(creator)
    if not hasattr(space, "n"):
        raise ValueError(f"{name} supports discrete action spaces")
    return _PolicyFactory(MLPPolicy, obs_dim, int(space.n),
                          config.hidden_size, config.seed)


class DDPPO:
    def __init__(self, config: DDPPOConfig):
        import ray_tpu_torch as rt

        self.config = config
        self.iteration = 0
        c = config
        creator = c.env_creator()
        policy_factory = discrete_policy_factory(creator, "DDPPO", c)
        worker_cls = rt.remote(_WorkerLearner)
        self.workers = [
            worker_cls.remote(
                creator, policy_factory,
                lr=c.lr, clip=c.clip_param, vf_coeff=c.vf_loss_coeff,
                ent_coeff=c.entropy_coeff, seed=c.seed + i,
                rollout_fragment_length=c.rollout_fragment_length,
                gamma=c.gamma, lam=c.lambda_,
            )
            for i in range(c.num_env_runners)
        ]
        self._env_steps = 0

    def train(self) -> Dict[str, Any]:
        import ray_tpu_torch as rt

        self.iteration += 1
        c = self.config
        losses: List[float] = []
        for _ in range(c.sgd_rounds_per_iteration):
            outs = rt.get([w.sample_and_grad.remote()
                           for w in self.workers])
            self._env_steps += sum(o["count"] for o in outs)
            losses.append(float(np.mean([o["loss"] for o in outs])))
            # The stand-in allreduce: average gradient trees.
            avg_grads = mean_tree([o["grads"] for o in outs])
            rt.get([w.apply_gradients.remote(avg_grads)
                    for w in self.workers])

        ep = episode_result(
            rt.get([w.episode_stats.remote() for w in self.workers]))
        return {
            "training_iteration": self.iteration,
            **ep,
            "num_env_steps_sampled": self._env_steps,
            "loss": losses[-1] if losses else float("nan"),
        }

    def get_weights(self):
        import ray_tpu_torch as rt

        return rt.get(self.workers[0].get_weights.remote())

    def stop(self):
        stop_actors(self.workers)
