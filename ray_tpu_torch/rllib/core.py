"""RLModule / Learner / LearnerGroup — the pluggable learner layer
(counterpart of ``ray_tpu/rllib/core.py``).

Ref analogue: rllib/core/rl_module/rl_module.py (network container) and
rllib/core/learner/learner.py:227 (compute_gradients:553,
apply_gradients:675, update:1227) + learner_group.py:66. An RLModule
declares the parameter tree and pure forward functions; a Learner
subclass implements ``compute_loss`` and inherits the
grad/clip/apply/target-polyak update.

A parameter tree keeps the JAX package's shape: dicts of lists of
``(W, b)`` tuples (SAC adds a scalar ``log_alpha``), here with float32
tensors on the learner's device as leaves. Weights enter and leave as
numpy trees of the same shape (``get_weights`` / ``set_weights``), which
the numpy rollout policies of both packages consume, so a tree carries
over between the packages leaf for leaf. The optimizer is
``train.optim.AdamW`` with ``weight_decay=0.0``, which is ``optax.adam``;
it updates the leaves in place, so every target network is a copy of its
leaves (JAX shares them because its arrays are immutable).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..train.optim import AdamW, leaves
from .algorithm import stop_actors


# ------------------------------------------------------------------ trees

def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of a tree of dicts, lists and tuples, with
    matching trees ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def to_device(value, device: torch.device) -> torch.Tensor:
    """One numpy array (or scalar) as a tensor of its own on ``device``,
    typed as ``jnp.asarray`` types it without 64-bit mode: float64 becomes
    float32 and int64 int32. From the host's pageable memory the copy is
    queued without waiting for the card (CUDA stages the bytes before the
    call returns)."""
    a = np.asarray(value)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    if not (a.flags.c_contiguous and a.flags.writeable):
        # Not np.ascontiguousarray: it turns a 0-d array (log_alpha) 1-d.
        a = a.copy()
    t = torch.from_numpy(a)
    if device.type == "cpu":
        return t.clone()
    return t.to(device, non_blocking=True)


def tree_to_device(tree, device: torch.device):
    """A numpy tree (e.g. ``get_weights()`` of either package) as float32
    tensors on ``device``, copied: the caller's arrays stay its own."""
    return tree_map(lambda a: to_device(np.asarray(a, np.float32), device),
                    tree)


def tree_to_numpy(tree):
    """A tensor tree as numpy arrays that share no memory with it (on the
    CPU ``Tensor.numpy()`` would alias a leaf the next update changes)."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True).numpy(), tree)


def clone_tree(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def polyak_(target, params, tau: float) -> None:
    """``target = (1 - tau) * target + tau * params`` in place, rounded as
    JAX writes it (``lerp`` rounds differently)."""
    ts = leaves(target)
    torch._foreach_mul_(ts, 1.0 - tau)
    torch._foreach_add_(ts, torch._foreach_mul(leaves(params), tau))


def value_and_grad(loss_fn: Callable, params, *args,
                   wrt: Optional[Sequence[str]] = None):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, *args)``:
    ((loss, aux), grads). ``wrt`` names the top-level entries of
    ``params`` to differentiate (default: all); ``grads`` holds those
    entries only. A leaf the loss does not reach gets a zero gradient."""
    keys = tuple(params) if wrt is None else tuple(wrt)
    live = {k: tree_map(lambda t: t.detach().requires_grad_(), params[k])
            for k in keys}
    with torch.enable_grad():
        loss, aux = loss_fn({**params, **live}, *args)
        xs = leaves(live)
        gs = torch.autograd.grad(loss, xs, allow_unused=True)
    by_leaf = {id(x): (torch.zeros_like(x) if g is None else g)
               for x, g in zip(xs, gs)}
    grads = tree_map(lambda x: by_leaf[id(x)], live)
    return (loss.detach(), aux), grads


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """``optax.clip_by_global_norm``: the gradients stay as they are when
    their global norm is below ``max_norm``, else each becomes
    ``g / norm * max_norm`` (no epsilon, unlike ``clip_grad_norm_``).
    In place and on the device: no host sync."""
    gs = leaves(grads)
    norm = torch.sqrt(sum((g * g).sum() for g in gs))
    keep = norm < max_norm
    for g in gs:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take_along_axis(x, idx[..., None], -1)[..., 0]``: the entry
    of the last axis that ``idx`` picks (int32 indices; ``gather`` wants
    int64)."""
    return x.gather(-1, idx.long()[..., None])[..., 0]


def to_floats(stats: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Device stats as Python floats, through one copy to the host."""
    if not stats:
        return {}
    vals = torch.stack([v.detach().float().reshape(()) for v in
                        stats.values()]).tolist()
    return dict(zip(stats, vals))


# ------------------------------------------------------------------ modules

class RLModule:
    """Owns network construction + pure forward functions (PyTorch). The
    parameter tree is plain nested lists/dicts so the numpy rollout
    policies (policy.py) consume the same weights."""

    def init_params(self) -> Any:
        raise NotImplementedError

    @staticmethod
    def mlp(params, x):
        for W, b in params:
            x = torch.tanh(x @ W + b)
        return x


class ActorCriticModule(RLModule):
    """Discrete actor-critic MLP matching policy.MLPPolicy's tree
    (trunk/pi/vf) so learner weights go straight into the numpy rollout
    policy."""

    def __init__(self, obs_dim: int, num_actions: int, hidden: int = 64,
                 seed: int = 0):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = hidden
        self.seed = seed

    def init_params(self):
        from .policy import MLPPolicy

        return MLPPolicy(
            self.obs_dim, self.num_actions, self.hidden, self.seed
        ).get_weights()

    @classmethod
    def forward(cls, params, obs):
        """(logits, value)."""
        h = cls.mlp(params["trunk"], obs)
        (Wp, bp), = params["pi"]
        (Wv, bv), = params["vf"]
        return h @ Wp + bp, (h @ Wv + bv)[..., 0]


class DeterministicActorModule(RLModule):
    """Deterministic continuous actor (TD3-style): tanh(mu) scaled to
    the Box bounds; matches policy.DeterministicPolicy's tree."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: int = 64,
                 seed: int = 0):
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.hidden = hidden
        self.seed = seed

    def init_params(self):
        from .policy import init_mlp_params

        rng = np.random.RandomState(self.seed)
        return {
            "trunk": init_mlp_params(
                rng, [self.obs_dim, self.hidden, self.hidden]
            ),
            "mu": init_mlp_params(rng, [self.hidden, self.act_dim]),
        }

    @classmethod
    def forward(cls, params, obs):
        """Action in [-1, 1]^act_dim."""
        h = cls.mlp(params["trunk"], obs)
        (Wm, bm), = params["mu"]
        return torch.tanh(h @ Wm + bm)


class QModule(RLModule):
    """State-action value MLP: Q(s, a) -> scalar."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: int = 64,
                 seed: int = 0):
        self.obs_dim = obs_dim
        self.act_dim = act_dim
        self.hidden = hidden
        self.seed = seed

    def init_params(self):
        from .policy import init_mlp_params

        rng = np.random.RandomState(self.seed)
        return {
            "trunk": init_mlp_params(
                rng, [self.obs_dim + self.act_dim, self.hidden,
                      self.hidden]
            ),
            "q": init_mlp_params(rng, [self.hidden, 1]),
        }

    @classmethod
    def forward(cls, params, obs, act):
        h = cls.mlp(params["trunk"], torch.cat([obs, act], -1))
        (W, b), = params["q"]
        return (h @ W + b)[..., 0]


# ------------------------------------------------------------------ learner

class Learner:
    """Owns the parameter tree on its device, the Adam state, optional
    polyak target copies, and the update. Subclasses implement
    ``compute_loss(params, target, batch) -> (loss, stats)`` on tensors
    and inherit everything else (ref: Learner.compute_gradients /
    apply_gradients / update). ``device=None`` is the card; without one
    the constructor raises."""

    def __init__(self, params, *, lr: float = 3e-4,
                 grad_clip: Optional[float] = None,
                 target_keys: Tuple[str, ...] = (),
                 tau: float = 0.005, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._params = tree_to_device(params, self.device)
        self._grad_clip = grad_clip
        self._opt = AdamW(lr, weight_decay=0.0)  # optax.adam(lr)
        # The entries the optimizer steps (TwinCriticLearner leaves the
        # actor out).
        self._train_keys = tuple(self._params)
        self._opt_state = self._opt.init(self._params)
        self._target_keys = tuple(target_keys)
        self._tau = tau
        self._target = {k: clone_tree(self._params[k])
                        for k in self._target_keys}
        self.num_updates = 0

    # -- subclass surface ----------------------------------------------

    def compute_loss(self, params, target, batch):
        """(scalar loss, {stat: scalar}) on tensors. ``target`` is the
        polyak-averaged target subtree dict ({} when target_keys=())."""
        raise NotImplementedError

    # -- update --------------------------------------------------------

    def update_device(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, torch.Tensor]:
        """One gradient step; the stats stay ON THE DEVICE (no host sync),
        so a minibatch loop keeps the card's queue full."""
        tbatch = {k: to_device(v, self.device) for k, v in batch.items()}
        (loss, stats), grads = value_and_grad(
            self.compute_loss, self._params, self._target, tbatch,
            wrt=self._train_keys)
        if self._grad_clip:
            clip_by_global_norm_(grads, self._grad_clip)
        self._opt.update({k: self._params[k] for k in self._train_keys},
                         grads, self._opt_state)
        # Entries outside target_keys pass through untouched (a subclass
        # may keep them on its own schedule, e.g. TD3's delayed actor).
        for k in self._target_keys:
            polyak_(self._target[k], self._params[k], self._tau)
        stats = {k: v.detach() for k, v in stats.items()}
        stats["total_loss"] = loss
        self.num_updates += 1
        return stats

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        return to_floats(self.update_device(batch))

    # -- weights -------------------------------------------------------

    def get_weights(self):
        return tree_to_numpy(self._params)

    def set_weights(self, weights):
        self._params = tree_to_device(weights, self.device)

    def get_state(self):
        return {
            "params": self.get_weights(),
            "target": tree_to_numpy(self._target),
            "num_updates": self.num_updates,
        }


class TwinCriticLearner(Learner):
    """Shared machinery for deterministic-actor critic algorithms
    (TD3, CQL twin; DDPG single): params {actor, q1[, q2, ...]}; the
    critic step runs through ``compute_loss`` with the actor subtree left
    OUT of its optimizer (optax's ``set_to_zero`` label: no Adam state, no
    movement; a zeroed gradient would still move it through Adam's
    momentum), the actor step maximizes Q1(s, pi(s)) with its OWN Adam
    state and polyak-syncs the actor target (its only sync point — critic
    targets sync in the base update), and weight/state round-trips keep
    the critics (get_weights returns the actor for rollout policies;
    set_weights accepts actor-only or full trees)."""

    def __init__(self, actor_params, *, obs_dim: int, act_dim: int,
                 hidden: int, lr: float, tau: float, seed: int,
                 critics: int = 2, device: DeviceLike = None):
        qkeys = tuple(f"q{i + 1}" for i in range(critics))
        params = {
            "actor": actor_params,
            **{
                k: QModule(obs_dim, act_dim, hidden,
                           seed + 1 + i).init_params()
                for i, k in enumerate(qkeys)
            },
        }
        # Critic targets polyak in the base update; the ACTOR target is
        # seeded below and synced ONLY by actor_update.
        super().__init__(params, lr=lr, target_keys=qkeys, tau=tau,
                         device=device)
        self._target["actor"] = clone_tree(self._params["actor"])
        self._train_keys = qkeys
        self._opt_state = self._opt.init(
            {k: self._params[k] for k in qkeys})
        self._aopt_state = self._opt.init({"actor": self._params["actor"]})
        self._act_dim = act_dim

    def _actor_loss(self, params, obs):
        a = DeterministicActorModule.forward(params["actor"], obs)
        return -QModule.forward(params["q1"], obs, a).mean(), {}

    def actor_update(self, batch) -> Dict[str, torch.Tensor]:
        """Policy step: maximize Q1(s, pi(s)); returns device-valued
        stats (callers sync once per iteration). Q1 is a constant here:
        only the actor is differentiated."""
        obs = to_device(batch["obs"], self.device)
        (loss, _), grads = value_and_grad(
            self._actor_loss, self._params, obs, wrt=("actor",))
        self._opt.update({"actor": self._params["actor"]}, grads,
                         self._aopt_state)
        polyak_(self._target["actor"], self._params["actor"], self._tau)
        return {"actor_loss": loss}

    def get_weights(self):
        """ACTOR weights only — what rollout policies consume."""
        return tree_to_numpy(self._params["actor"])

    def set_weights(self, weights):
        """Accepts either a full {actor, q1, q2} tree or (matching
        get_weights) an actor-only tree, merged into the full params —
        the inherited round-trip must not drop the critics."""
        if isinstance(weights, dict) and "q1" in weights:
            super().set_weights(weights)
        else:
            self._params = {
                **self._params,
                "actor": tree_to_device(weights, self.device),
            }

    def get_state(self):
        return {
            "params": tree_to_numpy(self._params),
            "target": tree_to_numpy(self._target),
            "num_updates": self.num_updates,
        }


class _LearnerActor:
    """Actor wrapper hosting a Learner replica (LearnerGroup remote
    mode). The factory arrives by reference: a module-level callable or
    a ``functools.partial`` of one."""

    def __init__(self, learner_factory: Callable[[], Learner]):
        self._learner = learner_factory()

    def update(self, batch):
        return self._learner.update(batch)

    def get_weights(self):
        return self._learner.get_weights()

    def num_updates(self):
        return self._learner.num_updates


class LearnerGroup:
    """Run a Learner locally or inside a remote actor (ref:
    learner_group.py:66 — local vs remote learners; the remote mode is
    the learner/actor split async algorithms build on). ``update_async``
    returns a future-like ref in remote mode so sampling continues
    while the learner steps. ``ray_remote_args={"num_gpus": 1}`` puts the
    learner in a GPU worker, where a factory that gives no device takes
    the card. A factory the worker could not import (a lambda, a local or
    ``__main__`` function) raises ``TypeError`` naming it."""

    def __init__(self, learner_factory: Callable[[], Learner],
                 *, remote: bool = False,
                 ray_remote_args: Optional[dict] = None):
        self._remote = remote
        if not remote:
            self._learner = learner_factory()
            self._actor = None
        else:
            import ray_tpu_torch as rt

            cls = rt.remote(**(ray_remote_args or {}))(_LearnerActor)
            self._actor = cls.remote(learner_factory)
            self._learner = None

    @property
    def is_remote(self) -> bool:
        return self._remote

    def update(self, batch) -> Dict[str, float]:
        if self._learner is not None:
            return self._learner.update(batch)
        import ray_tpu_torch as rt

        return rt.get(self._actor.update.remote(batch), timeout=300)

    def update_async(self, batch):
        """Remote mode: returns the update's result ref immediately.
        Local mode: runs inline and returns the stats."""
        if self._learner is not None:
            return self._learner.update(batch)
        return self._actor.update.remote(batch)

    def get_weights(self):
        if self._learner is not None:
            return self._learner.get_weights()
        import ray_tpu_torch as rt

        return rt.get(self._actor.get_weights.remote(), timeout=300)

    def shutdown(self):
        if self._actor is not None:
            stop_actors([self._actor])
