"""IMPALA: asynchronous actor-critic with V-trace off-policy correction
(counterpart of ``ray_tpu/rllib/impala.py``).

Ref analogue: rllib/algorithms/impala/ (Espeholt et al. 2018). Runners
sample CONTINUOUSLY — the learner consumes whatever fragments are ready
each step instead of barriering on every runner — so rollouts lag the
learner's weights by a step or two; the learner takes one time-major
fragment at a time and corrects that lag with V-trace's truncated
importance weights.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..train.optim import AdamW
from .algorithm import Algorithm, AlgorithmConfig
from .core import (
    ActorCriticModule,
    to_device,
    to_floats,
    tree_to_device,
    tree_to_numpy,
    value_and_grad,
)
from .ppo import action_logp, entropy
from .sample_batch import (
    ACTIONS,
    BOOTSTRAP_OBS,
    DONES,
    LOGPS,
    OBS,
    REWARDS,
    SampleBatch,
)


class IMPALAConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 6e-4
        self.vf_loss_coeff: float = 0.5
        self.entropy_coeff: float = 0.01
        self.rho_clip: float = 1.0  # V-trace rho-bar
        self.c_clip: float = 1.0    # V-trace c-bar
        # Max fragments consumed per training_step (bounds staleness).
        self.max_batches_per_step: int = 4

    def build(self, device: DeviceLike = None) -> "IMPALA":
        return IMPALA(self.copy(), device)


@torch.no_grad()
def vtrace(behav_logp, target_logp, rewards, dones, values, bootstrap, *,
           gamma: float, rho_clip: float, c_clip: float):
    """V-trace targets over one time-major fragment (Espeholt eq. 1):
    vs = V(x_s) + sum_t gamma^(t-s) * prod(c) * dt_V. Returns (vs, pg_adv),
    both constants for the gradient. JAX's reverse ``lax.scan`` is a loop
    over the T steps here: one multiply-add a step on the device."""
    rho = torch.exp(target_logp - behav_logp)
    rho_bar = torch.clamp(rho, max=rho_clip)
    c_bar = torch.clamp(rho, max=c_clip)
    discounts = gamma * (1.0 - dones)
    values_next = torch.cat([values[1:], bootstrap[None]])
    deltas = rho_bar * (rewards + discounts * values_next - values)
    dc = discounts * c_bar
    acc = torch.zeros_like(bootstrap)
    advs = [None] * len(deltas)
    for t in reversed(range(len(deltas))):
        acc = torch.addcmul(deltas[t], dc[t], acc)
        advs[t] = acc
    vs = values + torch.stack(advs)
    vs_next = torch.cat([vs[1:], bootstrap[None]])
    pg_adv = rho_bar * (rewards + discounts * vs_next - values)
    return vs, pg_adv


class IMPALALearner:
    """V-trace actor-critic learner on the card."""

    def __init__(self, policy, lr: float, gamma: float, rho_clip: float,
                 c_clip: float, vf_coeff: float, ent_coeff: float,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._params = tree_to_device(policy.get_weights(), self.device)
        self._opt = AdamW(lr, weight_decay=0.0)  # optax.adam(lr)
        self._opt_state = self._opt.init(self._params)
        self._gamma = gamma
        self._rho_clip = rho_clip
        self._c_clip = c_clip
        self._vf_coeff = vf_coeff
        self._ent_coeff = ent_coeff

    def _loss(self, params, obs, actions, behav_logp, rewards, dones,
              boot_obs):
        # The fragment's T observations plus the one AFTER the last
        # transition in a single forward: the bootstrap must be
        # V(s_{T+1}), not V(s_T) (masked by (1-done) inside vtrace).
        all_obs = torch.cat([obs, boot_obs[None]], dim=0)
        logits_all, values_all = ActorCriticModule.forward(params, all_obs)
        logits, values = logits_all[:-1], values_all[:-1]
        logp_all, target_logp = action_logp(logits, actions)
        vs, pg_adv = vtrace(
            behav_logp, target_logp.detach(), rewards, dones,
            values.detach(), values_all[-1].detach(), gamma=self._gamma,
            rho_clip=self._rho_clip, c_clip=self._c_clip)
        pg_loss = -(target_logp * pg_adv).mean()
        vf_loss = ((values - vs) ** 2).mean()
        ent = entropy(logp_all)
        total = pg_loss + self._vf_coeff * vf_loss - self._ent_coeff * ent
        return total, {"pg_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": ent}

    def update(self, batch: SampleBatch) -> Dict[str, float]:
        """One step on one time-major fragment."""
        dev = self.device
        obs = to_device(batch[OBS], dev)
        # Fragments from older runners may lack the bootstrap column; fall
        # back to the (biased) last-obs bootstrap rather than crash.
        boot = batch.get(BOOTSTRAP_OBS)
        boot = obs[-1] if boot is None else to_device(boot, dev)
        (loss, stats), grads = value_and_grad(
            self._loss, self._params, obs,
            to_device(np.asarray(batch[ACTIONS], np.int32), dev),
            to_device(batch[LOGPS], dev), to_device(batch[REWARDS], dev),
            to_device(np.asarray(batch[DONES], np.float32), dev), boot)
        self._opt.update(self._params, grads, self._opt_state)
        return to_floats({**stats, "total_loss": loss})

    def get_weights(self):
        return tree_to_numpy(self._params)


class IMPALA(Algorithm):
    def _build_learner(self, policy):
        c = self.config
        learner = IMPALALearner(
            policy, c.lr, c.gamma, c.rho_clip, c.c_clip,
            c.vf_loss_coeff, c.entropy_coeff, device=self.device,
        )
        # Continuous sampling: every runner always has a fragment in
        # flight; training_step consumes whatever finished.
        self._pending = [(r, r.sample.remote()) for r in self.runners]
        return learner

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch as rt

        c = self.config
        refs = [ref for _, ref in self._pending]
        ready, _ = rt.wait(refs, num_returns=1, timeout=30.0)
        ready_ids = {r.id() for r in ready}
        stats: Dict[str, float] = {}
        consumed = 0
        still = []
        for runner, ref in self._pending:
            if ref.id() in ready_ids and consumed < c.max_batches_per_step:
                batch = rt.get(ref)
                stats = self.learner.update(batch)
                consumed += 1
                # Ship fresh weights, resubmit the runner immediately:
                # the lag between these two is what V-trace corrects.
                runner.set_weights.remote(self.learner.get_weights())
                still.append((runner, runner.sample.remote()))
            else:
                still.append((runner, ref))
        self._pending = still
        return {
            **self.episode_stats(),
            "num_batches_consumed": consumed,
            **stats,
        }

    def stop(self):
        self._pending = []
        super().stop()
