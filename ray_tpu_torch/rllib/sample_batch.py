"""SampleBatch: columnar rollout storage (a copy of
``ray_tpu/rllib/sample_batch.py``, which is numpy and needs no port; the
port keeps its own so that it imports nothing of the JAX package).

Ref analogue: rllib/policy/sample_batch.py SampleBatch — a dict of aligned
arrays with standard column names.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
NEXT_OBS = "next_obs"
# Observation AFTER the fragment's last transition (for value
# bootstrapping at fragment boundaries). Scalar row, not per-timestep.
BOOTSTRAP_OBS = "bootstrap_obs"
LOGPS = "action_logp"
VALUES = "values"
ADVANTAGES = "advantages"
RETURNS = "returns"

# Columns carrying ONE row per fragment rather than one per timestep.
_PER_FRAGMENT_KEYS = frozenset({BOOTSTRAP_OBS})


class SampleBatch(dict):
    @property
    def count(self) -> int:
        if OBS in self:
            return len(self[OBS])
        for v in self.values():
            return len(v)
        return 0

    def _aligned_keys(self) -> List[str]:
        # Per-fragment metadata (one row per fragment, not time-aligned)
        # only makes sense on an un-merged fragment and is dropped by
        # concat/shuffle/minibatches. Named explicitly — a length
        # heuristic would misfire whenever obs_dim == fragment length.
        return [k for k in self if k not in _PER_FRAGMENT_KEYS]

    @staticmethod
    def concat(batches: List["SampleBatch"]) -> "SampleBatch":
        keys = batches[0]._aligned_keys()
        return SampleBatch(
            {k: np.concatenate([np.asarray(b[k]) for b in batches]) for k in keys}
        )

    def shuffle(self, rng: np.random.RandomState) -> "SampleBatch":
        idx = rng.permutation(self.count)
        return SampleBatch(
            {k: np.asarray(self[k])[idx] for k in self._aligned_keys()}
        )

    def minibatches(self, size: int) -> Iterator["SampleBatch"]:
        n = self.count
        keys = self._aligned_keys()
        for start in range(0, n - size + 1, size):
            yield SampleBatch(
                {k: np.asarray(self[k])[start:start + size] for k in keys}
            )


def compute_gae(
    rewards: np.ndarray,
    values: np.ndarray,
    dones: np.ndarray,
    last_value: float,
    *,
    gamma: float,
    lam: float,
) -> Dict[str, np.ndarray]:
    """Generalized advantage estimation (ref analogue:
    rllib/evaluation/postprocessing.py compute_advantages)."""
    T = len(rewards)
    adv = np.zeros(T, dtype=np.float32)
    last_gae = 0.0
    for t in reversed(range(T)):
        next_v = last_value if t == T - 1 else values[t + 1]
        nonterminal = 1.0 - float(dones[t])
        delta = rewards[t] + gamma * next_v * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
    returns = adv + values
    return {ADVANTAGES: adv, RETURNS: returns.astype(np.float32)}
