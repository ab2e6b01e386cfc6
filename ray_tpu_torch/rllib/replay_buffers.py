"""Replay buffers.

Ref analogue: rllib/utils/replay_buffers/replay_buffer.py ReplayBuffer +
prioritized_episode_buffer / PrioritizedReplayBuffer (proportional
prioritization, Schaul et al. 2015). Column-oriented numpy ring storage —
sampling produces contiguous arrays ready for the learner's one copy to the
card, without a per-row gather of python objects. A copy of
``ray_tpu/rllib/replay_buffers.py`` (numpy; the port imports nothing of the
JAX package).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .sample_batch import SampleBatch


class ReplayBuffer:
    """Uniform FIFO ring buffer over SampleBatch columns."""

    def __init__(self, capacity: int = 100_000, seed: int = 0):
        self.capacity = int(capacity)
        self._cols: Dict[str, np.ndarray] = {}
        self._size = 0
        self._next = 0
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: SampleBatch) -> None:
        n = batch.count
        if not self._cols:
            for k, v in batch.items():
                v = np.asarray(v)
                self._cols[k] = np.zeros(
                    (self.capacity,) + v.shape[1:], dtype=v.dtype
                )
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._cols[k][idx] = np.asarray(v)
        self._on_add(idx)
        self._next = int((self._next + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)

    def _on_add(self, idx: np.ndarray) -> None:
        pass

    def sample(self, num_items: int) -> SampleBatch:
        idx = self._rng.randint(0, self._size, size=num_items)
        return self._take(idx)

    def _take(self, idx: np.ndarray) -> SampleBatch:
        out = SampleBatch({k: v[idx] for k, v in self._cols.items()})
        out["batch_indexes"] = idx
        return out


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (ref:
    utils/replay_buffers/prioritized_replay_buffer.py): P(i) ∝ p_i^alpha,
    importance weights w_i = (N · P(i))^-beta / max w."""

    def __init__(self, capacity: int = 100_000, *, alpha: float = 0.6,
                 beta: float = 0.4, seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self._priorities = np.zeros(capacity, dtype=np.float64)
        self._max_priority = 1.0

    def _on_add(self, idx: np.ndarray) -> None:
        # New transitions get max priority so each is sampled at least once.
        self._priorities[idx] = self._max_priority

    def sample(self, num_items: int) -> SampleBatch:
        p = self._priorities[:self._size] ** self.alpha
        probs = p / p.sum()
        idx = self._rng.choice(self._size, size=num_items, p=probs)
        batch = self._take(idx)
        weights = (self._size * probs[idx]) ** (-self.beta)
        batch["weights"] = (weights / weights.max()).astype(np.float32)
        return batch

    def update_priorities(self, idx: np.ndarray,
                          priorities: np.ndarray) -> None:
        priorities = np.abs(np.asarray(priorities, dtype=np.float64)) + 1e-6
        self._priorities[np.asarray(idx)] = priorities
        self._max_priority = max(self._max_priority, priorities.max())
