"""Shared jittered-exponential backoff with an optional deadline (a copy
of ``ray_tpu/util/backoff.py``; the port's serve retries and circuit
breakers use it).

Ref analogue: the reference's ``ExponentialBackoff``
(src/ray/util/exponential_backoff.h) behind GCS reconnect, pull retry
and lease retry — one policy object instead of the ad-hoc fixed sleeps
that used to live in client reconnect, peer redial, object-transfer
admission and direct-plane endpoint re-resolution."""

from __future__ import annotations

import asyncio
import random
import time
from typing import Optional


class Backoff:
    """Exponential backoff: ``base * factor**attempt`` capped at
    ``max_delay``, multiplied by ``1 ± jitter`` (seeded — deterministic
    under test). ``deadline_s`` bounds the whole retry budget; once
    past it :meth:`sleep`/:meth:`async_sleep` return ``False`` without
    sleeping and the caller gives up."""

    def __init__(self, *, base: float = 0.1, factor: float = 2.0,
                 max_delay: float = 5.0, jitter: float = 0.25,
                 deadline_s: Optional[float] = None,
                 seed: Optional[int] = None):
        self._base = max(0.0, base)
        self._factor = max(1.0, factor)
        self._max = max(self._base, max_delay)
        self._jitter = min(1.0, max(0.0, jitter))
        self._rng = random.Random(seed)
        self._attempt = 0
        self._deadline = (
            None if deadline_s is None else time.monotonic() + deadline_s
        )

    @property
    def attempt(self) -> int:
        return self._attempt

    @property
    def expired(self) -> bool:
        return (self._deadline is not None
                and time.monotonic() >= self._deadline)

    def remaining(self) -> Optional[float]:
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    def reset(self) -> None:
        """Back to the base delay (a success happened); the deadline, if
        any, keeps running — it bounds the whole operation."""
        self._attempt = 0

    def next_delay(self) -> float:
        """The next delay (advances the attempt counter). Clamped to the
        remaining deadline so a capped sleep never overshoots it."""
        raw = min(self._max, self._base * (self._factor ** self._attempt))
        self._attempt += 1
        if self._jitter:
            raw *= 1.0 + self._jitter * (2.0 * self._rng.random() - 1.0)
        remaining = self.remaining()
        if remaining is not None:
            raw = min(raw, remaining)
        return max(0.0, raw)

    def sleep(self) -> bool:
        """Thread idiom: sleep the next delay; ``False`` = deadline hit
        (nothing slept), the caller should stop retrying."""
        if self.expired:
            return False
        time.sleep(self.next_delay())
        return True

    async def async_sleep(self) -> bool:
        """Event-loop idiom of :meth:`sleep`."""
        if self.expired:
            return False
        await asyncio.sleep(self.next_delay())
        return True
