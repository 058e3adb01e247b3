"""Retry policies (copy of ``pinot_tpu.utils.retry``, trimmed): a bounded
exponential backoff for fetches and a stateful full-jitter backoff for
the heartbeat and poll loops, so a fleet retrying the same dependency
does not hit it in lockstep."""
from __future__ import annotations

import random
import time
from typing import Callable, Optional, TypeVar

T = TypeVar("T")


class RetryError(Exception):
    pass


class ExponentialBackoffRetryPolicy:
    """``max_attempts`` tries with exponential backoff between them,
    optionally with FULL jitter (each delay uniform in [0, initial *
    factor**attempt]); ``seed`` makes the draw deterministic."""

    def __init__(
        self,
        max_attempts: int,
        initial_delay_s: float,
        factor: float = 2.0,
        jitter: bool = False,
        seed: Optional[int] = None,
    ) -> None:
        self.max_attempts = max_attempts
        self.initial = initial_delay_s
        self.factor = factor
        self._rng = random.Random(seed) if jitter else None

    def delay_s(self, attempt: int) -> float:
        cap = self.initial * (self.factor**attempt)
        return self._rng.uniform(0.0, cap) if self._rng is not None else cap

    def attempt(self, fn: Callable[[], T]) -> T:
        last: Optional[Exception] = None
        for i in range(self.max_attempts):
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 - the policy retries anything
                last = e
                if i + 1 < self.max_attempts:
                    time.sleep(self.delay_s(i))
        raise RetryError(f"failed after {self.max_attempts} attempts: {last}") from last


class FullJitterBackoff:
    """Full-jitter backoff for long-lived retry loops: ``next_delay()``
    grows the window exponentially up to ``cap_s`` and draws uniformly
    from [floor_s, window]; ``reset()`` on success re-arms the fast first
    retry; ``failures`` counts consecutive failures."""

    def __init__(
        self,
        initial_s: float = 0.25,
        cap_s: float = 5.0,
        factor: float = 2.0,
        floor_s: float = 0.05,
        seed: Optional[int] = None,
    ) -> None:
        self.initial = initial_s
        self.cap = cap_s
        self.factor = factor
        self.floor = floor_s
        self.failures = 0
        self._rng = random.Random(seed)

    def reset(self) -> None:
        self.failures = 0

    def tighten_cap(self, liveness_timeout_s: float) -> float:
        """Cap the delay at a third of a failure detector's window (never
        loosening it), so backoff cannot push the gap between heartbeats
        past it; returns that share."""
        share = float(liveness_timeout_s) / 3.0
        self.cap = min(self.cap, max(self.floor, share))
        return share

    def next_delay(self) -> float:
        window = min(self.cap, self.initial * (self.factor ** self.failures))
        self.failures += 1
        return self._rng.uniform(min(self.floor, window), window)


def tighten_liveness_budget(
    backoff: FullJitterBackoff, liveness_timeout_s: float, request_timeout_s: float,
    floor_s: float = 0.5,
) -> float:
    """Cap ``backoff`` at a third of the detector's window and return the
    per-request timeout clamped to the same share: the two shrink
    together, or one blackholed request alone outlasts the window."""
    share = backoff.tighten_cap(float(liveness_timeout_s))
    return min(request_timeout_s, max(floor_s, share))
