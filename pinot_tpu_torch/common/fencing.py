"""Fencing primitives: the controller epoch and the serving lease (copy
of ``pinot_tpu.common.fencing``, trimmed).

- The controller's epoch is its incarnation number; every lease and
  cluster-state snapshot carries it, and a write under an older epoch is
  a ``StaleEpochError``.
- A heartbeat reply carries a lease ``{epoch, durationS}``.  A server
  that cannot renew it within the window loses write authority (new
  consuming roles, commits) while its read path stays up.  A server that
  was never granted a lease holds implicit authority.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

DEFAULT_LEASE_S = 10.0


def default_lease_s() -> float:
    """Lease duration granted on each heartbeat, in seconds."""
    return DEFAULT_LEASE_S


class StaleEpochError(Exception):
    """A write carried an epoch older than the cluster's current one."""

    def __init__(self, message: str, stale: Any = None, current: Any = None) -> None:
        super().__init__(message)
        self.stale = stale
        self.current = current


def epoch_int(value: Any) -> int:
    """An epoch from its wire forms (int, numeric string); -1, always
    stale, for anything else."""
    try:
        return int(value)
    except (TypeError, ValueError):
        return -1


class ServingLease:
    """The server's view of its controller-granted serving lease:
    unleased (never granted: ``held()`` is True), held, or expired."""

    def __init__(self, clock=None, metrics=None) -> None:
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._granted = False
        self._expires_at = 0.0
        self._epoch = -1
        self.metrics = metrics
        if metrics is not None:
            metrics.meter("lease.renewals")
            metrics.gauge("lease.held").set_fn(lambda: 1 if self.held() else 0)

    def renew(self, lease: Optional[Dict[str, Any]]) -> None:
        """Apply a reply's ``lease`` block; None (no grant) is ignored."""
        if not lease:
            return
        duration = float(lease.get("durationS") or default_lease_s())
        with self._lock:
            self._granted = True
            self._epoch = epoch_int(lease.get("epoch"))
            self._expires_at = self._clock() + duration
        if self.metrics is not None:
            self.metrics.meter("lease.renewals").mark()

    def held(self) -> bool:
        with self._lock:
            return not self._granted or self._clock() < self._expires_at

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    @property
    def granted(self) -> bool:
        with self._lock:
            return self._granted

    def snapshot(self) -> Dict[str, Any]:
        held = self.held()
        with self._lock:
            return {
                "granted": self._granted,
                "held": held,
                "epoch": self._epoch,
                "remainingS": None if not self._granted
                else round(max(0.0, self._expires_at - self._clock()), 3),
            }
