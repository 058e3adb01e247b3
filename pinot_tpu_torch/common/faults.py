"""Device-fault injection for deterministic chaos tests (trimmed copy of
``pinot_tpu.common.faults.DeviceFaultInjector``; the transport and
network injectors are left out).

``DeviceFaultInjector`` hooks a server's ``DeviceLane``
(``engine/dispatch.py``) and injects device-side faults before a launch:
failed launches (retryable or poison), allocation failures, sticky CUDA
faults, stalls that wedge the lane thread (the watchdog trigger), and
per-plan-digest poisoning.  The self-healing path (device retry,
watchdog restart, host failover, poison quarantine) then runs the same
way on the CPU as on the card.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, List, Optional

import torch


@dataclass
class LaunchRecord:
    """One lane launch as seen by the injector (digest is the StaticPlan
    digest the executor handed the lane; None for raw key-only
    submits)."""

    digest: Optional[str]
    # "ok" | "fail_next" | "alloc_fail" | "sticky" | "poison" | "stall"
    outcome: str


class DeviceFaultInjector:
    """Device-fault programming for the DeviceLane.

    - ``fail_next(n, retryable=True)`` — the next ``n`` launches raise a
      typed ``DeviceExecutionError`` (transient blip or hard fault).
    - ``alloc_fail_next(n)`` — the next ``n`` launches raise a RAW
      ``torch.cuda.OutOfMemoryError`` (what the caching allocator raises
      on the card), so the executor's real ``classify_device_error``
      path gives ``resource_exhausted``.
    - ``sticky_fail_next(n)`` — the next ``n`` launches raise a RAW
      RuntimeError in CUDA's illegal-memory-access wording: the
      ``sticky`` class, which takes the lane off the device for good.
    - ``stall_next(n, stall_s)`` — the next ``n`` launches sleep
      ``stall_s`` inside the lane thread before proceeding (the
      watchdog-restart trigger when ``stall_s`` exceeds the lane's stall
      timeout).
    - ``poison_plan(digest)`` — every launch whose StaticPlan digest
      matches raises a non-retryable poison error until ``heal()``.

    Every launch decision is recorded in ``launches``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.launches: List[LaunchRecord] = []
        self._fail_next = 0
        self._fail_retryable = True
        self._alloc_fail_next = 0
        self._sticky_next = 0
        self._stall_next = 0
        self._stall_s = 0.0
        self._poisoned: set = set()

    # -- fault programming --------------------------------------------
    def fail_next(self, n: int, retryable: bool = True) -> None:
        with self._lock:
            self._fail_next = n
            self._fail_retryable = retryable

    def alloc_fail_next(self, n: int) -> None:
        with self._lock:
            self._alloc_fail_next = n

    def sticky_fail_next(self, n: int) -> None:
        with self._lock:
            self._sticky_next = n

    def stall_next(self, n: int, stall_s: float) -> None:
        with self._lock:
            self._stall_next = n
            self._stall_s = stall_s

    def poison_plan(self, digest: str) -> None:
        with self._lock:
            self._poisoned.add(digest)

    def heal(self) -> None:
        with self._lock:
            self._fail_next = 0
            self._alloc_fail_next = 0
            self._sticky_next = 0
            self._stall_next = 0
            self._stall_s = 0.0
            self._poisoned.clear()

    # -- lane hook -----------------------------------------------------
    def on_launch(self, digest: Optional[str], key: Any) -> None:
        """Called by the lane thread immediately before a launch; may
        sleep (stall) or raise."""
        from pinot_tpu_torch.engine.dispatch import DeviceExecutionError

        with self._lock:
            if digest is not None and digest in self._poisoned:
                self.launches.append(LaunchRecord(digest, "poison"))
                raise DeviceExecutionError(
                    f"injected: poisoned plan {digest}", retryable=False
                )
            if self._alloc_fail_next > 0:
                self._alloc_fail_next -= 1
                self.launches.append(LaunchRecord(digest, "alloc_fail"))
                # a RAW error: the executor must exercise its real
                # classification path (classify_device_error)
                raise torch.cuda.OutOfMemoryError(
                    "injected: CUDA out of memory. Tried to allocate 2.00 GiB"
                )
            if self._sticky_next > 0:
                self._sticky_next -= 1
                self.launches.append(LaunchRecord(digest, "sticky"))
                raise RuntimeError(
                    "injected: CUDA error: an illegal memory access was encountered"
                )
            if self._fail_next > 0:
                self._fail_next -= 1
                retryable = self._fail_retryable
                self.launches.append(LaunchRecord(digest, "fail_next"))
                raise DeviceExecutionError(
                    "injected: device launch failure", retryable=retryable
                )
            stall = 0.0
            if self._stall_next > 0:
                self._stall_next -= 1
                stall = self._stall_s
                self.launches.append(LaunchRecord(digest, "stall"))
            else:
                self.launches.append(LaunchRecord(digest, "ok"))
        if stall > 0.0:
            # sleep OUTSIDE the injector lock, inside the lane thread:
            # this is the wedge the watchdog must detect
            time.sleep(stall)
