"""Ingest consumer pool: bounded worker threads driving the per-partition
realtime consumers (port of ``pinot_tpu.realtime.pool``).

The LLC analog of the reference's shared realtime consumer executor:
consumers register a cooperative ``step()`` (one bounded unit of fetch,
index and completion-protocol work that never blocks on a wait) and
``PINOT_TPU_INGEST_CONSUMERS`` worker threads (default 4) drive the
ready consumer with the earliest eligible time.  ``step()`` returns:

- ``0.0``: it made progress and is eligible again at once;
- ``t > 0``: idle or held (a backpressure pause, an empty stream, a
  completion HOLD, an unreachable controller): eligible again in ``t``
  seconds.  The pool sleeps on a condition variable meanwhile;
- ``None``: finished (committed, discarded or stopped): deregistered.

Each consumer checks the server's backpressure governor in its own step,
so one held partition never blocks the others sharing its worker; a
consumer raising out of ``step()`` is parked with a backoff rather than
killing the worker.  No step touches CUDA: ingest is host numpy, and
only a query stages a consuming segment's snapshot.
"""
from __future__ import annotations

import logging
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

# error backoff for a consumer whose step() raised: long enough not to
# spin a broken consumer, short enough that a transient (stream hiccup
# racing a commit) self-heals quickly
_ERROR_PARK_S = 1.0


def default_pool_workers() -> int:
    """``PINOT_TPU_INGEST_CONSUMERS``: worker threads per pool (per
    server process).  More workers = more partitions consuming truly
    concurrently, up to the host's cores."""
    try:
        return max(1, int(os.environ.get("PINOT_TPU_INGEST_CONSUMERS", "4")))
    except ValueError:
        return 4


# every pool registers here, so a test can assert that a stopped pool's
# workers exited (``leaked_pool_threads``)
_all_pools: "weakref.WeakSet[IngestConsumerPool]" = weakref.WeakSet()


def leaked_pool_threads(grace_s: float = 2.0) -> List[threading.Thread]:
    """Worker threads still alive on stopped pools (running pools are
    exempt: they are still ingesting)."""
    suspects = [t for pool in list(_all_pools) if pool._stop.is_set() for t in pool._threads if t.is_alive()]
    deadline = time.monotonic() + grace_s
    leaked = []
    for t in suspects:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
        if t.is_alive():
            leaked.append(t)
    return leaked


class _Entry:
    __slots__ = ("consumer", "eligible_at", "running")

    def __init__(self, consumer: Any, eligible_at: float) -> None:
        self.consumer = consumer
        self.eligible_at = eligible_at
        self.running = False


class IngestConsumerPool:
    """Bounded worker threads multiplexing cooperative consumers."""

    def __init__(self, workers: Optional[int] = None, metrics=None, name: str = "ingest") -> None:
        self.workers = workers if workers is not None else default_pool_workers()
        self.metrics = metrics
        self.name = name
        self._cv = threading.Condition()
        self._entries: Dict[Any, _Entry] = {}  # key -> entry
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.steps = 0
        self.errors = 0
        if metrics is not None:
            metrics.meter("ingest.pool.steps")
            metrics.meter("ingest.pool.errors")
            metrics.gauge("ingest.pool.workers").set_fn(lambda: self.workers)
            metrics.gauge("ingest.pool.consumers").set_fn(lambda: len(self._entries))
        _all_pools.add(self)

    # -- registration --------------------------------------------------
    def add(self, consumer: Any, key: Optional[Any] = None) -> None:
        """Register a consumer (``key`` defaults to the consumer object).
        Idempotent per key: a redelivered CONSUMING transition must not
        drive one consumer twice."""
        key = consumer if key is None else key
        with self._cv:
            if self._stop.is_set():
                raise RuntimeError("pool is stopped")
            if key in self._entries:
                return
            self._entries[key] = _Entry(consumer, time.monotonic())
            while len(self._threads) < self.workers:
                t = threading.Thread(target=self._worker, name=f"{self.name}-pool-{len(self._threads)}",
                                     daemon=True)
                self._threads.append(t)
                t.start()
            self._cv.notify_all()

    def remove(self, key: Any) -> None:
        with self._cv:
            self._entries.pop(key, None)

    def kick(self) -> None:
        """Make every consumer eligible now (the controller is reachable
        again) instead of sleeping out its current delay."""
        now = time.monotonic()
        with self._cv:
            for e in self._entries.values():
                e.eligible_at = min(e.eligible_at, now)
            self._cv.notify_all()

    def stop(self) -> None:
        with self._cv:
            self._stop.set()
            self._entries.clear()
            self._cv.notify_all()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=2)

    # -- the worker loop ----------------------------------------------
    def _claim_locked(self, now: float):
        """The not-running entry with the earliest eligible time, or
        (None, None, soonest wakeup) when nothing is ready."""
        best_key = None
        best = None
        soonest: Optional[float] = None
        for key, e in self._entries.items():
            if e.running:
                continue
            if e.eligible_at <= now:
                if best is None or e.eligible_at < best.eligible_at:
                    best_key, best = key, e
            elif soonest is None or e.eligible_at < soonest:
                soonest = e.eligible_at
        return best_key, best, soonest

    def _worker(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self._stop.is_set():
                        return
                    now = time.monotonic()
                    key, entry, soonest = self._claim_locked(now)
                    if entry is not None:
                        entry.running = True
                        break
                    timeout = None if soonest is None else max(0.0, soonest - now)
                    self._cv.wait(timeout=timeout if timeout != 0 else 0.01)
            delay: Optional[float]
            try:
                delay = entry.consumer.step()
            except Exception:
                logger.exception("consumer step failed in pool %s; parking %.1fs", self.name, _ERROR_PARK_S)
                self.errors += 1
                if self.metrics is not None:
                    self.metrics.meter("ingest.pool.errors").mark()
                delay = _ERROR_PARK_S
            self.steps += 1
            if self.metrics is not None:
                self.metrics.meter("ingest.pool.steps").mark()
            with self._cv:
                if delay is None:
                    self._entries.pop(key, None)
                elif self._entries.get(key) is entry:
                    entry.eligible_at = time.monotonic() + delay
                    entry.running = False
                self._cv.notify_all()

    # -- observability -------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._cv:
            return {
                "workers": self.workers,
                "consumers": len(self._entries),
                "steps": self.steps,
                "errors": self.errors,
                "running": sum(1 for e in self._entries.values() if e.running),
            }
