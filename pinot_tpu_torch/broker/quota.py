"""Per-table query rate limiting (copy of ``pinot_tpu.broker.quota``):
QuotaConfig.maxQueriesPerSecond enforcement — the quota lives in the
table config (``common/config/QuotaConfig``) and brokers enforce it.

The rest of the reference's admission front door (``broker/admission.py``:
per-table in-flight caps, AIMD server windows) is ROADMAP queue 1 item
28."""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional


class _TokenBucket:
    """Token bucket with FRACTIONAL refill and configurable burst.

    ``qps`` may be < 1.0 (e.g. 0.5 = one query per two seconds), and an
    acquire always costs a whole token:

    - capacity = ``burst`` if given, else max(qps, 1.0) — a steady
      sub-1-QPS client is admitted every 1/qps seconds, and an explicit
      burst lets a bursty client spend saved-up headroom;
    - ``reconfigure`` updates qps/burst IN PLACE, preserving spent
      tokens (clamped to the new capacity) — a cluster-state re-notify
      must not refill a flooding table's bucket.
    """

    @staticmethod
    def _capacity(qps: float, burst: Optional[float]) -> float:
        # capacity floor of 1.0: acquiring costs a whole token, so a
        # sub-1 burst (misconfigured) would otherwise block EVERY query
        if burst and burst > 0:
            return max(float(burst), 1.0)
        return max(qps, 1.0)

    def __init__(self, qps: float, burst: Optional[float] = None) -> None:
        self.qps = float(qps)
        self.burst = burst
        self.capacity = self._capacity(qps, burst)
        self.tokens = self.capacity
        self.last = time.monotonic()
        self._lock = threading.Lock()

    def reconfigure(self, qps: float, burst: Optional[float] = None) -> None:
        """Apply a quota UPDATE without resetting spent tokens."""
        with self._lock:
            self._refill()
            self.qps = float(qps)
            self.burst = burst
            self.capacity = self._capacity(qps, burst)
            self.tokens = min(self.tokens, self.capacity)

    def _refill(self) -> None:
        # caller holds self._lock
        now = time.monotonic()
        self.tokens = min(self.capacity, self.tokens + (now - self.last) * self.qps)
        self.last = now

    def try_acquire(self) -> bool:
        with self._lock:
            self._refill()
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return True
            return False

    def headroom(self) -> float:
        """Fraction of the bucket currently unspent (peek, no acquire)."""
        with self._lock:
            self._refill()
            return self.tokens / self.capacity


class QueryQuotaManager:
    def __init__(self) -> None:
        self._buckets: Dict[str, _TokenBucket] = {}
        self._lock = threading.Lock()

    def set_quota(
        self, table: str, qps: Optional[float], burst: Optional[float] = None
    ) -> None:
        """Install/update/remove a table's QPS quota.  An UPDATE of an
        existing bucket reconfigures it in place (tokens preserved) so
        the periodic cluster-state re-notify cannot act as a refill;
        ``qps`` None/<=0 removes the bucket entirely."""
        with self._lock:
            if qps and qps > 0:
                bucket = self._buckets.get(table)
                if bucket is None:
                    self._buckets[table] = _TokenBucket(qps, burst)
                elif bucket.qps != qps or bucket.burst != burst:
                    bucket.reconfigure(qps, burst)
            else:
                self._buckets.pop(table, None)

    def tables(self) -> list:
        """Tables that currently carry a quota (propagation bookkeeping:
        the networked broker clears buckets for tables whose quota left
        the cluster-state snapshot)."""
        with self._lock:
            return list(self._buckets)

    def allow(self, table: str) -> bool:
        with self._lock:
            bucket = self._buckets.get(table)
        return bucket.try_acquire() if bucket is not None else True

    def headroom(self, table: str) -> float:
        """Fraction of the table's rate budget currently unused (1.0 when
        unlimited).  Hedged requests amplify server load, so the broker
        only hedges while the table has quota headroom — a table already
        brushing its QPS cap must not double its own traffic."""
        with self._lock:
            bucket = self._buckets.get(table)
        return bucket.headroom() if bucket is not None else 1.0
