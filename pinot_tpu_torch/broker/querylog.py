"""Broker slow-query log (copy of ``pinot_tpu.broker.querylog``): a ring
of recent notable queries.

Every query updates the totals; a query is RECORDED when it is slow
(``timeUsedMs >= threshold``), failed (any exception) or degraded
(``partialResponse``).  The ring keeps the last N entries, each with the
latency breakdown, the requestId, the scatter counters, the freshness
and the merged cost vector.  ``annotate`` adds to a recorded entry
afterwards (the replica audit's verdict).

Env knobs:

- ``PINOT_TPU_SLOW_QUERY_MS``     slow threshold, default 500 ms
- ``PINOT_TPU_SLOW_QUERY_LOG_N``  ring capacity, default 128"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional


class SlowQueryLog:
    def __init__(
        self,
        capacity: Optional[int] = None,
        threshold_ms: Optional[float] = None,
    ) -> None:
        if capacity is None:
            capacity = int(os.environ.get("PINOT_TPU_SLOW_QUERY_LOG_N", "128"))
        if threshold_ms is None:
            threshold_ms = float(os.environ.get("PINOT_TPU_SLOW_QUERY_MS", "500"))
        self.capacity = max(1, capacity)
        self.threshold_ms = threshold_ms
        self._ring: Deque[Dict[str, Any]] = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.total_queries = 0
        self.total_recorded = 0

    def observe(self, entry: Dict[str, Any]) -> bool:
        """Count the query; record it into the ring when notable.
        Returns True when the entry was recorded."""
        notable = (
            entry.get("timeUsedMs", 0.0) >= self.threshold_ms
            or bool(entry.get("exceptions"))
            or bool(entry.get("partialResponse"))
        )
        with self._lock:
            self.total_queries += 1
            if notable:
                self.total_recorded += 1
                self._ring.append(dict(entry, ts=round(time.time(), 3)))
        return notable

    def annotate(self, request_id: str, **kv: Any) -> bool:
        """Post-hoc enrichment of a recorded entry (the audit plane's
        ``auditRef`` cross-link lands AFTER the query was logged — the
        audit runs asynchronously).  Returns True when the entry was
        still in the ring."""
        if not request_id:
            return False
        with self._lock:
            for entry in self._ring:
                if entry.get("requestId") == request_id:
                    entry.update(kv)
                    return True
        return False

    def entries(self) -> List[Dict[str, Any]]:
        """Newest first."""
        with self._lock:
            return list(reversed(self._ring))

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "thresholdMs": self.threshold_ms,
                "capacity": self.capacity,
                "totalQueries": self.total_queries,
                "totalRecorded": self.total_recorded,
                "entries": list(reversed(self._ring)),
            }
