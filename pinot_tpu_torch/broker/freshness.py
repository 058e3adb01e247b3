"""Event-time freshness (copy of ``pinot_tpu.broker.freshness``).

``ingest.lag.*`` measures how far a consumer trails its stream in
offsets, which says nothing of how stale the data is.  This module
tracks **event time**: realtime consumers advance a per-(table,
partition) watermark to the maximum of the schema time column they have
indexed (in epoch milliseconds, through the time field's unit), and the
serving path derives every freshness surface from those watermarks:

- servers stamp ``IntermediateResult.freshness = {"minEventMs": ...}``
  (the minimum over the served table's partitions), a trailing optional
  DataTable field;
- the broker merges the servers' stamps with MIN and answers
  ``freshnessMs = now - minEventMs`` on the BrokerResponse, in the
  slow-query log, in EXPLAIN ANALYZE and as ``freshness.*`` series;
- ``freshnessMs`` is the SLO tracker's third objective
  (``utils/slo.py``).

The registry is **process-global**: one consumer per (table, partition)
exists in a process in production, and in-process multi-server harnesses
share the stream, so replicas advancing one key converge on one value.
Watermarks are keyed on (table, partition), not on the segment, so they
survive a segment's rollover and a consumer pool's resize.

Standard library only: servers and realtime consumers import it."""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional


def now_ms() -> float:
    return time.time() * 1000.0


class EventTimeWatermarks:
    """Max ingested event-time (epoch ms) per (table, partition).

    ``advance`` is monotone: late/duplicate batches (commit-retry
    replays, out-of-order event time inside the stream) can never move
    a watermark backwards — ``freshnessMs`` derived from it is then
    monotone-consistent with what was actually consumed.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # (table, partition) -> max event-time ms
        self._marks: Dict[tuple, float] = {}

    def advance(self, table: str, partition: int, event_ms: float) -> None:
        if event_ms is None:
            return
        key = (str(table), int(partition))
        with self._lock:
            cur = self._marks.get(key)
            if cur is None or event_ms > cur:
                self._marks[key] = float(event_ms)

    def get(self, table: str, partition: int) -> Optional[float]:
        return self._marks.get((str(table), int(partition)))

    def table_min_ms(self, table: str) -> Optional[float]:
        """The serving stamp: min over the table's partition watermarks
        (an answer is only as fresh as its stalest partition), or None
        when no partition of ``table`` has consumed anything yet."""
        table = str(table)
        with self._lock:
            vals = [v for (t, _p), v in self._marks.items() if t == table]
        return min(vals) if vals else None

    def tables(self) -> List[str]:
        with self._lock:
            return sorted({t for t, _p in self._marks})

    def drop_table(self, table: str) -> None:
        """Table deletion hook (tests / controller cleanup)."""
        table = str(table)
        with self._lock:
            for key in [k for k in self._marks if k[0] == table]:
                self._marks.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._marks.clear()

    def snapshot(self) -> Dict[str, Any]:
        """``/debug/audit`` freshness section: per-table min/max
        watermarks and the implied lag right now."""
        now = now_ms()
        with self._lock:
            marks = dict(self._marks)
        per_table: Dict[str, Dict[str, Any]] = {}
        for (table, partition), v in sorted(marks.items()):
            t = per_table.setdefault(
                table, {"partitions": {}, "minEventMs": v, "maxEventMs": v}
            )
            t["partitions"][str(partition)] = v
            t["minEventMs"] = min(t["minEventMs"], v)
            t["maxEventMs"] = max(t["maxEventMs"], v)
        for t in per_table.values():
            t["lagMs"] = round(max(0.0, now - t["minEventMs"]), 3)
        return {"tables": per_table}


# THE process-wide registry (see module docstring for why global).
WATERMARKS = EventTimeWatermarks()


def batch_max_event_ms(values, unit_ms: float) -> Optional[float]:
    """Max event time of one indexed batch, in epoch ms.

    ``values`` is whatever the consumer has for the time column — a
    numpy array (columnar path) or an iterable of row values.  Strings
    and empty batches yield None (no watermark movement: an unparseable
    time column must not fabricate freshness).
    """
    if values is None:
        return None
    try:
        import numpy as np

        arr = np.asarray(values)
        if arr.size == 0 or arr.dtype.kind not in "iuf":
            return None
        return float(arr.max()) * float(unit_ms)
    except (TypeError, ValueError):
        return None


def worst_freshness_tables(
    snapshot: Dict[str, Any], top: int = 5
) -> List[Dict[str, Any]]:
    """Doctor/postmortem helper: the ``top`` stalest tables out of an
    ``EventTimeWatermarks.snapshot()`` payload, worst first."""
    tables = (snapshot or {}).get("tables") or {}
    ranked = sorted(
        (
            {"table": name, "lagMs": info.get("lagMs", 0.0)}
            for name, info in tables.items()
        ),
        key=lambda e: -e["lagMs"],
    )
    return ranked[: max(0, top)]
