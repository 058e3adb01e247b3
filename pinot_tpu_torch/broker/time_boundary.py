"""Time boundary service for hybrid tables.

Reference: ``HelixExternalViewBasedTimeBoundaryService.java:36`` — for a
hybrid table the boundary is the max end-time over the OFFLINE table's
segments; the broker rewrites the offline sub-query to ``time <=
boundary`` and the realtime one to ``time > boundary`` so rows are
counted exactly once across the two sides.

(Copy of ``pinot_tpu.broker.time_boundary``.)
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional, Tuple

from pinot_tpu_torch.segment.immutable import SegmentMetadata


def compute_boundary(
    segment_metas: Iterable[SegmentMetadata],
) -> Optional[Tuple[str, int]]:
    """(time column, max end time) over the offline segments, or None —
    the single definition of the hybrid boundary rule, shared by the
    in-process listener path and the networked cluster-state snapshot."""
    col: Optional[str] = None
    max_end: Optional[int] = None
    for meta in segment_metas:
        if meta.time_column is None or meta.end_time is None:
            continue
        col = meta.time_column
        max_end = meta.end_time if max_end is None else max(max_end, meta.end_time)
    if col is None or max_end is None:
        return None
    return (col, max_end)


class TimeBoundaryService:
    def __init__(self) -> None:
        self._boundaries: Dict[str, Tuple[str, int]] = {}
        self._lock = threading.Lock()

    def update_from_segments(
        self, offline_table: str, segment_metas: Iterable[SegmentMetadata]
    ) -> None:
        boundary = compute_boundary(segment_metas)
        if boundary is not None:
            with self._lock:
                self._boundaries[offline_table] = boundary

    def set(self, offline_table: str, column: str, value: int) -> None:
        with self._lock:
            self._boundaries[offline_table] = (column, value)

    def get(self, offline_table: str) -> Optional[Tuple[str, int]]:
        with self._lock:
            return self._boundaries.get(offline_table)

    def remove(self, offline_table: str) -> None:
        with self._lock:
            self._boundaries.pop(offline_table, None)
