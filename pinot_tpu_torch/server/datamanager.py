"""Server-side data managers: instance -> table -> segment hierarchy with
refcounted acquire/release.

Mirrors the reference hierarchy (``InstanceDataManager.java:29``,
``AbstractTableDataManager.java:42``, ``SegmentDataManager``): queries
acquire segments (refcount++) before executing and release after, so a
segment swap/drop never unmaps data under a running query.  Dropping a
segment marks it dead; actual removal happens when the last reader
releases.

(Copy of ``pinot_tpu.server.datamanager``.)
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.segment.invindex import release_postings


class SegmentDataManager:
    def __init__(self, segment) -> None:
        # ImmutableSegment, or a MutableSegment (consuming) whose
        # .snapshot() yields the queryable view at the row watermark
        self.segment = segment
        self._refcount = 1  # owner reference
        self._lock = threading.Lock()

    @property
    def name(self) -> str:
        return self.segment.segment_name

    def query_view(self) -> ImmutableSegment:
        snap = getattr(self.segment, "snapshot", None)
        return snap() if callable(snap) else self.segment

    def acquire(self) -> bool:
        with self._lock:
            if self._refcount <= 0:
                return False
            self._refcount += 1
            return True

    def release(self) -> int:
        with self._lock:
            self._refcount -= 1
            rc = self._refcount
        if rc == 0:
            # the last reference is gone: its postings bytes go back to the
            # process-wide inverted-index budget
            release_postings(self.segment)
        return rc


class TableDataManager:
    """Per-table segment registry (AbstractTableDataManager analog)."""

    def __init__(self, table_name: str) -> None:
        self.table_name = table_name
        self._segments: Dict[str, SegmentDataManager] = {}
        self._lock = threading.Lock()

    def add_segment(self, segment) -> None:
        # integrity note: the disk-load CRC gate lives one layer up in
        # ServerInstance.add_segment(verify_crc=True) — it must run
        # BEFORE default-column injection, which this layer can't order
        name = segment.segment_name if hasattr(segment, "segment_name") else segment.metadata.segment_name
        with self._lock:
            old = self._segments.get(name)
            self._segments[name] = SegmentDataManager(segment)
        if old is not None:
            old.release()  # drop owner ref of the replaced segment

    def remove_segment(self, name: str) -> None:
        with self._lock:
            sdm = self._segments.pop(name, None)
        if sdm is not None:
            sdm.release()

    def segment_names(self) -> List[str]:
        with self._lock:
            return list(self._segments.keys())

    def acquire_segments(
        self, names: Optional[Sequence[str]] = None
    ) -> List[SegmentDataManager]:
        """Acquire the named segments (all if None); missing names are
        skipped — the reference reports them as partial results."""
        with self._lock:
            targets = (
                [self._segments[n] for n in names if n in self._segments]
                if names is not None
                else list(self._segments.values())
            )
        return [s for s in targets if s.acquire()]

    def release_segments(self, acquired: Sequence[SegmentDataManager]) -> None:
        for s in acquired:
            s.release()


class InstanceDataManager:
    def __init__(self) -> None:
        self._tables: Dict[str, TableDataManager] = {}
        self._lock = threading.Lock()

    def table(self, name: str, create: bool = False) -> Optional[TableDataManager]:
        with self._lock:
            tdm = self._tables.get(name)
            if tdm is None and create:
                tdm = TableDataManager(name)
                self._tables[name] = tdm
            return tdm

    def add_segment(self, table_name: str, segment: ImmutableSegment) -> None:
        self.table(table_name, create=True).add_segment(segment)

    def table_names(self) -> List[str]:
        with self._lock:
            return list(self._tables.keys())
