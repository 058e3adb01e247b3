"""Immutable columnar segment — the host representation (copy of
``pinot_tpu.segment.immutable``, trimmed).

A segment is per-column metadata + a sorted dictionary + a forward index
of dictIds (``fwd`` int32 [num_docs] for single-value columns; CSR
``mv_values``/``mv_offsets`` for multi-value columns).  The device-resident, padded and stacked form
is produced by ``pinot_tpu_torch.engine.device``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from pinot_tpu_torch.common.schema import DataType, FieldType
from pinot_tpu_torch.segment.dictionary import Dictionary


@dataclass
class ColumnMetadata:
    """Per-column metadata (reference: ColumnMetadata / metadata.properties)."""

    name: str
    data_type: DataType
    field_type: FieldType
    single_value: bool
    cardinality: int
    total_docs: int
    is_sorted: bool
    has_inverted_index: bool = False
    max_num_multi_values: int = 0
    total_number_of_entries: int = 0  # = num_docs for SV, total MV values for MV
    min_value: Any = None
    max_value: Any = None


@dataclass
class SegmentMetadata:
    """Segment-level metadata (reference: SegmentMetadataImpl)."""

    segment_name: str
    table_name: str
    num_docs: int
    columns: Dict[str, ColumnMetadata] = field(default_factory=dict)
    time_column: Optional[str] = None
    time_unit: str = "DAYS"
    start_time: Optional[int] = None
    end_time: Optional[int] = None
    crc: int = 0


@dataclass
class ColumnData:
    """One column's index data inside an immutable segment."""

    metadata: ColumnMetadata
    dictionary: Dictionary
    fwd: Optional[np.ndarray] = None  # int32 [num_docs] (SV)
    mv_values: Optional[np.ndarray] = None  # int32 [total_values] (MV)
    mv_offsets: Optional[np.ndarray] = None  # int32 [num_docs + 1] (MV)

    @property
    def is_single_value(self) -> bool:
        return self.metadata.single_value

    def dict_ids_for_doc(self, doc_id: int) -> np.ndarray:
        if self.is_single_value:
            return self.fwd[doc_id : doc_id + 1]
        lo, hi = self.mv_offsets[doc_id], self.mv_offsets[doc_id + 1]
        return self.mv_values[lo:hi]

    def values_for_doc(self, doc_id: int):
        ids = self.dict_ids_for_doc(doc_id)
        vals = [self.dictionary.get(int(i)) for i in ids]
        return vals[0] if self.is_single_value else vals


_staging_tokens = itertools.count()


@dataclass
class ImmutableSegment:
    """A sealed columnar segment: metadata + per-column index data."""

    metadata: SegmentMetadata
    columns: Dict[str, ColumnData]
    # process-unique instance identity for the staging cache: a re-loaded
    # segment with the same name and crc never aliases stale device arrays
    staging_token: int = field(
        default_factory=lambda: next(_staging_tokens), compare=False, repr=False
    )

    @property
    def segment_name(self) -> str:
        return self.metadata.segment_name

    @property
    def num_docs(self) -> int:
        return self.metadata.num_docs

    def column(self, name: str) -> ColumnData:
        try:
            return self.columns[name]
        except KeyError:
            raise KeyError(
                f"column {name!r} not in segment {self.segment_name!r}"
            ) from None

    def has_column(self, name: str) -> bool:
        return name in self.columns

    def row(self, doc_id: int) -> Dict[str, Any]:
        """Materialize one row (the selection finalize reads it)."""
        return {name: col.values_for_doc(doc_id) for name, col in self.columns.items()}
