"""Immutable columnar segment — the host representation (copy of
``pinot_tpu.segment.immutable``, trimmed).

A segment is per-column metadata + a sorted dictionary + a forward index
of dictIds (``fwd`` int32 [num_docs] for single-value columns; CSR
``mv_values``/``mv_offsets`` for multi-value columns).  The device-resident, padded and stacked form
is produced by ``pinot_tpu_torch.engine.device``.
"""
from __future__ import annotations

import itertools
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from pinot_tpu_torch.common.schema import DataType, FieldType
from pinot_tpu_torch.segment.dictionary import Dictionary

SEGMENT_FORMAT_VERSION = "tpu1"  # analog of SegmentVersion v1/v2/v3


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

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "dataType": self.data_type.value,
            "fieldType": self.field_type.value,
            "singleValue": self.single_value,
            "cardinality": self.cardinality,
            "totalDocs": self.total_docs,
            "isSorted": self.is_sorted,
            "hasInvertedIndex": self.has_inverted_index,
            "maxNumMultiValues": self.max_num_multi_values,
            "totalNumberOfEntries": self.total_number_of_entries,
            "minValue": self.min_value,
            "maxValue": self.max_value,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ColumnMetadata":
        return cls(
            name=d["name"],
            data_type=DataType(d["dataType"]),
            field_type=FieldType(d["fieldType"]),
            single_value=d["singleValue"],
            cardinality=d["cardinality"],
            total_docs=d["totalDocs"],
            is_sorted=d["isSorted"],
            has_inverted_index=d.get("hasInvertedIndex", False),
            max_num_multi_values=d.get("maxNumMultiValues", 0),
            total_number_of_entries=d.get("totalNumberOfEntries", 0),
            min_value=d.get("minValue"),
            max_value=d.get("maxValue"),
        )


@dataclass
class SegmentMetadata:
    """Segment-level metadata (reference: SegmentMetadataImpl +
    creation.meta: crc + creation time).  ``custom["dataCrc"]`` marks a
    crc that was computed over the column data (``format.verify_segment_crc``
    holds such a segment to it)."""

    segment_name: str
    table_name: str
    num_docs: int
    columns: Dict[str, ColumnMetadata] = field(default_factory=dict)
    time_column: Optional[str] = None
    time_unit: str = "DAYS"
    start_time: Optional[int] = None
    end_time: Optional[int] = None
    crc: int = 0
    creation_time_ms: int = 0
    format_version: str = SEGMENT_FORMAT_VERSION
    custom: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {
            "segmentName": self.segment_name,
            "tableName": self.table_name,
            "numDocs": self.num_docs,
            "columns": {k: v.to_json() for k, v in self.columns.items()},
            "timeColumn": self.time_column,
            "timeUnit": self.time_unit,
            "startTime": self.start_time,
            "endTime": self.end_time,
            "crc": self.crc,
            "creationTimeMs": self.creation_time_ms,
            "formatVersion": self.format_version,
            "custom": self.custom,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "SegmentMetadata":
        return cls(
            segment_name=d["segmentName"],
            table_name=d["tableName"],
            num_docs=d["numDocs"],
            columns={k: ColumnMetadata.from_json(v) for k, v in d["columns"].items()},
            time_column=d.get("timeColumn"),
            time_unit=d.get("timeUnit", "DAYS"),
            start_time=d.get("startTime"),
            end_time=d.get("endTime"),
            crc=d.get("crc", 0),
            creation_time_ms=d.get("creationTimeMs", 0),
            format_version=d.get("formatVersion", SEGMENT_FORMAT_VERSION),
            custom=d.get("custom", {}),
        )


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

    def rows(self) -> List[Dict[str, Any]]:
        return [self.row(i) for i in range(self.num_docs)]

    def compute_crc(self) -> int:
        """CRC over the column data: forward indexes, then the dictionary,
        column by column in name order (the reference's byte stream)."""
        crc = 0
        for name in sorted(self.columns):
            col = self.columns[name]
            for arr in (col.fwd, col.mv_values, col.mv_offsets):
                if arr is not None:
                    crc = zlib.crc32(np.ascontiguousarray(arr).tobytes(), crc)
            if col.dictionary.is_string:
                crc = zlib.crc32("\x00".join(col.dictionary.values).encode(), crc)
            else:
                crc = zlib.crc32(np.ascontiguousarray(col.dictionary.values).tobytes(), crc)
        return crc & 0xFFFFFFFF
