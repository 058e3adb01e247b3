"""Build the port's ``ImmutableSegment`` from plain numpy arrays and
Python values — the one way state crosses into this package.

Each column is described by a plain dict, so any producer (a segment
file reader, another engine, a test) can hand over exactly the data it
holds and both sides then query identical dictionaries and forward
indexes::

    {
        "data_type": "DOUBLE",          # DataType name
        "field_type": "METRIC",         # FieldType name
        "single_value": True,
        "dictionary": np.ndarray | list[str],   # sorted, unique values
        "fwd": np.ndarray,              # int dictIds [num_docs] (SV)
        "mv_values": ..., "mv_offsets": ...,    # CSR dictIds (MV)
        "is_sorted": bool,
        "cardinality": int,
        # optional: has_inverted_index, max_num_multi_values,
        #           total_number_of_entries, min_value, max_value
    }
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

from pinot_tpu_torch.common.schema import DataType, FieldType
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.immutable import (
    ColumnData,
    ColumnMetadata,
    ImmutableSegment,
    SegmentMetadata,
)


def _int_array(a: Optional[Any]) -> Optional[np.ndarray]:
    return None if a is None else np.ascontiguousarray(np.asarray(a, dtype=np.int32))


def column_from_arrays(name: str, num_docs: int, spec: Mapping[str, Any]) -> ColumnData:
    data_type = DataType(spec["data_type"])
    dictionary = Dictionary(data_type.stored_type, spec["dictionary"])
    single_value = bool(spec["single_value"])
    fwd = _int_array(spec.get("fwd"))
    mv_values = _int_array(spec.get("mv_values"))
    mv_offsets = _int_array(spec.get("mv_offsets"))
    if single_value and (fwd is None or fwd.shape != (num_docs,)):
        raise ValueError(f"column {name!r}: single-value fwd must be int [{num_docs}]")
    if not single_value and (mv_values is None or mv_offsets is None):
        raise ValueError(f"column {name!r}: multi-value columns need mv_values and mv_offsets")
    card = int(spec["cardinality"])
    if card != dictionary.cardinality:
        raise ValueError(
            f"column {name!r}: cardinality {card} != dictionary size {dictionary.cardinality}"
        )
    meta = ColumnMetadata(
        name=name,
        data_type=data_type,
        field_type=FieldType(spec["field_type"]),
        single_value=single_value,
        cardinality=card,
        total_docs=num_docs,
        is_sorted=bool(spec["is_sorted"]),
        has_inverted_index=bool(spec.get("has_inverted_index", False)),
        max_num_multi_values=int(spec.get("max_num_multi_values", 0)),
        total_number_of_entries=int(spec.get("total_number_of_entries", num_docs)),
        min_value=spec.get("min_value", dictionary.min_value),
        max_value=spec.get("max_value", dictionary.max_value),
    )
    return ColumnData(
        metadata=meta,
        dictionary=dictionary,
        fwd=fwd,
        mv_values=mv_values,
        mv_offsets=mv_offsets,
    )


def segment_arrays_of(segment: Any) -> Dict[str, Any]:
    """The plain arrays and values of any object shaped like an
    ``ImmutableSegment`` (``metadata``, ``columns`` of ``metadata`` /
    ``dictionary`` / ``fwd`` ...), as keyword arguments for
    ``segment_from_arrays``.  Enum fields travel by name, dictionaries
    as numpy arrays or string lists."""
    m = segment.metadata
    cols = {}
    for name, c in segment.columns.items():
        cm = c.metadata
        d = c.dictionary
        cols[name] = {
            "data_type": cm.data_type.value,
            "field_type": cm.field_type.value,
            "single_value": bool(cm.single_value),
            "dictionary": list(d.values) if d.is_string else np.asarray(d.values),
            "fwd": c.fwd,
            "mv_values": c.mv_values,
            "mv_offsets": c.mv_offsets,
            "is_sorted": bool(cm.is_sorted),
            "cardinality": int(cm.cardinality),
            "has_inverted_index": bool(cm.has_inverted_index),
            "max_num_multi_values": int(cm.max_num_multi_values),
            "total_number_of_entries": int(cm.total_number_of_entries),
            "min_value": cm.min_value,
            "max_value": cm.max_value,
        }
    return {
        "segment_name": m.segment_name,
        "table_name": m.table_name,
        "num_docs": int(m.num_docs),
        "columns": cols,
        "time_column": m.time_column,
        "start_time": m.start_time,
        "end_time": m.end_time,
        "crc": int(m.crc),
    }


def segment_from_arrays(
    segment_name: str,
    table_name: str,
    num_docs: int,
    columns: Mapping[str, Mapping[str, Any]],
    time_column: Optional[str] = None,
    start_time: Optional[int] = None,
    end_time: Optional[int] = None,
    crc: int = 0,
) -> ImmutableSegment:
    """One ``ImmutableSegment`` from per-column array dicts (module doc)."""
    cols: Dict[str, ColumnData] = {
        name: column_from_arrays(name, num_docs, spec) for name, spec in columns.items()
    }
    meta = SegmentMetadata(
        segment_name=segment_name,
        table_name=table_name,
        num_docs=num_docs,
        columns={n: c.metadata for n, c in cols.items()},
        time_column=time_column,
        start_time=start_time,
        end_time=end_time,
        crc=crc,
    )
    return ImmutableSegment(metadata=meta, columns=cols)
