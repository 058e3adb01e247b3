"""Seeded TPC-H lineitem-shaped data (copy of the lineitem part of
``pinot_tpu.tools.datagen``).

The numpy draws are made in the same order as the reference's, so the
same seed gives the same dictionaries and forward indexes in both
packages.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from pinot_tpu_torch.common.schema import DataType, FieldSpec, FieldType, Schema
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.immutable import (
    ColumnData,
    ColumnMetadata,
    ImmutableSegment,
    SegmentMetadata,
)

_SHIP_MODES = ["RAIL", "FOB", "MAIL", "SHIP", "TRUCK", "AIR", "REG AIR"]
_RETURN_FLAGS = ["R", "A", "N"]
_LINE_STATUS = ["O", "F"]


def lineitem_schema() -> Schema:
    return Schema(
        "lineitem",
        dimensions=[
            FieldSpec("l_returnflag", DataType.STRING),
            FieldSpec("l_linestatus", DataType.STRING),
            FieldSpec("l_shipmode", DataType.STRING),
            FieldSpec("l_shipdate", DataType.STRING),
            FieldSpec("l_receiptdate", DataType.STRING),
        ],
        metrics=[
            FieldSpec("l_quantity", DataType.DOUBLE, FieldType.METRIC),
            FieldSpec("l_extendedprice", DataType.DOUBLE, FieldType.METRIC),
            FieldSpec("l_discount", DataType.DOUBLE, FieldType.METRIC),
            FieldSpec("l_tax", DataType.DOUBLE, FieldType.METRIC),
        ],
    )


def _synthetic_columnar_segment(
    schema: Schema,
    table_name: str,
    dict_values: Dict[str, Any],
    num_rows: int,
    seed: int,
    name: str,
    clustered_column: Optional[str] = None,
    time_column: Optional[str] = None,
    rng=None,
) -> ImmutableSegment:
    """ColumnData built directly from per-column value pools (dictIds
    drawn uniformly, one ``rng.integers`` call per column in schema
    order).  ``clustered_column`` is sorted after the draw, so it
    qualifies for the docrange fast path as a sorted Pinot column does."""
    rng = rng if rng is not None else np.random.default_rng(seed)
    columns = {}
    for spec in schema.all_fields():
        vals = dict_values[spec.name]
        if spec.stored_type == DataType.STRING:
            d = Dictionary(DataType.STRING, sorted(set(vals)))
        else:
            d = Dictionary(spec.stored_type, np.unique(np.asarray(vals)))
        card = d.cardinality
        fwd = rng.integers(0, card, size=num_rows, dtype=np.int64).astype(np.int32)
        if spec.name == clustered_column:
            fwd.sort()
        columns[spec.name] = ColumnData(
            metadata=ColumnMetadata(
                name=spec.name,
                data_type=spec.data_type,
                field_type=spec.field_type,
                single_value=True,
                cardinality=card,
                total_docs=num_rows,
                is_sorted=bool(num_rows == 0 or np.all(fwd[1:] >= fwd[:-1])),
                total_number_of_entries=num_rows,
                min_value=d.min_value,
                max_value=d.max_value,
            ),
            dictionary=d,
            fwd=fwd,
        )
    smeta = SegmentMetadata(
        segment_name=name,
        table_name=table_name,
        num_docs=num_rows,
        columns={c.metadata.name: c.metadata for c in columns.values()},
        time_column=time_column,
    )
    seg = ImmutableSegment(metadata=smeta, columns=columns)
    smeta.crc = hash((name, num_rows, seed)) & 0xFFFFFFFF  # cheap identity
    return seg


def synthetic_lineitem_segment(num_rows: int, seed: int = 7, name: str = "li0") -> ImmutableSegment:
    """Fast numpy-path lineitem segment; ``l_shipdate`` is clustered."""
    rng = np.random.default_rng(seed)

    def dates(n: int) -> List[str]:
        out = []
        for y in range(1992, 1999):
            for m in range(1, 13):
                for d in range(1, 29):
                    out.append(f"{y:04d}-{m:02d}-{d:02d}")
                    if len(out) >= n:
                        return sorted(out)
        return sorted(out)

    dict_values = {
        "l_returnflag": sorted(_RETURN_FLAGS),
        "l_linestatus": sorted(_LINE_STATUS),
        "l_shipmode": sorted(_SHIP_MODES),
        "l_shipdate": dates(2000),
        "l_receiptdate": dates(2000),
        "l_quantity": np.arange(1.0, 51.0),
        "l_extendedprice": np.round(np.sort(rng.uniform(900.0, 105_000.0, 16384)), 2),
        "l_discount": np.round(np.arange(0.0, 0.11, 0.01), 2),
        "l_tax": np.round(np.arange(0.0, 0.09, 0.01), 2),
    }
    return _synthetic_columnar_segment(
        lineitem_schema(), "lineitem", dict_values, num_rows, seed, name,
        clustered_column="l_shipdate", rng=rng,
    )
