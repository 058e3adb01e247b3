"""Two-pass segment builder (copy of ``pinot_tpu.segment.builder``, the
row path).

Mirrors pinot-core's segment creation pipeline:

  pass 1 — scan records, collect per-column stats (cardinality, min/max,
           sortedness, MV lengths);
  then   — build sorted dictionaries per column
           (``SegmentDictionaryCreator.java``);
  pass 2 — write dictId forward indexes (SV: one dictId per doc,
           MV: CSR values+offsets) (``SegmentColumnarIndexCreator``);
  finally — segment metadata (time range, crc, creation time —
           metadata.properties + creation.meta analogs).

Missing fields get the schema's default null value (FieldSpec.java:37-47).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from pinot_tpu_torch.common.schema import FieldSpec, Schema
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.immutable import (
    ColumnData,
    ColumnMetadata,
    ImmutableSegment,
    SegmentMetadata,
)
from pinot_tpu_torch.startree.builder import build_star_tree

Row = Dict[str, Any]


@dataclass
class SegmentGeneratorConfig:
    """Build-time options (reference: SegmentGeneratorConfig)."""

    table_name: str
    segment_name: Optional[str] = None
    # a StarTreeBuilderConfig builds a star-tree over the segment; None
    # builds none
    startree_config: Optional[object] = None
    # columns to pre-derive HLL companions for (HllConfig analog);
    # declared, never read (the reference's builder does not read them)
    hll_columns: Sequence[str] = ()
    hll_suffix: str = "_hll"


class _ColumnStats:
    """Pass-1 per-column stats collector
    (reference: creator/impl/stats/ collectors)."""

    def __init__(self, spec: FieldSpec) -> None:
        self.spec = spec
        self.values: List[Any] = []
        self.max_mv = 0
        self.total_entries = 0
        self.prev = None
        self.is_sorted = spec.single_value  # MV columns are never "sorted"

    def collect(self, value: Any) -> None:
        st = self.spec.stored_type
        if self.spec.single_value:
            v = st.convert(value)
            self.values.append(v)
            self.total_entries += 1
            if self.is_sorted and self.prev is not None and v < self.prev:
                self.is_sorted = False
            self.prev = v
        else:
            vs = value if isinstance(value, (list, tuple)) else [value]
            if not vs:
                vs = [self.spec.get_default_null_value()]
            converted = [st.convert(x) for x in vs]
            self.values.extend(converted)
            self.total_entries += len(converted)
            self.max_mv = max(self.max_mv, len(converted))


class SegmentBuilder:
    def __init__(self, schema: Schema, config: SegmentGeneratorConfig) -> None:
        self.schema = schema
        self.config = config

    def build(self, rows: Sequence[Row]) -> ImmutableSegment:
        schema = self.schema
        num_docs = len(rows)

        # ---- pass 1: stats ------------------------------------------
        stats: Dict[str, _ColumnStats] = {
            spec.name: _ColumnStats(spec) for spec in schema.all_fields()
        }
        for row in rows:
            for spec in schema.all_fields():
                value = row.get(spec.name)
                if value is None or (isinstance(value, float) and np.isnan(value)):
                    value = spec.get_default_null_value()
                stats[spec.name].collect(value)

        # ---- dictionaries -------------------------------------------
        dictionaries: Dict[str, Dictionary] = {}
        for spec in schema.all_fields():
            dictionaries[spec.name] = Dictionary.build(
                spec.stored_type, stats[spec.name].values
            )

        # ---- pass 2: forward indexes --------------------------------
        columns: Dict[str, ColumnData] = {}
        for spec in schema.all_fields():
            st = spec.stored_type
            d = dictionaries[spec.name]
            s = stats[spec.name]
            meta = ColumnMetadata(
                name=spec.name,
                data_type=spec.data_type,
                field_type=spec.field_type,
                single_value=spec.single_value,
                cardinality=d.cardinality,
                total_docs=num_docs,
                is_sorted=s.is_sorted,
                max_num_multi_values=s.max_mv,
                total_number_of_entries=s.total_entries,
                min_value=d.min_value,
                max_value=d.max_value,
            )
            if spec.single_value:
                raw = np.asarray(s.values, dtype=st.to_numpy()) if not d.is_string else s.values
                fwd = d.index_array(np.asarray(s.values, dtype=object) if d.is_string else raw)
                columns[spec.name] = ColumnData(metadata=meta, dictionary=d, fwd=fwd)
            else:
                # CSR: s.values is already flattened in row order
                offsets = np.zeros(num_docs + 1, dtype=np.int32)
                flat: List[Any] = []
                pos = 0
                i = 0
                for row in rows:
                    value = row.get(spec.name)
                    if value is None:
                        vs = [spec.get_default_null_value()]
                    else:
                        vs = value if isinstance(value, (list, tuple)) else [value]
                        vs = [st.convert(x) for x in vs] or [spec.get_default_null_value()]
                    flat.extend(vs)
                    pos += len(vs)
                    i += 1
                    offsets[i] = pos
                if d.is_string:
                    mv_values = d.index_array(np.asarray(flat, dtype=object))
                else:
                    mv_values = d.index_array(np.asarray(flat, dtype=st.to_numpy()))
                columns[spec.name] = ColumnData(
                    metadata=meta, dictionary=d, mv_values=mv_values, mv_offsets=offsets
                )

        return finalize_segment(schema, self.config, num_docs, columns)


def finalize_segment(
    schema: Schema,
    config: SegmentGeneratorConfig,
    num_docs: int,
    columns: Dict[str, ColumnData],
) -> ImmutableSegment:
    """Segment metadata + CRC + optional star-tree (metadata.properties /
    creation.meta analogs)."""
    seg_name = config.segment_name or f"{config.table_name}_{num_docs}_{int(time.time())}"
    meta = SegmentMetadata(
        segment_name=seg_name,
        table_name=config.table_name,
        num_docs=num_docs,
        columns={c.metadata.name: c.metadata for c in columns.values()},
        time_column=schema.time_column_name,
        time_unit=schema.time_field.time_unit if schema.time_field else "DAYS",
        creation_time_ms=int(time.time() * 1000),
    )
    if schema.time_field is not None and num_docs > 0:
        tcol = columns[schema.time_column_name]
        if not tcol.dictionary.is_string:
            meta.start_time = int(tcol.dictionary.min_value)
            meta.end_time = int(tcol.dictionary.max_value)

    segment = ImmutableSegment(metadata=meta, columns=columns)
    meta.crc = segment.compute_crc()
    meta.custom["dataCrc"] = True  # verifiable claim (format.verify_segment_crc)

    if config.startree_config is not None:
        segment = build_star_tree(segment, schema, config.startree_config)
    return segment


def build_segment(
    schema: Schema,
    rows: Sequence[Row],
    table_name: str,
    segment_name: Optional[str] = None,
    **kwargs: Any,
) -> ImmutableSegment:
    cfg = SegmentGeneratorConfig(table_name=table_name, segment_name=segment_name, **kwargs)
    return SegmentBuilder(schema, cfg).build(rows)
