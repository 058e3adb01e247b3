"""Schema-evolution default columns.

When a table's schema grows a column, already-sealed segments don't
have it.  The reference patches each old segment at load time by
writing a constant forward index + single-entry dictionary for the new
column (pinot-core ``segment/index/loader/defaultcolumn/
BaseDefaultColumnHandler.java:18``, ``V3DefaultColumnHandler.java:31``,
driven by ``loader/SegmentPreProcessor.java``), so old rows answer with
the field's default null value instead of vanishing from results.

The TPU design needs no on-disk rewrite: a default column is a
cardinality-1 dictionary plus a constant dictId stream, which the
staging layer turns into a trivially compressible device array.  We
synthesize the ``ColumnData`` in memory at segment-add time
(``ServerInstance.set_table_schema`` / ``add_segment``) — the query
engine then sees it as an ordinary sorted column: global-dictionary
build, zone maps, group-by, everything works unchanged.
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from pinot_tpu_torch.common.schema import FieldSpec, Schema
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.immutable import ColumnData, ColumnMetadata, ImmutableSegment

logger = logging.getLogger(__name__)


def make_default_column(spec: FieldSpec, num_docs: int) -> ColumnData:
    """A constant column: every doc holds ``spec.get_default_null_value()``.

    Single-entry dictionary, so the forward index is all-zeros — the
    engine treats it as a sorted cardinality-1 column (best case for
    zone maps and match tables).  MV columns get one default entry per
    doc, mirroring DefaultColumnStatistics in the reference.
    """
    default = spec.get_default_null_value()
    dictionary = Dictionary(spec.stored_type, [default])
    meta = ColumnMetadata(
        name=spec.name,
        data_type=spec.data_type,
        field_type=spec.field_type,
        single_value=spec.single_value,
        cardinality=1,
        total_docs=num_docs,
        is_sorted=True,
        max_num_multi_values=0 if spec.single_value else 1,
        total_number_of_entries=num_docs,
        min_value=default,
        max_value=default,
    )
    if spec.single_value:
        return ColumnData(
            metadata=meta,
            dictionary=dictionary,
            fwd=np.zeros(num_docs, dtype=np.int32),
        )
    return ColumnData(
        metadata=meta,
        dictionary=dictionary,
        mv_values=np.zeros(num_docs, dtype=np.int32),
        mv_offsets=np.arange(num_docs + 1, dtype=np.int32),
    )


def inject_default_columns(
    segment: ImmutableSegment, schema: Optional[Schema]
) -> int:
    """Add synthesized columns for schema fields the segment lacks.

    Returns the number of columns injected.  The time column is never
    synthesized (a segment without its time column has no time range —
    pruning it is correct, defaulting it would corrupt time filters).
    """
    if schema is None:
        return 0
    injected = 0
    # patch via copy + atomic swap: live queries may be iterating the
    # column dict on another thread (dict insert during iteration raises)
    columns = dict(segment.columns)
    meta_columns = dict(segment.metadata.columns)
    for spec in schema.all_fields():
        if spec.name in columns:
            continue
        if spec.name == schema.time_column_name:
            continue
        col = make_default_column(spec, segment.num_docs)
        columns[spec.name] = col
        # metadata stays consistent with the live column set — the
        # reference's handler updates metadata.properties the same way;
        # converters/persistence iterate metadata.columns
        meta_columns[spec.name] = col.metadata
        injected += 1
    if injected:
        segment.columns = columns
        segment.metadata.columns = meta_columns
    if injected:
        logger.info(
            "injected %d default column(s) into %s", injected, segment.segment_name
        )
    return injected
