"""Seeded TPC-H lineitem-shaped and ad-events data (copy of the lineitem
and ad-events parts of ``pinot_tpu.tools.datagen``), and the reference
tests' mixed-type schema with multi-value columns.

The lineitem and ad-events numpy draws are made in the same order as the
reference's, so the same seed gives the same dictionaries and forward
indexes in both packages.  ``synthetic_mv_segment`` draws
``make_test_schema()`` rows by the law of the reference's ``random_rows``
(fixed value pools, 1..``mv_max`` entries a multi-value row) with numpy,
column by column, at sizes the row-at-a-time segment build cannot reach.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from pinot_tpu_torch.common.schema import DataType, FieldSpec, FieldType, Schema, TimeFieldSpec
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.immutable import (
    ColumnData,
    ColumnMetadata,
    ImmutableSegment,
    SegmentMetadata,
)

def make_test_schema(with_mv: bool = True) -> Schema:
    """A small mixed-type schema exercising every stored type (copy of
    ``pinot_tpu.tools.datagen.make_test_schema``)."""
    dims = [
        FieldSpec("dimStr", DataType.STRING, FieldType.DIMENSION),
        FieldSpec("dimInt", DataType.INT, FieldType.DIMENSION),
        FieldSpec("dimLong", DataType.LONG, FieldType.DIMENSION),
    ]
    if with_mv:
        dims.append(FieldSpec("dimStrMV", DataType.STRING_ARRAY, FieldType.DIMENSION, single_value=False))
        dims.append(FieldSpec("dimIntMV", DataType.INT_ARRAY, FieldType.DIMENSION, single_value=False))
    metrics = [
        FieldSpec("metInt", DataType.INT, FieldType.METRIC),
        FieldSpec("metFloat", DataType.FLOAT, FieldType.METRIC),
        FieldSpec("metDouble", DataType.DOUBLE, FieldType.METRIC),
    ]
    time_field = TimeFieldSpec("daysSinceEpoch", DataType.INT, time_unit="DAYS")
    return Schema("testTable", dimensions=dims, metrics=metrics, time_field=time_field)


def _value_pool(rng, stored: DataType, cardinality: int):
    """``cardinality`` pool values of a stored type, drawn as the reference's
    ``random_rows`` draws them: lowercase strings of 3 to 8 letters, ints in
    [0, 10000], floats in [-100, 100) rounded to 3 places (FLOAT through
    float32, as it is stored)."""
    if stored == DataType.STRING:
        letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
        lengths = rng.integers(3, 9, size=cardinality)
        chars = letters[rng.integers(0, 26, size=int(lengths.sum()))]
        ends = np.cumsum(lengths)
        return np.array(["".join(chars[e - n : e]) for e, n in zip(ends, lengths)], dtype=object)
    if stored in (DataType.INT, DataType.LONG):
        return rng.integers(0, 10_001, size=cardinality, dtype=np.int64)
    vals = np.round(rng.uniform(-100.0, 100.0, size=cardinality), 3)
    return vals.astype(np.float32).astype(np.float64) if stored == DataType.FLOAT else vals


def _dictionary_of(pool, stored: DataType, drawn: np.ndarray):
    """(dictionary of the pool values present in ``drawn``, dictId per draw)."""
    values, pool_ids = np.unique(pool, return_inverse=True)
    ids = pool_ids.reshape(-1)[drawn]
    hit = np.bincount(ids, minlength=values.size) > 0
    rank = (np.cumsum(hit) - 1).astype(np.int32)
    vals = values[hit]
    d = Dictionary(stored, list(vals) if stored == DataType.STRING else vals)
    return d, rank[ids]


def synthetic_mv_segment(
    num_rows: int,
    seed: int = 7,
    name: str = "mv0",
    cardinality: int = 20,
    mv_max: int = 3,
) -> ImmutableSegment:
    """A ``make_test_schema()`` segment drawn column by column with numpy:
    one fixed pool of ``cardinality`` values per column, the same for
    every ``seed`` (the segments of one table share their pools, as one
    ``random_rows`` call's rows do); a single-value column draws each row
    uniformly from its pool, a multi-value column draws 1..``mv_max``
    entries a row (duplicates within a row kept), each uniformly from its
    pool, from ``seed``.  Dictionaries hold the values present."""
    pools = np.random.default_rng(0)
    rng = np.random.default_rng(seed)
    schema = make_test_schema()
    columns = {}
    for spec in schema.all_fields():
        st = spec.stored_type
        pool = _value_pool(pools, st, cardinality)
        if spec.single_value:
            d, fwd = _dictionary_of(pool, st, rng.integers(0, cardinality, size=num_rows))
            mv_values = mv_offsets = None
            entries, max_mv, is_sorted = num_rows, 0, bool(num_rows == 0 or np.all(fwd[1:] >= fwd[:-1]))
        else:
            counts = rng.integers(1, mv_max + 1, size=num_rows)
            d, mv_values = _dictionary_of(pool, st, rng.integers(0, cardinality, size=int(counts.sum())))
            fwd = None
            mv_offsets = np.zeros(num_rows + 1, dtype=np.int32)
            np.cumsum(counts, out=mv_offsets[1:])
            entries, max_mv, is_sorted = int(counts.sum()), int(counts.max(initial=0)), False
        columns[spec.name] = ColumnData(
            metadata=ColumnMetadata(
                name=spec.name,
                data_type=spec.data_type,
                field_type=spec.field_type,
                single_value=spec.single_value,
                cardinality=d.cardinality,
                total_docs=num_rows,
                is_sorted=is_sorted,
                max_num_multi_values=max_mv,
                total_number_of_entries=entries,
                min_value=d.min_value,
                max_value=d.max_value,
            ),
            dictionary=d,
            fwd=fwd,
            mv_values=mv_values,
            mv_offsets=mv_offsets,
        )
    smeta = SegmentMetadata(
        segment_name=name,
        table_name=schema.schema_name,
        num_docs=num_rows,
        columns={c.metadata.name: c.metadata for c in columns.values()},
        time_column="daysSinceEpoch",
    )
    smeta.crc = hash((name, num_rows, seed)) & 0xFFFFFFFF
    return ImmutableSegment(metadata=smeta, columns=columns)


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


# ---------------------------------------------------------------------------
# Synthetic ad-events (the north-star configuration, NORTHSTAR_HLL.json:
# high-cardinality distinctCountHLL group-by)
# ---------------------------------------------------------------------------

ADEVENTS_TABLE = "adevents"


def adevents_schema() -> Schema:
    return Schema(
        ADEVENTS_TABLE,
        dimensions=[
            FieldSpec("campaign_id", DataType.INT, FieldType.DIMENSION),
            FieldSpec("site_id", DataType.INT, FieldType.DIMENSION),
            FieldSpec("user_id", DataType.LONG, FieldType.DIMENSION),
        ],
        metrics=[FieldSpec("clicks", DataType.INT, FieldType.METRIC)],
        time_field=TimeFieldSpec("event_time", DataType.LONG, time_unit="MILLISECONDS"),
    )


def synthetic_adevents_segment(
    num_rows: int,
    seed: int = 7,
    name: str = "ad0",
    campaign_card: int = 1024,
    site_card: int = 128,
    user_card: int = 1 << 20,
    user_universe: int = 1 << 26,
) -> ImmutableSegment:
    """Fast numpy-path ad-events segment: the high-cardinality HLL
    workload.  ``user_id`` draws ``user_card`` distinct users per segment
    from a ``user_universe``-wide population, so segments overlap
    partially and the global dictionary grows toward the universe size
    across segments."""
    rng = np.random.default_rng(seed)
    users = np.unique(
        rng.integers(0, user_universe, size=int(user_card * 1.05), dtype=np.int64)
    )
    t0 = 1_700_000_000_000 + seed * 3_600_000
    dict_values = {
        "campaign_id": np.arange(campaign_card, dtype=np.int64),
        "site_id": np.arange(site_card, dtype=np.int64),
        "user_id": users,
        "clicks": np.arange(16, dtype=np.int64),
        # clustered: events arrive in time order
        "event_time": t0 + np.arange(4096, dtype=np.int64) * 1000,
    }
    return _synthetic_columnar_segment(
        adevents_schema(), ADEVENTS_TABLE, dict_values, num_rows, seed, name,
        clustered_column="event_time", time_column="event_time", rng=rng,
    )


def tile_segments(distinct_segments, total: int) -> List[ImmutableSegment]:
    """Replicate ``distinct_segments`` round-robin up to ``total``
    segments under fresh names.  The clones share the originals' numpy
    arrays (host memory stays O(distinct)) but stage and execute as
    independent segments.  Answers are those of the tiled data (distinct
    counts do not grow past the distinct set); scan work is that of
    ``total`` segments."""
    out = []
    for i in range(total):
        base = distinct_segments[i % len(distinct_segments)]
        if i < len(distinct_segments):
            out.append(base)
            continue
        m = base.metadata
        smeta = SegmentMetadata(
            segment_name=f"{m.segment_name}_t{i}",
            table_name=m.table_name,
            num_docs=m.num_docs,
            columns=dict(m.columns),
            time_column=m.time_column,
        )
        smeta.crc = hash((smeta.segment_name, m.num_docs)) & 0xFFFFFFFF
        out.append(ImmutableSegment(metadata=smeta, columns=base.columns))
    return out
