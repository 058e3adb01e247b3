"""Seeded TPC-H lineitem-shaped, ad-events and baseballStats data (copy
of those parts of ``pinot_tpu.tools.datagen``), and the reference tests'
mixed-type schema with multi-value columns.  ``baseball_rows`` draws with
``random.Random`` as the reference's does, so the same seed gives the
same rows; so does ``random_rows`` (``GenerateData``'s rows).

The lineitem and ad-events numpy draws are made in the same order as the
reference's, so the same seed gives the same dictionaries and forward
indexes in both packages.  ``synthetic_mv_segment`` draws
``make_test_schema()`` rows by the law of the reference's ``random_rows``
(fixed value pools, 1..``mv_max`` entries a multi-value row) with numpy,
column by column, at sizes the row-at-a-time segment build cannot reach.
"""
from __future__ import annotations

import random
import string
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


def random_rows(
    schema: Schema,
    num_rows: int,
    seed: int = 0,
    cardinality: int = 20,
    mv_max: int = 3,
) -> List[Dict[str, Any]]:
    """Random rows for a schema with bounded per-column cardinality: a
    fixed value pool a column, drawn from ``random.Random(seed)``."""
    rng = random.Random(seed)
    pools: Dict[str, List[Any]] = {}
    for spec in schema.all_fields():
        st = spec.stored_type
        if st == DataType.STRING:
            pools[spec.name] = [
                "".join(rng.choices(string.ascii_lowercase, k=rng.randint(3, 8)))
                for _ in range(cardinality)
            ]
        elif st in (DataType.INT, DataType.LONG):
            pools[spec.name] = [rng.randint(0, 10_000) for _ in range(cardinality)]
        else:
            pools[spec.name] = [round(rng.uniform(-100, 100), 3) for _ in range(cardinality)]

    rows: List[Dict[str, Any]] = []
    for _ in range(num_rows):
        row: Dict[str, Any] = {}
        for spec in schema.all_fields():
            pool = pools[spec.name]
            if spec.single_value:
                row[spec.name] = rng.choice(pool)
            else:
                row[spec.name] = [rng.choice(pool) for _ in range(rng.randint(1, mv_max))]
        rows.append(row)
    return rows


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


# ---------------------------------------------------------------------------
# baseballStats-shaped quickstart data (Quickstart.java:33 /
# sample_data/baseball.schema; synthetic, shape- and type-faithful)
# ---------------------------------------------------------------------------

_TEAMS = ["BOS", "NYA", "CHA", "SFN", "LAN", "SLN", "ATL", "SEA", "OAK", "TEX"]
_LEAGUES = ["AL", "NL"]
_FIRST = ["hank", "babe", "ty", "willie", "ted", "lou", "joe", "mickey", "stan", "cal"]
_LAST = ["aaron", "ruth", "cobb", "mays", "williams", "gehrig", "dimaggio", "mantle", "musial", "ripken"]


def baseball_schema() -> Schema:
    return Schema(
        "baseballStats",
        dimensions=[
            FieldSpec("playerName", DataType.STRING),
            FieldSpec("teamID", DataType.STRING),
            FieldSpec("league", DataType.STRING),
            FieldSpec("yearID", DataType.INT),
        ],
        metrics=[
            FieldSpec("runs", DataType.INT, FieldType.METRIC),
            FieldSpec("hits", DataType.INT, FieldType.METRIC),
            FieldSpec("homeRuns", DataType.INT, FieldType.METRIC),
            FieldSpec("atBats", DataType.INT, FieldType.METRIC),
        ],
    )


def baseball_rows(num_rows: int = 10_000, seed: int = 42) -> List[Dict[str, Any]]:
    rng = random.Random(seed)
    players = [f"{f} {l}" for f in _FIRST for l in _LAST]
    rows: List[Dict[str, Any]] = []
    for _ in range(num_rows):
        at_bats = rng.randint(50, 650)
        hits = rng.randint(0, at_bats // 2)
        rows.append(
            {
                "playerName": rng.choice(players),
                "teamID": rng.choice(_TEAMS),
                "league": rng.choice(_LEAGUES),
                "yearID": rng.randint(1980, 2015),
                "runs": rng.randint(0, 140),
                "hits": hits,
                "homeRuns": rng.randint(0, 60),
                "atBats": at_bats,
            }
        )
    return rows


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


def synthetic_baseball_segment(num_rows: int, seed: int = 7, name: str = "bb0") -> ImmutableSegment:
    """A baseballStats segment built column by column: the schema and
    cardinalities of ``baseball_rows`` at sizes the row build cannot
    reach."""
    dict_values = {
        "playerName": sorted(f"{f} {l}" for f in _FIRST for l in _LAST),
        "teamID": sorted(_TEAMS),
        "league": sorted(_LEAGUES),
        "yearID": np.arange(1980, 2016, dtype=np.int64),
        "runs": np.arange(0, 141, dtype=np.int64),
        "hits": np.arange(0, 326, dtype=np.int64),
        "homeRuns": np.arange(0, 61, dtype=np.int64),
        "atBats": np.arange(50, 651, dtype=np.int64),
    }
    return _synthetic_columnar_segment(
        baseball_schema(), "baseballStats", dict_values, num_rows, seed, name
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


# ---------------------------------------------------------------------------
# Star Schema Benchmark tables (O'Neil, O'Neil, Chen, Revilak, TPCTC 2009):
# lineorder, part and date, for the join path.  lineorder and part are
# partitioned on their part key (partition = key % partitions, segment
# names ``..._pN``), so the two tables colocate.
# ---------------------------------------------------------------------------

SSB_YEARS = (1992, 1998)
SSB_DATES = 2556  # rows of SSB's date table
SSB_CATEGORIES = [f"MFGR#{m}{c}" for m in range(1, 6) for c in range(1, 6)]
SSB_BRANDS_PER_CATEGORY = 40


def lineorder_schema() -> Schema:
    return Schema(
        "lineorder",
        dimensions=[
            FieldSpec("lo_orderdate", DataType.INT),
            FieldSpec("lo_partkey", DataType.INT),
            FieldSpec("lo_shipmode", DataType.STRING),
        ],
        metrics=[
            FieldSpec("lo_quantity", DataType.INT, FieldType.METRIC),
            FieldSpec("lo_discount", DataType.INT, FieldType.METRIC),
            FieldSpec("lo_extendedprice", DataType.INT, FieldType.METRIC),
            FieldSpec("lo_revenue", DataType.INT, FieldType.METRIC),
        ],
    )


def part_schema() -> Schema:
    return Schema(
        "part",
        dimensions=[
            FieldSpec("p_partkey", DataType.INT),
            FieldSpec("p_category", DataType.STRING),
            FieldSpec("p_brand1", DataType.STRING),
        ],
        metrics=[FieldSpec("p_size", DataType.INT, FieldType.METRIC)],
    )


def date_schema() -> Schema:
    return Schema(
        "date",
        dimensions=[FieldSpec("d_datekey", DataType.INT), FieldSpec("d_year", DataType.INT)],
    )


def _segment_of_values(schema: Schema, table_name: str, name: str, values: Dict[str, Any]) -> ImmutableSegment:
    """A segment whose single-value columns hold ``values`` row by row: each
    dictionary the sorted distinct values, each forward index their ids.
    A column given as (sorted distinct pool, pool index per row) is
    encoded from the draws in linear time."""
    columns = {}
    num_rows = 0
    for spec in schema.all_fields():
        vals = values[spec.name]
        if isinstance(vals, tuple):
            pool, drawn = vals
            present = np.bincount(drawn, minlength=len(pool)) > 0
            rank = (np.cumsum(present) - 1).astype(np.int32)
            uniq, fwd = np.asarray(pool)[present], rank[drawn]
        else:
            uniq, fwd = np.unique(np.asarray(vals), return_inverse=True)
        num_rows = len(fwd)
        if spec.stored_type == DataType.STRING:
            d = Dictionary(DataType.STRING, [str(v) for v in uniq])
        else:
            d = Dictionary(spec.stored_type, uniq)
        fwd = fwd.reshape(-1).astype(np.int32)
        columns[spec.name] = ColumnData(
            metadata=ColumnMetadata(
                name=spec.name,
                data_type=spec.data_type,
                field_type=spec.field_type,
                single_value=True,
                cardinality=d.cardinality,
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
    )
    seg = ImmutableSegment(metadata=smeta, columns=columns)
    smeta.crc = hash((name, num_rows)) & 0xFFFFFFFF  # cheap identity
    return seg


def ssb_datekeys(n: int = SSB_DATES) -> np.ndarray:
    """The first ``n`` days from 1992-01-01 as yyyymmdd ints (d_datekey)."""
    days = np.arange(np.datetime64("1992-01-01"), np.datetime64("1992-01-01") + n)
    ymd = days.astype("datetime64[D]").astype(str)
    return np.asarray([int(s.replace("-", "")) for s in ymd], dtype=np.int64)


def ssb_date_segment(name: str = "date_0") -> ImmutableSegment:
    """SSB's date table: 2556 days from 1992-01-01, d_datekey and d_year."""
    keys = ssb_datekeys()
    return _segment_of_values(date_schema(), "date", name, {"d_datekey": keys, "d_year": keys // 10000})


def ssb_retailprice(partkey: np.ndarray) -> np.ndarray:
    """SSB / TPC-H dbgen's p_retailprice in cents: 90000 + ((k / 10) mod
    20001) + 100 * (k mod 1000)."""
    k = np.asarray(partkey, dtype=np.int64)
    return 90000 + (k // 10) % 20001 + 100 * (k % 1000)


def ssb_part_segments(num_parts: int, partitions: int, seed: int = 3) -> List[ImmutableSegment]:
    """SSB's part table, ``num_parts`` rows (p_partkey 1..num_parts, unique),
    one segment ``part_pN`` per partition of p_partkey % ``partitions``:
    p_category one of 25 (MFGR#11 .. MFGR#55), p_brand1 one of 40 in its
    category (MFGR#<category>01 .. 40), p_size 1-50."""
    rng = np.random.default_rng(seed)
    keys = np.arange(1, num_parts + 1, dtype=np.int64)
    cat = rng.integers(0, len(SSB_CATEGORIES), size=num_parts)
    brand = rng.integers(1, SSB_BRANDS_PER_CATEGORY + 1, size=num_parts)
    size = rng.integers(1, 51, size=num_parts)
    cats = np.asarray(SSB_CATEGORIES)
    out = []
    for p in range(partitions):
        rows = np.nonzero(keys % partitions == p)[0]
        c = cats[cat[rows]]
        out.append(_segment_of_values(part_schema(), "part", f"part_p{p}", {
            "p_partkey": keys[rows],
            "p_category": c,
            "p_brand1": np.char.add(c.astype(str), np.char.zfill(brand[rows].astype(str), 2)),
            "p_size": size[rows],
        }))
    return out


def ssb_lineorder_segment(num_rows: int, partition: int, partitions: int, num_parts: int,
                          seed: int = 7) -> ImmutableSegment:
    """One ``lineorder_pN`` segment: ``num_rows`` rows whose lo_partkey is
    drawn uniformly from the part keys of partition ``partition`` (key %
    ``partitions``), lo_orderdate uniformly from the d_datekeys,
    lo_quantity 1-50, lo_discount 0-10, lo_shipmode one of 7;
    lo_extendedprice = lo_quantity x p_retailprice and lo_revenue =
    lo_extendedprice x (100 - lo_discount) / 100, as SSB's dbgen makes them."""
    rng = np.random.default_rng(seed)
    first = partition if partition > 0 else partitions
    part_keys = np.arange(first, num_parts + 1, partitions, dtype=np.int64)
    pk = rng.integers(0, part_keys.size, size=num_rows)
    datekeys = ssb_datekeys()
    od = rng.integers(0, datekeys.size, size=num_rows)
    qty = rng.integers(0, 50, size=num_rows)
    disc = rng.integers(0, 11, size=num_rows)
    modes = sorted(_SHIP_MODES)
    ship = rng.integers(0, len(modes), size=num_rows)
    quantity, discount = np.arange(1, 51), np.arange(0, 11)
    extended = quantity[qty] * ssb_retailprice(part_keys)[pk]
    return _segment_of_values(lineorder_schema(), "lineorder", f"lineorder_p{partition}", {
        "lo_orderdate": (datekeys, od),
        "lo_partkey": (part_keys, pk),
        "lo_shipmode": (modes, ship),
        "lo_quantity": (quantity, qty),
        "lo_discount": (discount, disc),
        "lo_extendedprice": extended,
        "lo_revenue": extended * (100 - discount[disc]) // 100,
    })
