"""Distributed hash-join engine: side extraction, exchange payloads,
device hash-join execution, and the exact host-reference join (copy of
``pinot_tpu.engine.join``).

The broker plans a two-table equi-join (``broker/joinplan.py``) into one
of three strategies — colocated / broadcast / shuffle — but every
strategy bottoms out in the same server-side pipeline implemented here:

1. **extract**: one side's matched rows become a ``SideRows`` — the
   join key plus every referenced column, dict-encoded per column
   (``ids`` int32 into a compact sorted ``values`` vocabulary).  The
   encoding is the exchange wire format AND the device-friendly form:
   after the broker (or the local server) merges the two sides' key
   vocabularies, the join compares int32 ids, never raw values — string
   keys cost the same as ints (JSPIM's select-side framing: move ids,
   not values).

2. **join**: build-side rows pre-aggregate per unique key on host (the
   packing step), then the device program (``kernel.run_join_kernel``,
   torch ops; the reference's is jnp lowered by XLA, not a Pallas
   kernel) runs the build phase (parallel-claim insertion into an int32
   open-addressing table over padded lanes) and the probe phase
   (vectorized linear probing) and reduces aggregates/group holders in
   the same program: the grouped float sums through K1
   (``kernels.fused_groupby``), the joined-row counts as int64 adds,
   min / max as order-free scatter reductions.  Anything outside the device shape (selections,
   value-state aggregations, group spaces past the holder budget,
   build-side group columns under duplicate build keys) runs the exact
   host join — and a device failure heals through the executor's
   standard classify/retry/poison/host-failover contract
   (``executor.execute_join``), exactly like a poisoned scan.

3. **skew plan** (shuffle only): ``plan_shuffle_partitions`` assigns
   key-hash partitions to owners and detects heavy-hitter keys from the
   extracted per-key counts (dictionary-derived — the sides are already
   dict-encoded); a heavy key's build rows REPLICATE to every owner and
   its probe rows split round-robin across them (PIM-tree's
   split-and-replicate playbook), so no owner receives >2x the mean
   exchange bytes under zipf-skewed keys.

The wire dicts (``encode_side`` / ``decode_side``) are the reference's
byte for byte, so a side extracted by either package crosses to the
other.  ``extract_side`` and ``side_take`` dict-encode from the
segments' dictionary ids in linear time (a bincount per segment, a merge
of the small per-segment vocabularies) where the reference runs
``np.unique`` over the rows; the ``Col`` they return is the same.
"""
from __future__ import annotations

import concurrent.futures
import hashlib
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from pinot_tpu_torch.common.request import (
    BrokerRequest,
    FilterOperator,
    FilterQueryTree,
    JoinSpec,
    group_sort_ascending,
)
from pinot_tpu_torch.common.schema import DataType
from pinot_tpu_torch.common.values import render_value
from pinot_tpu_torch.engine import config
from pinot_tpu_torch.engine import hll as hll_mod
from pinot_tpu_torch.engine.results import (
    AvgPartial,
    CountPartial,
    DistinctPartial,
    HistogramPartial,
    HllPartial,
    IntermediateResult,
    MaxPartial,
    MinMaxRangePartial,
    MinPartial,
    SumPartial,
    make_partial,
    trim_group_candidates,
)

_KNUTH = np.uint64(2654435761)

_PARTITION_RE = __import__("re").compile(r"_+p(\d+)$")


def partition_of_segment(name: str) -> Optional[int]:
    """Partition id carried in a segment name (``..._p3`` / ``...__p3``)
    or None — the colocated strategy's placement channel: partitioned
    tables name their segments with the partition suffix, so both the
    broker planner and the server-side coverage re-check can read
    placement straight off the external view."""
    m = _PARTITION_RE.search(name)
    return int(m.group(1)) if m else None


class JoinValidationError(ValueError):
    """A join query the planner cannot execute (mixed-side OR
    predicates, MV columns, type-mismatched keys…) — a typed client
    error (QUERY_VALIDATION), never a server crash."""


# ---------------------------------------------------------------------------
# SideRows: the dict-encoded columnar exchange form of one join side
# ---------------------------------------------------------------------------


@dataclass
class Col:
    """One dict-encoded column: ``values[ids[i]]`` is row i's value.
    ``values`` is a sorted unique numpy array (numeric) or list[str]."""

    stored: str  # DataType name
    ids: np.ndarray  # int32 [n]
    values: Any  # np.ndarray (numeric) | List[str]

    @property
    def card(self) -> int:
        return len(self.values)

    def nbytes(self) -> int:
        vb = (
            self.values.nbytes
            if isinstance(self.values, np.ndarray)
            else sum(len(v) for v in self.values)
        )
        return int(self.ids.nbytes + vb)

    def row_values(self) -> np.ndarray:
        """Per-row value array (numeric columns only)."""
        return np.asarray(self.values, dtype=np.float64)[self.ids]

    def stored_type(self) -> DataType:
        return DataType[self.stored]

    def py_value(self, vid: int):
        v = self.values[vid]
        st = self.stored_type()
        if st in (DataType.INT, DataType.LONG):
            return int(v)
        if st in (DataType.FLOAT, DataType.DOUBLE):
            return float(v)
        return str(v)


@dataclass
class SideRows:
    """One join side's extracted rows: the key column plus every
    referenced column, all dict-encoded.  ``cols`` is keyed by the
    REQUEST-level column name (left side bare, right side
    ``"<right_table>.<col>"``), so execution reads straight off the
    parsed request."""

    n: int
    key: Col
    cols: Dict[str, Col] = field(default_factory=dict)

    def nbytes(self) -> int:
        return self.key.nbytes() + sum(c.nbytes() for c in self.cols.values())

    def key_counts(self) -> np.ndarray:
        """Per-key row counts (heavy-hitter statistic) — a bincount over
        the dictionary-encoded key ids."""
        return np.bincount(self.key.ids, minlength=self.key.card)


def _dict_encode(values: np.ndarray, stored: DataType) -> Col:
    if stored == DataType.STRING:
        arr = np.asarray(values, dtype=object)
        uniq, inv = np.unique(arr.astype(str), return_inverse=True)
        return Col(stored.name, inv.astype(np.int32), [str(v) for v in uniq])
    uniq, inv = np.unique(np.asarray(values), return_inverse=True)
    return Col(stored.name, inv.astype(np.int32), uniq)


def _compact_ids(ids: np.ndarray, card: int) -> Tuple[np.ndarray, np.ndarray]:
    """``np.unique(ids, return_inverse=True)`` of ids in [0, card), in
    linear time: (the ids present ascending, int32 rank of each id)."""
    present = np.bincount(ids, minlength=card)[:card] > 0
    rank = (np.cumsum(present) - 1).astype(np.int32)
    return np.nonzero(present)[0], rank[ids]


def _col_take(col: Col, rows: np.ndarray) -> Col:
    """Row subset with a re-compacted vocabulary (exchange slices ship
    only the values they reference)."""
    uniq, inv = _compact_ids(col.ids[rows], col.card)
    if isinstance(col.values, np.ndarray):
        values = col.values[uniq]
    else:
        values = [col.values[i] for i in uniq.tolist()]
    return Col(col.stored, inv.astype(np.int32), values)


def side_take(side: SideRows, rows: np.ndarray) -> SideRows:
    return SideRows(
        n=int(rows.size),
        key=_col_take(side.key, rows),
        cols={name: _col_take(c, rows) for name, c in side.cols.items()},
    )


def _merge_cols(cols: List[Col]) -> Col:
    """Concatenate dict-encoded columns, merging vocabularies."""
    stored = cols[0].stored
    if any(c.stored != stored for c in cols):
        raise JoinValidationError(
            f"column stored types differ across segments/servers: "
            f"{sorted({c.stored for c in cols})}"
        )
    if stored == DataType.STRING.name:
        vocab = sorted({v for c in cols for v in c.values})
        index = {v: i for i, v in enumerate(vocab)}
        # O(vocab) Python + O(rows) numpy: per-part remap tables, never
        # a per-row Python loop (this runs on the broker's merge path)
        ids = np.concatenate(
            [
                np.asarray(
                    [index[v] for v in c.values], dtype=np.int32
                )[c.ids]
                if c.ids.size
                else np.zeros(0, dtype=np.int32)
                for c in cols
            ]
        )
        return Col(stored, ids, vocab)
    vocab = np.unique(np.concatenate([np.asarray(c.values) for c in cols]))
    ids = np.concatenate(
        [
            np.searchsorted(vocab, np.asarray(c.values)[c.ids]).astype(np.int32)
            if c.ids.size
            else np.zeros(0, dtype=np.int32)
            for c in cols
        ]
    )
    return Col(stored, ids, vocab)


def merge_sides(parts: List[SideRows]) -> SideRows:
    # drop empty-extract placeholders (transient serving gaps): their
    # typeless empty key column must not fight the real parts' vocab
    parts = [p for p in parts if p is not None and (p.n or p.cols)]
    if not parts:
        return SideRows(n=0, key=Col(DataType.INT.name, np.zeros(0, np.int32), np.zeros(0, np.int64)))
    names = set()
    for p in parts:
        names.update(p.cols)
    return SideRows(
        n=sum(p.n for p in parts),
        key=_merge_cols([p.key for p in parts]),
        cols={
            name: _merge_cols([p.cols[name] for p in parts if name in p.cols])
            for name in sorted(names)
        },
    )


# -- wire encode/decode (rides the datatable tagged codec: arrays via
# the 'a' tag, string vocabularies as plain lists) ----------------------


def _enc_col(col: Col) -> Dict[str, Any]:
    values = col.values if isinstance(col.values, np.ndarray) else list(col.values)
    return {"stored": col.stored, "ids": col.ids, "values": values}


def _dec_col(d: Dict[str, Any]) -> Col:
    values = d["values"]
    if not isinstance(values, np.ndarray):
        values = [str(v) for v in values]
    return Col(str(d["stored"]), np.asarray(d["ids"], dtype=np.int32), values)


def encode_side(side: SideRows) -> Dict[str, Any]:
    return {
        "n": int(side.n),
        "key": _enc_col(side.key),
        "cols": {name: _enc_col(c) for name, c in side.cols.items()},
    }


def decode_side(d: Dict[str, Any]) -> SideRows:
    return SideRows(
        n=int(d["n"]),
        key=_dec_col(d["key"]),
        cols={name: _dec_col(c) for name, c in (d.get("cols") or {}).items()},
    )


# ---------------------------------------------------------------------------
# request decomposition: per-side filters and referenced columns
# ---------------------------------------------------------------------------


def _copy_leaf(node: FilterQueryTree, column: str) -> FilterQueryTree:
    return FilterQueryTree(
        operator=node.operator,
        column=column,
        values=list(node.values),
        range_spec=node.range_spec,
        children=[],
    )


def _strip_tree(node: FilterQueryTree, spec: JoinSpec) -> FilterQueryTree:
    if node.is_leaf:
        return _copy_leaf(node, spec.strip_right(node.column))
    return FilterQueryTree(
        operator=node.operator,
        children=[_strip_tree(c, spec) for c in node.children],
    )


def _copy_tree(node: FilterQueryTree) -> FilterQueryTree:
    if node.is_leaf:
        return _copy_leaf(node, node.column)
    return FilterQueryTree(
        operator=node.operator, children=[_copy_tree(c) for c in node.children]
    )


def split_join_filter(
    request: BrokerRequest,
) -> Tuple[Optional[FilterQueryTree], Optional[FilterQueryTree]]:
    """Split the WHERE tree into (left filter, right filter).  The top
    level must be a conjunction of single-side predicates: each AND arm
    is pushed down to its side's extraction; an arm mixing sides (an OR
    spanning the join) cannot be pushed through an inner join's
    extraction and is a typed validation error.  Right-side trees come
    back with the ``<right_table>.`` prefix stripped (segment-level
    column names)."""
    spec = request.join
    tree = request.filter
    if tree is None:
        return None, None
    arms = (
        list(tree.children)
        if (not tree.is_leaf and tree.operator == FilterOperator.AND)
        else [tree]
    )
    left: List[FilterQueryTree] = []
    right: List[FilterQueryTree] = []
    for arm in arms:
        sides = {
            "r" if spec.is_right_column(n.column) else "l"
            for n in arm.walk()
            if n.is_leaf
        }
        if len(sides) > 1:
            raise JoinValidationError(
                "join WHERE predicates must each reference a single side "
                "(an OR spanning both join sides cannot be pushed down)"
            )
        if sides == {"r"}:
            right.append(_strip_tree(arm, spec))
        else:
            left.append(_copy_tree(arm))

    def _pack(arms_: List[FilterQueryTree]) -> Optional[FilterQueryTree]:
        if not arms_:
            return None
        if len(arms_) == 1:
            return arms_[0]
        return FilterQueryTree(operator=FilterOperator.AND, children=arms_)

    return _pack(left), _pack(right)


def side_columns(request: BrokerRequest) -> Tuple[List[str], List[str]]:
    """Referenced VALUE columns per side (request-level names; join keys
    excluded — they ship as ``SideRows.key``).  Filter columns are
    excluded too: filters apply during extraction and never ship."""
    spec = request.join
    names: List[str] = []

    def add(c: Optional[str]) -> None:
        if c and c != "*" and c not in names:
            names.append(c)

    for a in request.aggregations:
        add(a.column)
    if request.is_group_by:
        for c in request.group_by.columns:
            add(c)
    if request.selection is not None:
        for c in request.selection.columns:
            add(c)
        for s in request.selection.sorts:
            add(s.column)
    left = [c for c in names if not spec.is_right_column(c)]
    right = [c for c in names if spec.is_right_column(c)]
    return left, right


# ---------------------------------------------------------------------------
# extraction: local segments -> SideRows
# ---------------------------------------------------------------------------


def extract_side(
    segments: Sequence[Any],
    filter_tree: Optional[FilterQueryTree],
    key_col: str,
    value_cols: Sequence[str],
    name_of: Optional[Dict[str, str]] = None,
) -> Tuple[SideRows, int]:
    """Matched rows of one side from local segments: apply the side's
    filter, gather the key + value columns, dict-encode.  ``name_of``
    maps segment-level column names to request-level names (the
    right side's ``<table>.<col>`` prefix).  Returns (rows, matched) —
    ``matched`` doubles as the extraction's numDocsScanned.

    MV columns cannot flatten into joined rows deterministically and
    are rejected (typed validation error).

    Each column dict-encodes from its dictionary ids: per segment the
    matched rows' ids and the values of the ids present, then one
    vocabulary over those values and a per-segment id -> vocabulary
    table (``_encode_segments``), the ``Col`` that ``_dict_encode``
    gives over the gathered values."""
    from pinot_tpu_torch.engine.host_fallback import _segment_mask

    name_of = name_of or {}
    # dedupe: the join key may ALSO be referenced as a value column
    # (sum(f.k), GROUP BY d.k) — reading it twice per segment would
    # silently double every per-row array while n stays correct
    read_cols = list(dict.fromkeys([key_col, *value_cols]))

    def scan(seg) -> Tuple[int, Dict[str, Tuple[Any, ...]]]:
        # no filter: every row, read in place
        rows = None if filter_tree is None else np.nonzero(_segment_mask(seg, filter_tree))[0]
        out = {}
        for c in read_cols:
            col = seg.column(c)  # KeyError -> caught by the server as 200
            if not col.is_single_value:
                raise JoinValidationError(
                    f"multi-value column {c!r} is not supported in joins"
                )
            fwd = col.fwd[: seg.num_docs] if rows is None else col.fwd[rows]
            card = col.dictionary.cardinality
            used = np.nonzero(np.bincount(fwd, minlength=card)[:card])[0]
            out[c] = (fwd, used, col.dictionary.value_array()[used], card, col.dictionary.stored_type)
        return (seg.num_docs if rows is None else int(rows.size)), out

    scanned = _map_parallel(scan, list(segments))
    if not scanned:
        # a transient serving gap (segment move mid-query): an EMPTY
        # side, not a client error — the broker's unserved-segment
        # accounting re-covers or degrades, exactly like the scan path
        return SideRows(
            n=0,
            key=Col(DataType.INT.name, np.zeros(0, np.int32), np.zeros(0, np.int64)),
        ), 0
    stored: Dict[str, DataType] = {}
    for _, cols in scanned:
        for c in read_cols:
            if stored.setdefault(c, cols[c][4]) != cols[c][4]:
                raise JoinValidationError(
                    f"column {c!r} stored type differs across segments"
                )
    matched_total = sum(m for m, _ in scanned)

    def enc(c: str) -> Col:
        return _encode_segments([cols[c][:4] for _, cols in scanned], stored[c])

    side = SideRows(
        n=matched_total,
        key=enc(key_col),
        cols={name_of.get(c, c): enc(c) for c in value_cols},
    )
    return side, matched_total


def _map_parallel(fn, items: List[Any]) -> List[Any]:
    """``fn`` over ``items`` on a thread pool, the results in item order:
    numpy releases the GIL in the filter gathers, bincounts and takes
    that a segment's extraction is made of."""
    if len(items) <= 1:
        return [fn(x) for x in items]
    with concurrent.futures.ThreadPoolExecutor(min(len(items), os.cpu_count() or 1)) as pool:
        return list(pool.map(fn, items))


def _take_into(table: np.ndarray, ids: np.ndarray, out: np.ndarray, chunk: int = 1 << 22) -> None:
    """``out[:] = table[ids]`` in chunks on the thread pool (one pass over
    the rows, which can number tens of millions)."""
    bounds = list(range(0, ids.size, chunk)) + [ids.size]

    def part(k: int) -> None:
        a, b = bounds[k], bounds[k + 1]
        np.take(table, ids[a:b], out=out[a:b], mode="clip")

    _map_parallel(part, list(range(len(bounds) - 1)))


def _encode_segments(parts: List[Tuple[np.ndarray, np.ndarray, Any, int]], stored: DataType) -> Col:
    """One column's ``Col`` from its per-segment parts (the rows' dictionary
    ids, the ids present, their values, the dictionary's cardinality):
    the merged sorted vocabulary, and each row's id in it through a
    per-segment dictionary id -> vocabulary id table, gathered into one
    buffer by segment in parallel."""
    if stored == DataType.STRING:
        vocab = sorted({str(v) for _, _, vals, _ in parts for v in vals})
        index = {v: i for i, v in enumerate(vocab)}
        pos = [np.asarray([index[str(v)] for v in vals], dtype=np.int32) for _, _, vals, _ in parts]
        values: Any = vocab
    else:
        values, pos = _numeric_vocab([np.asarray(vals) for _, _, vals, _ in parts])
    bounds = np.cumsum([0] + [fwd.size for fwd, _, _, _ in parts])
    ids = np.empty(int(bounds[-1]), dtype=np.int32)

    def fill(k: int) -> None:
        fwd, used, _, card = parts[k]
        table = np.zeros(card, dtype=np.int32)
        table[used] = pos[k]
        np.take(table, fwd, out=ids[bounds[k]:bounds[k + 1]], mode="clip")

    _map_parallel(fill, list(range(len(parts))))
    return Col(stored.name, ids, values)


def _numeric_vocab(parts: List[np.ndarray]) -> Tuple[np.ndarray, List[np.ndarray]]:
    """The sorted distinct values of ``parts`` and each part's int32
    positions in them (``np.unique`` + ``np.searchsorted``).  Integer
    values over a span at most a few times their count take a presence
    bitmap over the span instead: linear time, the same arrays."""
    cat = np.concatenate(parts)
    if cat.size and cat.dtype.kind in "iu":
        lo, hi = int(cat.min()), int(cat.max())
        if hi - lo < 4 * cat.size + 1024:
            present = np.zeros(hi - lo + 1, dtype=bool)
            present[cat - lo] = True
            rank = (np.cumsum(present) - 1).astype(np.int32)
            values = (np.nonzero(present)[0] + lo).astype(cat.dtype)
            return values, [rank[p - lo] for p in parts]
    values = np.unique(cat)
    return values, [np.searchsorted(values, p).astype(np.int32) for p in parts]


# ---------------------------------------------------------------------------
# shared key space + shuffle partition planning
# ---------------------------------------------------------------------------


def shared_key_ids(
    build: SideRows, probe: SideRows
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Map both sides' key ids into ONE merged vocabulary; returns
    (build ids, probe ids, vocab size).  Key stored types must be
    jointly numeric or jointly string."""
    kb, kp, V = _shared_key_maps(build, probe)
    kb_rows = kb[build.key.ids] if build.n else np.zeros(0, np.int32)
    kp_rows = kp[probe.key.ids] if probe.n else np.zeros(0, np.int32)
    return kb_rows, kp_rows, V


def _shared_key_maps(build: SideRows, probe: SideRows) -> Tuple[np.ndarray, np.ndarray, int]:
    """(build key id -> merged id, probe key id -> merged id, vocab size):
    ``shared_key_ids`` before the per-row gather."""
    b_st, p_st = build.key.stored, probe.key.stored
    # an all-empty side (zero matched rows on every server) carries the
    # typeless placeholder key: adopt the live side's type — an empty
    # inner join is a valid empty answer, not a type error
    if build.n == 0 and build.key.card == 0:
        b_st = p_st
    if probe.n == 0 and probe.key.card == 0:
        p_st = b_st
    b_str = b_st == DataType.STRING.name
    p_str = p_st == DataType.STRING.name
    if b_str != p_str:
        raise JoinValidationError(
            f"join key types are incompatible ({p_st} vs {b_st})"
        )
    if b_str:
        vocab = sorted(set(build.key.values) | set(probe.key.values))
        index = {v: i for i, v in enumerate(vocab)}
        kb = np.asarray([index[v] for v in build.key.values], dtype=np.int32)
        kp = np.asarray([index[v] for v in probe.key.values], dtype=np.int32)
    else:
        # integer keys merge in int64 space: a float64 vocabulary would
        # collide distinct 64-bit ids above 2^53 (snowflake-style keys)
        # and silently cross-join unrelated rows
        ints = {DataType.INT.name, DataType.LONG.name}
        dt = np.int64 if b_st in ints and p_st in ints else np.float64
        bv = np.asarray(build.key.values, dtype=dt)
        pv = np.asarray(probe.key.values, dtype=dt)
        vocab = np.unique(np.concatenate([bv, pv]))
        kb = np.searchsorted(vocab, bv).astype(np.int32)
        kp = np.searchsorted(vocab, pv).astype(np.int32)
    return kb, kp, len(vocab)


def _key_hash(ids: np.ndarray) -> np.ndarray:
    return (ids.astype(np.uint64) * _KNUTH) & np.uint64(0xFFFFFFFF)


def plan_shuffle_partitions(
    build: SideRows,
    probe: SideRows,
    n_owners: int,
    split_heavy: bool = True,
    heavy_factor: float = 0.5,
) -> Tuple[List[Tuple[np.ndarray, np.ndarray]], int]:
    """Assign every build/probe row to an owner partition.

    Normal keys route by hash; a HEAVY key — one whose probe-row count
    alone exceeds ``heavy_factor`` x the per-owner mean — would
    hot-spot its hash owner, so its probe rows split round-robin across
    ALL owners and its build rows replicate to all owners (inner-join
    correctness: every probe row still meets every matching build row
    exactly once).  Returns ([(build row idx, probe row idx)] per
    owner, heavy key count)."""
    kb, kp, V = shared_key_ids(build, probe)
    n_owners = max(1, int(n_owners))
    pid_of_key = (_key_hash(np.arange(V, dtype=np.int64)) % n_owners).astype(np.int32)
    probe_counts = np.bincount(kp, minlength=V) if kp.size else np.zeros(V, np.int64)
    mean_rows = max(1.0, probe.n / n_owners)
    heavy = np.zeros(V, dtype=bool)
    if split_heavy and n_owners > 1:
        heavy = probe_counts > heavy_factor * mean_rows
    n_heavy = int(heavy.sum())

    probe_pid = pid_of_key[kp] if kp.size else np.zeros(0, np.int32)
    if n_heavy:
        idx = np.nonzero(heavy[kp])[0]
        probe_pid = probe_pid.copy()
        probe_pid[idx] = (np.arange(idx.size) % n_owners).astype(np.int32)
    build_pid = pid_of_key[kb] if kb.size else np.zeros(0, np.int32)
    heavy_build = np.nonzero(heavy[kb])[0] if kb.size else np.zeros(0, np.int64)

    owners: List[Tuple[np.ndarray, np.ndarray]] = []
    for o in range(n_owners):
        b_idx = np.nonzero((build_pid == o) & ~heavy[kb])[0] if kb.size else np.zeros(0, np.int64)
        if heavy_build.size:
            b_idx = np.concatenate([b_idx, heavy_build])
            b_idx.sort()
        p_idx = np.nonzero(probe_pid == o)[0] if kp.size else np.zeros(0, np.int64)
        owners.append((b_idx, p_idx))
    return owners, n_heavy


# ---------------------------------------------------------------------------
# device join plan + packing
# ---------------------------------------------------------------------------

_SCALAR_AGGS = {"count", "sum", "min", "max", "avg", "minmaxrange"}


def join_group_capacity() -> int:
    """Largest group space the device join takes (``config.JOIN_GROUP_CAP``)."""
    return config.JOIN_GROUP_CAP


@dataclass(frozen=True)
class JoinPlan:
    """Static shape of one device join program (the kernel-cache and
    poison-quarantine key): padded lane counts, the open-addressing
    capacity, and the aggregation spec — never literals or data."""

    n_build_pad: int
    n_probe_pad: int
    cap: int  # hash-table slots (pow2, >= 2x build keys)
    # one entry per aggregation: (kind, side 'p'|'b'|None, value index)
    aggs: Tuple[Tuple[str, Optional[str], int], ...]
    n_groups: int  # 0 = scalar aggregation
    bg_space: int  # build-side group radix multiplier (1 = none)
    n_pv: int  # stacked probe value columns
    n_bv: int  # stacked build value columns


def join_plan_digest(plan: JoinPlan) -> str:
    return hashlib.blake2b(repr(plan).encode(), digest_size=8).hexdigest()


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _numeric(col: Col) -> bool:
    return col.stored != DataType.STRING.name


def build_join_plan(
    request: BrokerRequest, build: SideRows, probe: SideRows, precision: Any = "x64"
) -> Optional[Tuple[JoinPlan, Dict[str, np.ndarray], Dict[str, Any]]]:
    """Device eligibility + input packing.  Returns ``(plan, inputs,
    meta)`` or None when the query must take the host join: selections,
    value-state aggregations (distinct/percentile/HLL), group spaces
    past the holder budget, non-numeric aggregation inputs, build-side
    group columns under duplicate build keys, or probe sizes past the
    per-dispatch row budget.  ``precision`` ("x64" / "x32") sets the
    float width of the packed value streams."""
    spec = request.join
    if not config.JOIN_DEVICE:
        return None  # host-reference mode (differentials / tests)
    if request.selection is not None or not request.aggregations:
        return None
    if build.n == 0 or probe.n == 0:
        return None  # empty side: host path answers trivially (and exactly)
    kb_map, kp_map, _v = _shared_key_maps(build, probe)
    kb = kb_map[build.key.ids]

    gb_cols: List[str] = list(request.group_by.columns) if request.is_group_by else []
    b_group = [c for c in gb_cols if spec.is_right_column(c)]
    p_group = [c for c in gb_cols if not spec.is_right_column(c)]
    keys_unique = np.unique(kb).size == kb.size
    if b_group and not keys_unique:
        # a duplicate build key can carry distinct group values: the
        # per-key pre-aggregation below would conflate them
        return None
    g_space = 1
    for c in gb_cols:
        side = build if spec.is_right_column(c) else probe
        col = side.cols.get(c)
        if col is None:
            return None
        g_space *= max(1, col.card)
    if g_space > join_group_capacity():
        return None

    p_cols: List[str] = []
    b_cols: List[str] = []
    aggs: List[Tuple[str, Optional[str], int]] = []
    for a in request.aggregations:
        base = a.base_function
        if base not in _SCALAR_AGGS or a.is_mv:
            return None
        if a.column == "*":
            aggs.append(("count", None, 0))
            continue
        is_b = spec.is_right_column(a.column)
        side = build if is_b else probe
        col = side.cols.get(a.column)
        if col is None or not _numeric(col):
            return None
        pool = b_cols if is_b else p_cols
        if a.column not in pool:
            pool.append(a.column)
        aggs.append((base, "b" if is_b else "p", pool.index(a.column)))

    from pinot_tpu_torch.engine.kernel import chunk_rows_limit

    n_probe_pad = _pow2(probe.n)
    limit = chunk_rows_limit()
    if limit and n_probe_pad > limit:
        return None

    # -- pack build side: pre-aggregate per unique merged key (host) ---
    uniq_k, inv = np.unique(kb, return_inverse=True)
    U = uniq_k.size
    bcnt = np.bincount(inv, minlength=U).astype(np.int32)
    bg = np.zeros(U, dtype=np.int32)
    bg_space = 1
    # keys_unique holds whenever b_group is non-empty: inv is then a
    # permutation, and argsort(inv)[u] is the one build row of key u
    row_of_key = np.argsort(inv, kind="stable")[:U] if b_group else None
    for c in b_group:
        col = build.cols[c]
        bg = bg * col.card + col.ids[row_of_key]
        bg_space *= col.card
    # f64 under x64 (exact differentials), f32 otherwise
    fdt = config.as_precision(precision).np_float_dtype
    bs = np.zeros((max(1, len(b_cols)), U), dtype=fdt)
    bmn = np.full((max(1, len(b_cols)), U), np.inf, dtype=fdt)
    bmx = np.full((max(1, len(b_cols)), U), -np.inf, dtype=fdt)
    for i, c in enumerate(b_cols):
        vals = build.cols[c].row_values()
        bs[i] = np.bincount(inv, weights=vals, minlength=U).astype(fdt)
        order = np.argsort(inv, kind="stable")
        bounds = np.searchsorted(inv[order], np.arange(U))
        bmn[i] = np.minimum.reduceat(vals[order], bounds).astype(fdt)
        bmx[i] = np.maximum.reduceat(vals[order], bounds).astype(fdt)

    n_build_pad = _pow2(max(U, 1))
    cap = _pow2(max(2 * U, 8))

    def pad1(a: np.ndarray, n: int, fill) -> np.ndarray:
        out = np.full((n,), fill, dtype=a.dtype)
        out[: a.shape[0]] = a
        return out

    def pad2(a: np.ndarray, n: int, fill) -> np.ndarray:
        out = np.full((a.shape[0], n), fill, dtype=a.dtype)
        out[:, : a.shape[1]] = a
        return out

    # the probe streams gather straight into their padded buffers (one
    # pass a stream over the probe rows, which can number tens of millions)
    n = probe.n
    pk = np.empty(n_probe_pad, dtype=np.int32)
    pk[n:] = -1
    _take_into(kp_map, probe.key.ids, pk[:n])
    pg = np.zeros(n_probe_pad, dtype=np.int32)
    for c in p_group:
        col = probe.cols[c]
        pg[:n] *= col.card
        pg[:n] += col.ids
    pv = np.empty((max(1, len(p_cols)), n_probe_pad), dtype=fdt)
    pv[:, n:] = 0.0
    if not p_cols:
        pv[0, :n] = 0.0
    for i, c in enumerate(p_cols):
        col = probe.cols[c]
        _take_into(np.asarray(col.values, dtype=np.float64).astype(fdt), col.ids, pv[i, :n])

    plan = JoinPlan(
        n_build_pad=n_build_pad,
        n_probe_pad=n_probe_pad,
        cap=cap,
        aggs=tuple(aggs),
        n_groups=int(g_space) if gb_cols else 0,
        bg_space=int(bg_space),
        n_pv=max(1, len(p_cols)),
        n_bv=max(1, len(b_cols)),
    )
    inputs = {
        "bk": pad1(uniq_k.astype(np.int32), n_build_pad, -1),
        "bc": pad1(bcnt, n_build_pad, 0),
        "bg": pad1(bg, n_build_pad, 0),
        "bs": pad2(bs, n_build_pad, 0.0),
        "bmn": pad2(bmn, n_build_pad, np.inf),
        "bmx": pad2(bmx, n_build_pad, -np.inf),
        "pk": pk,
        "pg": pg,
        "pv": pv,
    }
    meta = {"p_group": p_group, "b_group": b_group, "gb_cols": gb_cols}
    return plan, inputs, meta


# ---------------------------------------------------------------------------
# finalize: device outputs -> IntermediateResult partials
# ---------------------------------------------------------------------------


def _scalar_from_state(kind: str, state) -> Any:
    if kind == "count":
        return CountPartial(float(state))
    if kind == "sum":
        return SumPartial(float(state))
    if kind == "min":
        return MinPartial(float(state))
    if kind == "max":
        return MaxPartial(float(state))
    if kind == "avg":
        return AvgPartial(float(state[0]), float(state[1]))
    return MinMaxRangePartial(float(state[0]), float(state[1]))


def _group_tuple(
    request: BrokerRequest,
    meta: Dict[str, Any],
    build: SideRows,
    probe: SideRows,
    slot: int,
) -> Tuple[str, ...]:
    """Decode a mixed-radix group slot back to rendered key values, in
    the request's GROUP BY column order."""
    spec = request.join
    gb_cols = meta["gb_cols"]
    cards = []
    for c in gb_cols:
        side = build if spec.is_right_column(c) else probe
        cards.append(max(1, side.cols[c].card))
    # the slot was built probe-major then build-minor? No: pg covers the
    # probe columns in order, bg the build columns in order, and the
    # kernel computes pg * bg_space + bg — so decompose in that layout,
    # then re-emit in the request's column order.
    p_cards = [max(1, probe.cols[c].card) for c in meta["p_group"]]
    b_cards = [max(1, build.cols[c].card) for c in meta["b_group"]]
    bg_space = 1
    for c in b_cards:
        bg_space *= c
    pg, bg = divmod(slot, bg_space) if bg_space > 1 else (slot, 0)
    vids: Dict[str, int] = {}
    rem = pg
    for c, card in zip(reversed(meta["p_group"]), reversed(p_cards)):
        vids[c] = rem % card
        rem //= card
    rem = bg
    for c, card in zip(reversed(meta["b_group"]), reversed(b_cards)):
        vids[c] = rem % card
        rem //= card
    out = []
    for c in gb_cols:
        side = build if spec.is_right_column(c) else probe
        col = side.cols[c]
        out.append(render_value(col.stored_type(), col.py_value(vids[c])))
    return tuple(out)


def finalize_device_join(
    request: BrokerRequest,
    plan: JoinPlan,
    meta: Dict[str, Any],
    build: SideRows,
    probe: SideRows,
    outs: Dict[str, Any],
) -> IntermediateResult:
    joined = int(outs["num_docs"])
    res = IntermediateResult(
        num_docs_scanned=joined,
        num_entries_scanned_post_filter=joined * max(1, len(plan.aggs)),
    )
    if plan.n_groups:
        cnt = np.asarray(outs["gb_cnt"])
        live = np.nonzero(cnt > 0)[0]
        groups: Dict[Tuple[str, ...], list] = {}
        # trim like every other serving path (reference topN*5 semantics)
        if live.size > max(request.group_by.top_n * 5, 100):
            order_vals = []
            for i, (kind, _s, _x) in enumerate(plan.aggs):
                st = outs[f"gb_{i}"]
                if kind == "count":
                    order_vals.append(cnt[live].astype(np.float64))
                elif kind in ("sum", "min", "max"):
                    order_vals.append(np.asarray(st)[live].astype(np.float64))
                elif kind == "avg":
                    with np.errstate(divide="ignore", invalid="ignore"):
                        order_vals.append(
                            np.where(
                                cnt[live] > 0,
                                np.asarray(st[0])[live] / np.maximum(cnt[live], 1),
                                -np.inf,
                            )
                        )
                else:
                    order_vals.append(
                        (np.asarray(st[1])[live] - np.asarray(st[0])[live]).astype(
                            np.float64
                        )
                    )
            keep = trim_group_candidates(
                order_vals,
                [group_sort_ascending(a.function) for a in request.aggregations],
                request.group_by.top_n,
                live.size,
            )
            live = live[keep]
        for slot in live.tolist():
            partials = []
            for i, (kind, _side, _idx) in enumerate(plan.aggs):
                st = outs[f"gb_{i}"]
                if kind == "count":
                    partials.append(CountPartial(float(cnt[slot])))
                elif kind == "avg":
                    partials.append(
                        AvgPartial(float(np.asarray(st[0])[slot]), float(cnt[slot]))
                    )
                elif kind == "minmaxrange":
                    partials.append(
                        MinMaxRangePartial(
                            float(np.asarray(st[0])[slot]),
                            float(np.asarray(st[1])[slot]),
                        )
                    )
                elif kind == "sum":
                    partials.append(SumPartial(float(np.asarray(st)[slot])))
                elif kind == "min":
                    partials.append(MinPartial(float(np.asarray(st)[slot])))
                else:
                    partials.append(MaxPartial(float(np.asarray(st)[slot])))
            groups[_group_tuple(request, meta, build, probe, slot)] = partials
        res.groups = groups
    else:
        res.aggregations = [
            _scalar_from_state(kind, outs[f"agg_{i}"])
            for i, (kind, _side, _idx) in enumerate(plan.aggs)
        ]
    return res


# ---------------------------------------------------------------------------
# exact host join (the reference path every strategy differentials against)
# ---------------------------------------------------------------------------


def _joined_indices(
    build: SideRows, probe: SideRows
) -> Tuple[np.ndarray, np.ndarray]:
    """Inner-join row index pairs: (probe_idx, build_idx), probe-major
    and deterministic (build matches in stable build-row order)."""
    kb, kp, _v = shared_key_ids(build, probe)
    if kb.size == 0 or kp.size == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    order = np.argsort(kb, kind="stable")
    kb_sorted = kb[order]
    lo = np.searchsorted(kb_sorted, kp, side="left")
    hi = np.searchsorted(kb_sorted, kp, side="right")
    counts = (hi - lo).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    probe_idx = np.repeat(np.arange(kp.size, dtype=np.int64), counts)
    offs = np.concatenate(([0], np.cumsum(counts)[:-1])).astype(np.int64)
    take = np.arange(total, dtype=np.int64) - np.repeat(offs, counts) + np.repeat(
        lo.astype(np.int64), counts
    )
    return probe_idx, order[take]


def host_join(
    request: BrokerRequest, build: SideRows, probe: SideRows
) -> IntermediateResult:
    """Exact numpy inner join + aggregation/selection — the correctness
    oracle the device kernel must match byte-identically, and the heal
    target when a join plan poisons."""
    t0 = time.perf_counter()
    res = _host_join_impl(request, build, probe)
    res.add_cost(
        hostMs=round((time.perf_counter() - t0) * 1000, 3),
        bytesScanned=build.nbytes() + probe.nbytes(),
    )
    return res


def _host_join_impl(
    request: BrokerRequest, build: SideRows, probe: SideRows
) -> IntermediateResult:
    spec = request.join
    probe_idx, build_idx = _joined_indices(build, probe)
    joined = int(probe_idx.size)
    res = IntermediateResult(
        num_docs_scanned=joined,
        num_entries_scanned_post_filter=joined * max(1, len(request.aggregations)),
    )

    def col_of(name: str) -> Tuple[Col, np.ndarray]:
        if spec.is_right_column(name):
            return build.cols[name], build_idx
        return probe.cols[name], probe_idx

    def joined_ids(name: str) -> Tuple[Col, np.ndarray]:
        col, idx = col_of(name)
        return col, col.ids[idx]

    def joined_vals(name: str) -> np.ndarray:
        col, ids = joined_ids(name)
        return np.asarray(col.values, dtype=np.float64)[ids]

    # -- selection ----------------------------------------------------
    if request.selection is not None:
        sel = request.selection
        res.selection_columns = list(sel.columns)
        rows: List[Tuple[list, list]] = []
        k = sel.offset + sel.size
        take = np.arange(joined) if sel.sorts else np.arange(min(joined, k))
        cols_py: Dict[str, list] = {}
        for name in {*sel.columns, *(s.column for s in sel.sorts)}:
            col, ids = joined_ids(name)
            cols_py[name] = [col.py_value(int(v)) for v in ids[take]]
        for j in range(take.size):
            sort_vals = [cols_py[s.column][j] for s in sel.sorts]
            rows.append((sort_vals, [cols_py[c][j] for c in sel.columns]))
        res.selection_rows = rows
        return res

    # -- group-by -----------------------------------------------------
    if request.is_group_by:
        res.groups = {}
        gb = request.group_by
        if joined == 0:
            return res
        gcols = [joined_ids(c) for c in gb.columns]
        keys = np.zeros(joined, dtype=np.int64)
        for col, ids in gcols:
            keys = keys * max(1, col.card) + ids
        uniq, inv = np.unique(keys, return_inverse=True)
        k = uniq.size
        counts = np.bincount(inv, minlength=k).astype(np.float64)
        order = None
        bounds = None

        def minmax(vals: np.ndarray):
            nonlocal order, bounds
            if order is None:
                order = np.argsort(inv, kind="stable")
                bounds = np.searchsorted(inv[order], np.arange(k))
            sv = vals[order]
            return (
                np.minimum.reduceat(sv, bounds),
                np.maximum.reduceat(sv, bounds),
            )

        states: List[tuple] = []
        order_vals: List[np.ndarray] = []
        for a in request.aggregations:
            base = a.base_function
            if base == "count":
                states.append(("count", counts))
                order_vals.append(counts)
                continue
            col, ids = joined_ids(a.column)
            if base in ("distinctcount", "distinctcounthll", "fasthll"):
                pair = np.unique(inv.astype(np.int64) * max(1, col.card) + ids)
                pg_ = pair // max(1, col.card)
                pgid = pair % max(1, col.card)
                pbounds = np.searchsorted(pg_, np.arange(k + 1))
                dcounts = np.diff(pbounds).astype(np.float64)
                kind = "distinct" if base == "distinctcount" else "hll"
                states.append((kind, col, pgid, pbounds))
                order_vals.append(dcounts)
                continue
            if base.startswith("percentile"):
                p = int(
                    base[len("percentileest"):]
                    if base.startswith("percentileest")
                    else base[len("percentile"):]
                )
                states.append(("hist", col, ids, p))
                # order by the exact percentile value per group
                vals = np.asarray(col.values, dtype=np.float64)[ids]
                ov = np.zeros(k)
                so = np.lexsort((vals, inv))
                sb = np.searchsorted(inv[so], np.arange(k + 1))
                for gi in range(k):
                    seg = vals[so[sb[gi]:sb[gi + 1]]]
                    n = seg.size
                    ov[gi] = seg[min(int(n * p / 100.0), n - 1)] if n else -np.inf
                order_vals.append(ov)
                continue
            vals = np.asarray(col.values, dtype=np.float64)[ids]
            if base == "sum":
                s = np.bincount(inv, weights=vals, minlength=k)
                states.append(("sum", s))
                order_vals.append(s)
            elif base == "avg":
                s = np.bincount(inv, weights=vals, minlength=k)
                states.append(("avg", s, counts))
                order_vals.append(s / np.maximum(counts, 1))
            else:
                mn, mx = minmax(vals)
                if base == "min":
                    states.append(("min", mn))
                    order_vals.append(mn)
                elif base == "max":
                    states.append(("max", mx))
                    order_vals.append(mx)
                else:
                    states.append(("minmaxrange", mn, mx))
                    order_vals.append(mx - mn)

        keep = trim_group_candidates(
            order_vals,
            [group_sort_ascending(a.function) for a in request.aggregations],
            gb.top_n,
            k,
        )

        def partial(state, i: int):
            kind = state[0]
            if kind == "count":
                return CountPartial(float(state[1][i]))
            if kind == "sum":
                return SumPartial(float(state[1][i]))
            if kind == "min":
                return MinPartial(float(state[1][i]))
            if kind == "max":
                return MaxPartial(float(state[1][i]))
            if kind == "avg":
                return AvgPartial(float(state[1][i]), float(state[2][i]))
            if kind == "minmaxrange":
                return MinMaxRangePartial(float(state[1][i]), float(state[2][i]))
            if kind == "distinct":
                _, col, pgid, pbounds = state
                ids = pgid[pbounds[i]:pbounds[i + 1]]
                vals = {col.py_value(int(v)) for v in ids}
                return DistinctPartial(vals)
            if kind == "hll":
                _, col, pgid, pbounds = state
                ids = pgid[pbounds[i]:pbounds[i + 1]]
                return HllPartial(
                    hll_mod.registers_from_values(
                        [col.py_value(int(v)) for v in ids]
                    )
                )
            # hist
            _, col, ids, p = state
            seg_ids = ids[inv == i]
            vals, cts = np.unique(seg_ids, return_counts=True)
            counts_map = {
                float(np.asarray(col.values, dtype=np.float64)[int(v)]): int(c)
                for v, c in zip(vals, cts)
            }
            return HistogramPartial(counts_map, percentile=p)

        # decompose kept slots -> rendered key tuples
        for i in keep.tolist():
            rem = int(uniq[i])
            vids = []
            for col, _ids in reversed(gcols):
                vids.append(rem % max(1, col.card))
                rem //= max(1, col.card)
            vids.reverse()
            ktup = tuple(
                render_value(col.stored_type(), col.py_value(v))
                for (col, _ids), v in zip(gcols, vids)
            )
            res.groups[ktup] = [partial(st, int(i)) for st in states]
        return res

    # -- plain aggregation --------------------------------------------
    partials = []
    for a in request.aggregations:
        base = a.base_function
        if joined == 0:
            partials.append(make_partial(base))
            continue
        if base == "count":
            partials.append(CountPartial(float(joined)))
            continue
        col, ids = joined_ids(a.column)
        if base in ("distinctcount", "distinctcounthll", "fasthll"):
            uids = np.unique(ids)
            values = [col.py_value(int(v)) for v in uids]
            if base == "distinctcount":
                partials.append(DistinctPartial(set(values)))
            else:
                partials.append(HllPartial(hll_mod.registers_from_values(values)))
            continue
        if base.startswith("percentile"):
            p = int(
                base[len("percentileest"):]
                if base.startswith("percentileest")
                else base[len("percentile"):]
            )
            uids, cts = np.unique(ids, return_counts=True)
            vals = np.asarray(col.values, dtype=np.float64)[uids]
            partials.append(
                HistogramPartial(
                    {float(v): int(c) for v, c in zip(vals, cts)}, percentile=p
                )
            )
            continue
        vals = np.asarray(col.values, dtype=np.float64)[ids]
        if base == "sum":
            partials.append(SumPartial(float(vals.sum())))
        elif base == "avg":
            partials.append(AvgPartial(float(vals.sum()), float(joined)))
        elif base == "min":
            partials.append(MinPartial(float(vals.min())))
        elif base == "max":
            partials.append(MaxPartial(float(vals.max())))
        else:
            partials.append(MinMaxRangePartial(float(vals.min()), float(vals.max())))
    res.aggregations = partials
    return res
