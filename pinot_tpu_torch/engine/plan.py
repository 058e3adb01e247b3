"""Query planning: BrokerRequest -> (StaticPlan, query inputs) — port of
``pinot_tpu.engine.plan`` restricted to single-value filter leaves,
AND/OR trees, scalar and pair aggregations, and single-value group-by.

- **StaticPlan** — a hashable description of the kernel's structure:
  filter tree shape, leaf evaluation kinds, aggregation list, group-by
  strides and capacity.
- **Query inputs** — per-segment data for that structure, computed on
  the host in O(cardinality) per column: dictId intervals, point sets,
  interval unions and match tables, and global-id remap tables.

Leaf evaluation kinds (dictIds are order-preserving, so most predicates
become vector compares):
  docrange    — a RANGE/EQ on a column sorted in every segment is one doc
                interval per segment, found by binary search; the kernel
                never reads the column
  interval    — (fwd >= lo) & (fwd < hi)
  points      — any(fwd == pts[k]) for small IN/EQ sets
  points_none — complement of points (NOT / NOT_IN)
  runs        — union of a few dictId intervals
  table       — bool[card] match table lookup (regex, large IN lists)
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.common.request import (
    BrokerRequest,
    FilterOperator,
    FilterQueryTree,
    RangeSpec,
)
from pinot_tpu_torch.engine import config
from pinot_tpu_torch.engine.config import Precision
from pinot_tpu_torch.engine.context import TableContext
from pinot_tpu_torch.engine.device import StagedTable
from pinot_tpu_torch.segment.dictionary import Dictionary

SV, MV_ANY, MV_NONE = "sv", "mv_any", "mv_none"


@dataclass(frozen=True)
class StaticLeaf:
    column: str
    mode: str  # SV (MV_ANY | MV_NONE: a later slice)
    eval_kind: str = "table"
    k_pad: int = 0  # static points-array length (pow2-padded)


@dataclass(frozen=True)
class StaticAgg:
    func: str  # full function name e.g. "sum"
    base: str  # base function e.g. "sum"
    column: str  # "*" for count(*)
    is_mv: bool
    kind: str  # scalar | pair (presence | hist | hll: a later slice)
    gcard_pad: int = 0
    # read values from the staged raw array instead of dict_vals[fwd]
    use_raw: bool = False
    sort_pairs: bool = False
    hll_from_presence: bool = False


@dataclass(frozen=True)
class StaticGroupBy:
    columns: Tuple[str, ...]
    col_is_mv: Tuple[bool, ...]
    gcards: Tuple[int, ...]  # global cardinalities (strides derive from these)
    capacity: int  # dense holder size = prod(gcards)
    top_n: int
    use_gfwd: Tuple[bool, ...] = ()  # read staged global-id fwd per column


@dataclass(frozen=True)
class StaticPlan:
    # filter tree encoded as nested tuples: ("leaf", i) | ("and"|"or", (...))
    filter_tree: Optional[tuple]
    leaves: Tuple[StaticLeaf, ...]
    aggs: Tuple[StaticAgg, ...]
    group_by: Optional[StaticGroupBy]
    selection: Optional[Any]  # always None: selection is a later slice
    on_device: bool  # False -> the host tier, which this port does not have


def group_capacity(request, ctx) -> int:
    """Dense group-key space: product of the group columns' global
    cardinalities."""
    cap = 1
    for c in request.group_by.columns:
        cap *= max(ctx.column(c).global_cardinality, 1)
    return cap


def group_capacity_forces_host(cap: int, precision: Precision) -> bool:
    return cap > config.MAX_GROUP_CAPACITY or cap > precision.max_key_space


def plan_forced_host(request, ctx, precision: Precision) -> bool:
    """Host-path decisions decidable before staging (for the shapes this
    slice supports: the group space)."""
    try:
        if request.is_group_by:
            return group_capacity_forces_host(group_capacity(request, ctx), precision)
    except KeyError:
        return False  # unknown column: let the normal path raise properly
    return False


def _agg_kind(base: str) -> str:
    if base in ("count", "sum", "min", "max"):
        return "scalar"
    if base in ("avg", "minmaxrange"):
        return "pair"
    if base == "distinctcount":
        return "presence"
    if base in ("distinctcounthll", "fasthll"):
        return "hll"
    if base.startswith("percentile"):
        return "hist"
    raise ValueError(f"unknown aggregation {base!r}")


_MAX_POINTS = 16  # IN lists up to this size evaluate as compares
_MAX_RUNS = 64  # match tables with <= this many dictId runs evaluate as interval unions


def _effective_table(
    leaf_node, mode: str, d: Dictionary, card_pad: int, true_card: int
) -> np.ndarray:
    """The table the kernel would read for this leaf: SV NOT/NOT_IN bakes
    the complement.  Shared by plan-time run counting and input build so
    they can never disagree."""
    t = match_table(leaf_node, d, card_pad)
    if mode == SV and leaf_node.operator in (FilterOperator.NOT, FilterOperator.NOT_IN):
        flipped = np.zeros(card_pad, dtype=bool)
        flipped[:true_card] = ~t[:true_card]
        t = flipped
    return t


def _table_runs(t: np.ndarray):
    """Maximal True runs of a bool table -> [(lo, hi)) dictId ranges."""
    if not t.any():
        return []
    d = np.diff(t.astype(np.int8))
    starts = list(np.nonzero(d == 1)[0] + 1)
    ends = list(np.nonzero(d == -1)[0] + 1)
    if t[0]:
        starts.insert(0, 0)
    if t[-1]:
        ends.append(t.size)
    return list(zip(starts, ends))


def _pad_pow2(k: int) -> int:
    p = 1
    while p < k:
        p *= 2
    return p


def _leaf_eval_kind(node: FilterQueryTree) -> Tuple[str, int]:
    op = node.operator
    if op == FilterOperator.RANGE:
        return "interval", 0
    if op in (FilterOperator.EQUALITY, FilterOperator.IN):
        k = len(node.values)
        if 0 < k <= _MAX_POINTS:
            return "points", _pad_pow2(k)
    if op in (FilterOperator.NOT, FilterOperator.NOT_IN):
        k = len(node.values)
        if 0 < k <= _MAX_POINTS:
            return "points_none", _pad_pow2(k)
    return "table", 0


def build_static_plan(
    request: BrokerRequest,
    ctx: TableContext,
    staged: StagedTable,
    scratch: Optional[Dict[Any, Any]] = None,
) -> StaticPlan:
    """``scratch`` caches plan-time effective match tables for
    ``build_query_inputs`` so a regex never scans a dictionary twice."""
    leaves: List[StaticLeaf] = []

    def encode(node: FilterQueryTree) -> tuple:
        if node.is_leaf:
            # mode from segment metadata, not the staged column: a
            # docrange-only column is dropped from staging entirely
            if not ctx.segments[0].column(node.column).metadata.single_value:
                raise NotImplementedError(
                    f"filter on multi-value column {node.column!r}: MV leaves are "
                    "a later slice of the port"
                )
            mode = SV
            eval_kind, k_pad = _leaf_eval_kind(node)
            if eval_kind == "table":
                # a table that is a few contiguous dictId runs evaluates as
                # an interval union; values-based operators bound their run
                # count by the value count, only regex scans the dictionary
                if node.operator != FilterOperator.REGEX:
                    max_runs = len(node.values) + 1
                else:
                    max_runs = 0
                    for si, seg in enumerate(ctx.segments):
                        stg = staged.column(node.column)
                        t = _effective_table(
                            node, mode, seg.column(node.column).dictionary,
                            stg.card_pad, stg.cards[si],
                        )
                        if scratch is not None:
                            scratch[(id(node), si)] = t
                        max_runs = max(max_runs, len(_table_runs(t)))
                if max_runs <= _MAX_RUNS:
                    eval_kind, k_pad = "runs", _pad_pow2(max(max_runs, 1))
            if (
                eval_kind == "interval"
                or (eval_kind == "points" and len(node.values) == 1
                    and node.operator == FilterOperator.EQUALITY)
            ) and all(seg.column(node.column).metadata.is_sorted for seg in ctx.segments):
                # sorted in every segment: one doc interval per segment
                eval_kind, k_pad = "docrange", 0
            leaves.append(
                StaticLeaf(column=node.column, mode=mode, eval_kind=eval_kind, k_pad=k_pad)
            )
            return ("leaf", len(leaves) - 1)
        op = "and" if node.operator == FilterOperator.AND else "or"
        return (op, tuple(encode(c) for c in node.children))

    tree = encode(request.filter) if request.filter is not None else None

    on_device = True
    aggs: List[StaticAgg] = []
    for a in request.aggregations:
        base = a.base_function
        kind = _agg_kind(base)
        if kind not in ("scalar", "pair"):
            raise NotImplementedError(
                f"aggregation {a.function!r}: value-state aggregations "
                "(distinctcount, percentile, HLL) are the next slice of the port"
            )
        if a.is_mv or (a.column != "*" and not staged.column(a.column).single_value):
            raise NotImplementedError(
                f"aggregation {a.function}({a.column}): MV aggregations are a later slice"
            )
        use_raw = a.column != "*" and staged.column(a.column).raw is not None
        aggs.append(
            StaticAgg(
                func=a.function, base=base, column=a.column, is_mv=False,
                kind=kind, use_raw=use_raw,
            )
        )

    group_by: Optional[StaticGroupBy] = None
    if request.is_group_by:
        cols = tuple(request.group_by.columns)
        for c in cols:
            if not staged.column(c).single_value:
                raise NotImplementedError(
                    f"group-by on multi-value column {c!r}: a later slice of the port"
                )
        gcards = tuple(ctx.column(c).global_cardinality for c in cols)
        cap = group_capacity(request, ctx)
        if group_capacity_forces_host(cap, staged.precision):
            on_device = False
        group_by = StaticGroupBy(
            columns=cols,
            col_is_mv=tuple(False for _ in cols),
            gcards=gcards,
            capacity=int(cap),
            top_n=request.group_by.top_n,
            use_gfwd=tuple(staged.column(c).gfwd is not None for c in cols),
        )

    return StaticPlan(
        filter_tree=tree,
        leaves=tuple(leaves),
        aggs=tuple(aggs),
        group_by=group_by,
        selection=None,
        on_device=on_device,
    )


# ---------------------------------------------------------------------------
# Match tables (host-side predicate evaluation in dictId space)
# ---------------------------------------------------------------------------


def _doc_bound(fwd: np.ndarray, dict_id: int) -> int:
    """First doc index with fwd >= dict_id on a sorted column."""
    if dict_id <= 0:
        return 0
    if np.issubdtype(fwd.dtype, np.integer) and dict_id > int(np.iinfo(fwd.dtype).max):
        return int(fwd.size)
    return int(np.searchsorted(fwd, np.asarray(dict_id, dtype=fwd.dtype), "left"))


def leaf_interval(node: FilterQueryTree, dictionary: Dictionary) -> Tuple[int, int]:
    """Half-open [lo, hi) dictId interval satisfying a RANGE leaf."""
    stored = dictionary.stored_type
    card = dictionary.cardinality
    r = node.range_spec or RangeSpec()
    lo = 0
    hi = card
    if r.lower is not None and r.lower != "*":
        v = stored.convert(r.lower)
        i = dictionary.insertion_index(v)
        if r.include_lower:
            lo = i
        else:
            lo = i + 1 if (i < card and dictionary._eq(dictionary.values[i], v)) else i
    if r.upper is not None and r.upper != "*":
        v = stored.convert(r.upper)
        i = dictionary.insertion_index(v)
        if r.include_upper:
            hi = i + 1 if (i < card and dictionary._eq(dictionary.values[i], v)) else i
        else:
            hi = i
    return lo, max(lo, hi)


def leaf_points(node: FilterQueryTree, dictionary: Dictionary, k_pad: int) -> np.ndarray:
    """dictIds of a small EQ/IN/NOT_IN value set, padded with -1 (which
    never matches a forward index)."""
    stored = dictionary.stored_type
    pts = np.full(k_pad, -1, dtype=np.int32)
    j = 0
    for v in node.values:
        i = dictionary.index_of(stored.convert(v))
        if i >= 0:
            pts[j] = i
            j += 1
    return pts


def match_table(node: FilterQueryTree, dictionary: Dictionary, card_pad: int) -> np.ndarray:
    """bool[card_pad] — True at dictIds whose value satisfies the leaf
    (NOT / NOT_IN: membership of the excluded set; the caller flips)."""
    stored = dictionary.stored_type
    card = dictionary.cardinality
    table = np.zeros(card_pad, dtype=bool)
    op = node.operator
    if op in (FilterOperator.EQUALITY, FilterOperator.IN, FilterOperator.NOT, FilterOperator.NOT_IN):
        for v in node.values:
            i = dictionary.index_of(stored.convert(v))
            if i >= 0:
                table[i] = True
    elif op == FilterOperator.RANGE:
        lo, hi = leaf_interval(node, dictionary)
        if hi > lo:
            table[lo:hi] = True
    elif op == FilterOperator.REGEX:
        pattern = re.compile(node.values[0])
        for i in range(card):
            if pattern.search(str(dictionary.get(i))) is not None:
                table[i] = True
    else:
        raise ValueError(f"unsupported leaf operator {op}")
    return table


# ---------------------------------------------------------------------------
# Query inputs (per-segment arrays, stacked [S, ...])
# ---------------------------------------------------------------------------


def build_query_inputs(
    request: BrokerRequest,
    plan: StaticPlan,
    ctx: TableContext,
    staged: StagedTable,
    scratch: Optional[Dict[Any, Any]] = None,
) -> Dict[str, Any]:
    S = staged.num_segments
    inputs: Dict[str, Any] = {}

    if plan.filter_tree is not None:
        # walk request filter leaves in the same order encode() visited them
        flat_leaves = [n for n in request.filter.walk() if n.is_leaf]
        tables, bounds, points, run_arrays = [], [], [], []
        for leaf_node, leaf_static in zip(flat_leaves, plan.leaves):
            kind = leaf_static.eval_kind
            # dummies keep the input structure identical per plan
            table_e = np.zeros((S, 1), dtype=bool)
            bound_e = np.zeros((S, 2), dtype=np.int32)
            point_e = np.zeros((S, max(leaf_static.k_pad, 1)), dtype=np.int32)
            runs_e = np.zeros(
                (S, max(leaf_static.k_pad, 1) if kind == "runs" else 1, 2), dtype=np.int32
            )
            for i, seg in enumerate(ctx.segments):
                scol = seg.column(leaf_static.column)
                d = scol.dictionary
                if kind == "runs":
                    t = None if scratch is None else scratch.get((id(leaf_node), i))
                    if t is None:
                        stg = staged.column(leaf_static.column)
                        t = _effective_table(
                            leaf_node, leaf_static.mode, d, stg.card_pad, stg.cards[i]
                        )
                    for ri, (lo, hi) in enumerate(_table_runs(t)):
                        runs_e[i, ri] = (lo, hi)
                elif kind == "interval":
                    bound_e[i] = leaf_interval(leaf_node, d)
                elif kind == "docrange":
                    if leaf_node.operator == FilterOperator.EQUALITY:
                        did = d.index_of(d.stored_type.convert(leaf_node.values[0]))
                        lo, hi = (did, did + 1) if did >= 0 else (0, 0)
                    else:
                        lo, hi = leaf_interval(leaf_node, d)
                    bound_e[i] = (_doc_bound(scol.fwd, lo), _doc_bound(scol.fwd, hi))
                elif kind in ("points", "points_none"):
                    point_e[i] = leaf_points(leaf_node, d, leaf_static.k_pad)
                else:
                    col = staged.column(leaf_static.column)
                    if table_e.shape[1] == 1:
                        table_e = np.zeros((S, col.card_pad), dtype=bool)
                    t = None if scratch is None else scratch.get((id(leaf_node), i))
                    if t is None:
                        t = _effective_table(
                            leaf_node, leaf_static.mode, d, col.card_pad, col.cards[i]
                        )
                    table_e[i] = t
            tables.append(table_e)
            bounds.append(bound_e)
            points.append(point_e)
            run_arrays.append(runs_e)
        inputs["match"] = tables
        inputs["bounds"] = bounds
        inputs["pts"] = points
        inputs["runs"] = run_arrays

    inputs["agg_aux"] = [{} for _ in plan.aggs]  # scalar/pair aggs need no tables

    # group-by remaps (dummy entry when the staged gfwd array is used)
    if plan.group_by is not None and plan.on_device:
        inputs["group_remap"] = [
            np.zeros((S, 1), dtype=np.int32) if use_g else _stacked_remap(ctx, staged, c)
            for c, use_g in zip(plan.group_by.columns, plan.group_by.use_gfwd)
        ]
    return inputs


def _stacked_remap(ctx: TableContext, staged: StagedTable, column: str) -> np.ndarray:
    col = staged.column(column)
    out = np.zeros((staged.num_segments, col.card_pad), dtype=np.int32)
    for i, remap in enumerate(ctx.column(column).remaps):
        out[i, : remap.size] = remap
    return out
