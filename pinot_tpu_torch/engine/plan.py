"""Query planning: BrokerRequest -> (StaticPlan, query inputs) — port of
``pinot_tpu.engine.plan``: filter trees of single- and multi-value
leaves, group-by over single- and multi-value columns, scalar, pair and
value-state (distinctcount, percentile, HLL) aggregations, their MV
forms, and selections.

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

Leaf modes:
  SV      — mask = match(fwd)
  MV_ANY  — mask = any(match(mv) & entry valid)     (positive predicates)
  MV_NONE — mask = ~any(member(mv) & entry valid)   (NOT / NOT_IN: the
            table or points hold the excluded set, the kernel negates
            after the any)

Value-state aggregations keep a dense holder per group: presence bits or
a histogram over the column's global dictionary (``gcard_pad`` wide), or
``HLL_M`` registers.  Holders too big for the dense path take the
sort-dedup (group slot, valueId) pairs instead (``sort_pairs``).

A selection (``StaticSelection``) keeps per segment the ``k = offset +
size`` first docs in sort order: one packed integer key when the radix
product of the sort columns' global cardinalities fits the precision's
key space, else a lexicographic sort over one ordinal per column.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

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
from pinot_tpu_torch.engine.hll import dictionary_tables
from pinot_tpu_torch.engine.kernels import fused_groupby
from pinot_tpu_torch.segment.dictionary import Dictionary

SV, MV_ANY, MV_NONE = "sv", "mv_any", "mv_none"


@dataclass(frozen=True)
class StaticLeaf:
    column: str
    mode: str  # SV | MV_ANY | MV_NONE
    eval_kind: str = "table"
    k_pad: int = 0  # static points-array length (pow2-padded)


@dataclass(frozen=True)
class StaticAgg:
    func: str  # full function name e.g. "sum"
    base: str  # base function e.g. "sum"
    column: str  # "*" for count(*)
    # reads every entry of an MV column; an ``…mv`` function over a
    # single-value column reads its one value a row, the SV plan
    is_mv: bool
    kind: str  # scalar | pair | presence | hist | hll
    gcard_pad: int = 0  # value-state holder width (padded global cardinality)
    # read values from the staged raw array instead of dict_vals[fwd]
    use_raw: bool = False
    # exact distinct / percentile / HLL through a sort-dedup of (group
    # slot, valueId) pairs instead of the dense [capacity, gcard_pad] holder
    sort_pairs: bool = False
    # an SV HLL over a modest global dictionary computes presence over
    # global value ids; the finalize hashes the present values into
    # registers (registers depend only on the distinct value set)
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
class StaticSelection:
    columns: Tuple[str, ...]
    sort_columns: Tuple[str, ...]
    sort_ascending: Tuple[bool, ...]
    sort_gcards: Tuple[int, ...]  # global cards = composite-key radices
    k: int  # per-segment candidates = offset + size
    # True -> the sort key packs into one integer (radix product fits the
    # key space); False -> lexicographic sort over one ordinal per column
    packed: bool = True
    use_gfwd: Tuple[bool, ...] = ()  # per sort column, as StaticGroupBy


@dataclass(frozen=True)
class StaticPlan:
    # filter tree encoded as nested tuples: ("leaf", i) | ("and"|"or", (...))
    filter_tree: Optional[tuple]
    leaves: Tuple[StaticLeaf, ...]
    aggs: Tuple[StaticAgg, ...]
    group_by: Optional[StaticGroupBy]
    selection: Optional[StaticSelection]
    on_device: bool  # False -> the host tier (``host_fallback.execute_host``)


def group_capacity(request, ctx) -> int:
    """Dense group-key space: product of the group columns' global
    cardinalities."""
    cap = 1
    for c in request.group_by.columns:
        cap *= max(ctx.column(c).global_cardinality, 1)
    return cap


# MV group-by: at most this many expanded keys per row on the device
MAX_GROUP_EXPANSION = 64

# K1 and K2 bound a segment's rows by an int32 (``num_docs * E * M`` over
# a flattened pair space): a wider segment stream runs on the host
MAX_SEGMENT_PAIRS = fused_groupby.MAX_ROWS


def group_capacity_forces_host(cap: int, precision: Precision) -> bool:
    return cap > config.MAX_GROUP_CAPACITY or cap > precision.max_key_space


def value_state_sort_pairs(kind: str, gcard_pad: int, cap: Optional[int]) -> bool:
    """Whether a value-state agg (presence/hist/hll) leaves the dense
    holder for the pair-sort path: per-agg state too big, or (grouped)
    the [capacity, state] product too big.  Shared by build_static_plan
    and plan_forced_host so the two can never drift."""
    if kind in ("presence", "hist") and gcard_pad > config.MAX_VALUE_STATE:
        return True
    if cap is not None:
        state = gcard_pad if kind != "hll" else config.HLL_M
        return cap * state > config.MAX_VALUE_STATE * 4
    return False


def plan_forced_host(request, ctx, precision: Precision) -> bool:
    """Host-path decisions decidable before staging — a subset of the
    ``on_device = False`` conditions of ``build_static_plan`` (via the
    same shared predicates), so a query that could only run on the host
    never pays device staging."""
    try:
        cap = group_capacity(request, ctx) if request.is_group_by else None
        if cap is not None and group_capacity_forces_host(cap, precision):
            return True
        if request.filter is None:
            for a in request.aggregations:
                if a.column == "*":
                    continue
                kind = _agg_kind(a.base_function)
                if kind not in ("presence", "hist"):
                    continue
                gcard = ctx.column(a.column).global_cardinality
                if gcard <= config.DISTINCT_PAIR_CAP:
                    continue
                # with no filter every dictionary entry lands in >= 1
                # (group, valueId) pair: a sort-pairs agg at this
                # cardinality would overflow the device pair buffer
                if value_state_sort_pairs(kind, config.pad_value_card(gcard), cap):
                    return True
    except KeyError:
        return False  # unknown column: let the normal path raise properly
    return False


def hll_lowers_to_presence(request, ctx, column: str) -> bool:
    """Whether an SV distinctcounthll lowers to a presence holder over
    global value ids (see ``StaticAgg.hll_from_presence``).  Shared by the
    planner and the executor's staging-role decision (gfwd stream vs
    per-row HLL streams): the two must agree or the kernel reads missing
    arrays.

    Presence wins when the per-group value state (gcard_pad) is no wider
    than the direct register state (HLL_M * 64 rho lanes); the dense
    holder must also fit the cap the presence guard applies."""
    gcard_pad = config.pad_value_card(ctx.column(column).global_cardinality)
    if gcard_pad > config.HLL_M * 64:
        return False
    cap = 1
    if request.is_group_by:
        for c in request.group_by.columns:
            cap *= max(ctx.column(c).global_cardinality, 1)
    return cap * gcard_pad <= config.MAX_VALUE_STATE * 4


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
            if ctx.segments[0].column(node.column).metadata.single_value:
                mode = SV
            elif node.operator in (FilterOperator.NOT, FilterOperator.NOT_IN):
                mode = MV_NONE
            else:
                mode = MV_ANY
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
            if mode == SV and (
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
    # the recursive closure holds itself through its cell: dropping it
    # breaks the cycle, which would keep ``staged`` (and its tensors on the
    # card) alive after a demotion until the garbage collector ran
    del encode

    on_device = True
    aggs: List[StaticAgg] = []
    for a in request.aggregations:
        base = a.base_function
        kind = _agg_kind(base)
        # an MV column makes every function over it an MV one; an ``…mv``
        # function over an SV column is its SV plan (one entry a row)
        is_mv = a.column != "*" and not staged.column(a.column).single_value
        gcard_pad = 0
        hll_from_presence = False
        if (kind == "hll" and a.column != "*" and not is_mv
                and hll_lowers_to_presence(request, ctx, a.column)):
            kind = "presence"
            hll_from_presence = True
        if kind in ("presence", "hist"):
            gcard_pad = config.pad_value_card(ctx.column(a.column).global_cardinality)
        use_raw = a.column != "*" and not is_mv and staged.column(a.column).raw is not None
        aggs.append(
            StaticAgg(
                func=a.function, base=base, column=a.column, is_mv=is_mv,
                kind=kind, gcard_pad=gcard_pad, use_raw=use_raw,
                sort_pairs=value_state_sort_pairs(kind, gcard_pad, None),
                hll_from_presence=hll_from_presence,
            )
        )

    group_by: Optional[StaticGroupBy] = None
    if request.is_group_by:
        cols = tuple(request.group_by.columns)
        col_is_mv = tuple(not staged.column(c).single_value for c in cols)
        gcards = tuple(ctx.column(c).global_cardinality for c in cols)
        cap = group_capacity(request, ctx)
        if group_capacity_forces_host(cap, staged.precision):
            on_device = False
        # value-state aggs need [capacity, state] holders: past the cap on
        # the product every kind sorts pairs instead (presence dedups,
        # hist counts runs, hll packs (bucket, rho) into the pair gid)
        for ai, a in enumerate(aggs):
            if a.kind in ("presence", "hist", "hll") and value_state_sort_pairs(
                a.kind, a.gcard_pad, cap
            ):
                aggs[ai] = replace(a, sort_pairs=True)
        for a in aggs:
            # the hll_from_presence finalize reads only the dense holder
            # (hll_lowers_to_presence admits exactly the shapes it keeps)
            assert not (a.hll_from_presence and a.sort_pairs), a
        group_by = StaticGroupBy(
            columns=cols,
            col_is_mv=col_is_mv,
            gcards=gcards,
            capacity=int(cap),
            top_n=request.group_by.top_n,
            use_gfwd=tuple(
                not mv and staged.column(c).gfwd is not None for c, mv in zip(cols, col_is_mv)
            ),
        )
        # each row adds to the group of each of its entries' key: past
        # MAX_GROUP_EXPANSION keys a row, the host tier
        if group_expansion(group_by, staged) > MAX_GROUP_EXPANSION:
            on_device = False
    if segment_pairs(aggs, group_by, staged) > MAX_SEGMENT_PAIRS:
        on_device = False

    # guaranteed pair overflow: the global dictionary holds only values
    # present in the data, so with no filter every entry lands in >= 1
    # (group, valueId) pair -- more unique pairs than the device buffer
    # returns (the same condition plan_forced_host applies)
    if request.filter is None:
        for a in aggs:
            if (
                a.sort_pairs
                and a.kind in ("presence", "hist")
                and ctx.column(a.column).global_cardinality > config.DISTINCT_PAIR_CAP
            ):
                on_device = False

    selection: Optional[StaticSelection] = None
    if request.is_selection:
        sel = request.selection
        sort_cols = tuple(s.column for s in sel.sorts)
        sort_gcards = tuple(max(ctx.column(c).global_cardinality, 1) for c in sort_cols)
        space = 1
        for g in sort_gcards:
            space *= g
        selection = StaticSelection(
            columns=tuple(sel.columns) if sel.columns and sel.columns != ["*"] else ("*",),
            sort_columns=sort_cols,
            sort_ascending=tuple(s.ascending for s in sel.sorts),
            sort_gcards=sort_gcards,
            k=int(min(sel.offset + sel.size, staged.n_pad)),
            packed=space <= staged.precision.max_key_space,
            use_gfwd=tuple(staged.column(c).gfwd is not None for c in sort_cols),
        )

    return StaticPlan(
        filter_tree=tree,
        leaves=tuple(leaves),
        aggs=tuple(aggs),
        group_by=group_by,
        selection=selection,
        on_device=on_device,
    )


def group_expansion(group_by: StaticGroupBy, staged: StagedTable) -> int:
    """E, the keys a row expands to: the product of the MV group columns'
    ``mv_pad`` (1 with none)."""
    e = 1
    for c, mv in zip(group_by.columns, group_by.col_is_mv):
        if mv:
            e *= staged.column(c).mv_pad
    return e


def segment_pairs(aggs: Sequence[StaticAgg], group_by: Optional[StaticGroupBy],
                  staged: StagedTable) -> int:
    """The widest per-segment stream the kernels walk: ``n_pad * E * M``,
    E the group expansion, M the largest ``mv_pad`` of an MV value-state
    column (``kernel._Flat``)."""
    e = group_expansion(group_by, staged) if group_by is not None else 1
    m = max((staged.column(a.column).mv_pad for a in aggs
             if a.is_mv and a.kind in ("presence", "hist", "hll")), default=1)
    return staged.n_pad * e * m


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


# regex tables are the one plan-time cost that scans a dictionary (re over
# every value); identical regex leaves across queries hit this LRU
# instead, keyed by segment identity so a reload cannot alias
# (pinot_tpu/engine/plan.py:245-266).  The scheduler's workers share it.
_regex_tables: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
_regex_lock = threading.Lock()


def cached_match_table(
    leaf_node: FilterQueryTree, d: Dictionary, card_pad: int, cache_key: Optional[tuple]
) -> np.ndarray:
    """``match_table`` with the regex LRU in front (the postings tier's
    tables; regex is the only operator whose table scans the dictionary)."""
    if cache_key is None or leaf_node.operator != FilterOperator.REGEX:
        return match_table(leaf_node, d, card_pad)
    key = ("raw", cache_key, card_pad, tuple(leaf_node.values))
    with _regex_lock:
        cached = _regex_tables.get(key)
        if cached is not None:
            _regex_tables.move_to_end(key)
            return cached
    t = match_table(leaf_node, d, card_pad)
    with _regex_lock:
        _regex_tables[key] = t
        if len(_regex_tables) > 256:
            _regex_tables.popitem(last=False)
    return t


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

    # per-agg auxiliary tables
    agg_aux: List[Dict[str, np.ndarray]] = []
    for a in plan.aggs:
        aux: Dict[str, np.ndarray] = {}
        if a.kind in ("presence", "hist"):
            # SV presence/hist read the staged .gfwd stream (kernel
            # _value_inputs); the remap table would be dead H2D weight
            if staged.column(a.column).gfwd is not None:
                aux["remap"] = np.zeros((S, 1), dtype=np.int32)
            else:
                aux["remap"] = _stacked_remap(ctx, staged, a.column)
        elif a.kind == "hll":
            if staged.column(a.column).hll_bucket is not None:
                # staged per-row streams: the tables would be dead H2D
                aux["bucket"] = np.zeros((S, 1), dtype=np.int32)
                aux["rho"] = np.zeros((S, 1), dtype=np.int32)
            else:
                aux["bucket"], aux["rho"] = _hll_tables(ctx, staged, a.column)
        agg_aux.append(aux)
    inputs["agg_aux"] = agg_aux

    # group-by and sort-column remaps (dummy entry when the staged gfwd
    # array is used)
    if plan.group_by is not None and plan.on_device:
        inputs["group_remap"] = [
            np.zeros((S, 1), dtype=np.int32) if use_g else _stacked_remap(ctx, staged, c)
            for c, use_g in zip(plan.group_by.columns, plan.group_by.use_gfwd)
        ]
    if plan.selection is not None and plan.selection.sort_columns:
        inputs["sel_remap"] = [
            np.zeros((S, 1), dtype=np.int32) if use_g else _stacked_remap(ctx, staged, c)
            for c, use_g in zip(plan.selection.sort_columns, plan.selection.use_gfwd)
        ]
    return inputs


def _stacked_remap(ctx: TableContext, staged: StagedTable, column: str) -> np.ndarray:
    col = staged.column(column)
    out = np.zeros((staged.num_segments, col.card_pad), dtype=np.int32)
    for i, remap in enumerate(ctx.column(column).remaps):
        out[i, : remap.size] = remap
    return out


def _hll_tables(ctx: TableContext, staged: StagedTable, column: str):
    """Per-dictId (bucket, rho) tables: the HLL hash work happens once
    per dictionary entry on the host; the device only gathers them."""
    col = staged.column(column)
    S = staged.num_segments
    bucket = np.zeros((S, col.card_pad), dtype=np.int32)
    rho = np.zeros((S, col.card_pad), dtype=np.int32)
    for i, seg in enumerate(ctx.segments):
        bt, rt = dictionary_tables(seg.column(column).dictionary)
        bucket[i, : bt.size] = bt
        rho[i, : rt.size] = rt
    return bucket, rho
