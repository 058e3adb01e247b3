"""Internal query request model — the BrokerRequest equivalent.

The reference models a parsed query as a Thrift ``BrokerRequest``
(pinot-common ``src/thrift/request.thrift``): querySource, a filter query
tree, aggregationsInfo, groupBy, selections, plus per-query flags
(enableTrace, debugOptions, queryOptions).  Here the same information is
plain dataclasses — there is no cross-language wire concern for the parsed
form; the serialized wire format between broker and server is the
DataTable/JSON layer (see ``common/datatable.py`` and ``transport/``).

Filter trees use the reference's operator vocabulary
(``FilterOperator``: AND, OR, EQUALITY, NOT, RANGE, REGEX, NOT_IN, IN —
request.thrift enum), but ranges are structured (lower/upper/inclusive)
instead of Pinot's encoded "[a\\t\\tb]" strings.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple


class FilterOperator(str, Enum):
    AND = "AND"
    OR = "OR"
    EQUALITY = "EQUALITY"
    NOT = "NOT"  # not-equal in the reference ("<>")
    RANGE = "RANGE"
    REGEX = "REGEX"
    NOT_IN = "NOT_IN"
    IN = "IN"


# Sentinel for unbounded range ends (reference uses "*").
UNBOUNDED = "*"


@dataclass
class RangeSpec:
    """Structured range predicate: lower/upper bounds with inclusivity.

    ``None`` bound = unbounded (reference encodes as "*",
    pinot-core predicate evaluators parse "[lo\\t\\thi]" strings).
    """

    lower: Optional[str] = None
    upper: Optional[str] = None
    include_lower: bool = True
    include_upper: bool = True

    def to_json(self) -> Dict[str, Any]:
        return {
            "lower": self.lower,
            "upper": self.upper,
            "includeLower": self.include_lower,
            "includeUpper": self.include_upper,
        }


@dataclass
class FilterQueryTree:
    """Filter tree node (reference: FilterQueryTree in pinot-common
    ``common/utils/request/FilterQueryTree.java``).

    Leaves carry (column, operator, values|range); internal nodes are
    AND/OR over children.
    """

    operator: FilterOperator
    column: Optional[str] = None
    values: List[str] = field(default_factory=list)
    range_spec: Optional[RangeSpec] = None
    children: List["FilterQueryTree"] = field(default_factory=list)

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"operator": self.operator.value}
        if self.column is not None:
            d["column"] = self.column
        if self.values:
            d["values"] = list(self.values)
        if self.range_spec is not None:
            d["range"] = self.range_spec.to_json()
        if self.children:
            d["children"] = [c.to_json() for c in self.children]
        return d

    def __repr__(self) -> str:  # compact for debugging
        if self.is_leaf:
            if self.operator == FilterOperator.RANGE and self.range_spec is not None:
                r = self.range_spec
                lo = "(" if not r.include_lower else "["
                hi = ")" if not r.include_upper else "]"
                return f"{self.column} RANGE {lo}{r.lower},{r.upper}{hi}"
            return f"{self.column} {self.operator.value} {self.values}"
        inner = f" {self.operator.value} ".join(repr(c) for c in self.children)
        return f"({inner})"


# Aggregation function names supported by the engine — superset naming of
# AggregationFunctionFactory.java:25-58 (count/min/max/sum/avg/minmaxrange/
# distinctcount/distinctcounthll/fasthll/percentileNN/percentileestNN + MV).
SV_AGGREGATION_FUNCTIONS = (
    "count",
    "min",
    "max",
    "sum",
    "avg",
    "minmaxrange",
    "distinctcount",
    "distinctcounthll",
    "fasthll",
    "percentile50",
    "percentile90",
    "percentile95",
    "percentile99",
    "percentileest50",
    "percentileest90",
    "percentileest95",
    "percentileest99",
)
MV_AGGREGATION_FUNCTIONS = tuple(f + "mv" for f in SV_AGGREGATION_FUNCTIONS)
AGGREGATION_FUNCTIONS = SV_AGGREGATION_FUNCTIONS + MV_AGGREGATION_FUNCTIONS


def group_sort_ascending(function: str) -> bool:
    """Group-by results for min (and minMV) sort ascending; every other
    function — including minmaxrange — sorts descending.  Mirrors
    AggregationGroupByOperatorService.java:52,146: the trim comparator
    reverses only when getFunctionName() starts with "min_", which is
    true for min_<col> (the registry maps minmv there too) but NOT for
    minMaxRange_<col>."""
    return function in ("min", "minmv")


@dataclass
class AggregationInfo:
    """One aggregation call, e.g. sum(runs) (request.thrift AggregationInfo)."""

    function: str  # lower-cased, e.g. "sum", "distinctcounthll", "summv"
    column: str  # "*" for count(*)

    def __post_init__(self) -> None:
        self.function = self.function.lower()

    @property
    def is_mv(self) -> bool:
        return self.function.endswith("mv")

    @property
    def base_function(self) -> str:
        return self.function[:-2] if self.is_mv else self.function

    @property
    def display_name(self) -> str:
        """Response column name, reference style: ``sum_runs`` / ``count_star``."""
        col = "star" if self.column == "*" else self.column
        return f"{self.function}_{col}"


@dataclass
class GroupBy:
    columns: List[str] = field(default_factory=list)
    top_n: int = 10  # reference default TOP 10


@dataclass
class SelectionSort:
    column: str
    ascending: bool = True


@dataclass
class Selection:
    columns: List[str] = field(default_factory=list)  # ["*"] = all
    sorts: List[SelectionSort] = field(default_factory=list)
    offset: int = 0
    size: int = 10  # reference default LIMIT 10


@dataclass
class HavingSpec:
    """HAVING predicate over aggregation results (PQL2.g4 havingClause)."""

    function: str
    column: str
    operator: str  # '=', '<>', '<', '>', '<=', '>='
    value: float


@dataclass
class JoinSpec:
    """Two-table INNER equi-join (``FROM a JOIN b ON a.k = b.k``).

    The LEFT table (``BrokerRequest.table_name``) is the probe/fact
    side; the RIGHT table is the build/dimension side.  Column
    references are resolved at parse time: left-side columns are stored
    UNQUALIFIED everywhere in the request (filter tree, aggregations,
    group-by, selection), right-side columns as
    ``"<right_table>.<col>"`` — the raw right TABLE name, not the query
    alias, so two aliases of the same semantic query share a plan
    shape.  ``left_key``/``right_key`` are plain column names on their
    own sides.  The reference (Pinot v0.016) had no join support at
    all — see PARITY.md."""

    right_table: str
    left_key: str
    right_key: str

    def right_prefix(self) -> str:
        return self.right_table + "."


@dataclass
class BrokerRequest:
    table_name: str
    filter: Optional[FilterQueryTree] = None
    aggregations: List[AggregationInfo] = field(default_factory=list)
    group_by: Optional[GroupBy] = None
    selection: Optional[Selection] = None
    having: Optional[HavingSpec] = None
    # two-table equi-join (broker-planned; engine/join.py executes) —
    # None for the single-table queries the reference supported
    join: Optional[JoinSpec] = None
    enable_trace: bool = False
    query_options: Dict[str, str] = field(default_factory=dict)
    debug_options: Dict[str, str] = field(default_factory=dict)
    # introspection mode from an EXPLAIN prefix: None (execute),
    # "plan" (return the physical plan, NO execution), or "analyze"
    # (execute AND annotate the plan with actuals).  Rides the wire
    # inside the PQL text itself, so servers re-derive it on re-parse.
    explain: Optional[str] = None

    @property
    def is_aggregation(self) -> bool:
        return bool(self.aggregations)

    @property
    def is_group_by(self) -> bool:
        return self.group_by is not None and bool(self.group_by.columns)

    @property
    def is_selection(self) -> bool:
        return not self.aggregations

    def referenced_columns(self) -> List[str]:
        """All physical columns the query touches (for pruning)."""
        cols: List[str] = []

        def add(c: Optional[str]) -> None:
            if c and c != "*" and c not in cols:
                cols.append(c)

        if self.filter is not None:
            for node in self.filter.walk():
                add(node.column)
        for agg in self.aggregations:
            add(agg.column)
        if self.group_by:
            for c in self.group_by.columns:
                add(c)
        if self.selection:
            for c in self.selection.columns:
                add(c)
            for s in self.selection.sorts:
                add(s.column)
        return cols
