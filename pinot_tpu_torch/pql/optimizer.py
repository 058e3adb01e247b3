"""Filter-tree optimizers, mirroring the reference broker's rewrites.

Reference: pinot-transport ``requestHandler/BrokerRequestOptimizer.java``
with ``FlattenNestedPredicatesFilterQueryTreeOptimizer.java`` and
``MultipleOrEqualitiesToInClauseFilterQueryTreeOptimizer.java``.

1. Flatten nested AND(AND(...)) / OR(OR(...)) into a single level.
2. Collapse OR of EQUALITY/IN on the same column into one IN clause
   (single-value IN degenerates back to EQUALITY).
"""
from __future__ import annotations

from typing import List, Optional

from pinot_tpu_torch.common.request import BrokerRequest, FilterOperator, FilterQueryTree
from pinot_tpu_torch.pql.parser import PqlParseError


def flatten(tree: FilterQueryTree) -> FilterQueryTree:
    if tree.is_leaf:
        return tree
    new_children: List[FilterQueryTree] = []
    for child in tree.children:
        c = flatten(child)
        if c.operator == tree.operator and not c.is_leaf:
            new_children.extend(c.children)
        else:
            new_children.append(c)
    if len(new_children) == 1:
        return new_children[0]
    return FilterQueryTree(operator=tree.operator, children=new_children)


def or_equalities_to_in(tree: FilterQueryTree) -> FilterQueryTree:
    if tree.is_leaf:
        return tree
    children = [or_equalities_to_in(c) for c in tree.children]
    if tree.operator != FilterOperator.OR:
        return FilterQueryTree(operator=tree.operator, children=children)

    # Gather EQUALITY/IN leaves per column; keep everything else as-is.
    by_column: dict = {}
    others: List[FilterQueryTree] = []
    for c in children:
        if c.is_leaf and c.operator in (FilterOperator.EQUALITY, FilterOperator.IN) and c.column:
            by_column.setdefault(c.column, [])
            for v in c.values:
                if v not in by_column[c.column]:
                    by_column[c.column].append(v)
        else:
            others.append(c)

    merged: List[FilterQueryTree] = []
    for col, vals in by_column.items():
        if len(vals) == 1:
            merged.append(FilterQueryTree(operator=FilterOperator.EQUALITY, column=col, values=vals))
        else:
            merged.append(FilterQueryTree(operator=FilterOperator.IN, column=col, values=vals))

    out = merged + others
    if len(out) == 1:
        return out[0]
    return FilterQueryTree(operator=FilterOperator.OR, children=out)


class InvalidQueryOptionsError(PqlParseError):
    """Bad per-query options (e.g. malformed ``optimizationFlags``) —
    a client error, distinct from internal ValueErrors so the broker
    can report it as PQL_PARSING without masking engine bugs (ADVICE
    r1: broker.py bare-ValueError catch)."""


class OptimizationFlags:
    """Per-query optimizer toggles from the ``optimizationFlags`` debug
    option (``requestHandler/OptimizationFlags.java``): a comma list of
    names each prefixed ``+`` (enable — disabling all others) or ``-``
    (disable that one); mixing both is an error, as in the reference."""

    def __init__(self, enabled: set, disabled: set) -> None:
        if enabled and disabled:
            raise InvalidQueryOptionsError(
                "cannot exclude and include optimizations at the same time"
            )
        self._enabled = enabled
        self._disabled = disabled

    def is_enabled(self, name: str) -> bool:
        if self._enabled:
            return name in self._enabled
        return name not in self._disabled

    @staticmethod
    def from_debug_options(debug_options) -> Optional["OptimizationFlags"]:
        s = (debug_options or {}).get("optimizationFlags", "")
        if not s:
            return None
        enabled: set = set()
        disabled: set = set()
        for opt in (o.strip() for o in s.split(",")):
            if not opt:
                continue
            if opt[0] == "+":
                enabled.add(opt[1:])
            elif opt[0] == "-":
                disabled.add(opt[1:])
            else:
                raise InvalidQueryOptionsError(
                    f"optimization flag {opt!r} must be prefixed with + or -"
                )
        return OptimizationFlags(enabled, disabled)


def optimize_filter(
    tree: Optional[FilterQueryTree], flags: Optional[OptimizationFlags] = None
) -> Optional[FilterQueryTree]:
    if tree is None:
        return None
    flatten_on = flags is None or flags.is_enabled("flattenNestedPredicates")
    if flatten_on:
        tree = flatten(tree)
    if flags is None or flags.is_enabled("multipleOrEqualitiesToInClause"):
        tree = or_equalities_to_in(tree)
        if flatten_on:
            tree = flatten(tree)
    return tree


def optimize_request(request: BrokerRequest) -> BrokerRequest:
    if request.having is not None:
        # HAVING must name a selected aggregation — silently ignoring
        # an unmatched predicate would return unfiltered groups
        h = request.having
        if not any(
            h.function == a.function and (h.column == a.column or h.column == "*")
            for a in request.aggregations
        ):
            from pinot_tpu_torch.pql.parser import PqlParseError

            raise PqlParseError(
                f"HAVING references {h.function}({h.column}), which is not "
                "in the SELECT aggregation list"
            )
    flags = OptimizationFlags.from_debug_options(request.debug_options)
    request.filter = optimize_filter(request.filter, flags)
    return request
