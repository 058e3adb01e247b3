"""Plan-shape digest: the workload-introspection key (copy of
``pinot_tpu.engine.plandigest``).

A *plan shape* is a query with its literals erased: the table (logical
— physical ``_OFFLINE``/``_REALTIME`` suffixes stripped so broker and
server agree), the filter tree's (column, operator) structure, the
aggregation list, group-by columns + topN, and the selection's
columns/sorts/limit.  Two queries that differ only in filter literals
(``dimInt > 40`` vs ``dimInt > 90``) share a digest — exactly the
equivalence class the ROADMAP's cross-query batched serving needs
("batch same-plan-shape queries with different literals into one
vmapped launch"), and the granularity at which the PlanStatsStore
(``utils/planstats.py``) accumulates frequency/latency/cost.

This is deliberately a LEVEL ABOVE ``engine/dispatch.plan_digest``:
that one digests the compiled ``StaticPlan`` (literal-bucketed device
program identity — the jit-cache / poison-quarantine key); this one
digests the request shape (workload identity).  EXPLAIN reports both
(``planDigest`` vs ``device.planDigest``).
"""
from __future__ import annotations

import hashlib
from typing import Optional, Tuple

from pinot_tpu_torch.common.request import BrokerRequest, FilterQueryTree

_PHYSICAL_SUFFIXES = ("_OFFLINE", "_REALTIME")


def _raw_table(table: str) -> str:
    for suffix in _PHYSICAL_SUFFIXES:
        if table.endswith(suffix):
            return table[: -len(suffix)]
    return table


def _filter_shape(node: Optional[FilterQueryTree]) -> Optional[tuple]:
    if node is None:
        return None
    if node.is_leaf:
        # literals erased: only (column, operator) — a RANGE keeps no
        # bound values, an IN keeps no list (nor its length: the planner
        # buckets k_pad anyway, and ``x IN (1,2)`` vs ``x IN (3,4,5)``
        # is the same workload shape)
        return (node.column, node.operator.value)
    return (node.operator.value, tuple(_filter_shape(c) for c in node.children))


def plan_shape(request: BrokerRequest) -> tuple:
    """The hashable literal-erased shape tuple (deterministic repr)."""
    aggs = tuple((a.function, a.column) for a in request.aggregations)
    gb = None
    if request.is_group_by:
        gb = (tuple(request.group_by.columns), request.group_by.top_n)
    sel = None
    if request.selection is not None:
        s = request.selection
        sel = (
            tuple(s.columns),
            tuple((x.column, x.ascending) for x in s.sorts),
            s.offset,
            s.size,
        )
    having = None
    if request.having is not None:
        h = request.having
        having = (h.function, h.column, h.operator)
    join = None
    if request.join is not None:
        j = request.join
        # the join is part of the plan shape: a joined scan and a plain
        # scan of the same left table are different workloads (and the
        # broker's strategy planner keys per-shape stats off this)
        join = (_raw_table(j.right_table), j.left_key, j.right_key)
    return (
        _raw_table(request.table_name),
        _filter_shape(request.filter),
        aggs,
        gb,
        sel,
        having,
        join,
    )


def plan_shape_digest(request: BrokerRequest) -> str:
    """Stable 16-hex-char digest of the plan shape.  Compute it on the
    OPTIMIZED request (broker and server both run ``optimize_request``
    on the same text, so the two sides key the same series)."""
    return hashlib.blake2b(
        repr(plan_shape(request)).encode(), digest_size=8
    ).hexdigest()


def plan_literals(request: BrokerRequest) -> tuple:
    """The literal complement of ``plan_shape``: every value the shape
    erased, in deterministic walk order — filter leaf value lists,
    having bounds, and the debug options that can steer execution.
    ``plan_shape(request) + plan_literals(request)`` together identify
    the full query text semantically, which is exactly what the
    ingest-aware result cache (engine/rescache.py) keys on:
    (segment set + staging tokens, plan digest, literal values)."""
    lits = []
    if request.filter is not None:
        for node in request.filter.walk():
            if node.is_leaf:
                # RANGE bounds live in range_spec, not values — a
                # literal digest blind to them would collide `a>5`
                # with `a>999` (tests/test_batching.py regression)
                rng = None
                if node.range_spec is not None:
                    r = node.range_spec
                    rng = (r.lower, r.upper, r.include_lower, r.include_upper)
                lits.append(
                    (node.column, node.operator.value, tuple(node.values), rng)
                )
    having = None
    if request.having is not None:
        having = request.having.value
    opts = tuple(sorted((request.query_options or {}).items()))
    dbg = tuple(sorted((request.debug_options or {}).items()))
    return (tuple(lits), having, opts, dbg)


def plan_literal_digest(request: BrokerRequest) -> str:
    """Stable 16-hex-char digest of the literal tuple."""
    return hashlib.blake2b(
        repr(plan_literals(request)).encode(), digest_size=8
    ).hexdigest()


def plan_shape_summary(request: BrokerRequest) -> str:
    """Short human label for a digest ("what shape is this?"), rendered
    on /debug/plans, /debug/workload, and the controller dashboard."""
    parts = []
    if request.aggregations:
        parts.append(",".join(a.display_name for a in request.aggregations))
    elif request.selection is not None:
        cols = ",".join(request.selection.columns) or "*"
        parts.append(f"select({cols})")
    if request.filter is not None:
        leaves = [n for n in request.filter.walk() if n.is_leaf]
        parts.append(
            "where " + "&".join(f"{n.column}:{n.operator.value}" for n in leaves)
        )
    if request.is_group_by:
        parts.append("by " + ",".join(request.group_by.columns))
    if request.selection is not None and request.selection.sorts:
        parts.append(
            "order " + ",".join(s.column for s in request.selection.sorts)
        )
    parts.append(f"from {_raw_table(request.table_name)}")
    if request.join is not None:
        j = request.join
        parts.append(
            f"join {_raw_table(j.right_table)} on {j.left_key}={j.right_key}"
        )
    return " ".join(parts)
