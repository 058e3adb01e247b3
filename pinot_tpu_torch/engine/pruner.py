"""Segment pruning before planning (copy of ``pinot_tpu.engine.pruner``).

Reference: pinot-core ``query/pruner/`` —
``DataSchemaSegmentPruner`` (drop segments missing referenced columns),
``ValidSegmentPruner`` (drop empty segments), ``TimeSegmentPruner``
(drop segments whose [startTime, endTime] cannot match the query's
time-column predicate).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from pinot_tpu_torch.common.request import BrokerRequest, FilterOperator, FilterQueryTree
from pinot_tpu_torch.segment.immutable import ImmutableSegment


def _time_bounds(
    tree: Optional[FilterQueryTree], time_column: str
) -> Optional[Tuple[float, float]]:
    """Conservative [lo, hi] the time column must intersect, from
    top-level AND / single-leaf predicates only."""
    if tree is None:
        return None
    leaves: List[FilterQueryTree] = []
    if tree.is_leaf:
        leaves = [tree]
    elif tree.operator == FilterOperator.AND:
        leaves = [c for c in tree.children if c.is_leaf]
    lo, hi = float("-inf"), float("inf")
    found = False
    for leaf in leaves:
        if leaf.column != time_column:
            continue
        try:
            if leaf.operator == FilterOperator.EQUALITY:
                v = float(leaf.values[0])
                lo, hi = max(lo, v), min(hi, v)
                found = True
            elif leaf.operator == FilterOperator.RANGE and leaf.range_spec:
                r = leaf.range_spec
                if r.lower not in (None, "*"):
                    lo = max(lo, float(r.lower))
                if r.upper not in (None, "*"):
                    hi = min(hi, float(r.upper))
                found = True
            elif leaf.operator == FilterOperator.IN:
                vs = [float(v) for v in leaf.values]
                lo, hi = max(lo, min(vs)), min(hi, max(vs))
                found = True
        except ValueError:
            continue
    return (lo, hi) if found else None


def _prune_reason(
    seg: ImmutableSegment, request: BrokerRequest, needed: Sequence[str]
) -> Optional[str]:
    """Why this segment is pruned, or None to keep it: the one verdict
    ``prune_segments`` and ``prune_explain`` share."""
    if seg.num_docs == 0:  # ValidSegmentPruner
        return "empty segment (ValidSegmentPruner)"
    missing = [c for c in needed if not seg.has_column(c)]
    if missing:  # DataSchemaSegmentPruner
        return f"missing columns {sorted(missing)} (DataSchemaSegmentPruner)"
    meta = seg.metadata
    if meta.time_column and meta.start_time is not None and meta.end_time is not None:
        bounds = _time_bounds(request.filter, meta.time_column)
        if bounds is not None:
            lo, hi = bounds
            if hi < meta.start_time or lo > meta.end_time:  # TimeSegmentPruner
                return (
                    f"time range [{meta.start_time},{meta.end_time}] outside "
                    f"predicate [{lo},{hi}] (TimeSegmentPruner)"
                )
    return None


def prune_explain(
    segments: Sequence[ImmutableSegment], request: BrokerRequest
) -> List[Tuple[ImmutableSegment, Optional[str]]]:
    """Per-segment prune verdicts in input order: (segment, reason);
    reason None means the segment survives to planning."""
    needed = request.referenced_columns()
    return [(seg, _prune_reason(seg, request, needed)) for seg in segments]


def prune_segments(
    segments: Sequence[ImmutableSegment], request: BrokerRequest
) -> List[ImmutableSegment]:
    needed = request.referenced_columns()
    return [
        seg for seg in segments if _prune_reason(seg, request, needed) is None
    ]
