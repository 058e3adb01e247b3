"""Reduce: merged IntermediateResults -> BrokerResponse (port of the
aggregation and group-by branches of ``pinot_tpu.engine.reduce``).

The ``BrokerReduceService.reduceOnDataTable`` analog: merge per-server
partials, finalize aggregation values, sort + trim group-by results
(ascending iff the function is min, ``AggregationGroupByOperatorService
.java:146``), apply HAVING, and sum execution stats.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Sequence

import numpy as np

from pinot_tpu_torch.common.request import BrokerRequest, group_sort_ascending
from pinot_tpu_torch.common.response import (
    AggregationResult,
    BrokerResponse,
    GroupByResult,
    QueryException,
)
from pinot_tpu_torch.engine import hll as hll_mod
from pinot_tpu_torch.engine.results import HllPartial, IntermediateResult


def merge_results(parts: Sequence[IntermediateResult]) -> Optional[IntermediateResult]:
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    merged = parts[0]
    for p in parts[1:]:
        merged.merge(p)
    return merged


def reduce_to_response(
    request: BrokerRequest,
    parts: Sequence[IntermediateResult],
    exceptions: Optional[List[QueryException]] = None,
) -> BrokerResponse:
    merged = merge_results(parts)
    resp = BrokerResponse(exceptions=list(exceptions or []))
    if merged is None:
        return resp
    resp.num_docs_scanned = merged.num_docs_scanned
    resp.total_docs = merged.total_docs
    resp.num_segments_queried = merged.num_segments_queried
    resp.num_entries_scanned_in_filter = merged.num_entries_scanned_in_filter
    resp.num_entries_scanned_post_filter = merged.num_entries_scanned_post_filter
    resp.cost = dict(merged.cost)
    if request.is_group_by:
        resp.aggregation_results = _reduce_group_by(request, merged)
    elif request.is_aggregation:
        resp.aggregation_results = [
            AggregationResult(function=a.display_name, value=p.finalize())
            for a, p in zip(request.aggregations, merged.aggregations or [])
        ]
    else:
        raise NotImplementedError("selection queries are a later slice of the port")
    return resp


def _reduce_group_by(request: BrokerRequest, merged: IntermediateResult):
    groups = merged.groups or {}
    out: List[AggregationResult] = []
    gb = request.group_by

    # HAVING filters GROUPS: a group failing the predicate disappears from
    # every aggregation's result list
    passing = None
    having_idx = -1
    having_vals = {}
    if request.having is not None:
        h = request.having
        for i, agg in enumerate(request.aggregations):
            if h.function == agg.function and (h.column == agg.column or h.column == "*"):
                having_idx = i
                hkeys = list(groups)
                having_vals = dict(zip(hkeys, _batch_finalize([groups[k][i] for k in hkeys])))
                passing = {
                    key for key, v in having_vals.items() if _having_ok(v, h.operator, h.value)
                }
                break

    keys = [k for k in groups if passing is None or k in passing]
    for i, agg in enumerate(request.aggregations):
        if i == having_idx:
            vals = [having_vals[k] for k in keys]
        else:
            vals = _batch_finalize([groups[k][i] for k in keys])
        pairs = list(zip(keys, vals))
        asc = group_sort_ascending(agg.function)
        pairs.sort(key=lambda kv: (kv[1], kv[0]) if asc else (-_num(kv[1]), kv[0]))
        trimmed = pairs[: gb.top_n]
        out.append(
            AggregationResult(
                function=agg.display_name,
                group_by_columns=list(gb.columns),
                group_by_result=[GroupByResult(group=list(k), value=v) for k, v in trimmed],
            )
        )
    return out


def _batch_finalize(partials: List[Any]) -> List[Any]:
    """Per-group finalize, vectorized where the partial type allows: one
    stacked estimate over [G, 256] registers instead of one HLL estimator
    call per group."""
    if len(partials) > 8 and all(type(p) is HllPartial for p in partials):
        ests = hll_mod.estimate_from_registers(np.stack([p.registers for p in partials]))
        return [int(e) for e in np.asarray(ests).ravel()]
    return [p.finalize() for p in partials]


def _num(v: Any) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        return -math.inf


def _having_ok(value: Any, op: str, target: float) -> bool:
    v = _num(value)
    if op == "=":
        return v == target
    if op in ("<>", "!="):
        return v != target
    if op == "<":
        return v < target
    if op == ">":
        return v > target
    if op == "<=":
        return v <= target
    if op == ">=":
        return v >= target
    return True
