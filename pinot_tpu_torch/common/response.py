"""Broker response model and error codes (copy of
``pinot_tpu.common.response``).

The JSON shape mirrors the reference broker's response
(pinot-common ``common/response/broker/BrokerResponseNative.java``):
``aggregationResults`` (plain or group-by), ``selectionResults``,
``exceptions``, and execution stats (``numDocsScanned``, ``totalDocs``,
``timeUsedMs``, ``numServersQueried``, ``numServersResponded``,
``traceInfo``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


def _fmt_value(v: Any) -> str:
    """Reference renders aggregation values as strings (String.format)."""
    if isinstance(v, bool):
        return str(v).lower()
    if isinstance(v, float):
        # Pinot prints doubles with 5 decimal places in aggregation results
        # (SelectionOperatorUtils / AggregationFunctionUtils formatting).
        return f"{v:.5f}"
    return str(v)


@dataclass
class GroupByResult:
    group: List[str]
    value: Any

    def to_json(self) -> Dict[str, Any]:
        return {"value": _fmt_value(self.value), "group": list(self.group)}


@dataclass
class AggregationResult:
    function: str  # display name, e.g. "sum_runs"
    value: Any = None
    group_by_columns: Optional[List[str]] = None
    group_by_result: Optional[List[GroupByResult]] = None

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"function": self.function}
        if self.group_by_result is not None:
            d["groupByResult"] = [g.to_json() for g in self.group_by_result]
            d["groupByColumns"] = list(self.group_by_columns or [])
        else:
            d["value"] = _fmt_value(self.value)
        return d


@dataclass
class SelectionResults:
    columns: List[str]
    rows: List[List[Any]]

    def to_json(self) -> Dict[str, Any]:
        return {
            "columns": list(self.columns),
            "results": [[_sel_fmt(v) for v in row] for row in self.rows],
        }


def _sel_fmt(v: Any) -> Any:
    if isinstance(v, list):
        return [_sel_fmt(x) for x in v]
    if isinstance(v, float):
        return _fmt_value(v)
    return str(v)


@dataclass
class QueryException:
    error_code: int
    message: str

    def to_json(self) -> Dict[str, Any]:
        return {"errorCode": self.error_code, "message": self.message}


# Error codes, mirroring pinot-common QueryException constants.
class ErrorCode:
    JSON_PARSING = 100
    PQL_PARSING = 150
    QUERY_VALIDATION = 160
    QUERY_EXECUTION = 200
    SERVER_SCHEDULER_DOWN = 210
    SERVER_SHUTTING_DOWN = 220
    # a server answered but could not serve some requested segments
    # (dropped / quarantined pending re-fetch); the broker re-covers
    # them on a replica or degrades honestly via partialResponse
    SERVER_SEGMENT_MISSING = 230
    EXECUTION_TIMEOUT = 250
    BROKER_GATHER = 300
    BROKER_TIMEOUT = 350
    BROKER_RESOURCE_MISSING = 410
    BROKER_INSTANCE_MISSING = 420
    TOO_MANY_REQUESTS = 429
    INTERNAL = 450
    UNKNOWN = 1000


@dataclass
class BrokerResponse:
    aggregation_results: Optional[List[AggregationResult]] = None
    selection_results: Optional[SelectionResults] = None
    exceptions: List[QueryException] = field(default_factory=list)
    num_docs_scanned: int = 0
    num_entries_scanned_in_filter: int = 0
    num_entries_scanned_post_filter: int = 0
    total_docs: int = 0
    num_segments_queried: int = 0
    num_servers_queried: int = 0
    num_servers_responded: int = 0
    # graceful-degradation contract: when retries/failover could not
    # cover every routed segment, partial_response flips true and
    # num_segments_unserved counts what is missing — clients must be
    # able to distinguish a complete answer from a degraded one without
    # parsing exception strings
    partial_response: bool = False
    num_segments_unserved: int = 0
    num_retries: int = 0
    num_hedges: int = 0
    time_used_ms: float = 0.0
    # per-query cost vector (engine/results.py COST_KEYS): bytes
    # touched, device vs host kernel ms, serving-tier segment counts,
    # coalesce/cache hits — merged across scatter-gather so the totals
    # equal the sum of the per-server totals exactly
    cost: Dict[str, float] = field(default_factory=dict)
    trace_info: Dict[str, Any] = field(default_factory=dict)
    # broker-assigned globally-unique id echoed to the client so a
    # response correlates with traces and the slow-query log
    request_id: str = ""
    # workload-introspection plane: the literal-erased plan-shape digest
    # (engine/plandigest.py) on EVERY response, cross-linking a query to
    # /debug/plans and /debug/workload; ``explain`` is populated only
    # for EXPLAIN / EXPLAIN ANALYZE queries (the structured plan tree)
    plan_digest: str = ""
    explain: Optional[Dict[str, Any]] = None
    # event-time freshness of the answer (broker/freshness.py): now −
    # the stalest consumed event-time watermark over the realtime
    # partitions that served this query.  None for offline-only answers
    # — the key is then absent from the JSON, so pure-offline responses
    # stay byte-identical to the pre-audit-plane payloads.  Like
    # timeUsedMs/requestId, every byte-identity differential oracle
    # strips it (it is wall-clock-dependent accounting, not data).
    freshness_ms: Optional[float] = None

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        if self.request_id:
            d["requestId"] = self.request_id
        if self.selection_results is not None:
            d["selectionResults"] = self.selection_results.to_json()
        if self.aggregation_results is not None:
            d["aggregationResults"] = [a.to_json() for a in self.aggregation_results]
        d["exceptions"] = [e.to_json() for e in self.exceptions]
        d["numDocsScanned"] = self.num_docs_scanned
        d["numEntriesScannedInFilter"] = self.num_entries_scanned_in_filter
        d["numEntriesScannedPostFilter"] = self.num_entries_scanned_post_filter
        d["totalDocs"] = self.total_docs
        d["numSegmentsQueried"] = self.num_segments_queried
        d["numServersQueried"] = self.num_servers_queried
        d["numServersResponded"] = self.num_servers_responded
        d["partialResponse"] = self.partial_response
        d["numSegmentsUnserved"] = self.num_segments_unserved
        if self.num_retries:
            d["numRetries"] = self.num_retries
        if self.num_hedges:
            d["numHedges"] = self.num_hedges
        if self.cost:
            d["cost"] = {
                k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in sorted(self.cost.items())
            }
        d["timeUsedMs"] = round(self.time_used_ms, 3)
        if self.freshness_ms is not None:
            d["freshnessMs"] = round(self.freshness_ms, 3)
        if self.plan_digest:
            d["planDigest"] = self.plan_digest
        if self.explain is not None:
            d["explain"] = self.explain
        if self.trace_info:
            d["traceInfo"] = self.trace_info
        return d
