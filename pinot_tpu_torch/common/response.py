"""Broker response model (copy of ``pinot_tpu.common.response``, trimmed
to the aggregation, group-by and selection results the port returns).

JSON shape mirrors the reference ``BrokerResponseNative``
(pinot-common ``common/response/broker/BrokerResponseNative.java``).
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
    partial_response: bool = False
    num_segments_unserved: int = 0
    time_used_ms: float = 0.0
    cost: Dict[str, float] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
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
        if self.cost:
            d["cost"] = {
                k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in sorted(self.cost.items())
            }
        d["timeUsedMs"] = round(self.time_used_ms, 3)
        return d
