"""Mergeable aggregation partials (port of ``pinot_tpu.engine.results``).

  count/sum         float        merge = +
  min / max         float        merge = min / max
  avg               (sum, count) merge = pairwise +
  minmaxrange       (min, max)
  distinctcount     value set    merge = union
  distinctcounthll  uint8[m] HLL registers, merge = elementwise max
  percentile*       value -> count histogram, merge = counter add

Group-by partials are {group key tuple -> per-function partial} maps,
merged key-wise and trimmed to top_n at the broker reduce.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pinot_tpu_torch.engine import hll as hll_mod


class AggPartial:
    """Base: merge in place, then finalize to the response value."""

    def merge(self, other: "AggPartial") -> None:
        raise NotImplementedError

    def finalize(self) -> Any:
        raise NotImplementedError


class CountPartial(AggPartial):
    def __init__(self, count: float = 0.0) -> None:
        self.count = float(count)

    def merge(self, other: "CountPartial") -> None:
        self.count += other.count

    def finalize(self) -> Any:
        return int(self.count)


class SumPartial(AggPartial):
    def __init__(self, total: float = 0.0) -> None:
        self.total = float(total)

    def merge(self, other: "SumPartial") -> None:
        self.total += other.total

    def finalize(self) -> float:
        return self.total


class MinPartial(AggPartial):
    def __init__(self, value: float = math.inf) -> None:
        self.value = float(value)

    def merge(self, other: "MinPartial") -> None:
        self.value = min(self.value, other.value)

    def finalize(self) -> float:
        return self.value


class MaxPartial(AggPartial):
    def __init__(self, value: float = -math.inf) -> None:
        self.value = float(value)

    def merge(self, other: "MaxPartial") -> None:
        self.value = max(self.value, other.value)

    def finalize(self) -> float:
        return self.value


class AvgPartial(AggPartial):
    def __init__(self, total: float = 0.0, count: float = 0.0) -> None:
        self.total = float(total)
        self.count = float(count)

    def merge(self, other: "AvgPartial") -> None:
        self.total += other.total
        self.count += other.count

    def finalize(self) -> float:
        return self.total / self.count if self.count else -math.inf


class MinMaxRangePartial(AggPartial):
    def __init__(self, mn: float = math.inf, mx: float = -math.inf) -> None:
        self.mn = float(mn)
        self.mx = float(mx)

    def merge(self, other: "MinMaxRangePartial") -> None:
        self.mn = min(self.mn, other.mn)
        self.mx = max(self.mx, other.mx)

    def finalize(self) -> float:
        return self.mx - self.mn


class DistinctPartial(AggPartial):
    """Exact distinct value set for one group: a Python set, or a unique
    numpy array on the bulk paths (a vectorized gather instead of a
    per-value set build)."""

    def __init__(self, values: Optional[object] = None) -> None:
        self.values = values if values is not None else set()

    def merge(self, other: "DistinctPartial") -> None:
        a, b = self.values, other.values
        if isinstance(a, set) and isinstance(b, set):
            a |= b
            return
        na = np.asarray(sorted(a, key=repr)) if isinstance(a, set) else a
        nb = np.asarray(sorted(b, key=repr)) if isinstance(b, set) else b
        if na.size == 0:
            self.values = nb
        elif nb.size == 0:
            self.values = na
        else:
            self.values = np.union1d(na, nb)

    def finalize(self) -> int:
        return len(self.values) if isinstance(self.values, set) else int(self.values.size)

    def iter_sorted(self):
        """Values in a deterministic order (the DataTable serde contract)."""
        if isinstance(self.values, set):
            return sorted(self.values, key=repr)
        return np.sort(self.values).tolist()


class HllPartial(AggPartial):
    def __init__(self, registers: Optional[np.ndarray] = None) -> None:
        self.registers = (
            registers.astype(np.uint8)
            if registers is not None
            else np.zeros(hll_mod.M, dtype=np.uint8)
        )

    def merge(self, other: "HllPartial") -> None:
        self.registers = hll_mod.merge_registers(self.registers, other.registers)

    def finalize(self) -> int:
        return int(hll_mod.estimate_from_registers(self.registers))


class HistogramPartial(AggPartial):
    """Exact value histogram for percentiles."""

    def __init__(self, counts: Optional[Dict[float, int]] = None, percentile: int = 50) -> None:
        self.counts: Dict[float, int] = counts or {}
        self.percentile = percentile

    def merge(self, other: "HistogramPartial") -> None:
        for v, c in other.counts.items():
            self.counts[v] = self.counts.get(v, 0) + c

    def finalize(self) -> float:
        """Reference formula sorted[int(n * p/100)]
        (quantile/PercentileUtil.java:50) over the histogram."""
        if not self.counts:
            return -math.inf
        items = sorted(self.counts.items())
        n = sum(c for _, c in items)
        idx = min(int(n * self.percentile / 100.0), n - 1)
        acc = 0
        for v, c in items:
            acc += c
            if acc > idx:
                return v
        return items[-1][0]


def percentile_of(base_function: str) -> int:
    """The NN of percentileNN / percentileestNN."""
    prefix = "percentileest" if base_function.startswith("percentileest") else "percentile"
    return int(base_function[len(prefix):])


_PARTIALS = {
    "count": CountPartial,
    "sum": SumPartial,
    "min": MinPartial,
    "max": MaxPartial,
    "avg": AvgPartial,
    "minmaxrange": MinMaxRangePartial,
    "distinctcount": DistinctPartial,
    "distinctcounthll": HllPartial,
    "fasthll": HllPartial,
}


def make_partial(base_function: str) -> AggPartial:
    if base_function.startswith("percentile"):
        return HistogramPartial(percentile=percentile_of(base_function))
    try:
        return _PARTIALS[base_function]()
    except KeyError:
        raise ValueError(f"unknown aggregation {base_function!r}") from None


GroupKey = Tuple[str, ...]


class IntermediateResult:
    """One server's partial answer for a query — merges with peers'."""

    def __init__(
        self,
        aggregations: Optional[List[AggPartial]] = None,
        groups: Optional[Dict[GroupKey, List[AggPartial]]] = None,
        selection_rows: Optional[List[Tuple[list, list]]] = None,  # (sort_key_values, row)
        num_docs_scanned: int = 0,
        total_docs: int = 0,
        num_segments_queried: int = 0,
        num_entries_scanned_in_filter: int = 0,
        num_entries_scanned_post_filter: int = 0,
        trace: Optional[Dict[str, Any]] = None,
        selection_columns: Optional[List[str]] = None,
        exceptions: Optional[List[Tuple[int, str]]] = None,
        unserved_segments: Optional[List[str]] = None,
        cost: Optional[Dict[str, float]] = None,
        plan_info: Optional[List[Dict[str, Any]]] = None,
    ) -> None:
        self.selection_columns = selection_columns
        # (error code, message) pairs the server reports with its reply
        self.exceptions: List[Tuple[int, str]] = exceptions or []
        # requested segments this server could not serve; the broker
        # re-covers them on a replica or reports a partial response
        self.unserved_segments: List[str] = unserved_segments or []
        self.aggregations = aggregations
        self.groups = groups
        self.selection_rows = selection_rows
        self.num_docs_scanned = num_docs_scanned
        self.total_docs = total_docs
        self.num_segments_queried = num_segments_queried
        self.num_entries_scanned_in_filter = num_entries_scanned_in_filter
        self.num_entries_scanned_post_filter = num_entries_scanned_post_filter
        # {scope: [span dicts]} (utils/trace.py), concatenated on merge
        self.trace = trace or {}
        self.cost: Dict[str, float] = dict(cost or {})
        # the answering server's saturation snapshot ({"pending",
        # "maxPending", "laneDepth"}): per reply, never merged
        self.backpressure: Dict[str, float] = {}
        # EXPLAIN plan nodes, one per server, concatenated on merge (the
        # port's servers send none; the wire carries them)
        self.plan_info: List[Dict[str, Any]] = list(plan_info or [])
        # join-extract payload (engine/join.py SideRows wire dict): the
        # columnar key / value arrays a join-extract phase returns to the
        # broker's exchange.  Not additive: the broker drains it before
        # the result joins the reduce merge; None on every scan reply.
        self.join_payload: Optional[Dict[str, Any]] = None
        # event-time freshness stamp ({"minEventMs": ...}), merged with
        # MIN; None for offline tables (all the port serves)
        self.freshness: Optional[Dict[str, Any]] = None

    def add_cost(self, **kv: float) -> None:
        for k, v in kv.items():
            if v:
                self.cost[k] = self.cost.get(k, 0) + v

    def merge(self, other: "IntermediateResult") -> None:
        self.exceptions.extend(other.exceptions)
        self.unserved_segments.extend(other.unserved_segments)
        self.plan_info.extend(other.plan_info)
        of = other.freshness
        if of is not None and of.get("minEventMs") is not None:
            mine = self.freshness
            if mine is None or mine.get("minEventMs") is None:
                self.freshness = dict(of)
            else:
                mine["minEventMs"] = min(mine["minEventMs"], of["minEventMs"])
        for k, v in other.cost.items():
            self.cost[k] = self.cost.get(k, 0) + v
        self.num_docs_scanned += other.num_docs_scanned
        self.total_docs += other.total_docs
        self.num_segments_queried += other.num_segments_queried
        self.num_entries_scanned_in_filter += other.num_entries_scanned_in_filter
        self.num_entries_scanned_post_filter += other.num_entries_scanned_post_filter
        # trace values are span lists keyed by scope: two partials from
        # the same scope concatenate
        for scope, spans in other.trace.items():
            mine = self.trace.get(scope)
            if isinstance(mine, list) and isinstance(spans, list):
                self.trace[scope] = mine + spans
            else:
                self.trace[scope] = spans
        if other.aggregations is not None:
            if self.aggregations is None:
                self.aggregations = other.aggregations
            else:
                for mine, theirs in zip(self.aggregations, other.aggregations):
                    mine.merge(theirs)
        if other.groups is not None:
            if self.groups is None:
                self.groups = other.groups
            else:
                for key, partials in other.groups.items():
                    existing = self.groups.get(key)
                    if existing is None:
                        self.groups[key] = partials
                    else:
                        for mine, theirs in zip(existing, partials):
                            mine.merge(theirs)
        if other.selection_rows is not None:
            if self.selection_rows is None:
                self.selection_rows = other.selection_rows
            else:
                self.selection_rows.extend(other.selection_rows)
        if self.selection_columns is None:
            self.selection_columns = other.selection_columns


# Cap on boundary-tie groups admitted past the trim (see
# pinot_tpu/engine/results.py:425-433).
MAX_TRIM_TIES = 10_000


def trim_group_candidates(
    order_vals_list: List[np.ndarray],
    ascending_list: List[bool],
    top_n: int,
    k: int,
) -> np.ndarray:
    """Candidate group indices to keep after the per-server trim: a group
    survives if it is within topN*5 (min 100) of any aggregation's
    ordering, or tied (capped) with that boundary.  Sorted indices into
    [0, k)."""
    trim = max(top_n * 5, 100)
    if k <= trim:
        return np.arange(k)
    candidates: set = set()
    for ov, asc in zip(order_vals_list, ascending_list):
        order = np.argsort(ov, kind="stable")
        chosen = order[:trim] if asc else order[-trim:]
        candidates.update(chosen.tolist())
        boundary = ov[order[trim - 1 if asc else -trim]]
        ties = np.nonzero(ov == boundary)[0]
        if ties.size > MAX_TRIM_TIES:
            ties = ties[:MAX_TRIM_TIES]
        candidates.update(ties.tolist())
    return np.asarray(sorted(candidates), dtype=np.int64)


# Cost-vector keys the port emits (the reference's ``COST_KEYS``,
# pinot_tpu/engine/results.py:260-286, trimmed to these).  Every value is
# additive, so the merge is a key-wise sum:
#
#   bytesScanned       column bytes the serving path read (device: the
#                      staged arrays handed to the kernel; host: forward-
#                      index and MV value bytes of the referenced columns)
#   deviceMs           wall ms of the device section: the launch (direct
#                      path) or the lane wait's end to the packed fetch
#   hostMs             wall ms of the host tier's execution
#   deviceBytes        the device tier's share of bytesScanned
#   coalesceHits       queries served by riding an identical in-flight
#                      device dispatch (engine/dispatch.py)
#   batchHits          queries that rode a batched launch with other
#                      same-plan queries (the lane's micro-batching tier)
#   buildRows          join build-side rows extracted / hash-table
#                      inserted (engine/join.py: dim-side work)
#   probeRows          join probe-side rows extracted / probed against
#                      the build hash table (fact-side work)
#   shuffleBytes       serialized join-exchange bytes a server RECEIVED
#                      in a shuffle join (the skew-balance observable:
#                      no server should receive > 2x the mean)
#   broadcastBytes     serialized build-side bytes a server received in
#                      a broadcast join (one copy per probe server)
#   segmentsPruned     segments dropped before execution (empty, or
#                      missing a referenced column)
#   segmentsZonemap    segments scanned over their zone-map candidate
#                      blocks only (engine/zonemap.py)
#   segmentsFullScan   segments scanned whole by the device's table kernel
#   segmentsHost       segments served by the host tier (forced before
#                      staging, a plan off the device, or pair overflow)
COST_KEYS = (
    "bytesScanned",
    "deviceMs",
    "hostMs",
    "deviceBytes",
    "coalesceHits",
    "batchHits",
    "buildRows",
    "probeRows",
    "shuffleBytes",
    "broadcastBytes",
    "segmentsPruned",
    "segmentsZonemap",
    "segmentsFullScan",
    "segmentsHost",
)

# Serving-tier subset of COST_KEYS: all but segmentsPruned partition the
# segments a query was served from.
SEGMENT_TIER_KEYS = tuple(k for k in COST_KEYS if k.startswith("segments"))
