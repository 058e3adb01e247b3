"""Mergeable aggregation partials (port of ``pinot_tpu.engine.results``,
without the HLL, distinct and histogram partials of the next slice).

  count/sum    float        merge = +
  min / max    float        merge = min / max
  avg          (sum, count) merge = pairwise +
  minmaxrange  (min, max)

Group-by partials are {group key tuple -> per-function partial} maps,
merged key-wise and trimmed to top_n at the broker reduce.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


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


_PARTIALS = {
    "count": CountPartial,
    "sum": SumPartial,
    "min": MinPartial,
    "max": MaxPartial,
    "avg": AvgPartial,
    "minmaxrange": MinMaxRangePartial,
}


def make_partial(base_function: str) -> AggPartial:
    try:
        return _PARTIALS[base_function]()
    except KeyError:
        raise NotImplementedError(
            f"aggregation {base_function!r} is not part of this slice of the port"
        ) from None


GroupKey = Tuple[str, ...]


class IntermediateResult:
    """One server's partial answer for a query — merges with peers'."""

    def __init__(
        self,
        aggregations: Optional[List[AggPartial]] = None,
        groups: Optional[Dict[GroupKey, List[AggPartial]]] = None,
        num_docs_scanned: int = 0,
        total_docs: int = 0,
        num_segments_queried: int = 0,
        num_entries_scanned_in_filter: int = 0,
        num_entries_scanned_post_filter: int = 0,
        cost: Optional[Dict[str, float]] = None,
    ) -> None:
        self.aggregations = aggregations
        self.groups = groups
        self.num_docs_scanned = num_docs_scanned
        self.total_docs = total_docs
        self.num_segments_queried = num_segments_queried
        self.num_entries_scanned_in_filter = num_entries_scanned_in_filter
        self.num_entries_scanned_post_filter = num_entries_scanned_post_filter
        self.cost: Dict[str, float] = dict(cost or {})

    def add_cost(self, **kv: float) -> None:
        for k, v in kv.items():
            if v:
                self.cost[k] = self.cost.get(k, 0) + v

    def merge(self, other: "IntermediateResult") -> None:
        for k, v in other.cost.items():
            self.cost[k] = self.cost.get(k, 0) + v
        self.num_docs_scanned += other.num_docs_scanned
        self.total_docs += other.total_docs
        self.num_segments_queried += other.num_segments_queried
        self.num_entries_scanned_in_filter += other.num_entries_scanned_in_filter
        self.num_entries_scanned_post_filter += other.num_entries_scanned_post_filter
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
