"""Row-at-a-time aggregation state (copy of the accumulator of
``pinot_tpu.tools.scan_engine``, trimmed to what the host tier uses).

Semantics, matched to the reference engine:

- Multi-value (MV) columns: an aggregation reads every value of the row;
  ``countmv`` counts values, not rows.
- ``percentileNN`` is the exact reference formula: sort ascending, take
  ``sorted[int(n * NN/100)]`` (``quantile/PercentileUtil.java:50``);
  ``percentileestNN`` follows the same exact path.
- ``distinctcounthll`` / ``fasthll`` estimate through the engine's own
  HLL sketch (``pinot_tpu_torch.engine.hll``), so results agree exactly.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

from pinot_tpu_torch.common.request import AggregationInfo

Row = Dict[str, Any]


def _values_of(row: Row, column: str) -> List[Any]:
    v = row[column]
    if isinstance(v, (list, tuple)):
        return list(v)
    return [v]


def _numeric_values(row: Row, agg: AggregationInfo) -> List[float]:
    vals = _values_of(row, agg.column)
    return [float(v) for v in vals]


class _Accumulator:
    """One aggregation function's running state (exact)."""

    def __init__(self, agg: AggregationInfo) -> None:
        self.agg = agg
        base = agg.base_function
        self.base = base
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.distinct: set = set()
        self.values: List[float] = []  # for percentiles

    def add(self, row: Row) -> None:
        base = self.base
        if base == "count":
            if self.agg.is_mv:
                self.count += len(_values_of(row, self.agg.column))
            else:
                self.count += 1
            return
        if base in ("distinctcount", "distinctcounthll", "fasthll"):
            for v in _values_of(row, self.agg.column):
                self.distinct.add(v)
            return
        vals = _numeric_values(row, self.agg)
        for v in vals:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
        if base.startswith("percentile"):
            self.values.extend(vals)

    def result(self) -> Any:
        base = self.base
        if base == "count":
            return self.count
        if base == "sum":
            return self.sum
        if base == "min":
            return self.min
        if base == "max":
            return self.max
        if base == "avg":
            return self.sum / self.count if self.count else -math.inf
        if base == "minmaxrange":
            return self.max - self.min
        if base == "distinctcount":
            return len(self.distinct)
        if base in ("distinctcounthll", "fasthll"):
            from pinot_tpu_torch.engine.hll import hll_estimate_exact_values

            return hll_estimate_exact_values(self.distinct)
        if base.startswith("percentileest"):
            p = int(base[len("percentileest"):])
            return _percentile(self.values, p)
        if base.startswith("percentile"):
            p = int(base[len("percentile"):])
            return _percentile(self.values, p)
        raise ValueError(f"unknown aggregation {base}")


def _percentile(values: List[float], p: int) -> float:
    """Reference formula: quantile/PercentileUtil.java:50."""
    if not values:
        return -math.inf
    s = sorted(values)
    idx = min(int(len(s) * p / 100.0), len(s) - 1)
    return s[idx]
