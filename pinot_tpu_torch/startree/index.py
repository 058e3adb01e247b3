"""Star-tree index structures (copy of ``pinot_tpu.startree.index``).

The reference serializes a node tree over materialized aggregate
records (``StarTreeSerDe.java``, ``StarTreeIndexNode``).  The TPU-first
representation is a **flat pre-aggregated cube table**:

  dims    int32 [n_agg, k]   dictIds per split-order dimension,
                             STAR (-1) where a row aggregates over a dim
  sums    f64   [n_agg, m]   per-metric sums
  counts  i64   [n_agg]      raw docs folded into the row

plus a small host-side node tree whose leaves are [start, end) ranges
into that table.  Query-time traversal (host, O(tree)) picks ranges;
the aggregation over them is an ordinary vectorized scan — so the
"index" is just a smaller table for the same engine, which is exactly
what a TPU wants.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

STAR = -1  # dictId sentinel: this row aggregates over the dimension


@dataclass
class StarTreeNode:
    level: int  # dimension index this node's children split on
    start: int
    end: int
    children: Dict[int, "StarTreeNode"] = field(default_factory=dict)  # dictId -> node
    star_child: Optional["StarTreeNode"] = None

    @property
    def is_leaf(self) -> bool:
        return not self.children and self.star_child is None

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"level": int(self.level), "start": int(self.start), "end": int(self.end)}
        if self.children:
            d["children"] = {str(k): v.to_json() for k, v in self.children.items()}
        if self.star_child is not None:
            d["star"] = self.star_child.to_json()
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "StarTreeNode":
        node = cls(level=d["level"], start=d["start"], end=d["end"])
        for k, v in d.get("children", {}).items():
            node.children[int(k)] = cls.from_json(v)
        if "star" in d:
            node.star_child = cls.from_json(d["star"])
        return node


@dataclass
class StarTreeIndex:
    split_order: List[str]  # dimension column names, split order
    metric_columns: List[str]
    dims: np.ndarray  # int32 [n_agg, k]
    sums: np.ndarray  # float64 [n_agg, m]
    counts: np.ndarray  # int64 [n_agg]
    root: StarTreeNode
    max_leaf_records: int
    # HLL pre-aggregation (the derived-HLL-column capability,
    # HllConfig/HllUtil analogs): per configured column, uint8 register
    # arrays [n_agg, 256] merged with elementwise max.
    hll_columns: List[str] = field(default_factory=list)
    hll_registers: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def num_records(self) -> int:
        return int(self.dims.shape[0])
