"""Star-tree builder (copy of ``pinot_tpu.startree.builder``).

Algorithm mirrors the reference (``OffHeapStarTreeBuilder.java:96``,
algorithm doc :69-91): records are aggregated by the dimension split
order; each node splits on its level's dimension into per-value
children plus a star child whose records aggregate over that dimension
(deduped by the remaining dimensions); splitting stops at
``max_leaf_records`` or when dimensions run out.  Split order defaults
to descending cardinality (the reference's default heuristic).

Implementation is vectorized numpy throughout: grouping is
lexicographic sort + run detection (``np.unique(axis=0)``), and star
records are generated level-wise by masking the starred column and
re-aggregating — no per-record recursion.

HLL pre-aggregation (``config.hll_columns`` — the HllConfig
derived-column capability): each cube row carries a uint8[256] register
array sketching the configured column's values folded into it; rows
merge with elementwise max, so ``distinctcounthll``/``fasthll`` answer
from the cube too.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pinot_tpu_torch.common.schema import FieldType, Schema
from pinot_tpu_torch.engine import hll as hll_mod
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.startree.index import STAR, StarTreeIndex, StarTreeNode
from pinot_tpu_torch.utils.npgroup import group_max_rows, scatter_max_2d

Regs = Dict[str, np.ndarray]  # column -> uint8 [n, 256]


@dataclass
class StarTreeBuilderConfig:
    """StarTreeBuilderConfig analog (split order, leaf cap, skips,
    HLL columns)."""

    split_order: Optional[List[str]] = None
    max_leaf_records: int = 10_000
    skip_star_for_dims: List[str] = field(default_factory=list)
    hll_columns: List[str] = field(default_factory=list)


def _pack_keys(dims: np.ndarray, radices: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """ONE mixed-radix int64 key per row (STAR=-1 offset in): sorting /
    uniquing the packed key is identical in order and grouping to
    lexicographic row operations, and a scalar int64 argsort is several
    times faster than np.unique(axis=0)'s structured-view sort — the
    dominant cost of large builds.  None when the radix product could
    overflow (callers fall back to the row-wise path)."""
    if radices is None:
        return None
    key = np.zeros(dims.shape[0], dtype=np.int64)
    for j in range(dims.shape[1]):
        key = key * int(radices[j]) + (dims[:, j].astype(np.int64) + 1)
    return key


def _dim_radices(cards: Sequence[int]) -> Optional[np.ndarray]:
    radices = np.asarray([int(c) + 1 for c in cards], dtype=np.int64)
    prod = 1.0
    for r in radices:
        prod *= float(r)
    if prod >= 2.0**62:
        return None
    return radices


def _unique_rows(dims: np.ndarray, radices: Optional[np.ndarray]):
    """(unique rows lexicographically sorted, inverse) — packed-key
    fast path when the radix product fits int64."""
    key = _pack_keys(dims, radices)
    if key is not None:
        _, index, inverse = np.unique(key, return_index=True, return_inverse=True)
        return dims[index], inverse
    return np.unique(dims, axis=0, return_inverse=True)


def _aggregate(
    dims: np.ndarray,
    sums: np.ndarray,
    counts: np.ndarray,
    regs: Optional[Regs],
    radices: Optional[np.ndarray] = None,
):
    """Group rows by all dim columns; sum metrics/counts, max registers.
    Output rows come back lexicographically SORTED (np.unique's order on
    either path) — the invariant split_node's run detection relies on,
    with no separate sort pass."""
    if dims.shape[0] == 0:
        return dims, sums, counts, regs
    uniq, inverse = _unique_rows(dims, radices)
    m = sums.shape[1]
    agg_sums = np.zeros((uniq.shape[0], m), dtype=np.float64)
    for j in range(m):
        agg_sums[:, j] = np.bincount(inverse, weights=sums[:, j], minlength=uniq.shape[0])
    agg_counts = np.bincount(inverse, weights=counts, minlength=uniq.shape[0]).astype(np.int64)
    agg_regs: Optional[Regs] = None
    if regs is not None:
        agg_regs = {
            col: group_max_rows(inverse, uniq.shape[0], r) for col, r in regs.items()
        }
    return uniq.astype(np.int32), agg_sums, agg_counts, agg_regs


class _Accum:
    """Append-only global record arrays."""

    def __init__(self, k: int, m: int, hll_cols: Sequence[str]) -> None:
        self.dims: List[np.ndarray] = []
        self.sums: List[np.ndarray] = []
        self.counts: List[np.ndarray] = []
        self.regs: Dict[str, List[np.ndarray]] = {c: [] for c in hll_cols}
        self.size = 0
        self.k = k
        self.m = m

    def append(self, dims, sums, counts, regs: Optional[Regs]) -> Tuple[int, int]:
        start = self.size
        self.dims.append(dims)
        self.sums.append(sums)
        self.counts.append(counts)
        if regs is not None:
            for c, r in regs.items():
                self.regs[c].append(r)
        self.size += dims.shape[0]
        return start, self.size

    def finalize(self):
        if not self.dims:
            return (
                np.zeros((0, self.k), np.int32),
                np.zeros((0, self.m), np.float64),
                np.zeros(0, np.int64),
                {c: np.zeros((0, hll_mod.M), np.uint8) for c in self.regs},
            )
        return (
            np.concatenate(self.dims),
            np.concatenate(self.sums),
            np.concatenate(self.counts),
            {c: np.concatenate(blocks) for c, blocks in self.regs.items()},
        )


def build_star_tree(
    segment: ImmutableSegment,
    schema: Schema,
    config: Optional[StarTreeBuilderConfig] = None,
) -> ImmutableSegment:
    """Attach a star-tree index to the segment (in place; returned for
    chaining).  Only single-value dimension/time columns participate;
    metrics must be numeric (reference: metrics are summed into
    MetricBuffers)."""
    config = config or StarTreeBuilderConfig()

    dim_cols = [
        s.name
        for s in schema.all_fields()
        if s.field_type in (FieldType.DIMENSION, FieldType.TIME) and s.single_value
    ]
    metric_cols = [
        s.name for s in schema.all_fields() if s.field_type == FieldType.METRIC and s.single_value
    ]

    split_order = list(config.split_order) if config.split_order else None
    if split_order is None:
        # default: descending cardinality (reference heuristic)
        split_order = sorted(
            dim_cols,
            key=lambda c: -segment.column(c).metadata.cardinality,
        )
    # HLL columns must not be split dims (they're the counted column)
    split_order = [c for c in split_order if c not in config.hll_columns]
    k, m = len(split_order), len(metric_cols)

    # base records: raw docs in dictId space
    n = segment.num_docs
    dims = (
        np.stack([segment.column(c).fwd for c in split_order], axis=1).astype(np.int32)
        if k
        else np.zeros((n, 0), np.int32)
    )
    sums = (
        np.stack(
            [
                np.asarray(segment.column(c).dictionary.values, dtype=np.float64)[
                    segment.column(c).fwd
                ]
                for c in metric_cols
            ],
            axis=1,
        )
        if m
        else np.zeros((n, 0), np.float64)
    )
    counts = np.ones(n, dtype=np.int64)

    radices = _dim_radices([segment.column(c).metadata.cardinality for c in split_order])

    # aggregate raw docs by all split dims; fold HLL registers in the
    # same pass via per-dictId (bucket, rho) tables
    if n:
        uniq, inverse = _unique_rows(dims, radices)
    else:
        uniq, inverse = np.zeros((0, k), np.int32), np.zeros(0, np.int64)
    agg_sums = np.zeros((uniq.shape[0], m), dtype=np.float64)
    for j in range(m):
        agg_sums[:, j] = np.bincount(inverse, weights=sums[:, j], minlength=uniq.shape[0])
    agg_counts = np.bincount(inverse, weights=counts, minlength=uniq.shape[0]).astype(np.int64)

    regs: Optional[Regs] = None
    if config.hll_columns:
        regs = {}
        for hcol in config.hll_columns:
            d = segment.column(hcol).dictionary
            # ONE shared per-dictId (bucket, rho) table build, cached on
            # the dictionary (hll.dictionary_tables) — the same tables
            # the staging/planner paths use, so repeated builds and
            # queries over this segment never re-hash the dictionary
            bucket, rho = hll_mod.dictionary_tables(d)
            fwd = segment.column(hcol).fwd
            regs[hcol] = scatter_max_2d(
                inverse, uniq.shape[0], bucket[fwd].astype(np.int64), rho[fwd], hll_mod.M
            )

    # rows are already lexicographically sorted (np.unique order)
    dims, sums, counts = uniq.astype(np.int32), agg_sums, agg_counts

    acc = _Accum(k, m, config.hll_columns)
    skip = set(config.skip_star_for_dims)

    def split_node(dims_b, sums_b, counts_b, regs_b, level: int, gstart: int) -> StarTreeNode:
        """Node over rows [gstart, gstart+len) of the flat table.
        Children reference subranges of the SAME block (records are
        stored once); only star children append new aggregated blocks."""
        node = StarTreeNode(level=level, start=gstart, end=gstart + dims_b.shape[0])
        if level >= k or dims_b.shape[0] <= config.max_leaf_records:
            return node
        col = dims_b[:, level]
        boundaries = np.flatnonzero(np.diff(col)) + 1
        run_starts = np.concatenate([[0], boundaries])
        run_ends = np.concatenate([boundaries, [col.size]])
        for rs, re_ in zip(run_starts, run_ends):
            rregs = {c: r[rs:re_] for c, r in regs_b.items()} if regs_b is not None else None
            node.children[int(col[rs])] = split_node(
                dims_b[rs:re_], sums_b[rs:re_], counts_b[rs:re_], rregs, level + 1, gstart + int(rs)
            )
        if split_order[level] not in skip:
            star_dims = dims_b.copy()
            star_dims[:, level] = STAR
            sd, ss, sc, sr = _aggregate(star_dims, sums_b, counts_b, regs_b, radices)
            sstart, _ = acc.append(sd, ss, sc, sr)
            node.star_child = split_node(sd, ss, sc, sr, level + 1, sstart)
        return node

    base_start, _ = acc.append(dims, sums, counts, regs)
    root = split_node(dims, sums, counts, regs, 0, base_start)

    flat_dims, flat_sums, flat_counts, flat_regs = acc.finalize()
    segment.star_tree = StarTreeIndex(
        split_order=split_order,
        metric_columns=metric_cols,
        dims=flat_dims,
        sums=flat_sums,
        counts=flat_counts,
        root=root,
        max_leaf_records=config.max_leaf_records,
        hll_columns=list(config.hll_columns),
        hll_registers=flat_regs if config.hll_columns else {},
    )
    segment.metadata.custom["starTree"] = {
        "splitOrder": split_order,
        "maxLeafRecords": config.max_leaf_records,
        "numRecords": int(flat_dims.shape[0]),
        "hllColumns": list(config.hll_columns),
    }
    return segment
