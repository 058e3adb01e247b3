"""Zone maps: per-block dictId min/max for host-side block pruning (port
of ``pinot_tpu.engine.zonemap``).

Per block of ``zone_block_rows()`` rows and per single-value column, the
min and max dictId.  Dictionaries are sorted, so dictId order is value
order, and every predicate the planner rewrote into dictId space is
tested per block on the host:

  interval [lo,hi)   -> candidate iff  zmax >= lo and zmin < hi
  points   {p...}    -> candidate iff  some p in [zmin, zmax]
  match table        -> candidate iff  any(match[zmin : zmax+1])
  docrange [lo,hi)   -> candidate iff  the block overlaps the doc interval

AND / OR trees combine candidacy bitwise; MV leaves are all-candidate.
The executor then runs K1 and K2 over the candidate blocks only
(``block_ids`` of ``engine/kernels``), or gathers them for the torch-op
route, so a point query on a clustered column reads a few blocks a
segment instead of the table.  Segment files persist the zones
(``segment/format.py``); a coarser block is derived from them.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from pinot_tpu_torch.engine import config
from pinot_tpu_torch.engine.plan import SV, StaticPlan
from pinot_tpu_torch.segment.immutable import ImmutableSegment


def zone_block_rows() -> int:
    """Rows per zone block (``config.ZONE_BLOCK``)."""
    return int(config.ZONE_BLOCK)


def column_zones(
    seg: ImmutableSegment, column: str, block: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(zmin, zmax) int64 dictId per block of an SV column, cached on the
    segment (segments are immutable); None for MV columns."""
    col = seg.column(column)
    if not col.metadata.single_value:
        return None
    cache = getattr(seg, "_zone_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(seg, "_zone_cache", cache)
    key = (column, block)
    z = cache.get(key)
    if z is not None:
        return z
    # persisted zones of a finer block that divides this one: grouped
    # min / max instead of a rescan of the column
    for (cname, pblock), (pmin, pmax) in list(cache.items()):
        if cname != column or pblock >= block or block % pblock:
            continue
        g = block // pblock
        nb = -(-pmin.size // g)
        pad = nb * g - pmin.size
        if pad:
            pmin = np.concatenate([pmin, np.full(pad, pmin[-1])])
            pmax = np.concatenate([pmax, np.full(pad, pmax[-1])])
        z = (pmin.reshape(nb, g).min(axis=1), pmax.reshape(nb, g).max(axis=1))
        cache[key] = z
        return z
    if col.fwd is None:
        return None  # nothing to scan and no zones to derive: all-candidate
    fwd = np.asarray(col.fwd)
    n = fwd.size
    nb = -(-n // block) if n else 0
    pad = nb * block - n
    if pad:
        # the last real value pads, so padding never widens a zone
        fwd = np.concatenate([fwd, np.full(pad, fwd[-1] if n else 0, fwd.dtype)])
    f2 = fwd.reshape(nb, block)
    z = (f2.min(axis=1).astype(np.int64), f2.max(axis=1).astype(np.int64))
    cache[key] = z
    return z


def _stacked_zones(
    live: Sequence[ImmutableSegment], column: str, nb: int, block: int, cache: Optional[Dict] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(zmin, zmax) int64 [S, nb] of a column over ``live`` and known
    bool [S] (False where a segment has no zones: all-candidate there),
    or None for known when every segment has zones.  Blocks past a
    segment's zones hold the empty zone [0, -1], which no interval,
    point, run or match table takes.  Kept in ``cache`` (the staged
    table's, whose segments are ``live``)."""
    if cache is not None and (column, block) in cache:
        return cache[(column, block)]
    S = len(live)
    zmin = np.zeros((S, nb), dtype=np.int64)
    zmax = np.full((S, nb), -1, dtype=np.int64)
    known = np.zeros(S, dtype=bool)
    for si, seg in enumerate(live):
        z = column_zones(seg, column, block)
        if z is None:
            continue
        known[si] = True
        n = min(z[0].shape[0], nb)
        zmin[si, :n] = z[0][:n]
        zmax[si, :n] = z[1][:n]
    out = (zmin, zmax, None if known.all() else known)
    if cache is not None:
        cache[(column, block)] = out
    return out


def _leaf_candidates(
    leaf, i: int, q_np: Dict, live: Sequence[ImmutableSegment], nb: int, block: int,
    cache: Optional[Dict] = None,
) -> Tuple[Optional[np.ndarray], bool]:
    """(bool [S, nb] conservative candidacy of one filter leaf over every
    segment at once, or None = cannot tell (all-candidate); exact: True
    when no block past a segment's rows is a candidate, so the caller
    need not mask them).  Each kind is a few array operations over the
    stacked zones, the literals broadcast on an axis of their own."""
    if leaf.mode != SV:
        return None, False
    kind = leaf.eval_kind
    if kind == "docrange":
        # exact block overlap with the doc interval: no zones needed
        b = q_np["bounds"][i]
        start = np.arange(0, nb * block, block, dtype=np.int64)
        return (start < b[:, 1:2]) & (start + block > b[:, 0:1]), False
    zmin, zmax, known = _stacked_zones(live, leaf.column, nb, block, cache)
    exact = known is None
    if kind == "interval":
        b = q_np["bounds"][i]
        out = (zmax >= b[:, 0:1]) & (zmin < b[:, 1:2])
    elif kind in ("points", "points_none"):
        # points [S, P, 1] against the zones [S, 1, nb]; -1 padding lies
        # below every zone (dictIds and empty zones start at 0)
        p = q_np["pts"][i][:, :, None]
        if kind == "points":
            out = ((zmin[:, None, :] <= p) & (p <= zmax[:, None, :])).any(axis=1)
        else:
            # NOT IN: a block drops only when every row is in the point
            # set, provable from zones only for single-value blocks
            out = ~((zmin == zmax) & (zmin[:, None, :] == p).any(axis=1))
            exact = False
    elif kind == "runs":
        rr = q_np["runs"][i]  # [S, k, 2], empty runs lo == hi == 0
        lo, hi = rr[:, :, 0:1], rr[:, :, 1:2]
        out = ((hi > lo) & (zmax[:, None, :] >= lo) & (zmin[:, None, :] < hi)).any(axis=1)
    else:
        # match table: any matching dictId within [zmin, zmax], from the
        # table's prefix counts (one flat gather per zone end)
        table = q_np["match"][i]
        S, top = table.shape
        csum = np.zeros((S, top + 1), dtype=np.int32)
        np.cumsum(table.view(np.uint8) if table.dtype == bool else table, axis=1, dtype=np.int32,
                  out=csum[:, 1:])
        row = (np.arange(S, dtype=np.int64) * (top + 1))[:, None]
        flat = csum.ravel()
        out = flat[row + np.minimum(zmax + 1, top)] > flat[row + np.minimum(zmin, top)]
    if known is not None:
        out[~known] = True
    return out, exact


def _tree_candidates(plan: StaticPlan, node, q_np, live, nb: int, block: int, cache=None):
    """(candidacy [S, nb] or None for all-candidate, exact) of a filter
    subtree: AND is exact when any part is, OR when every part is."""
    if node[0] == "leaf":
        return _leaf_candidates(plan.leaves[node[1]], node[1], q_np, live, nb, block, cache)
    parts = [_tree_candidates(plan, ch, q_np, live, nb, block, cache) for ch in node[1]]
    if node[0] == "and":
        maps = [c for c, _ in parts if c is not None]
        out = None
        for c in maps:
            out = c if out is None else out & c
        return out, any(e for _, e in parts)
    if any(c is None for c, _ in parts):
        return None, False
    out = parts[0][0]
    for c, _ in parts[1:]:
        out = out | c
    return out, all(e for _, e in parts)


def candidate_blocks(
    plan: StaticPlan,
    q_np: Dict,
    live: Sequence[ImmutableSegment],
    n_pad: int,
    block: Optional[int] = None,
    cache: Optional[Dict] = None,
) -> Optional[np.ndarray]:
    """bool [len(live), n_pad // block] candidate map, or None when block
    pruning does not apply (no filter, or segments under two blocks).
    Every segment is tested at once: the host cost is a few array
    operations per leaf, not per segment or per literal.  ``cache`` keeps
    the stacked zones (``StagedTable.zones`` of ``live``)."""
    if plan.filter_tree is None:
        return None
    block = block or zone_block_rows()
    if n_pad < 2 * block or n_pad % block:
        return None
    nb = n_pad // block
    cand, exact = _tree_candidates(plan, plan.filter_tree, q_np, live, nb, block, cache)
    if exact:
        return cand  # the empty zones past each segment's rows took no block
    # blocks past each segment's rows stay dead
    real = None if cache is None else cache.get(("real", block))
    if real is None:
        real_blocks = np.array([-(-seg.num_docs // block) for seg in live], dtype=np.int64)
        real = np.arange(nb)[None, :] < real_blocks[:, None]
        if cache is not None:
            cache[("real", block)] = real
    return real.copy() if cand is None else cand & real


def block_ids_input(cand: np.ndarray, nb_pad: int) -> np.ndarray:
    """The candidate map as ascending int32 block ids [S, nb_pad], -1
    padded (the kernels' ``block_ids``)."""
    ids = np.full((cand.shape[0], nb_pad), -1, dtype=np.int32)
    seg, blk = np.nonzero(cand)  # row-major: ascending blocks within a segment
    counts = cand.sum(axis=1)
    ids[seg, np.arange(seg.size) - (np.cumsum(counts) - counts)[seg]] = blk
    return ids


def block_rows_read(block_ids: np.ndarray, num_docs: Sequence[int], block: int) -> int:
    """Rows a block-table launch reads: the rows of each candidate block
    below its segment's num_docs."""
    ids = block_ids.astype(np.int64)
    docs = np.asarray(num_docs, dtype=np.int64)[:, None]
    rows = np.clip(np.minimum(docs, (ids + 1) * block) - ids * block, 0, None)
    return int(np.where(ids >= 0, rows, 0).sum())
