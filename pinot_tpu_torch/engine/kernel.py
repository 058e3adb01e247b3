"""The table kernel: StaticPlan + staged segments -> reduced outputs
(port of ``pinot_tpu.engine.kernel``).

The JAX package writes the pipeline for one segment and lifts it with
``vmap``; here every op works on the stacked ``[S, n_pad]`` axis written
out:

  mask        = filter tree over the leaves & (row < num_docs); an MV leaf
                is any (MV_ANY) or none (MV_NONE) of the row's valid
                entries matching
  values      = raw rows or dict_vals[fwd]; an MV column's entries
  MV states   = over the flattened pair space [S, n_pad * E * M]
                (``_Flat``): each row's E group-key entries times its M
                value entries, row major, through the same kernels
  scalars     = masked reductions per segment
  group-by    = count/sum/avg through the fused kernel over key windows,
                min/max scatters into [capacity] holders keyed by
                global-id mixed-radix keys
  value state = presence bits, a histogram or (bucket, rho) registers of
                a combined index, through ``value_state_counts.value_state``
                (K2), which combines the index itself

  sort pairs  = (group slot, valueId) pairs per row, int32, the sentinel
                on dropped rows, for value states too wide for a dense
                holder (``StaticAgg.sort_pairs``)
  selection   = per segment the k first docs in sort order

Per-segment states reduce over the segment axis (``output_reducers`` /
``apply_reduce``); group-by and value-state states are computed over
every segment at once (reducer "none"), the packed grouped-HLL keys
reduce by one sort (``_reduce_hll_sort``), the pairs by one sort-dedup
(``_reduce_distinct_pairs``), and selection candidates stay per segment.

Routing is keyed on the plan, never on the device, so the CPU tests take
the card's routes:
  * a plan whose filter is one single-value leaf the fused kernel takes
    (an interval, a doc interval, a match table, or a point list, which
    becomes a match table of the column's padded card),
    whose group-by is single-value and fits the kernel's shared-memory
    accumulators, and whose aggregations are all count / sum / avg,
    computes ``num_docs``, ``gb_presence`` and every state in one
    ``kernels.fused_groupby`` call with the filter inside (the fused
    route, counted in ``fused_dispatches``);
  * a plan whose filter is none or such a leaf, whose value states are
    dense presence / histogram holders, scalar HLL or the small grouped
    HLL ("matmul" in ``_grouped_hll_path``), and whose other aggregations
    are counts (grouped: count / sum / avg that K1 takes) computes each
    value state in one K2 launch with the leaf, the group-by columns and
    the value streams, and a grouped plan's counts and sums in one K1
    launch the same way: no mask, key or index is built in device memory
    (the fused value route, counted in ``fused_value_dispatches``);
  * every other plan, and every plan with a selection or a sort-pairs
    aggregation, evaluates its filter tree with torch ops and hands
    the mask to the same kernels as a match table over {0, 1}, with the
    group-by columns: group counts and float sums are per-block partials
    reduced in a fixed order, so they are the same on every run (no
    float atomics); the precombined group key is built only where min /
    max holders, key windows, more group-by columns than the kernels take
    (``MAX_GROUP_COLUMNS``), the "sort" and "scatter" grouped-HLL
    lowerings or the grouped sort pairs (torch ops, as they are jnp or
    ``lax.sort`` in the reference) need it.
On the card both kernels are the CUDA kernels; on the CPU their wrappers
run the plain torch versions.

Zone-map block skipping (``engine/zonemap.py``): when the executor puts
``block_ids`` (int32 [S, nb_pad], candidate zone blocks, -1 padded) in the
query inputs, the fused routes hand them to K1 and K2, which read those
blocks in place and nothing else; the torch-op route gathers the
candidate blocks first (``gather_blocks``, the reference's
``_gather_blocks``) and runs on the gathered rows, with their validity and
original doc ids (docrange leaves, selection doc ids) beside them.

Past the per-dispatch row budget (``config.CHUNK_ROWS``) a chunkable plan
runs as segment-axis chunks (``make_chunked_table_kernel``): each chunk is
one ``run_table_kernel`` over a slice of the segment axis (on the fused
routes one K1 or K2 launch), and the chunks' reduced outputs combine
elementwise in chunk order (``combine_reduced``).

Cross-query batching (``run_batched_table_kernel``, the lane's
micro-batching tier): B queries of one plan over the same staged segments,
each query-input leaf with a leading [B] axis.  On the fused routes one
batched K1 (and K2) launch serves every member, the row streams read once
and each member's literals as its own tables; the torch-op route and
selections run their members one after another inside the one launch
call (no hand kernel to batch there: they do not share the read).  Every
output gains a leading [B] axis.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from pinot_tpu_torch.engine import config
from pinot_tpu_torch.engine.device import StagedTable
from pinot_tpu_torch.engine.kernels import fused_groupby, value_state_counts
from pinot_tpu_torch.engine.plan import MV_ANY, SV, StaticAgg, StaticPlan, group_expansion

fused_dispatches = 0  # table-kernel runs that took the fused route
fused_value_dispatches = 0  # table-kernel runs that took the fused value route
block_dispatches = 0  # table-kernel runs over zone-map candidate blocks
batched_dispatches = 0  # batched table-kernel runs (run_batched_table_kernel)
chunked_dispatches = 0  # table-kernel runs split into segment-axis chunks

# grouped HLL lowerings (``_grouped_hll_path``), the reference's gates
# (pinot_tpu/engine/kernel.py:57,62); module constants so a test can force
# each lowering, as the reference's tests patch theirs
_MATMUL_HLL_CAP = 1 << 18
_HLL_SORT_CAP = 1 << 16

# int32 sentinel of masked packed HLL keys and of dropped (slot, gid)
# pairs: sorts past every real key (slots < MAX_GROUP_CAPACITY, gids < 2^31-1)
_PAIR_SENTINEL = torch.iinfo(torch.int32).max

_FUSED_LEAF_KINDS = ("interval", "docrange", "table", "points")
_VALUE_KINDS = ("presence", "hist", "hll")


def _valid_mask(seg: Dict[str, Any], n_pad: int) -> torch.Tensor:
    """[S, n_pad] doc validity from ``row < num_docs`` — no stored column
    (gathered blocks carry theirs)."""
    valid = seg.get("valid")
    if valid is not None:
        return valid
    nd = seg["num_docs"]
    rows = torch.arange(n_pad, device=nd.device)
    return rows[None, :] < nd[:, None]


def _mv_valid(seg: Dict[str, Any], column: str) -> torch.Tensor:
    """[S, n_pad, mv_pad] MV entry validity from the per-doc counts:
    entry < mvc."""
    mvc = seg[f"{column}.mvc"]
    entry = torch.arange(seg[f"{column}.mv"].shape[-1], device=mvc.device)
    return entry < mvc[..., None]


def _ids_match(kind: str, mode: str, q, i: int, ids: torch.Tensor) -> torch.Tensor:
    """Per-entry truth of leaf ``i`` over dictIds ``ids`` ([S, n_pad] or
    [S, n_pad, mv_pad]): the leaf's eval kind, SV complements baked in
    (an MV_NONE leaf's points and tables hold the excluded set)."""
    S = ids.shape[0]
    lead = (S,) + (1,) * (ids.dim() - 1)
    if kind == "interval":
        b = q["bounds"][i]
        return (ids >= b[:, 0].view(lead)) & (ids < b[:, 1].view(lead))
    if kind in ("points", "points_none"):
        pts = q["pts"][i]  # [S, k_pad], -1 padded
        hit = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
        for k in range(pts.shape[1]):
            hit |= ids == pts[:, k].view(lead)
        return ~hit if (kind == "points_none" and mode == SV) else hit
    if kind == "runs":
        rr = q["runs"][i]  # [S, k_pad, 2], SV complements baked in
        hit = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
        for k in range(rr.shape[1]):
            hit |= (ids >= rr[:, k, 0].view(lead)) & (ids < rr[:, k, 1].view(lead))
        return hit
    return torch.gather(q["match"][i], 1, ids.reshape(S, -1).long()).view(ids.shape)


def _leaf_mask(plan: StaticPlan, i: int, seg, q, n_pad: int) -> torch.Tensor:
    leaf = plan.leaves[i]
    kind = leaf.eval_kind
    if kind == "docrange":
        b = q["bounds"][i]
        rows = seg.get("rowid")  # gathered blocks: the original doc ids
        if rows is None:
            rows = torch.arange(n_pad, device=b.device)[None, :]
        return (rows >= b[:, 0:1]) & (rows < b[:, 1:2])
    if leaf.mode == SV:
        return _ids_match(kind, leaf.mode, q, i, seg[f"{leaf.column}.fwd"])
    hit = (_ids_match(kind, leaf.mode, q, i, seg[f"{leaf.column}.mv"])
           & _mv_valid(seg, leaf.column)).any(dim=-1)
    return hit if leaf.mode == MV_ANY else ~hit


def _eval_tree(plan: StaticPlan, node: tuple, seg, q, n_pad: int) -> torch.Tensor:
    if node[0] == "leaf":
        return _leaf_mask(plan, node[1], seg, q, n_pad)
    masks = [_eval_tree(plan, c, seg, q, n_pad) for c in node[1]]
    out = masks[0]
    for m in masks[1:]:
        out = (out & m) if node[0] == "and" else (out | m)
    return out


def _row_values(agg: StaticAgg, seg) -> torch.Tensor:
    """Per-row numeric values [S, n_pad] for an SV agg column."""
    if agg.use_raw:
        return seg[f"{agg.column}.raw"]  # streamed, no gather
    return torch.gather(seg[f"{agg.column}.dict"], 1, seg[f"{agg.column}.fwd"].long())


def _entry_gather(table: torch.Tensor, mv: torch.Tensor) -> torch.Tensor:
    """``table[s][mv[s, i, j]]``: a per-segment table read at every MV entry."""
    return torch.gather(table, 1, mv.reshape(mv.shape[0], -1).long()).view(mv.shape)


def _entry_values(agg: StaticAgg, seg) -> torch.Tensor:
    """Per-entry numeric values [S, n_pad, mv_pad] for an MV agg column:
    the staged decoded values, else the dictionary at each entry."""
    mvr = seg.get(f"{agg.column}.mvraw")
    if mvr is not None:
        return mvr
    return _entry_gather(seg[f"{agg.column}.dict"], seg[f"{agg.column}.mv"])


def _hll_rows(agg: StaticAgg, seg, bucket, rho) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (register index, rank) [S, n_pad] for an SV HLL agg: the
    staged uint8 streams when there are, else gathers of the per-dictId
    tables.  Returned in their own dtype; the index combine widens them."""
    hb = seg.get(f"{agg.column}.hllb")
    if hb is not None:
        return hb, seg[f"{agg.column}.hllr"]
    fwd = seg[f"{agg.column}.fwd"].long()
    return torch.gather(bucket, 1, fwd), torch.gather(rho, 1, fwd)


def _grouped_hll_path(capacity: int) -> str:
    """Which lowering a dense grouped-HLL agg takes — consulted by both
    ``_group_value_state`` and ``_state_reduce``, which must agree.

    'matmul':  (group, bucket, rho) occupancy counts (``value_state_counts``;
               the reference contracts one-hots on the MXU here).
    'sort':    packed int32 keys, sort + run-max extraction in the reduce.
    'scatter': flat scatter-max (the packed key would overflow int32).
    """
    if capacity * config.HLL_M * 64 <= _MATMUL_HLL_CAP:
        return "matmul"
    if capacity <= _HLL_SORT_CAP:
        return "sort"
    return "scatter"


class _Flat:
    """The pair space a state is computed over, flattened to [S, n_pad * E
    * M]: each row's E group-key entries (the product of the MV group
    columns' ``mv_pad``, 1 without) times the M entries of an MV value
    column (its ``mv_pad``, 1 for an SV one), row major, so a segment's
    pairs keep row order (the order the reference scatters them in).  The
    kernels take such a stream as their row axis, with the row bound
    ``num_docs * E * M``, an int32: a plan whose ``n_pad * E * M`` passes
    it runs on the host (``plan.segment_pairs``).  With E = M = 1 every
    stream is its own [S, n_pad] view: nothing is copied; otherwise a row
    stream costs E * M times its bytes."""

    def __init__(self, S: int, n: int, E: int = 1, M: int = 1) -> None:
        self.S, self.n, self.E, self.M = S, n, E, M

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """A per-row stream [S, n_pad] -> [S, N]."""
        return t[:, :, None, None].expand(self.S, self.n, self.E, self.M).reshape(self.S, -1)

    def keys(self, t: torch.Tensor) -> torch.Tensor:
        """A per-key-entry stream [S, n_pad, E or 1] -> [S, N]."""
        return t[..., None].expand(self.S, self.n, self.E, self.M).reshape(self.S, -1)

    def entries(self, t: torch.Tensor) -> torch.Tensor:
        """A per-value-entry stream [S, n_pad, M] -> [S, N]."""
        return t[:, :, None, :].expand(self.S, self.n, self.E, self.M).reshape(self.S, -1)

    def num_docs(self, seg) -> torch.Tensor:
        nd = seg["num_docs"]
        return nd if self.E * self.M == 1 else nd * (self.E * self.M)


_VALUE_MODES = {"presence": "presence", "hist": "counts", "hll": "registers"}


def _value_inputs(agg: StaticAgg, aux, seg, flat: _Flat) -> Dict[str, Any]:
    """K2's value arguments in ``flat``'s pair space: an MV column's
    entries through the remap table (presence / hist) or the per-dictId
    tables (hll); for an SV column the staged global-id stream, else the
    local fwd through the remap table (presence / hist), the staged
    (bucket, rho) uint8 streams, else the fwd through the tables (hll)."""
    if agg.is_mv:
        values = flat.entries(seg[f"{agg.column}.mv"])
        if agg.kind in ("presence", "hist"):
            return dict(values=values, value_table=aux["remap"], width=agg.gcard_pad)
        return dict(values=values, value_table=aux["bucket"], rho_table=aux["rho"])
    if agg.kind in ("presence", "hist"):
        gf = seg.get(f"{agg.column}.gfwd")
        if gf is not None:
            return dict(values=flat.rows(gf), width=agg.gcard_pad)
        return dict(values=flat.rows(seg[f"{agg.column}.fwd"]), value_table=aux["remap"],
                    width=agg.gcard_pad)
    hb = seg.get(f"{agg.column}.hllb")
    if hb is not None:
        return dict(values=flat.rows(hb), rho=flat.rows(seg[f"{agg.column}.hllr"]))
    return dict(values=flat.rows(seg[f"{agg.column}.fwd"]), value_table=aux["bucket"],
                rho_table=aux["rho"])


def _value_state(agg: StaticAgg, aux, seg, flat: _Flat, filt: Dict[str, Any],
                 group: Optional[Dict[str, Any]] = None, capacity: int = 0, members: int = 0):
    """(matched total, holder) of one value-state agg from one K2 launch
    over every segment: presence bits, the histogram or HLL registers,
    ``[capacity, ...]`` when grouped.  The filter and group streams are in
    ``flat``'s pair space; ``group`` also carries the fused route's block
    ids (``block_ids`` / ``block_rows``).  With ``members`` one batched
    launch serves every member (the per-member tables lead with
    ``[members]``), and both outputs lead with that axis."""
    kw = dict(_value_inputs(agg, aux, seg, flat), capacity=max(capacity, 1), **filt, **(group or {}))
    mode = _VALUE_MODES[agg.kind]
    if members:
        docs, holder = value_state_counts.value_state_batched(mode, flat.num_docs(seg), members=members, **kw)
    else:
        docs, holder = value_state_counts.value_state(mode, flat.num_docs(seg), **kw)
    lead = ((members,) if members else ()) + ((capacity,) if capacity else ())
    return docs, holder.reshape(*lead, config.HLL_M if agg.kind == "hll" else agg.gcard_pad)


def _pair_gids(agg: StaticAgg, aux, seg, flat: _Flat) -> torch.Tensor:
    """int32 value ids [S, N] of a sort-pairs agg in ``flat``'s pair space:
    the global value id (presence / hist: an MV column's entries through
    the remap table, an SV column's staged global-id stream, which
    ``_role_columns`` stages for every SV presence / hist column), or
    ``bucket * 64 + rho`` (hll)."""
    if agg.kind == "hll":
        b, r = _pair_hll(agg, aux, seg, flat)
        return b.to(torch.int32) * 64 + r.to(torch.int32)
    if agg.is_mv:
        return flat.entries(_entry_gather(aux["remap"], seg[f"{agg.column}.mv"]))
    return flat.rows(seg[f"{agg.column}.gfwd"].to(torch.int32))


def _pair_hll(agg: StaticAgg, aux, seg, flat: _Flat) -> Tuple[torch.Tensor, torch.Tensor]:
    """(register index, rank) [S, N] of an HLL agg in ``flat``'s pair space."""
    if agg.is_mv:
        mv = seg[f"{agg.column}.mv"]
        return (flat.entries(_entry_gather(aux["bucket"], mv)),
                flat.entries(_entry_gather(aux["rho"], mv)))
    b, r = _hll_rows(agg, seg, aux["bucket"], aux["rho"])
    return flat.rows(b), flat.rows(r)


def _sort_pairs(agg: StaticAgg, aux, seg, flat: _Flat, keep: torch.Tensor,
                slot: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(group slot, gid) int32 pairs [S, N] of a sort-pairs agg, the
    sentinel in both where ``keep`` is False.  ``slot`` is the group slot
    per pair (None when ungrouped: slot 0)."""
    gid = _pair_gids(agg, aux, seg, flat)
    slot = torch.zeros_like(gid) if slot is None else slot.to(torch.int32)
    return torch.where(keep, slot, _PAIR_SENTINEL), torch.where(keep, gid, _PAIR_SENTINEL)


def _mask_filter(mask: torch.Tensor) -> Dict[str, Any]:
    """An evaluated [S, N] mask as a kernel filter: a match table over
    {0, 1}."""
    S = mask.shape[0]
    match = torch.arange(2, device=mask.device).bool().expand(S, 2).contiguous()  # [False, True]
    return dict(filter_fwd=mask.view(torch.uint8), match=match)


def _agg_flat(agg: StaticAgg, seg, mask: torch.Tensor, E: int = 1,
              kvalid: Optional[torch.Tensor] = None) -> Tuple[_Flat, torch.Tensor]:
    """The pair space of a value-state or sort-pairs agg and its validity
    [S, N]: the key entries (``kvalid`` [S, n_pad, E], else the row mask)
    times the agg column's valid MV entries."""
    S, n = mask.shape
    M = seg[f"{agg.column}.mv"].shape[-1] if agg.is_mv else 1
    flat = _Flat(S, n, E, M)
    valid = flat.keys(kvalid) if kvalid is not None else flat.rows(mask)
    if agg.is_mv:
        valid = valid & flat.entries(_mv_valid(seg, agg.column))
    return flat, valid


def _agg_state(agg: StaticAgg, i: int, seg, q, mask, fdt) -> Any:
    """Partial state for one aggregation (no group-by): per segment [S]
    for scalar and pair kinds, over every segment at once for value
    states (one K2 launch covers all S segments).  An MV agg reads every
    valid entry of its matched rows."""
    base = agg.base
    aux = q["agg_aux"][i]
    if agg.sort_pairs or agg.kind in _VALUE_KINDS:
        flat, valid = _agg_flat(agg, seg, mask)
        if agg.sort_pairs:
            return _sort_pairs(agg, aux, seg, flat, valid, None)
        return _value_state(agg, aux, seg, flat, _mask_filter(valid))[1]
    if agg.is_mv:
        m, dims = _mv_valid(seg, agg.column) & mask[..., None], (1, 2)
    else:
        m, dims = mask, 1
    if base == "count":
        return m.sum(dim=dims, dtype=torch.int64)
    vals = _entry_values(agg, seg) if agg.is_mv else _row_values(agg, seg)
    inf = torch.tensor(float("inf"), dtype=fdt, device=vals.device)
    zero = torch.zeros((), dtype=fdt, device=vals.device)
    if base == "sum":
        return torch.where(m, vals, zero).sum(dim=dims, dtype=fdt)
    if base == "min":
        return torch.where(m, vals, inf).amin(dim=dims)
    if base == "max":
        return torch.where(m, vals, -inf).amax(dim=dims)
    if base == "avg":
        return (torch.where(m, vals, zero).sum(dim=dims, dtype=fdt), m.sum(dim=dims, dtype=torch.int64))
    if base == "minmaxrange":
        return (torch.where(m, vals, inf).amin(dim=dims), torch.where(m, vals, -inf).amax(dim=dims))
    raise AssertionError(agg)


def _group_columns(plan: StaticPlan, seg, q) -> Tuple[list, list]:
    """(id stream, remap or None) per SV group-by column: the staged
    global-id stream, else the local fwd with its remap table."""
    gb = plan.group_by
    cols, remaps = [], []
    for col, remap, use_g in zip(gb.columns, q["group_remap"], gb.use_gfwd):
        cols.append(seg[f"{col}.gfwd"] if use_g else seg[f"{col}.fwd"])
        remaps.append(None if use_g else remap)
    return cols, remaps


def _group_kwargs(plan: StaticPlan, seg, q) -> Dict[str, Any]:
    """The SV group-by columns as the kernels take them (they combine the key)."""
    cols, remaps = _group_columns(plan, seg, q)
    return dict(group_cols=cols, group_cards=plan.group_by.gcards, group_remaps=remaps)


def _group_entries(plan: StaticPlan, staged: StagedTable, seg, q, mask):
    """The group-by columns over each row's E key entries (the MV
    expansion: each row adds to the group of each of its entries' key,
    duplicates within a row included, the first MV column major):
    (id streams [S, n_pad, E or 1], remap or None per column, the entry
    validity [S, n_pad, E], E)."""
    gb = plan.group_by
    S, n = mask.shape
    pads = [staged.column(c).mv_pad for c, mv in zip(gb.columns, gb.col_is_mv) if mv]
    E = group_expansion(gb, staged)
    cols, remaps, valid, p = [], [], mask[:, :, None], 0
    for col, is_mv, remap, use_g in zip(gb.columns, gb.col_is_mv, q["group_remap"], gb.use_gfwd):
        if not is_mv:
            cols.append((seg[f"{col}.gfwd"] if use_g else seg[f"{col}.fwd"])[:, :, None])
            remaps.append(None if use_g else remap)
            continue
        shape = [S, n] + [pads[k] if k == p else 1 for k in range(len(pads))]

        def spread(t):
            return t.view(shape).expand(S, n, *pads).reshape(S, n, E)

        cols.append(spread(seg[f"{col}.mv"]))
        remaps.append(remap)
        valid = valid & spread(_mv_valid(seg, col))
        p += 1
    return cols, remaps, valid.expand(S, n, E), E


def _group_keys(cols, gcards, remaps, kdt) -> torch.Tensor:
    """The mixed-radix global group key in ``kdt`` of the group columns'
    [S, N] streams (the torch-op route; the fused route has K1 combine it)."""
    return fused_groupby.combine_group_keys(cols, gcards, remaps, dtype=kdt)


def _weights(plan: StaticPlan, seg, mask, fdt) -> Dict[Tuple[str, str], torch.Tensor]:
    """Per-row float weight streams [S, n_pad] of the grouped sums K1 takes:
    ("v", column) the row's value (SV) or the sum of its valid entries
    (MV: sum / avg), ("n", column) the count of its valid entries (MV:
    count / avg).  Each row's weight adds to the group of each of its key
    entries."""
    out: Dict[Tuple[str, str], torch.Tensor] = {}
    for agg in plan.aggs:
        if agg.kind not in ("scalar", "pair") or agg.base not in ("count", "sum", "avg"):
            continue
        if not agg.is_mv:
            if agg.base != "count":
                out.setdefault(("v", agg.column), _row_values(agg, seg))
            continue
        m = _mv_valid(seg, agg.column)
        if agg.base != "sum":
            out.setdefault(("n", agg.column), m.sum(dim=-1).to(fdt))
        if agg.base != "count":
            zero = torch.zeros((), dtype=fdt, device=mask.device)
            out.setdefault(("v", agg.column),
                           torch.where(m, _entry_values(agg, seg), zero).sum(dim=-1, dtype=fdt))
    return out


def _group_sums(
    plan: StaticPlan, staged: StagedTable, seg, weights, flat: _Flat, filt, group_cols, group_remaps, slot
) -> Tuple[torch.Tensor, Dict[Tuple[str, str], torch.Tensor]]:
    """Group counts (int64 [capacity]) and float sums per weight stream over
    every segment's key entries, through the fused kernel with the
    evaluated entry mask as its filter (a match table over {0, 1}) and
    the group-by columns, whose key it combines.  The kernel's group space
    is bounded by its shared memory and its group columns by
    ``MAX_GROUP_COLUMNS``, so a wider space or more columns run in key
    windows over the precombined key (``slot()``), and more weight streams
    than the kernel takes run in chunks: each call adds per-block partials
    in a fixed order, so the result is the same on every run."""
    cap = plan.group_by.capacity
    fdt = staged.precision.float_dtype
    fbytes = 8 if staged.precision.x64 else 4
    keys = list(weights)
    num_docs = flat.num_docs(seg)
    remap_cards = [r.shape[-1] for r in group_remaps if r is not None]
    chunks = [keys[j : j + fused_groupby.MAX_VALUE_COLUMNS]
              for j in range(0, len(keys), fused_groupby.MAX_VALUE_COLUMNS)] or [[]]
    counts: Optional[torch.Tensor] = None
    sums: Dict[Tuple[str, str], torch.Tensor] = {}
    for chunk in chunks:
        raws = [flat.rows(weights[k]) for k in chunk]
        nones = [None] * len(chunk)
        if (len(group_cols) <= fused_groupby.MAX_GROUP_COLUMNS
                and all(c <= fused_groupby.MAX_TABLE_CARD for c in remap_cards)
                and cap <= fused_groupby.max_capacity(fbytes, len(chunk), 0, 2, sum(remap_cards))):
            _, cnt, sm = fused_groupby.fused_filtered_groupby_sums(
                filt["filter_fwd"], filt["match"], num_docs, None, nones, nones, cap, dtype=fdt,
                value_raws=raws, group_cols=group_cols, group_cards=plan.group_by.gcards,
                group_remaps=group_remaps,
            )
            parts_c, parts_s = [cnt], [sm]
        else:
            keys32 = slot().to(torch.int32)  # capacity <= MAX_GROUP_CAPACITY fits int32
            window = fused_groupby.max_capacity(fbytes, len(chunk), 0, 2)
            parts_c, parts_s = [], []
            for lo in range(0, cap, window):
                _, cnt, sm = fused_groupby.fused_filtered_groupby_sums(
                    filt["filter_fwd"], filt["match"], num_docs, keys32 - lo if lo else keys32,
                    nones, nones, min(window, cap - lo), dtype=fdt, value_raws=raws,
                )
                parts_c.append(cnt)
                parts_s.append(sm)
        if counts is None:
            counts = torch.cat(parts_c)
        for j, k in enumerate(chunk):
            sums[k] = torch.cat([p[j] for p in parts_s])
    return counts, sums


def _group_value_state(agg: StaticAgg, aux, seg, mask, kvalid, E: int, group, slot, cap: int) -> Any:
    """Grouped value-state holder over every segment's (key entry, value
    entry) pairs: dense presence / histogram grids and small-group HLL
    registers from one K2 launch with the group-by columns (``group``, in
    key-entry form; None when there are more than K2 takes: then the
    precombined key is its one group column, masked entries carrying
    ``cap`` and so dropping), larger group spaces by the reference's sort
    or scatter lowering over the precombined key (``slot()``), and states
    too wide for a dense holder as (slot, gid) pairs."""
    flat, valid = _agg_flat(agg, seg, mask, E, kvalid)
    S, n = mask.shape

    def pair_slot():
        return flat.keys(slot().view(S, n, E))

    if agg.sort_pairs:
        return _sort_pairs(agg, aux, seg, flat, valid, pair_slot())
    path = _grouped_hll_path(cap) if agg.kind == "hll" else "matmul"
    if path == "matmul":
        if group is None:
            group = dict(group_cols=[pair_slot().to(torch.int32)], group_cards=[cap], group_remaps=[None])
        else:
            group = dict(group, group_cols=[flat.keys(c) for c in group["group_cols"]])
        return _value_state(agg, aux, seg, flat, _mask_filter(valid), group, cap)[1]
    b, r = _pair_hll(agg, aux, seg, flat)
    keys = pair_slot()
    if path == "sort":
        # one packed int32 per pair (capacity <= 2^16 keeps it below 2^30),
        # sorted and run-max extracted by the reduce (_reduce_hll_sort)
        cell = keys.to(torch.int32) * config.HLL_M + b.to(torch.int32)
        return torch.where(valid, (cell << 6) | r.to(torch.int32), _PAIR_SENTINEL)
    # flat scatter-max into [capacity * HLL_M] registers, a spare drop cell
    cell = keys.long() * config.HLL_M + b.long()
    ncells = cap * config.HLL_M
    regs = torch.zeros(ncells + 1, dtype=torch.int32, device=keys.device)
    regs.scatter_reduce_(0, torch.where(valid, cell, ncells).reshape(-1),
                         r.to(torch.int32).reshape(-1), reduce="amax", include_self=True)
    return regs[:ncells].view(cap, config.HLL_M).to(torch.uint8)


def _group_outputs(plan: StaticPlan, staged: StagedTable, seg, q, mask) -> Dict[str, Any]:
    """Grouped states over every segment's key entries at once (module
    docstring).  The precombined key is built only where min/max holders,
    key windows, more group columns than the kernels take or the sort /
    scatter HLL lowerings need it."""
    cap = plan.group_by.capacity
    fdt = staged.precision.float_dtype
    cols, remaps, kvalid, E = _group_entries(plan, staged, seg, q, mask)
    S, n = mask.shape
    flat = _Flat(S, n, E)
    group_cols = [flat.keys(c) for c in cols]
    entry_mask = flat.keys(kvalid)
    keys: List[torch.Tensor] = []

    def slot() -> torch.Tensor:
        """The key [S, n_pad * E] in the key dtype, masked entries -> the
        spare slot."""
        if not keys:
            key = _group_keys(group_cols, plan.group_by.gcards, remaps, staged.precision.key_dtype)
            keys.append(torch.where(entry_mask, key, cap))
        return keys[0]

    weights = _weights(plan, seg, mask, fdt)
    counts, sums = _group_sums(plan, staged, seg, weights, flat, _mask_filter(entry_mask),
                               group_cols, remaps, slot)
    out: Dict[str, Any] = {"gb_presence": (counts > 0).to(torch.int32)}
    fits = len(plan.group_by.columns) <= value_state_counts.MAX_GROUP_COLUMNS
    group = dict(group_cols=cols, group_cards=plan.group_by.gcards, group_remaps=remaps) if fits else None

    def extreme(agg, reduce, seed):
        if agg.is_mv:  # the row's extreme over its valid entries
            vals = torch.where(_mv_valid(seg, agg.column), _entry_values(agg, seg),
                               torch.tensor(seed, dtype=fdt, device=mask.device))
            vals = vals.amin(dim=-1) if reduce == "amin" else vals.amax(dim=-1)
        else:
            vals = _row_values(agg, seg)
        h = torch.full((cap + 1,), seed, dtype=fdt, device=mask.device)
        h.scatter_reduce_(0, slot().reshape(-1).long(), flat.rows(vals).reshape(-1).to(fdt),
                          reduce=reduce, include_self=True)
        return h[:cap]

    for i, agg in enumerate(plan.aggs):
        base = agg.base
        if agg.kind in _VALUE_KINDS:
            state = _group_value_state(agg, q["agg_aux"][i], seg, mask, kvalid, E, group, slot, cap)
        elif base == "count":
            state = sums[("n", agg.column)] if agg.is_mv else counts
        elif base == "sum":
            state = sums[("v", agg.column)]
        elif base == "avg":
            state = (sums[("v", agg.column)], sums[("n", agg.column)] if agg.is_mv else counts)
        elif base == "min":
            state = extreme(agg, "amin", float("inf"))
        elif base == "max":
            state = extreme(agg, "amax", float("-inf"))
        elif base == "minmaxrange":
            state = (extreme(agg, "amin", float("inf")), extreme(agg, "amax", float("-inf")))
        else:
            raise AssertionError(agg)
        out[f"gb_{i}"] = state
    return out


def _sort_ordinals(sel, seg, q, dtype):
    """Per sort column: the global ordinal of each doc's value [S, n_pad]
    in ``dtype`` (an MV column's first entry), flipped for a descending
    column, with its cardinality."""
    for col, asc, gcard, remap, use_g in zip(
        sel.sort_columns, sel.sort_ascending, sel.sort_gcards, q.get("sel_remap", ()), sel.use_gfwd
    ):
        if use_g:
            g = seg[f"{col}.gfwd"].to(dtype)
        else:
            ids = seg.get(f"{col}.fwd")
            if ids is None:  # an MV column orders by its first entry
                ids = seg[f"{col}.mv"][:, :, 0]
            g = torch.gather(remap, 1, ids.long()).to(dtype)
        if not asc:
            g = (gcard - 1) - g
        yield g, gcard


def _selection_outputs(plan: StaticPlan, seg, q, mask) -> Dict[str, Any]:
    """Per segment the k first docs [S, k] in (matched first, sort key,
    doc) order, and whether each matched.  The reference takes
    ``lax.top_k`` of one packed key (ties: the lower doc first) or, for a
    key space wider than the key dtype, one multi-operand ``lax.sort``.
    Here the packed key folds the doc id in, so no two scores tie and
    ``torch.topk`` (which promises no order among ties) picks the same
    docs in the same order; where the folded key would not fit int64,
    and for the unpacked plan, successive stable sorts from the least
    significant key to the mask key do the lexicographic sort, doc order
    coming from stability."""
    sel = plan.selection
    S, n = mask.shape
    space = 1
    for g in sel.sort_gcards:
        space *= g
    if sel.packed and (space + 1) * n <= 1 << 63:
        key = torch.zeros(mask.shape, dtype=torch.int64, device=mask.device)
        for g, gcard in _sort_ordinals(sel, seg, q, torch.int64):
            key = key * gcard + g
        doc = torch.arange(n, dtype=torch.int64, device=mask.device)
        score = torch.where(mask, key, space) * n + doc
        idx = torch.topk(score, sel.k, dim=1, largest=False, sorted=True).indices
    else:
        keys = [(~mask).to(torch.int32)]  # matches first
        keys.extend(g for g, _ in _sort_ordinals(sel, seg, q, torch.int32))
        idx = torch.arange(n, device=mask.device).expand(S, n)
        for key in reversed(keys):
            perm = torch.sort(torch.gather(key, 1, idx), dim=1, stable=True).indices
            idx = torch.gather(idx, 1, perm)
        idx = idx[:, : sel.k]
    return {"sel_docids": idx.to(torch.int32), "sel_valid": torch.gather(mask, 1, idx)}


def output_reducers(plan: StaticPlan) -> Dict[str, str]:
    """Reduce op over the segment axis per output key."""
    red: Dict[str, str] = {"num_docs": "sum"}
    if plan.group_by is not None:
        red["gb_presence"] = "none"
        for i, agg in enumerate(plan.aggs):
            red[f"gb_{i}"] = _state_reduce(agg, plan.group_by.capacity)
    else:
        for i, agg in enumerate(plan.aggs):
            red[f"agg_{i}"] = _state_reduce(agg)
    if plan.selection is not None:
        red["sel_docids"] = "none"
        red["sel_valid"] = "none"
    return red


def _state_reduce(agg: StaticAgg, capacity: int = 0) -> str:
    """'none' for states already computed over every segment: grouped
    states, and value states (whose reference reducers — max for presence
    and registers, sum for histograms — the summed counts already
    apply)."""
    if agg.sort_pairs:
        return "distinct_pairs"
    if capacity:
        if agg.kind == "hll" and _grouped_hll_path(capacity) == "sort":
            # packed-key states: the reduce sorts and extracts registers;
            # the capacity rides in the op tag
            return f"hll_sort:{capacity}"
        return "none"
    if agg.kind in ("presence", "hist", "hll"):
        return "none"
    return {
        "count": "sum",
        "sum": "sum",
        "min": "min",
        "max": "max",
        "avg": "sum_pair",
        "minmaxrange": "minmax_pair",
    }[agg.base]


def _reduce_hll_sort(value: torch.Tensor, capacity: int) -> torch.Tensor:
    """Dense grouped-HLL registers from packed (group, bucket, rho) int32
    keys across all segments: one sort plus a searchsorted run-max
    extraction.  rho rides the low 6 bits, so the largest packed key
    within a (group, bucket) cell carries the cell's max rho."""
    s = torch.sort(value.reshape(-1)).values
    ncells = capacity * config.HLL_M
    cell_ids = torch.arange(ncells, dtype=torch.int32, device=s.device)
    # the last packed key below (cell+1)<<6 is the cell's max-rho entry
    pos = torch.searchsorted(s, (cell_ids + 1) << 6) - 1
    v = s[pos.clamp(min=0)]
    regs = torch.where((pos >= 0) & ((v >> 6) == cell_ids), v & 63, 0)
    return regs.view(capacity, config.HLL_M).to(torch.uint8)


def _reduce_distinct_pairs(value) -> Tuple[torch.Tensor, ...]:
    """Global sort-dedup of (group slot, valueId) pairs across all
    segments: the exact distinct / histogram merge without per-pair
    state.  torch has no multi-operand sort, so each kept pair packs into
    one int64 key ``slot << 32 | gid`` (both are non-negative int32, so
    the key order is the lexicographic pair order); the dropped pairs
    (sentinels, which the reference sorts last) are left out before the
    sort, and the run starts compact in order by ``torch.nonzero``.

    Returns (slots, gids, starts, n_unique, total_valid) with the
    reference's contract (``pinot_tpu/engine/kernel.py:879-909``): the
    first ``n_unique`` entries are the unique pairs in (slot, gid) order
    and each one's first position in the sorted kept pairs, so per-pair
    occurrence counts are diff(starts) with ``total_valid`` closing the
    last run.  The buffers hold min(n_unique, DISTINCT_PAIR_CAP) entries:
    ``n_unique`` above the cap is the overflow the executor refuses."""
    s = value[0].reshape(-1)
    g = value[1].reshape(-1)
    kept = torch.nonzero(s != _PAIR_SENTINEL).squeeze(1)
    key = torch.sort((s[kept].long() << 32) | g[kept].long()).values
    first = torch.ones(key.shape, dtype=torch.bool, device=key.device)
    first[1:] = key[1:] != key[:-1]
    starts = torch.nonzero(first).squeeze(1)
    n_unique = first.sum(dtype=torch.int32)
    total_valid = torch.full((), key.numel(), dtype=torch.int32, device=key.device)
    starts = starts[: config.DISTINCT_PAIR_CAP]
    head = key[starts]
    return ((head >> 32).to(torch.int32), (head & 0xFFFFFFFF).to(torch.int32),
            starts.to(torch.int32), n_unique, total_valid)


def apply_reduce(op: str, value: Any):
    if op.startswith("hll_sort:"):
        return _reduce_hll_sort(value, int(op.split(":", 1)[1]))
    if op == "distinct_pairs":
        return _reduce_distinct_pairs(value)
    if op == "none":
        return value
    if op == "sum":
        return value.sum(dim=0)
    if op == "min":
        return value.amin(dim=0)
    if op == "max":
        return value.amax(dim=0)
    if op == "sum_pair":
        return (value[0].sum(dim=0), value[1].sum(dim=0))
    if op == "minmax_pair":
        return (value[0].amin(dim=0), value[1].amax(dim=0))
    raise ValueError(op)


def _segment_outputs(plan: StaticPlan, staged: StagedTable, seg, q) -> Dict[str, Any]:
    """The torch-op path's outputs, before ``apply_reduce``."""
    n_pad = staged.n_pad
    mask = _valid_mask(seg, n_pad)
    if plan.filter_tree is not None:
        mask = mask & _eval_tree(plan, plan.filter_tree, seg, q, n_pad)
    out: Dict[str, Any] = {"num_docs": mask.sum(dim=1, dtype=torch.int64)}
    if plan.group_by is not None:
        out.update(_group_outputs(plan, staged, seg, q, mask))
        return out
    fdt = staged.precision.float_dtype
    for i, agg in enumerate(plan.aggs):
        out[f"agg_{i}"] = _agg_state(agg, i, seg, q, mask, fdt)
    if plan.selection is not None:
        out.update(_selection_outputs(plan, seg, q, mask))
        rowid = seg.get("rowid")
        if rowid is not None:  # gathered positions -> doc ids
            out["sel_docids"] = torch.gather(rowid, 1, out["sel_docids"].long()).to(torch.int32)
    return out


# row-shaped staged roles: gathered by ``gather_blocks``
_ROW_ROLES = (".fwd", ".raw", ".gfwd", ".mv", ".mvc", ".hllb", ".hllr", ".mvraw")


def gather_blocks(seg: Dict[str, Any], block_ids: torch.Tensor, block: int) -> Dict[str, Any]:
    """The candidate row blocks of every row-shaped array ([S, n_pad, ...]
    -> [S, nb_pad * block, ...]), the gathered rows' ``valid`` mask (a
    real block, a row below num_docs) and original doc ids (``rowid``),
    and ``num_docs`` set to the gathered width, since ``valid`` now
    carries the rows' validity (the reference's ``_gather_blocks``)."""
    rowid, live = fused_groupby.candidate_rows(block_ids, block)
    out: Dict[str, Any] = {}
    for k, v in seg.items():
        if k.endswith(_ROW_ROLES):
            idx = rowid if v.dim() == 2 else rowid[:, :, None].expand(-1, -1, v.shape[-1])
            out[k] = torch.gather(v, 1, idx)
        else:
            out[k] = v
    nd = seg["num_docs"]
    out["valid"] = live & (rowid < nd[:, None])
    out["rowid"] = rowid
    out["num_docs"] = torch.full_like(nd, rowid.shape[1])
    return out


def _fused_value_columns(plan: StaticPlan, value_states: bool = False) -> Optional[List[str]]:
    """Distinct value columns of the plan's sum / avg aggregations when
    every other aggregation is a count (or, with ``value_states``, a
    value state), else None."""
    cols: List[str] = []
    for agg in plan.aggs:
        if agg.is_mv:
            return None
        if value_states and agg.kind in _VALUE_KINDS:
            continue
        if agg.base not in ("count", "sum", "avg"):
            return None
        if agg.base != "count" and agg.column not in cols:
            cols.append(agg.column)
    return cols


def _fused_leaf_card(plan: StaticPlan, staged: StagedTable) -> Optional[int]:
    """For a plan whose filter the fused kernels take (none, or one
    single-value interval, docrange, point-list or match-table leaf):
    its match table's card (0 without one; a list of two or more points
    is a match table).  Else None."""
    if plan.filter_tree is None:
        return 0
    if plan.filter_tree != ("leaf", 0):
        return None
    leaf = plan.leaves[0]
    if leaf.mode != SV:
        return None
    if leaf.eval_kind not in _FUSED_LEAF_KINDS:
        return None
    if leaf.eval_kind in ("interval", "docrange") or (leaf.eval_kind == "points" and leaf.k_pad == 1):
        return 0
    card = staged.column(leaf.column).card_pad
    return card if card <= fused_groupby.MAX_TABLE_CARD else None


def _k1_fits(plan: StaticPlan, staged: StagedTable, cols: List[str], match_card: int) -> bool:
    """Whether one K1 launch takes the plan's group-by with these sum
    columns: single-value group columns it combines itself, dictionaries
    and remap tables in its shared memory."""
    gb = plan.group_by
    if any(gb.col_is_mv) or len(gb.columns) > fused_groupby.MAX_GROUP_COLUMNS:
        return False
    if len(cols) > fused_groupby.MAX_VALUE_COLUMNS:
        return False
    use_raw = {a.column: a.use_raw for a in plan.aggs}
    dict_cards = [staged.column(c).card_pad for c in cols if not use_raw[c]]
    # a remap-fed group column's table sits in the kernel's shared memory
    remap_cards = [staged.column(c).card_pad for c, use_g in zip(gb.columns, gb.use_gfwd) if not use_g]
    if any(card > fused_groupby.MAX_TABLE_CARD for card in dict_cards + remap_cards):
        return False
    fbytes = 8 if staged.precision.x64 else 4
    return fused_groupby.fits_shared_memory(fbytes, gb.capacity, len(cols), dict_cards, match_card, remap_cards)


def _torch_op_only(plan: StaticPlan) -> bool:
    """A selection's top-k and a sort-pairs agg's (slot, gid) pairs are
    torch ops over the evaluated mask: such plans take the torch-op route."""
    return plan.selection is not None or any(a.sort_pairs for a in plan.aggs)


def fused_eligible(plan: StaticPlan, staged: StagedTable) -> bool:
    """Whether this plan takes the fused kernel (module docstring)."""
    if plan.group_by is None or plan.filter_tree is None or _torch_op_only(plan):
        return False
    match_card = _fused_leaf_card(plan, staged)
    cols = _fused_value_columns(plan)
    return match_card is not None and cols is not None and _k1_fits(plan, staged, cols, match_card)


def fused_value_eligible(plan: StaticPlan, staged: StagedTable) -> bool:
    """Whether this plan takes the fused value route (module docstring):
    the fused kernels' filter, value states K2 counts (grouped HLL only
    in its "matmul" lowering), and beside them counts (or, grouped,
    count / sum / avg that K1 takes)."""
    if _torch_op_only(plan):
        return False
    match_card = _fused_leaf_card(plan, staged)
    cols = _fused_value_columns(plan, value_states=True)
    values = [a for a in plan.aggs if a.kind in _VALUE_KINDS]
    if match_card is None or cols is None or not values:
        return False
    gb = plan.group_by
    if gb is None:
        return not cols
    if any(a.kind == "hll" and _grouped_hll_path(gb.capacity) != "matmul" for a in values):
        return False
    return _k1_fits(plan, staged, cols, match_card)


def _leaf_filter(plan: StaticPlan, staged: StagedTable, seg, q) -> Dict[str, Any]:
    """The fused kernels' filter arguments for the plan's one leaf ({}
    for a plan with no filter).  A list of points becomes a match table
    of the column's padded card (the dictionary it was staged with)."""
    if plan.filter_tree is None:
        return {}
    leaf = plan.leaves[0]
    fwd = seg.get(f"{leaf.column}.fwd")
    if leaf.eval_kind == "table":
        return dict(filter_fwd=fwd, match=q["match"][0])
    if leaf.eval_kind == "docrange":
        return dict(filter_bounds=q["bounds"][0])
    if leaf.eval_kind == "interval":
        return dict(filter_fwd=fwd, filter_bounds=q["bounds"][0])
    pts = q["pts"][0]  # [(B,) S, k_pad], -1 padded
    if pts.shape[-1] > 1:
        card = staged.column(leaf.column).card_pad
        match = torch.zeros((*pts.shape[:-1], card + 1), dtype=torch.bool, device=pts.device)
        match.scatter_(-1, torch.where(pts >= 0, pts, card).long(), True)
        return dict(filter_fwd=fwd, match=match[..., :card].contiguous())
    # single point p: the interval [p, p+1); p = -1 matches nothing
    p = pts[..., 0:1]
    return dict(filter_fwd=fwd, filter_bounds=torch.cat([p, p + 1], dim=-1).contiguous())


def _k1_outputs(plan: StaticPlan, staged: StagedTable, seg, q, filt, cols, blocks,
                members: int = 0) -> Dict[str, Any]:
    """num_docs, gb_presence and the count / sum / avg states from one K1
    launch with the group-by columns (already reduced over the segment
    axis), over the candidate blocks when ``blocks`` names them; a plan
    with no filter is the docrange of every row.  With ``members`` one
    batched launch serves every member and each output leads with that
    axis."""
    fdt = staged.precision.float_dtype
    if not filt:
        bounds = seg["num_docs"].new_zeros((staged.num_segments, 2))
        bounds[:, 1] = staged.n_pad
        filt = dict(filter_bounds=bounds)
    use_raw = {a.column: a.use_raw for a in plan.aggs}
    fwds = [None if use_raw[c] else seg[f"{c}.fwd"] for c in cols]
    dicts = [None if use_raw[c] else seg[f"{c}.dict"] for c in cols]
    raws = [seg[f"{c}.raw"] if use_raw[c] else None for c in cols]
    if members:
        docs, count, sums = fused_groupby.fused_filtered_groupby_sums_batched(
            filt.get("filter_fwd"), filt.get("match"), seg["num_docs"], fwds, dicts,
            plan.group_by.capacity, members=members, dtype=fdt, filter_bounds=filt.get("filter_bounds"),
            value_raws=raws, **_group_kwargs(plan, seg, q),
        )
        sums = sums.unbind(1)
    else:
        docs, count, sums = fused_groupby.fused_filtered_groupby_sums(
            filt.get("filter_fwd"), filt.get("match"), seg["num_docs"], None, fwds, dicts,
            plan.group_by.capacity, dtype=fdt, filter_bounds=filt.get("filter_bounds"), value_raws=raws,
            **_group_kwargs(plan, seg, q), **blocks,
        )
    out: Dict[str, Any] = {"num_docs": docs, "gb_presence": (count > 0).to(torch.int32)}
    for i, agg in enumerate(plan.aggs):
        if agg.kind in _VALUE_KINDS:
            continue
        if agg.base == "count":
            out[f"gb_{i}"] = count
        elif agg.base == "sum":
            out[f"gb_{i}"] = sums[cols.index(agg.column)]
        else:  # avg
            out[f"gb_{i}"] = (sums[cols.index(agg.column)], count)
    return out


def _fused_outputs(plan: StaticPlan, staged: StagedTable, seg, q, blocks, members: int = 0) -> Dict[str, Any]:
    """Every state from one fused launch (module docstring)."""
    return _k1_outputs(plan, staged, seg, q, _leaf_filter(plan, staged, seg, q), _fused_value_columns(plan),
                       blocks, members)


def _fused_value_outputs(plan: StaticPlan, staged: StagedTable, seg, q, blocks,
                         members: int = 0) -> Dict[str, Any]:
    """The fused value route's outputs, already reduced over the segment
    axis: one K1 launch for a grouped plan's num_docs, gb_presence and
    count / sum / avg states, one K2 launch per value state, each with
    the leaf and the group-by columns.  No [S, n_pad] mask, key or index
    is built in device memory; a scalar plan's num_docs (and counts) are
    K2's matched-doc total."""
    filt = _leaf_filter(plan, staged, seg, q)
    flat = _Flat(staged.num_segments, staged.n_pad)
    gb = plan.group_by
    if gb is not None:
        out = _k1_outputs(plan, staged, seg, q, filt, _fused_value_columns(plan, value_states=True), blocks,
                          members)
        group = dict(_group_kwargs(plan, seg, q), **blocks)
        for i, agg in enumerate(plan.aggs):
            if agg.kind in _VALUE_KINDS:
                out[f"gb_{i}"] = _value_state(agg, q["agg_aux"][i], seg, flat, filt, group, gb.capacity,
                                              members)[1]
        return out
    out = {}
    for i, agg in enumerate(plan.aggs):
        if agg.kind in _VALUE_KINDS:
            out["num_docs"], out[f"agg_{i}"] = _value_state(agg, q["agg_aux"][i], seg, flat, filt, blocks,
                                                            members=members)
    for i, agg in enumerate(plan.aggs):
        if agg.kind not in _VALUE_KINDS:  # count(*)
            out[f"agg_{i}"] = out["num_docs"]
    return out


def run_table_kernel(
    plan: StaticPlan, staged: StagedTable, seg: Dict[str, torch.Tensor], q: Dict[str, Any],
    block_rows: int = 0,
) -> Dict[str, Any]:
    """All segments' outputs, merged over the segment axis; over the
    zone-map candidate blocks of ``block_rows`` rows when the inputs hold
    ``block_ids`` (module docstring)."""
    global fused_dispatches, fused_value_dispatches, block_dispatches
    ids = q.get("block_ids")
    blocks: Dict[str, Any] = {}
    if ids is not None:
        block_dispatches += 1
        blocks = dict(block_ids=ids, block_rows=block_rows)
    if fused_eligible(plan, staged):
        fused_dispatches += 1
        return _fused_outputs(plan, staged, seg, q, blocks)
    if fused_value_eligible(plan, staged):
        fused_value_dispatches += 1
        return _fused_value_outputs(plan, staged, seg, q, blocks)
    if ids is not None:
        seg = gather_blocks(seg, ids, block_rows)
        staged = dataclasses.replace(staged, n_pad=seg["rowid"].shape[1])
    reducers = output_reducers(plan)
    outs = _segment_outputs(plan, staged, seg, q)
    return {k: apply_reduce(reducers[k], v) for k, v in outs.items()}


# ---------------------------------------------------------------------------
# Segment-axis chunking past the per-dispatch row budget
# (pinot_tpu/engine/kernel.py:1073-1190)
# ---------------------------------------------------------------------------

_ELEMENTWISE_REDUCERS = ("sum", "min", "max", "sum_pair", "minmax_pair")


def chunk_rows_limit() -> int:
    """Most rows (S x n_pad) one dispatch runs over; 0: no chunking
    (``config.CHUNK_ROWS``, read at each call)."""
    return config.CHUNK_ROWS


def _combine_op(agg: StaticAgg, capacity: int = 0) -> str:
    """How two chunks' reduced states of ``agg`` merge: the reference's
    reducer for it (``pinot_tpu/engine/kernel.py:823-847``).  The port
    computes grouped and value states over every segment of a launch at
    once (``_state_reduce``'s "none"), so the merge of two chunks is the
    reference's segment reduce."""
    base = agg.base
    if base in ("count", "sum"):
        return "sum"
    if base in ("min", "max"):
        return base
    if base == "avg":
        return "sum_pair"
    if base == "minmaxrange":
        return "minmax_pair"
    if agg.sort_pairs:
        return "distinct_pairs"
    if agg.kind == "hist":
        return "sum"
    if agg.kind == "hll" and capacity and _grouped_hll_path(capacity) == "sort":
        return f"hll_sort:{capacity}"
    return "max"  # presence bits, HLL registers


def chunk_reducers(plan: StaticPlan) -> Dict[str, str]:
    """Per output key, how two chunks' reduced outputs combine."""
    red: Dict[str, str] = {"num_docs": "sum"}
    if plan.group_by is not None:
        red["gb_presence"] = "max"
        for i, agg in enumerate(plan.aggs):
            red[f"gb_{i}"] = _combine_op(agg, plan.group_by.capacity)
    else:
        for i, agg in enumerate(plan.aggs):
            red[f"agg_{i}"] = _combine_op(agg)
    if plan.selection is not None:
        red["sel_docids"] = "none"
        red["sel_valid"] = "none"
    return red


def plan_chunkable(plan: StaticPlan) -> bool:
    """Every output combines elementwise across chunks (the grouped-HLL
    sort lowering's registers too); pair buffers and per-segment
    selection candidates need the whole segment axis in one dispatch."""
    return all(op in _ELEMENTWISE_REDUCERS or op.startswith("hll_sort:")
               for op in chunk_reducers(plan).values())


def combine_reduced(op: str, a, b):
    if op.startswith("hll_sort:"):
        return torch.maximum(a, b)  # chunk-reduced register states
    if op == "sum":
        return a + b
    if op == "max":
        return torch.maximum(a, b)
    if op == "min":
        return torch.minimum(a, b)
    if op == "sum_pair":
        return (a[0] + b[0], a[1] + b[1])
    if op == "minmax_pair":
        return (torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1]))
    raise ValueError(op)


def _pick_chunk(num_segments: int, n_pad: int, limit: int, granularity: int = 1) -> int:
    """Segments per dispatch under the row budget, in multiples of
    ``granularity``.  Prefers a divisor of num_segments (every dispatch
    then has one shape) but never shrinks below half the budget chasing
    one (the reference's rule)."""
    chunk = max(1, limit // max(n_pad, 1)) if limit else num_segments
    chunk = max(granularity, (chunk // granularity) * granularity)
    divisor = chunk
    while divisor > max(granularity, chunk // 2) and (
        num_segments % divisor or divisor % granularity
    ):
        divisor -= granularity
    if (
        divisor >= max(granularity, chunk // 2)
        and num_segments % divisor == 0
        and divisor % granularity == 0
    ):
        chunk = divisor
    return chunk


def _map_tensors(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _chunked_run(reducers: Dict[str, str], num_segments: int, chunk: int):
    """The table kernel over segments [s, s + chunk), chunk after chunk,
    the reduced outputs combined elementwise in chunk order; the combined
    outputs leave in one packed fetch, and the dispatch / fetch halves
    stay apart for the lane (``run.dispatch`` / ``run.fetch``)."""
    from pinot_tpu_torch.engine import packing

    def outputs(plan: StaticPlan, staged: StagedTable, seg, q, block_rows: int = 0):
        global chunked_dispatches
        chunked_dispatches += 1
        outs = None
        for s in range(0, num_segments, chunk):
            e = min(s + chunk, num_segments)
            part = dataclasses.replace(staged, num_segments=e - s, num_docs=staged.num_docs[s:e],
                                       num_docs_arr=staged.num_docs_arr[s:e])
            o = run_table_kernel(plan, part, _map_tensors(lambda t: t[s:e], seg),
                                 _map_tensors(lambda t: t[s:e], q))
            outs = o if outs is None else {k: combine_reduced(reducers[k], outs[k], o[k]) for k in o}
        return outs

    def dispatch(*args):
        return packing.dispatch_packed(outputs(*args))

    def run(*args):
        return packing.fetch_handle(dispatch(*args))

    run.dispatch = dispatch
    run.fetch = packing.fetch_handle
    return run


def make_chunked_table_kernel(plan: StaticPlan, num_segments: int, n_pad: int):
    """The table kernel dispatched over segment-axis chunks when the
    table passes the per-dispatch row budget; None when chunking is off,
    not needed, or the plan is not chunk-combinable (the caller then runs
    the plain packed table kernel)."""
    limit = chunk_rows_limit()
    if not limit or num_segments * n_pad <= limit:
        # within the budget (and the divisor search below would walk
        # limit / n_pad candidates for a small n_pad, such as a consuming
        # segment's early snapshot)
        return None
    chunk = _pick_chunk(num_segments, n_pad, limit)
    if num_segments <= chunk or not plan_chunkable(plan):
        return None
    return _chunked_run(chunk_reducers(plan), num_segments, chunk)


# ---------------------------------------------------------------------------
# Cross-query batching: B same-plan queries in one launch
# (make_packed_batched_table_kernel, pinot_tpu/engine/kernel.py:1236-1267)
# ---------------------------------------------------------------------------


def _stack_outputs(outs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Member outputs stacked on a new leading axis; a leaf whose length
    differs between members (the pair buffers, cut to each member's
    unique pairs) is zero-padded to the longest first."""

    def stack(*leaves):
        if isinstance(leaves[0], (tuple, list)):
            return type(leaves[0])(stack(*parts) for parts in zip(*leaves))
        shape = [max(t.shape[d] for t in leaves) for d in range(leaves[0].dim())]
        padded = []
        for t in leaves:
            if list(t.shape) != shape:
                z = t.new_zeros(shape)
                z[tuple(slice(0, n) for n in t.shape)] = t
                t = z
            padded.append(t)
        return torch.stack(padded)

    return {k: stack(*(o[k] for o in outs)) for k in outs[0]}


def run_batched_table_kernel(plan: StaticPlan, staged: StagedTable, seg: Dict[str, torch.Tensor],
                             q: Dict[str, Any], members: int) -> Dict[str, Any]:
    """``members`` queries of one plan over the same staged segments, each
    query-input leaf leading with the member axis; every output leads
    with it too, member m's equal to ``run_table_kernel`` of member m
    alone (module docstring).  Full scans only: no block table."""
    global batched_dispatches, fused_dispatches, fused_value_dispatches
    if "block_ids" in q:
        raise ValueError("a batched launch takes no block table: block-path dispatches run alone")
    batched_dispatches += 1
    if fused_eligible(plan, staged):
        fused_dispatches += 1
        return _fused_outputs(plan, staged, seg, q, {}, members)
    if fused_value_eligible(plan, staged):
        fused_value_dispatches += 1
        return _fused_value_outputs(plan, staged, seg, q, {}, members)
    # the torch-op route: one member after another, the outputs stacked
    return _stack_outputs([run_table_kernel(plan, staged, seg, _map_tensors(lambda t: t[m], q))
                           for m in range(members)])


# ---------------------------------------------------------------------------
# Bit-sliced tier programs (engine/bitsliced.py; pinot_tpu/engine/kernel.py:
# 1297-1446).  torch ops over the whole stack, the reference's per-segment
# vmap written out.  A spec is
#   (leaves, tree, sums, extremes)
#   leaves   = ((kind, col, width, k_pad), ...)  kind in
#              {"interval", "points", "points_none"}
#   tree     = ("leaf", i) | ("and"|"or", child, ...)
#   sums     = ((col, value_width), ...)         value-offset planes
#   extremes = ((col, width, is_max), ...)       dictId planes
# Inputs: segs = {"nd": int32 [S],
#                 "p:<col>": int32 [S, W, nw], "v:<col>": int32 [S, Wv, nw]}
#         q    = {"bounds:<i>": int32 [..., S, 2], "pts:<i>": int32 [..., S, k_pad]}
# The leading "..." of q is the member axis of a batched launch (empty
# solo); the planes broadcast over it and are never copied.
# Outputs, per segment (the host finalize merges them, applying each
# segment's vmin and dictionary):
#   "count": int64 [..., S]; "psum:<col>": int64 [..., S, Wv];
#   "ext:mx:<col>" / "ext:mn:<col>": int32 [..., S]
# Words are int32 (the reference's uint32 bits; torch shifts only signed
# words): an all-ones word is -1, ">>" is arithmetic, so every shifted
# value is masked before it is used.
# ---------------------------------------------------------------------------

bitsliced_dispatches = 0  # bit-sliced programs run (solo or batched)
batched_bitsliced_dispatches = 0  # of them, batched launches

_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR population count of int32 words (torch has none).  Each
    shifted term is masked, so the arithmetic shift's sign fill never
    counts; the result (0..32) is non-negative int32."""
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def _bsi_valid_words(num_docs: torch.Tensor, n_words: int) -> torch.Tensor:
    """int32 [..., S, n_words] validity words from the doc counts: word j
    keeps the bits of rows j*32 .. j*32+31 below num_docs."""
    j = torch.arange(n_words, device=num_docs.device, dtype=torch.int64)
    bits = (num_docs.to(torch.int64)[..., None] - j * 32).clamp(0, 32)
    base = (torch.ones_like(bits) << bits.clamp(0, 31)) - 1  # < 2^31: fits int32
    return torch.where(bits >= 32, torch.full_like(bits, -1), base).to(torch.int32)


def _bsi_ge(planes: torch.Tensor, t: torch.Tensor, width: int) -> torch.Tensor:
    """Bitmap of rows whose value >= t (int32 [..., S]) over planes
    [S, W, nw]: the bit-serial MSB->LSB descent, ``gt`` the rows already
    proven greater, ``eq`` the rows still matching t's prefix."""
    t = t[..., None]
    gt = None
    eq = None
    for b in range(width - 1, -1, -1):
        tmask = -((t >> b) & 1)  # 0 or -1 (all ones)
        p = planes[:, b]
        if gt is None:
            gt = p & ~tmask
            eq = ~(p ^ tmask)
        else:
            gt = gt | (eq & p & ~tmask)
            eq = eq & ~(p ^ tmask)
    ge = gt | eq
    if width < 31:
        # t at or above 2^W would otherwise truncate to GE(t mod 2^W)
        ge = torch.where(t >= (1 << width), torch.zeros_like(ge), ge)
    return ge


def _bsi_points(planes: torch.Tensor, pts: torch.Tensor, width: int) -> torch.Tensor:
    """Bitmap of rows whose value is in ``pts`` (int32 [..., S, k], -1
    padded): a per-point XNOR descent, OR-reduced over the points."""
    out = None
    for i in range(pts.shape[-1]):
        pt = pts[..., i, None]
        eq = None
        for b in range(width):
            m = ~(planes[:, b] ^ -((pt >> b) & 1))
            eq = m if eq is None else eq & m
        # -1 padding shifts to all ones and would alias dictId 2^W - 1:
        # padded (and out-of-width) points match nothing
        ok = pt >= 0
        if width < 31:
            ok = ok & (pt < (1 << width))
        eq = torch.where(ok, eq, torch.zeros_like(eq))
        out = eq if out is None else out | eq
    return out


def _bsi_extreme(planes: torch.Tensor, bitmap: torch.Tensor, width: int, is_max: bool) -> torch.Tensor:
    """Bit-serial candidate descent: the extreme dictId among the bitmap's
    rows, int32 [..., S] (garbage for an empty bitmap; the finalize masks
    on count).  Each plane's "any row left" stays on the device."""
    cand = bitmap
    out = torch.zeros(bitmap.shape[:-1], dtype=torch.int32, device=bitmap.device)
    for b in range(width - 1, -1, -1):
        t = cand & planes[:, b] if is_max else cand & ~planes[:, b]
        any_t = (t != 0).any(dim=-1)
        cand = torch.where(any_t[..., None], t, cand)
        taken = any_t if is_max else ~any_t
        out = out | (taken.to(torch.int32) << b)
    return out


def _bsi_eval_tree(node, bms):
    if node[0] == "leaf":
        return bms[node[1]]
    acc = _bsi_eval_tree(node[1], bms)
    for child in node[2:]:
        m = _bsi_eval_tree(child, bms)
        acc = (acc & m) if node[0] == "and" else (acc | m)
    return acc


def _bsi_popsum(words: torch.Tensor) -> torch.Tensor:
    return _popcount32(words).sum(dim=-1, dtype=torch.int64)


def make_single_segment_bitsliced_kernel(spec):
    """The bit-sliced program of ``spec``: (segs, q) -> outputs, over the
    whole segment stack at once (and q's member axis, if any)."""
    leaves, tree, sums, extremes = spec

    def program(segs: Dict[str, torch.Tensor], q: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        bms = []
        n_words = None
        for i, (kind, col, width, _k_pad) in enumerate(leaves):
            planes = segs[f"p:{col}"]
            n_words = planes.shape[-1]
            if kind == "interval":
                b = q[f"bounds:{i}"]
                bm = _bsi_ge(planes, b[..., 0], width) & ~_bsi_ge(planes, b[..., 1], width)
            else:
                bm = _bsi_points(planes, q[f"pts:{i}"], width)
                if kind == "points_none":
                    bm = ~bm  # the complement; padding cleared by the valid words
            bms.append(bm)
        bitmap = _bsi_eval_tree(tree, bms) & _bsi_valid_words(segs["nd"], n_words)
        outs: Dict[str, torch.Tensor] = {"count": _bsi_popsum(bitmap)}
        for col, vwidth in sums:
            v = segs[f"v:{col}"]
            outs[f"psum:{col}"] = torch.stack([_bsi_popsum(v[:, b] & bitmap) for b in range(vwidth)], dim=-1)
        for col, width, is_max in extremes:
            outs[f"ext:{'mx' if is_max else 'mn'}:{col}"] = _bsi_extreme(segs[f"p:{col}"], bitmap, width, is_max)
        return outs

    return program


def _counted(program, batched: bool):
    def run(segs, q):
        global bitsliced_dispatches, batched_bitsliced_dispatches
        bitsliced_dispatches += 1
        batched_bitsliced_dispatches += int(batched)
        return program(segs, q)

    return run


@functools.lru_cache(maxsize=256)
def make_packed_bitsliced_kernel(spec):
    """The bit-sliced program with the one packed fetch
    (``packing.make_packed_kernel``: ``.dispatch`` / ``.fetch``)."""
    from pinot_tpu_torch.engine.packing import make_packed_kernel

    return make_packed_kernel(_counted(make_single_segment_bitsliced_kernel(spec), False))


@functools.lru_cache(maxsize=128)
def make_packed_batched_bitsliced_kernel(spec):
    """Cross-query batched bit-sliced program: B same-spec queries over the
    same resident planes in one launch, each member's ``bounds:<i>`` /
    ``pts:<i>`` stacked on a new leading axis.  The planes broadcast over
    that axis (never copied): each op reads a plane once for all the
    members.  Every output leads with [B], member b's equal to its solo
    launch."""
    from pinot_tpu_torch.engine.packing import make_packed_kernel

    return make_packed_kernel(_counted(make_single_segment_bitsliced_kernel(spec), True))


# ---------------------------------------------------------------------------
# Device hash join (engine/join.py JoinPlan -> one device program)
# ---------------------------------------------------------------------------

join_dispatches = 0  # join programs run (run_join_kernel)

_KNUTH = 2654435761


def _join_hash(k: torch.Tensor, cap: int) -> torch.Tensor:
    """Knuth multiplicative hash of int32 key ids, masked to the pow2
    open-addressing capacity: ``(k * 2654435761 mod 2^32) >> 8 & (cap -
    1)``, the reference's uint32 arithmetic (``pinot_tpu/engine/
    kernel.py:1448-1452``).  Torch has no uint32 multiply on CUDA, so the
    product is formed in int64 from the key's two 16-bit halves (each
    partial product stays below 2^48) and wrapped to 32 bits."""
    kk = k.long() & 0xFFFFFFFF
    lo = (kk & 0xFFFF) * _KNUTH
    hi = ((kk >> 16) * _KNUTH) & 0xFFFF
    h = (lo + (hi << 16)) & 0xFFFFFFFF
    return ((h >> 8) & (cap - 1)).to(torch.int32)


def _join_build(bk: torch.Tensor, cap: int) -> Tuple[torch.Tensor, torch.Tensor, bool, int]:
    """BUILD: unique build keys insert in parallel-claim rounds.  Each
    unplaced lane proposes slot ``(hash + r) & (cap - 1)``; the lanes
    whose proposed slot is empty claim it with an int32 ``amin`` scatter
    of their lane index (the lowest lane wins a contested slot, the same
    in any order), the winners write (key, lane), everyone else advances
    ``r``.  Rounds end when every lane is placed or at ``2 * cap``.  Only
    the unplaced lanes take part in a round (the reference's program
    masks them in place over every lane; the placements are the same).
    Returns (table keys [cap], table rows [cap], every lane placed, rounds)."""
    dev = bk.device
    U = bk.numel()
    bh = _join_hash(bk, cap)
    lanes = torch.arange(U, dtype=torch.int32, device=dev)
    # one spare slot past the table: the drop target of losing lanes
    table_key = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev)
    table_row = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    active = torch.nonzero(bk >= 0).view(-1)  # padded lanes never insert
    r = 0
    while active.numel() and r < 2 * cap:
        lane = lanes[active]
        slot = (bh[active] + r) & (cap - 1)
        attempt = table_key[slot] == -1
        claims = torch.full((cap + 1,), U, dtype=torch.int32, device=dev)
        claims.scatter_reduce_(0, torch.where(attempt, slot, cap).long(), lane, reduce="amin")
        won = attempt & (claims[slot] == lane)
        win_slot = torch.where(won, slot, cap).long()
        table_key[win_slot] = bk[active]
        table_row[win_slot] = lane
        active = active[~won]
        r += 1
    return table_key[:cap], table_row[:cap], active.numel() == 0, r


def _join_probe(pk: torch.Tensor, table_key: torch.Tensor, table_row: torch.Tensor,
                cap: int) -> Tuple[torch.Tensor, int]:
    """PROBE: every probe lane walks its linear probe sequence until its
    key matches (the matched build lane) or an empty slot ends it (no
    match), all live lanes in lockstep, at most ``cap + 1`` offsets; a
    finished lane leaves the live set.  Returns (build lane of each probe
    lane, -1 where none; rounds)."""
    dev = pk.device
    ph = _join_hash(pk, cap)
    midx = torch.full((pk.numel(),), -1, dtype=torch.int32, device=dev)
    active = torch.nonzero(pk >= 0).view(-1)  # padded lanes: no match
    off = 0
    while active.numel() and off <= cap:
        slot = ((ph[active] + off) & (cap - 1)).long()
        at = table_key[slot]
        key = pk[active]
        found = at == key
        midx.index_copy_(0, active, torch.where(found, table_row[slot], midx[active]))
        active = active[~(found | (at == -1))]
        off += 1
    return midx, off


def _join_weights(jplan, inputs, safe: torch.Tensor, cntf: torch.Tensor) -> Dict[Tuple[str, int], torch.Tensor]:
    """The float weight stream [n_probe_pad] of each summed value column:
    ``v * cnt`` for a probe-side column (a probe row meets ``cnt`` build
    rows), the build side's per-key sum gathered at the matched lane for
    a build-side one."""
    out: Dict[Tuple[str, int], torch.Tensor] = {}
    for kind, side, idx in jplan.aggs:
        if kind not in ("sum", "avg") or (side, idx) in out:
            continue
        out[(side, idx)] = inputs["pv"][idx] * cntf if side == "p" else inputs["bs"][idx][safe]
    return out


def _join_group_sums(weights: Dict[Tuple[str, int], torch.Tensor], matched: torch.Tensor,
                     gid: torch.Tensor, G: int, fdt: torch.dtype) -> Dict[Tuple[str, int], torch.Tensor]:
    """Grouped float sums of the matched lanes through K1: the filter is
    the ``{0, 1}`` match table over ``matched``, the key the precombined
    group id, the weight streams K1's raw value columns, all [1,
    n_probe_pad].  A group space past one launch's shared memory runs in
    key windows (keys outside a window drop), more streams than a launch
    takes in chunks, as ``_group_sums`` does: per-block partials added in
    a fixed order, so the same on every run and free of float atomics."""
    if not weights:
        return {}
    n = matched.numel()
    filt = _mask_filter(matched.view(1, n))
    num_docs = torch.full((1,), n, dtype=torch.int32, device=matched.device)
    keys32 = gid.view(1, n)
    fbytes = 8 if fdt == torch.float64 else 4
    names = list(weights)
    sums: Dict[Tuple[str, int], torch.Tensor] = {}
    for j in range(0, len(names), fused_groupby.MAX_VALUE_COLUMNS):
        chunk = names[j : j + fused_groupby.MAX_VALUE_COLUMNS]
        raws = [weights[k].view(1, n).contiguous() for k in chunk]
        nones = [None] * len(chunk)
        window = fused_groupby.max_capacity(fbytes, len(chunk), 0, 2)
        parts = []
        for lo in range(0, G, window):
            _, _, sm = fused_groupby.fused_filtered_groupby_sums(
                filt["filter_fwd"], filt["match"], num_docs, keys32 - lo if lo else keys32,
                nones, nones, min(window, G - lo), dtype=fdt, value_raws=raws,
            )
            parts.append(sm)
        for c, k in enumerate(chunk):
            sums[k] = torch.cat([p[c] for p in parts])
    return sums


def run_join_kernel(jplan, inputs: Dict[str, torch.Tensor],
                    stats: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    """The build + probe hash-join program for one ``engine/join.py``
    JoinPlan (the counterpart of ``make_join_kernel``, ``pinot_tpu/engine/
    kernel.py:1455-1640``, which is jnp lowered by XLA, not a Pallas
    kernel): torch ops for the build (``_join_build``) and the probe
    (``_join_probe``), then the aggregation of the matched lanes.  A probe
    row matching a duplicated build key contributes ``cnt`` joined rows,
    so a sum weights by ``cnt`` and a count adds ``cnt``: the inner join's
    multiplicity.

      num_docs, counts   int64 adds of ``cnt`` (exact, the same in any
                         order: integer atomics on the card)
      grouped sums       through K1 (``_join_group_sums``): no float atomics
      min / max          ``scatter_reduce_`` amin / amax over the ±inf
                         seeds (order-free)
      scalar sums        ``torch.sum`` over the masked lanes

    Group mode keys dense ``[n_groups]`` holders by the mixed-radix
    (probe group, build group) id; K1 drops the unmatched lanes through
    its filter, and the counts and min / max scatter the matched lanes
    only.  ``join_ok`` is False when the build ran out of
    rounds.  ``stats`` (when given) receives the build and probe rounds:
    each round's end is one host sync on the card.  On CPU tensors K1's
    wrapper runs its plain version."""
    global join_dispatches
    join_dispatches += 1
    cap = jplan.cap
    bk, bc = inputs["bk"], inputs["bc"]
    table_key, table_row, join_ok, b_rounds = _join_build(bk, cap)
    pk = inputs["pk"]
    midx, p_rounds = _join_probe(pk, table_key, table_row, cap)
    if stats is not None:
        stats["build_rounds"], stats["probe_rounds"] = b_rounds, p_rounds
    dev = pk.device
    pv, bs, bmn, bmx = inputs["pv"], inputs["bs"], inputs["bmn"], inputs["bmx"]
    fdt = pv.dtype
    matched = midx >= 0
    safe = midx.clamp_min(0).long()
    cnt = torch.where(matched, bc[safe], 0).long()
    cntf = cnt.to(fdt)
    inf = torch.tensor(float("inf"), dtype=fdt, device=dev)
    outs: Dict[str, Any] = {
        "num_docs": cnt.sum(),
        "join_ok": torch.tensor(join_ok, device=dev),
    }
    weights = _join_weights(jplan, inputs, safe, cntf)

    def extremes(side: str, idx: int):
        if side == "p":
            return pv[idx], pv[idx]
        return bmn[idx][safe], bmx[idx][safe]

    if jplan.n_groups:
        G = jplan.n_groups
        gid = (inputs["pg"] * jplan.bg_space + inputs["bg"][safe]).to(torch.int32)
        sums = _join_group_sums(weights, matched, gid, G, fdt)
        # the counts and min / max scatter the matched lanes only: an
        # unmatched lane has no group, and sending each to a spare slot
        # would funnel millions of atomics into one address
        live = torch.nonzero(matched).view(-1)
        gl = gid[live].long()
        gcnt = torch.zeros(G, dtype=torch.int64, device=dev).index_add_(0, gl, cnt[live])
        outs["gb_cnt"] = gcnt

        def holder(side: str, idx: int, table: torch.Tensor, reduce: str, seed: float) -> torch.Tensor:
            vals = pv[idx][live] if side == "p" else table[idx][safe[live]]
            return torch.full((G,), seed, dtype=fdt, device=dev).scatter_reduce_(0, gl, vals, reduce=reduce)

        for i, (kind, side, idx) in enumerate(jplan.aggs):
            if kind == "count":
                outs[f"gb_{i}"] = gcnt
            elif kind == "sum":
                outs[f"gb_{i}"] = sums[(side, idx)]
            elif kind == "avg":
                outs[f"gb_{i}"] = (sums[(side, idx)], gcnt)
            elif kind == "min":
                outs[f"gb_{i}"] = holder(side, idx, bmn, "amin", math.inf)
            elif kind == "max":
                outs[f"gb_{i}"] = holder(side, idx, bmx, "amax", -math.inf)
            else:  # minmaxrange
                outs[f"gb_{i}"] = (holder(side, idx, bmn, "amin", math.inf),
                                   holder(side, idx, bmx, "amax", -math.inf))
        return outs

    total_cnt = outs["num_docs"]
    zero = torch.zeros((), dtype=fdt, device=dev)
    for i, (kind, side, idx) in enumerate(jplan.aggs):
        if kind == "count":
            outs[f"agg_{i}"] = total_cnt
            continue
        vmin, vmax = extremes(side, idx)
        live = matched & (cnt > 0) if side == "p" else matched
        ssum = torch.where(matched, weights[(side, idx)], zero).sum() if (side, idx) in weights else None
        smin = torch.where(live, vmin, inf).min()
        smax = torch.where(live, vmax, -inf).max()
        if kind == "sum":
            outs[f"agg_{i}"] = ssum
        elif kind == "avg":
            outs[f"agg_{i}"] = (ssum, total_cnt)
        elif kind == "min":
            outs[f"agg_{i}"] = smin
        elif kind == "max":
            outs[f"agg_{i}"] = smax
        else:
            outs[f"agg_{i}"] = (smin, smax)
    return outs


def join_kernel_reference(jplan, inputs: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Plain torch version of the join program, the jnp program step by
    step (``pinot_tpu/engine/kernel.py:1483-1636``): the build and probe
    loops mask every lane in place, and every sum is a float
    ``index_add_`` / ``torch.sum`` (``.at[].add``), the grouped ones in
    float64 and cast back.  Its outputs are the program's."""
    cap = jplan.cap
    bk, bc, pk = inputs["bk"], inputs["bc"], inputs["pk"]
    dev = pk.device
    U, N = bk.numel(), pk.numel()
    bh = _join_hash(bk, cap)
    lane_ids = torch.arange(U, dtype=torch.int32, device=dev)
    table_key = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev)
    table_row = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
    placed = bk < 0
    r = 0
    while bool((~placed).any()) and r < 2 * cap:
        slot = (bh + r) & (cap - 1)
        attempt = ~placed & (table_key[slot] == -1)
        claims = torch.full((cap + 1,), U, dtype=torch.int32, device=dev)
        claims.scatter_reduce_(0, torch.where(attempt, slot, cap).long(), lane_ids, reduce="amin")
        won = attempt & (claims[slot] == lane_ids)
        win_slot = torch.where(won, slot, cap).long()
        table_key[win_slot] = bk
        table_row[win_slot] = lane_ids
        placed = placed | won
        r += 1
    join_ok = bool(placed.all())
    ph = _join_hash(pk, cap)
    midx = torch.full((N,), -1, dtype=torch.int32, device=dev)
    done = pk < 0
    off = 0
    while bool((~done).any()) and off <= cap:
        slot = ((ph + off) & (cap - 1)).long()
        at = table_key[slot]
        found = ~done & (at == pk)
        empty = ~done & (at == -1)
        midx = torch.where(found, table_row[slot], midx)
        done = done | found | empty
        off += 1
    matched = midx >= 0
    safe = midx.clamp_min(0).long()
    pv, bs, bmn, bmx = inputs["pv"], inputs["bs"], inputs["bmn"], inputs["bmx"]
    fdt = pv.dtype
    cnt = torch.where(matched, bc[safe], 0).long()
    cntf = cnt.to(fdt)
    inf = torch.tensor(float("inf"), dtype=fdt, device=dev)
    outs: Dict[str, Any] = {"num_docs": cnt.sum(), "join_ok": torch.tensor(join_ok, device=dev)}

    def vals(side, idx):
        if side == "p":
            v = pv[idx]
            return v * cntf, v, v
        return bs[idx][safe], bmn[idx][safe], bmx[idx][safe]

    if jplan.n_groups:
        G = jplan.n_groups
        gid = inputs["pg"].long() * jplan.bg_space + inputs["bg"][safe].long()
        gslot = torch.where(matched, gid, G)
        gcnt = torch.zeros(G + 1, dtype=torch.int64, device=dev).index_add_(0, gslot, cnt)[:G]
        outs["gb_cnt"] = gcnt
        for i, (kind, side, idx) in enumerate(jplan.aggs):
            if kind == "count":
                outs[f"gb_{i}"] = gcnt
                continue
            vsum, vmin, vmax = vals(side, idx)
            s = torch.zeros(G + 1, dtype=torch.float64, device=dev)
            s = s.index_add_(0, gslot, torch.where(matched, vsum, 0.0).double())[:G].to(fdt)
            mn = torch.full((G + 1,), float("inf"), dtype=fdt, device=dev)
            mn = mn.scatter_reduce_(0, gslot, torch.where(matched, vmin, inf), reduce="amin")[:G]
            mx = torch.full((G + 1,), float("-inf"), dtype=fdt, device=dev)
            mx = mx.scatter_reduce_(0, gslot, torch.where(matched, vmax, -inf), reduce="amax")[:G]
            outs[f"gb_{i}"] = {"sum": s, "avg": (s, gcnt), "min": mn, "max": mx,
                               "minmaxrange": (mn, mx)}[kind]
        return outs
    total = outs["num_docs"]
    for i, (kind, side, idx) in enumerate(jplan.aggs):
        if kind == "count":
            outs[f"agg_{i}"] = total
            continue
        vsum, vmin, vmax = vals(side, idx)
        live = matched & (cnt > 0) if side == "p" else matched
        s = torch.where(matched, vsum, 0.0).sum()
        mn, mx = torch.where(live, vmin, inf).min(), torch.where(live, vmax, -inf).max()
        outs[f"agg_{i}"] = {"sum": s, "avg": (s, total), "min": mn, "max": mx, "minmaxrange": (mn, mx)}[kind]
    return outs
