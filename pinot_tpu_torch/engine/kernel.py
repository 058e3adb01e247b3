"""The table kernel: StaticPlan + staged segments -> reduced outputs
(port of the main-path subset of ``pinot_tpu.engine.kernel``).

The JAX package writes the pipeline for one segment and lifts it with
``vmap``; here every op works on the stacked ``[S, n_pad]`` axis written
out:

  mask      = filter tree over the leaves & (row < num_docs)
  values    = raw rows or dict_vals[fwd]
  scalars   = masked reductions per segment
  group-by  = scatter-add/min/max into [S, capacity] holders keyed by
              global-id mixed-radix keys

and the per-segment states reduce over the segment axis
(``output_reducers`` / ``apply_reduce``).

Routing: a plan whose filter is one single-value leaf the fused kernel
takes, whose group-by is single-value and fits the kernel's shared-memory
accumulators, and whose aggregations are all count / sum / avg, computes
``num_docs``, ``gb_presence`` and every state through
``kernels.fused_groupby`` — on the card that is the CUDA kernel.  Every
other plan runs the torch ops below.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from pinot_tpu_torch.engine.device import StagedTable
from pinot_tpu_torch.engine.kernels import fused_groupby
from pinot_tpu_torch.engine.plan import SV, StaticAgg, StaticPlan

fused_dispatches = 0  # table-kernel runs that took the fused route

_FUSED_LEAF_KINDS = ("interval", "docrange", "table")


def _valid_mask(seg: Dict[str, Any], n_pad: int) -> torch.Tensor:
    """[S, n_pad] doc validity from ``row < num_docs`` — no stored column."""
    nd = seg["num_docs"]
    rows = torch.arange(n_pad, device=nd.device)
    return rows[None, :] < nd[:, None]


def _leaf_mask(plan: StaticPlan, i: int, seg, q, n_pad: int) -> torch.Tensor:
    leaf = plan.leaves[i]
    kind = leaf.eval_kind
    if leaf.mode != SV:
        raise NotImplementedError("multi-value filter leaves are a later slice of the port")
    if kind == "docrange":
        b = q["bounds"][i]
        rows = torch.arange(n_pad, device=b.device)[None, :]
        return (rows >= b[:, 0:1]) & (rows < b[:, 1:2])
    ids = seg[f"{leaf.column}.fwd"]
    if kind == "interval":
        b = q["bounds"][i]
        return (ids >= b[:, 0:1]) & (ids < b[:, 1:2])
    if kind in ("points", "points_none"):
        pts = q["pts"][i]  # [S, k_pad], -1 padded
        hit = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
        for k in range(pts.shape[1]):
            hit |= ids == pts[:, k : k + 1]
        return ~hit if kind == "points_none" else hit
    if kind == "runs":
        rr = q["runs"][i]  # [S, k_pad, 2], SV complements baked in
        hit = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
        for k in range(rr.shape[1]):
            hit |= (ids >= rr[:, k, 0:1]) & (ids < rr[:, k, 1:2])
        return hit
    return torch.gather(q["match"][i], 1, ids.long())


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


def _agg_state(agg: StaticAgg, seg, mask, fdt) -> Any:
    """Per-segment partial state [S] for one aggregation (no group-by)."""
    base = agg.base
    if base == "count":
        return mask.sum(dim=1, dtype=torch.int64)
    vals = _row_values(agg, seg)
    inf = torch.tensor(float("inf"), dtype=fdt, device=vals.device)
    zero = torch.zeros((), dtype=fdt, device=vals.device)
    if base == "sum":
        return torch.where(mask, vals, zero).sum(dim=1, dtype=fdt)
    if base == "min":
        return torch.where(mask, vals, inf).amin(dim=1)
    if base == "max":
        return torch.where(mask, vals, -inf).amax(dim=1)
    if base == "avg":
        return (torch.where(mask, vals, zero).sum(dim=1, dtype=fdt), mask.sum(dim=1, dtype=torch.int64))
    if base == "minmaxrange":
        return (torch.where(mask, vals, inf).amin(dim=1), torch.where(mask, vals, -inf).amax(dim=1))
    raise NotImplementedError(f"aggregation {agg.func!r} is not part of this slice")


def _group_keys(plan: StaticPlan, seg, q, kdt) -> torch.Tensor:
    """Mixed-radix global group keys [S, n_pad] in ``kdt``."""
    gb = plan.group_by
    keys = None
    for col, gcard, remap, use_g in zip(gb.columns, gb.gcards, q["group_remap"], gb.use_gfwd):
        if use_g:
            g = seg[f"{col}.gfwd"].to(kdt)  # staged global ids
        else:
            g = torch.gather(remap, 1, seg[f"{col}.fwd"].long()).to(kdt)
        keys = g if keys is None else keys * gcard + g
    return keys


def _group_state(agg: StaticAgg, seg, flat_idx, S: int, cap: int, fdt, counts) -> Any:
    """[S, cap] holders.  Each segment owns cap+1 slots of one flat
    holder; the spare slot catches masked rows (JAX's mode="drop") and is
    sliced off.  Min/max holders are seeded with +-inf, so an empty slot
    reads as the reference's sentinel.  Sums accumulate in float64 and
    return in ``fdt``: ``index_add_`` adds row by row into a bucket, which
    in float32 drifts by percents at millions of rows per group."""
    dev = flat_idx.device
    n_slots = S * (cap + 1)

    def add(w):
        h = torch.zeros(n_slots, dtype=torch.float64, device=dev)
        h.index_add_(0, flat_idx, w.reshape(-1).to(torch.float64))
        return h.view(S, cap + 1)[:, :cap].to(fdt)

    def extreme(w, reduce, seed):
        h = torch.full((n_slots,), seed, dtype=fdt, device=dev)
        h.scatter_reduce_(0, flat_idx, w.reshape(-1).to(fdt), reduce=reduce, include_self=True)
        return h.view(S, cap + 1)[:, :cap]

    base = agg.base
    if base == "count":
        return counts
    vals = _row_values(agg, seg)
    if base == "sum":
        return add(vals)
    if base == "avg":
        return (add(vals), counts)
    if base == "min":
        return extreme(vals, "amin", float("inf"))
    if base == "max":
        return extreme(vals, "amax", float("-inf"))
    if base == "minmaxrange":
        return (extreme(vals, "amin", float("inf")), extreme(vals, "amax", float("-inf")))
    raise NotImplementedError(f"aggregation {agg.func!r} is not part of this slice")


def output_reducers(plan: StaticPlan) -> Dict[str, str]:
    """Reduce op over the segment axis per output key."""
    red: Dict[str, str] = {"num_docs": "sum"}
    if plan.group_by is not None:
        red["gb_presence"] = "max"
        for i, agg in enumerate(plan.aggs):
            red[f"gb_{i}"] = _state_reduce(agg)
    else:
        for i, agg in enumerate(plan.aggs):
            red[f"agg_{i}"] = _state_reduce(agg)
    return red


def _state_reduce(agg: StaticAgg) -> str:
    return {
        "count": "sum",
        "sum": "sum",
        "min": "min",
        "max": "max",
        "avg": "sum_pair",
        "minmaxrange": "minmax_pair",
    }[agg.base]


def apply_reduce(op: str, value: Any):
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
    """The torch-op path: per-segment states, stacked on axis 0."""
    n_pad = staged.n_pad
    fdt = staged.precision.float_dtype
    mask = _valid_mask(seg, n_pad)
    if plan.filter_tree is not None:
        mask = mask & _eval_tree(plan, plan.filter_tree, seg, q, n_pad)
    out: Dict[str, Any] = {"num_docs": mask.sum(dim=1, dtype=torch.int64)}
    if plan.group_by is None:
        for i, agg in enumerate(plan.aggs):
            out[f"agg_{i}"] = _agg_state(agg, seg, mask, fdt)
        return out
    S = staged.num_segments
    cap = plan.group_by.capacity
    keys = _group_keys(plan, seg, q, staged.precision.key_dtype)
    slot = torch.where(mask, keys.long(), cap)
    flat_idx = (slot + torch.arange(S, device=slot.device)[:, None] * (cap + 1)).reshape(-1)
    counts = torch.zeros(S * (cap + 1), dtype=torch.int64, device=slot.device)
    counts.index_add_(0, flat_idx, torch.ones_like(flat_idx))
    counts = counts.view(S, cap + 1)[:, :cap]
    out["gb_presence"] = (counts > 0).to(torch.int32)
    for i, agg in enumerate(plan.aggs):
        out[f"gb_{i}"] = _group_state(agg, seg, flat_idx, S, cap, fdt, counts)
    return out


def _fused_value_columns(plan: StaticPlan) -> Optional[List[str]]:
    """Distinct value columns of a count/sum/avg-only plan, or None."""
    cols: List[str] = []
    for agg in plan.aggs:
        if agg.is_mv or agg.base not in ("count", "sum", "avg"):
            return None
        if agg.base != "count" and agg.column not in cols:
            cols.append(agg.column)
    return cols


def fused_eligible(plan: StaticPlan, staged: StagedTable) -> bool:
    """Whether this plan takes the fused kernel (module docstring)."""
    gb = plan.group_by
    if gb is None or any(gb.col_is_mv) or plan.filter_tree != ("leaf", 0):
        return False
    leaf = plan.leaves[0]
    if leaf.mode != SV:
        return False
    single_point = leaf.eval_kind == "points" and leaf.k_pad == 1
    if leaf.eval_kind not in _FUSED_LEAF_KINDS and not single_point:
        return False
    match_card = 0
    if leaf.eval_kind == "table":
        match_card = staged.column(leaf.column).card_pad
        if match_card > fused_groupby.MAX_TABLE_CARD:
            return False
    cols = _fused_value_columns(plan)
    if cols is None or len(cols) > fused_groupby.MAX_VALUE_COLUMNS:
        return False
    use_raw = {a.column: a.use_raw for a in plan.aggs}
    dict_cards = []
    for c in cols:
        if not use_raw[c]:
            card = staged.column(c).card_pad
            if card > fused_groupby.MAX_TABLE_CARD:
                return False
            dict_cards.append(card)
    fbytes = 8 if staged.precision.x64 else 4
    return fused_groupby.fits_shared_memory(fbytes, gb.capacity, len(cols), dict_cards, match_card)


def _fused_outputs(plan: StaticPlan, staged: StagedTable, seg, q) -> Dict[str, Any]:
    """num_docs, gb_presence and every state from one fused launch —
    already reduced over the segment axis."""
    leaf = plan.leaves[0]
    fdt = staged.precision.float_dtype
    keys = _group_keys(plan, seg, q, torch.int32)
    filter_fwd = match = bounds = None
    if leaf.eval_kind == "table":
        filter_fwd, match = seg[f"{leaf.column}.fwd"], q["match"][0]
    elif leaf.eval_kind == "docrange":
        bounds = q["bounds"][0]
    elif leaf.eval_kind == "interval":
        filter_fwd, bounds = seg[f"{leaf.column}.fwd"], q["bounds"][0]
    else:  # single point p: the interval [p, p+1); p = -1 matches nothing
        filter_fwd = seg[f"{leaf.column}.fwd"]
        p = q["pts"][0][:, 0:1]
        bounds = torch.cat([p, p + 1], dim=1).contiguous()
    cols = _fused_value_columns(plan)
    use_raw = {a.column: a.use_raw for a in plan.aggs}
    fwds = [None if use_raw[c] else seg[f"{c}.fwd"] for c in cols]
    dicts = [None if use_raw[c] else seg[f"{c}.dict"] for c in cols]
    raws = [seg[f"{c}.raw"] if use_raw[c] else None for c in cols]
    docs, count, sums = fused_groupby.fused_filtered_groupby_sums(
        filter_fwd, match, seg["num_docs"], keys, fwds, dicts, plan.group_by.capacity,
        dtype=fdt, filter_bounds=bounds, value_raws=raws,
    )
    out: Dict[str, Any] = {"num_docs": docs, "gb_presence": (count > 0).to(torch.int32)}
    for i, agg in enumerate(plan.aggs):
        if agg.base == "count":
            out[f"gb_{i}"] = count
        elif agg.base == "sum":
            out[f"gb_{i}"] = sums[cols.index(agg.column)]
        else:  # avg
            out[f"gb_{i}"] = (sums[cols.index(agg.column)], count)
    return out


def run_table_kernel(
    plan: StaticPlan, staged: StagedTable, seg: Dict[str, torch.Tensor], q: Dict[str, Any]
) -> Dict[str, Any]:
    """All segments' outputs, merged over the segment axis."""
    global fused_dispatches
    if fused_eligible(plan, staged):
        fused_dispatches += 1
        return _fused_outputs(plan, staged, seg, q)
    reducers = output_reducers(plan)
    outs = _segment_outputs(plan, staged, seg, q)
    return {k: apply_reduce(reducers[k], v) for k, v in outs.items()}
