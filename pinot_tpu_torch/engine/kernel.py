"""The table kernel: StaticPlan + staged segments -> reduced outputs
(port of ``pinot_tpu.engine.kernel`` for single-value columns).

The JAX package writes the pipeline for one segment and lifts it with
``vmap``; here every op works on the stacked ``[S, n_pad]`` axis written
out:

  mask        = filter tree over the leaves & (row < num_docs)
  values      = raw rows or dict_vals[fwd]
  scalars     = masked reductions per segment
  group-by    = count/sum/avg through the fused kernel over key windows,
                min/max scatters into [capacity] holders keyed by
                global-id mixed-radix keys
  value state = occupancy counts of a combined index (presence, histogram
                or (bucket, rho) registers) through ``value_state_counts``

Per-segment states reduce over the segment axis (``output_reducers`` /
``apply_reduce``); group-by and value-state states are computed over
every segment at once (reducer "none"), and the packed grouped-HLL keys
reduce by one sort (``_reduce_hll_sort``).

Routing is keyed on the plan, never on the device, so the CPU tests take
the card's routes:
  * a plan whose filter is one single-value leaf the fused kernel takes,
    whose group-by is single-value and fits the kernel's shared-memory
    accumulators, and whose aggregations are all count / sum / avg,
    computes ``num_docs``, ``gb_presence`` and every state in one
    ``kernels.fused_groupby`` call with the filter inside (the fused
    route, counted in ``fused_dispatches``);
  * every other grouped plan evaluates its filter tree with torch ops and
    hands the mask to the same kernel as a match table over {0, 1}: its
    group counts and float sums are per-block partials reduced in a fixed
    order, so they are the same on every run (no float atomics);
  * every dense presence / histogram holder, scalar HLL registers and the
    small grouped HLL ("matmul" in ``_grouped_hll_path``) count through
    ``kernels.value_state_counts``; the "sort" and "scatter" grouped-HLL
    lowerings are torch ops, as they are jnp in the reference.
On the card both kernels are the CUDA kernels; on the CPU their wrappers
run the plain torch versions.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from pinot_tpu_torch.engine import config
from pinot_tpu_torch.engine.device import StagedTable
from pinot_tpu_torch.engine.kernels import fused_groupby, value_state_counts
from pinot_tpu_torch.engine.plan import SV, StaticAgg, StaticPlan

fused_dispatches = 0  # table-kernel runs that took the fused route

# grouped HLL lowerings (``_grouped_hll_path``), the reference's gates
# (pinot_tpu/engine/kernel.py:57,62); module constants so a test can force
# each lowering, as the reference's tests patch theirs
_MATMUL_HLL_CAP = 1 << 18
_HLL_SORT_CAP = 1 << 16

# int32 sentinel of masked packed HLL keys: sorts past every real key
_PAIR_SENTINEL = torch.iinfo(torch.int32).max

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


def _value_gids(agg: StaticAgg, seg, remap) -> torch.Tensor:
    """Per-row global value ids [S, n_pad] for an SV presence/hist agg:
    the staged global-id stream (``.gfwd``) when there is one, else a
    gather of the remap table."""
    gf = seg.get(f"{agg.column}.gfwd")
    if gf is not None:
        return gf
    return torch.gather(remap, 1, seg[f"{agg.column}.fwd"].long())


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


def _value_state_index(
    agg: StaticAgg, aux, seg, mask, slot: Optional[torch.Tensor] = None, capacity: int = 1
) -> Tuple[torch.Tensor, int]:
    """The combined int32 index [S, n_pad] that ``value_state_counts``
    counts, and its size K; masked rows carry the sentinel K.

      presence / hist  (slot * gcard_pad + gid)         K = capacity * gcard_pad
      hll registers    (slot * HLL_M + bucket) * 64 + rho   K = capacity * HLL_M * 64

    ``slot`` is the group key (None for a scalar agg, whose one slot is 0)."""
    if agg.kind in ("presence", "hist"):
        K = capacity * agg.gcard_pad
        key = _value_gids(agg, seg, aux["remap"]).to(torch.int32)
        if slot is not None:
            key = slot * agg.gcard_pad + key
    else:
        K = capacity * config.HLL_M * 64
        b, r = _hll_rows(agg, seg, aux["bucket"], aux["rho"])
        key = b.to(torch.int32)
        if slot is not None:
            key = slot * config.HLL_M + key
        key = key * 64 + r.to(torch.int32)
    return torch.where(mask, key.to(torch.int32), K), K


def _value_state_from_counts(agg: StaticAgg, counts: torch.Tensor, capacity: int = 0):
    """Presence bits, the histogram, or HLL registers (the largest rho
    seen per bucket) from occupancy counts; ``capacity`` > 0 gives the
    grouped ``[capacity, ...]`` holder."""
    lead = (capacity,) if capacity else ()
    if agg.kind == "hll":
        counts = counts.view(*lead, config.HLL_M, 64)
        rho = torch.arange(64, device=counts.device)
        return torch.where(counts > 0, rho, 0).amax(dim=-1).to(torch.uint8)
    counts = counts.view(*lead, agg.gcard_pad)
    if agg.kind == "presence":
        return (counts > 0).to(torch.int32)
    return counts


def _agg_state(agg: StaticAgg, i: int, seg, q, mask, fdt) -> Any:
    """Partial state for one aggregation (no group-by): per segment [S]
    for scalar and pair kinds, over every segment at once for value
    states (one ``value_state_counts`` call covers all S segments)."""
    base = agg.base
    if agg.kind in ("presence", "hist", "hll"):
        idx, K = _value_state_index(agg, q["agg_aux"][i], seg, mask)
        return _value_state_from_counts(agg, value_state_counts.value_state_counts(idx, K))
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
    raise AssertionError(agg)


def _group_columns(plan: StaticPlan, seg, q) -> Tuple[list, list]:
    """(id stream, remap or None) per group-by column: the staged
    global-id stream, else the local fwd with its remap table."""
    gb = plan.group_by
    cols, remaps = [], []
    for col, remap, use_g in zip(gb.columns, q["group_remap"], gb.use_gfwd):
        cols.append(seg[f"{col}.gfwd"] if use_g else seg[f"{col}.fwd"])
        remaps.append(None if use_g else remap)
    return cols, remaps


def _group_keys(plan: StaticPlan, seg, q, kdt) -> torch.Tensor:
    """Mixed-radix global group keys [S, n_pad] in ``kdt`` (the torch-op
    route; the fused route has K1 combine them)."""
    cols, remaps = _group_columns(plan, seg, q)
    return fused_groupby.combine_group_keys(cols, plan.group_by.gcards, remaps, dtype=kdt)


def _sum_columns(plan: StaticPlan) -> List[str]:
    """Distinct value columns of the plan's sum / avg aggregations."""
    cols: List[str] = []
    for agg in plan.aggs:
        if agg.base in ("sum", "avg") and agg.column not in cols:
            cols.append(agg.column)
    return cols


def _group_sums(
    plan: StaticPlan, staged: StagedTable, seg, mask, keys
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Group counts (int64 [capacity]) and float sums per sum/avg column
    over every segment, through the fused kernel with the evaluated mask
    as its filter (a match table over {0, 1}).  The kernel's group space
    is bounded by its shared memory, so a wider one runs in key windows,
    and more value columns than the kernel takes run in column chunks:
    each call adds per-block partials in a fixed order, so the result is
    the same on every run."""
    cap = plan.group_by.capacity
    fdt = staged.precision.float_dtype
    fbytes = 8 if staged.precision.x64 else 4
    S = staged.num_segments
    by_column = {a.column: a for a in plan.aggs if a.base in ("sum", "avg")}
    cols = _sum_columns(plan)
    filt = mask.view(torch.uint8)
    match = torch.arange(2, device=mask.device).bool().expand(S, 2).contiguous()  # [False, True]
    keys = keys.to(torch.int32)  # capacity <= MAX_GROUP_CAPACITY fits int32
    chunks = [cols[j : j + fused_groupby.MAX_VALUE_COLUMNS]
              for j in range(0, len(cols), fused_groupby.MAX_VALUE_COLUMNS)] or [[]]
    counts: Optional[torch.Tensor] = None
    sums: Dict[str, torch.Tensor] = {}
    for chunk in chunks:
        raws = [_row_values(by_column[c], seg) for c in chunk]
        window = fused_groupby.max_capacity(fbytes, len(chunk), 0, match.shape[1])
        parts_c, parts_s = [], []
        for lo in range(0, cap, window):
            width = min(window, cap - lo)
            _, cnt, sm = fused_groupby.fused_filtered_groupby_sums(
                filt, match, seg["num_docs"], keys - lo if lo else keys,
                [None] * len(chunk), [None] * len(chunk), width, dtype=fdt, value_raws=raws,
            )
            parts_c.append(cnt)
            parts_s.append(sm)
        if counts is None:
            counts = torch.cat(parts_c)
        for j, c in enumerate(chunk):
            sums[c] = torch.cat([p[j] for p in parts_s])
    return counts, sums


def _group_value_state(agg: StaticAgg, aux, seg, mask, slot, cap: int) -> Any:
    """Grouped value-state holder over every segment: dense presence /
    histogram grids and small-group HLL registers from occupancy counts,
    larger group spaces by the reference's sort or scatter lowering."""
    path = _grouped_hll_path(cap) if agg.kind == "hll" else "matmul"
    if path == "matmul":
        idx, K = _value_state_index(agg, aux, seg, mask, slot.to(torch.int32), cap)
        return _value_state_from_counts(agg, value_state_counts.value_state_counts(idx, K), cap)
    b, r = _hll_rows(agg, seg, aux["bucket"], aux["rho"])
    if path == "sort":
        # one packed int32 per row (capacity <= 2^16 keeps it below 2^30),
        # sorted and run-max extracted by the reduce (_reduce_hll_sort)
        cell = slot.to(torch.int32) * config.HLL_M + b.to(torch.int32)
        return torch.where(mask, (cell << 6) | r.to(torch.int32), _PAIR_SENTINEL)
    # flat scatter-max into [capacity * HLL_M] registers, a spare drop cell
    cell = slot.long() * config.HLL_M + b.long()
    ncells = cap * config.HLL_M
    regs = torch.zeros(ncells + 1, dtype=torch.int32, device=slot.device)
    regs.scatter_reduce_(0, torch.where(mask, cell, ncells).reshape(-1),
                         r.to(torch.int32).reshape(-1), reduce="amax", include_self=True)
    return regs[:ncells].view(cap, config.HLL_M).to(torch.uint8)


def _group_outputs(plan: StaticPlan, staged: StagedTable, seg, q, mask) -> Dict[str, Any]:
    """Grouped states over every segment at once (module docstring)."""
    cap = plan.group_by.capacity
    fdt = staged.precision.float_dtype
    keys = _group_keys(plan, seg, q, staged.precision.key_dtype)
    counts, sums = _group_sums(plan, staged, seg, mask, keys)
    out: Dict[str, Any] = {"gb_presence": (counts > 0).to(torch.int32)}
    slot = torch.where(mask, keys, cap)  # masked rows -> the spare slot, in the key dtype

    def extreme(agg, reduce, seed):
        h = torch.full((cap + 1,), seed, dtype=fdt, device=slot.device)
        h.scatter_reduce_(0, slot.reshape(-1).long(), _row_values(agg, seg).reshape(-1).to(fdt),
                          reduce=reduce, include_self=True)
        return h[:cap]

    for i, agg in enumerate(plan.aggs):
        base = agg.base
        if agg.kind in ("presence", "hist", "hll"):
            state = _group_value_state(agg, q["agg_aux"][i], seg, mask, slot, cap)
        elif base == "count":
            state = counts
        elif base == "sum":
            state = sums[agg.column]
        elif base == "avg":
            state = (sums[agg.column], counts)
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
    return red


def _state_reduce(agg: StaticAgg, capacity: int = 0) -> str:
    """'none' for states already computed over every segment: grouped
    states, and value states (whose reference reducers — max for presence
    and registers, sum for histograms — the summed counts already
    apply)."""
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


def apply_reduce(op: str, value: Any):
    if op.startswith("hll_sort:"):
        return _reduce_hll_sort(value, int(op.split(":", 1)[1]))
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
    if len(gb.columns) > fused_groupby.MAX_GROUP_COLUMNS:
        return False
    # a remap-fed group column's table sits in the kernel's shared memory
    remap_cards = [staged.column(c).card_pad for c, use_g in zip(gb.columns, gb.use_gfwd) if not use_g]
    if any(card > fused_groupby.MAX_TABLE_CARD for card in remap_cards):
        return False
    fbytes = 8 if staged.precision.x64 else 4
    return fused_groupby.fits_shared_memory(
        fbytes, gb.capacity, len(cols), dict_cards, match_card, remap_cards
    )


def _fused_outputs(plan: StaticPlan, staged: StagedTable, seg, q) -> Dict[str, Any]:
    """num_docs, gb_presence and every state from one fused launch —
    already reduced over the segment axis.  The group key is combined
    inside the kernel from the group-by columns."""
    leaf = plan.leaves[0]
    fdt = staged.precision.float_dtype
    group_cols, group_remaps = _group_columns(plan, seg, q)
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
        filter_fwd, match, seg["num_docs"], None, fwds, dicts, plan.group_by.capacity,
        dtype=fdt, filter_bounds=bounds, value_raws=raws, group_cols=group_cols,
        group_cards=plan.group_by.gcards, group_remaps=group_remaps,
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
