"""Bit-sliced (BSI) filter / aggregate tier, the second filter tier (port of
``pinot_tpu.engine.bitsliced``).

Columns are staged as packed int32 bit-planes (``device.py``'s ``bsi`` /
``bsiv`` roles, encoded by ``packing.bitslice_encode``), and an eligible
scalar aggregation evaluates its whole filter as O(bit-width) wide
AND / OR / popcount passes over n/32-word planes, with COUNT / SUM / MIN /
MAX / AVG fused into the bitwise pass (``kernel.py``'s bit-sliced
programs, torch ops on the card: the reference's are jnp, not Pallas).

Position in the tier ladder (``engine/executor.py``):

  postings (invindex_path)  needle queries, O(matches) on the host
  bit-sliced (this module)  mid-selectivity scalar aggs, O(W x n/32)
  zone-map blocks           clustered predicates, O(candidate blocks)
  full scan (kernel.py)     everything else, O(n)

The decision keeps ``index_path_decision``'s contract: a JSON-safe verdict
that EXPLAIN can report without serving the query, plus an opaque
execution state when taken.  The crossover constants are
``engine/tiercost.py``'s.  The executor's ``bitsliced`` switch replaces the
reference's ``PINOT_TPU_BITSLICED``: False disables the tier, "force"
skips the cost model (never the structural eligibility), True applies it;
its ``zone_maps`` switch replaces ``PINOT_TPU_ZONEMAP`` in the
sorted-column deferral.

A fused SUM is offered only where it is bit-exact against the scan tier:
exactly integral dictionaries (``packing.integral_dictionary_values``)
with an offset width of at most 32, summed on the host in exact integer
arithmetic as  sum = vmin_s x count_s + sum_b 2^b x popcount(plane_b & bitmap).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from pinot_tpu_torch.common.request import BrokerRequest, FilterOperator, FilterQueryTree
from pinot_tpu_torch.common.schema import DataType
from pinot_tpu_torch.engine import tiercost
from pinot_tpu_torch.engine.context import TableContext
from pinot_tpu_torch.engine.device import (
    bsi_filter_width,
    bsiv_value_spec,
    get_staged,
    to_device_inputs,
)
from pinot_tpu_torch.engine.dispatch import BatchSpec, plan_digest, ready_event, stream_handoff
from pinot_tpu_torch.engine.kernel import (
    chunk_rows_limit,
    make_packed_batched_bitsliced_kernel,
    make_packed_bitsliced_kernel,
)
from pinot_tpu_torch.engine.packing import batch_input_signature, stack_query_inputs
from pinot_tpu_torch.engine.plan import leaf_interval, leaf_points
from pinot_tpu_torch.engine.results import (
    AvgPartial,
    CountPartial,
    IntermediateResult,
    MaxPartial,
    MinPartial,
    SumPartial,
    make_partial,
)
from pinot_tpu_torch.segment.immutable import ImmutableSegment

_MAX_POINTS = 16  # the IN-list bound the StaticPlan leaf lowering uses
_SCALAR_AGGS = ("count", "sum", "min", "max", "avg")

Mode = Union[bool, str]  # True (the cost model), False (off) or "force"


def _k_pad(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length()) if n > 1 else 1


def _leaf_kind(op: FilterOperator) -> Optional[str]:
    if op == FilterOperator.RANGE:
        return "interval"
    if op in (FilterOperator.EQUALITY, FilterOperator.IN):
        return "points"
    if op in (FilterOperator.NOT, FilterOperator.NOT_IN):
        return "points_none"
    return None  # REGEX needs the match-table path


def _encode_tree(
    node: FilterQueryTree,
    live: List[ImmutableSegment],
    leaves: List[Tuple[FilterQueryTree, str, str, int, int]],
):
    """-> nested ("leaf", i) / ("and"|"or", ...) encoding, or a string
    reason why the subtree is not bit-sliceable."""
    if node.is_leaf:
        kind = _leaf_kind(node.operator)
        if kind is None:
            return f"operator {node.operator.name} not bit-sliceable"
        col = node.column
        if not all(s.has_column(col) for s in live):
            return f"column {col!r} missing from a segment"
        cols = [s.column(col) for s in live]
        if not cols[0].metadata.single_value:
            return f"column {col!r} is multi-value"
        if any(c.dictionary.cardinality <= 0 for c in cols):
            return f"column {col!r} has no dictionary"
        if kind != "interval" and len(node.values) > _MAX_POINTS:
            return f"point set over {_MAX_POINTS} values"
        width = bsi_filter_width(cols)
        k_pad = _k_pad(len(node.values)) if kind != "interval" else 0
        leaves.append((node, kind, col, width, k_pad))
        return ("leaf", len(leaves) - 1)
    if node.operator not in (FilterOperator.AND, FilterOperator.OR):
        return f"operator {node.operator.name} not bit-sliceable"
    children = []
    for c in node.children:
        enc = _encode_tree(c, live, leaves)
        if isinstance(enc, str):
            return enc
        children.append(enc)
    op = "and" if node.operator == FilterOperator.AND else "or"
    return (op, *children)


def bitsliced_decision(
    request: BrokerRequest,
    live: List[ImmutableSegment],
    ctx: TableContext,
    total_docs: int,
    mode: Mode = True,
    zone_maps: bool = True,
):
    """The bit-sliced tier's verdict, apart from execution so EXPLAIN can
    report it without serving the query.  Returns ``(decision, state)``:
    a JSON-safe record, and the execution handoff (the program spec, the
    leaf nodes, the fused-aggregation descriptors) only when taken.
    ``mode`` is the executor's ``bitsliced`` switch, ``zone_maps`` its
    zone-map switch."""
    if mode is False:
        return {"taken": False, "reason": "bit-sliced tier disabled (bitsliced=False)"}, None
    force = mode == "force"
    if not live:
        return {"taken": False, "reason": "no live segments"}, None
    if (
        not request.is_aggregation
        or request.is_group_by
        or request.is_selection
        or request.join is not None
        or not request.aggregations
    ):
        return {"taken": False, "reason": "tier serves single-table scalar aggregations only"}, None
    for a in request.aggregations:
        if a.base_function not in _SCALAR_AGGS or a.is_mv:
            return {"taken": False, "reason": f"aggregation {a.function} not popcount-fusable"}, None
    if request.filter is None:
        return {"taken": False, "reason": "no filter: the plain scan already streams every row once"}, None

    leaves: List[Tuple[FilterQueryTree, str, str, int, int]] = []
    tree = _encode_tree(request.filter, live, leaves)
    if isinstance(tree, str):
        return {"taken": False, "reason": tree}, None

    # fused-aggregate eligibility: SUM / AVG need exactly integral value
    # planes (bit-exactness against the scan tier); MIN / MAX descend the
    # dictId planes (dictionaries are sorted: extreme dictId = extreme value)
    sums: Dict[str, int] = {}
    extremes: Dict[Tuple[str, bool], int] = {}
    agg_descs = []
    for a in request.aggregations:
        base = a.base_function
        if base == "count":
            agg_descs.append(("count", None))
            continue
        col = a.column
        if not all(s.has_column(col) for s in live):
            return {"taken": False, "reason": f"agg column {col!r} missing"}, None
        cols = [s.column(col) for s in live]
        if not cols[0].metadata.single_value or cols[0].metadata.data_type.stored_type == DataType.STRING:
            return {"taken": False, "reason": f"agg column {col!r} not a numeric SV column"}, None
        if base in ("sum", "avg"):
            spec_v = bsiv_value_spec(cols)
            if spec_v is None:
                return {
                    "taken": False,
                    "reason": f"sum({col}) not fusable: dictionary values "
                    "not exactly integral (bit-exactness contract)",
                }, None
            sums[col] = spec_v[0]
        else:
            extremes[(col, base == "max")] = bsi_filter_width(cols)
        agg_descs.append((base, col))

    filter_planes = sum(w for (_, _, _, w, _) in leaves)
    planes_total = filter_planes + sum(sums.values()) + sum(extremes.values())
    plane_counts = {col: w for (_, _, col, w, _) in leaves}
    decision: Dict[str, Any] = {
        "column": next(iter(plane_counts), None),
        "planes": int(planes_total),
        "planeCounts": plane_counts,
        "fusedAggs": [base if col is None else f"{base}({col})" for base, col in agg_descs],
    }
    cap = tiercost.bsi_max_planes()
    if planes_total > cap and not force:
        decision.update(taken=False, reason=f"{planes_total} planes over the bit-sliced budget ({cap})")
        return decision, None

    if not force:
        # clustered interval predicates belong to the zone-map / doc-range
        # tier: block pruning reads O(candidate blocks), which no bitwise
        # full-width pass can beat
        if zone_maps:
            for node, kind, col, _, _ in leaves:
                sortedish = kind == "interval" or (kind == "points" and len(node.values) == 1)
                if sortedish and all(s.column(col).metadata.is_sorted for s in live):
                    decision.update(
                        taken=False,
                        reason=f"sorted column {col!r} defers to zone-map/doc-range block pruning",
                    )
                    return decision, None
        bsi_ns = tiercost.bitsliced_cost_ns(total_docs, planes_total)
        scan_ns = tiercost.scan_cost_ns(total_docs)
        decision["estCostNs"] = int(bsi_ns)
        decision["scanCostNs"] = int(scan_ns)
        if bsi_ns >= scan_ns:
            decision.update(taken=False, reason=f"cost model favors the full scan ({planes_total} planes)")
            return decision, None

    decision.update(
        taken=True,
        reason="mid-selectivity scalar aggregation fuses into the "
        f"bitwise pass over {planes_total} planes",
    )
    spec = (
        tuple((kind, col, w, k) for (_, kind, col, w, k) in leaves),
        tree,
        tuple(sorted(sums.items())),
        tuple(sorted((c, w, m) for (c, m), w in extremes.items())),
    )
    return decision, (spec, leaves, agg_descs, planes_total, filter_planes)


def _query_inputs(leaves, live: List[ImmutableSegment], S: int) -> Dict[str, np.ndarray]:
    """Per-segment dictId thresholds / point sets for every leaf:
    dictionaries are per segment, so each segment lowers its own literals
    (``plan.leaf_interval`` / ``leaf_points``)."""
    q: Dict[str, np.ndarray] = {}
    for i, (node, kind, col, _, k_pad) in enumerate(leaves):
        if kind == "interval":
            b = np.zeros((S, 2), dtype=np.int32)
            for s, seg in enumerate(live):
                b[s] = leaf_interval(node, seg.column(col).dictionary)
            q[f"bounds:{i}"] = b
        else:
            p = np.full((S, k_pad), -1, dtype=np.int32)
            for s, seg in enumerate(live):
                p[s] = leaf_points(node, seg.column(col).dictionary, k_pad)
            q[f"pts:{i}"] = p
    return q


def _finalize(agg_descs, staged, live: List[ImmutableSegment], outs: Dict[str, np.ndarray]):
    """Host merge of the per-segment program outputs into aggregation
    partials, in exact integer arithmetic (Python ints) end to end, so a
    fused SUM is bit-exact against the scan tier's float64 result for the
    integral values the eligibility gate admits.  Min / max round-trip
    through the staged value dtype, as the scan tier's staged
    dictionaries do."""
    counts = np.asarray(outs["count"], dtype=np.int64)
    matched = int(counts.sum())
    fdt = staged.precision.np_float_dtype
    partials = []
    for base, col in agg_descs:
        if base == "count":
            partials.append(CountPartial(float(matched)))
            continue
        if base in ("sum", "avg"):
            sc = staged.columns[col]
            psum = np.asarray(outs[f"psum:{col}"])  # int64 [S, Wv]
            total = 0
            for b in range(sc.bsiv_width):
                total += (1 << b) * int(psum[:, b].sum())
            for s in range(len(live)):
                total += int(sc.bsiv_min[s]) * int(counts[s])
            if base == "sum":
                partials.append(SumPartial(float(total)))
            else:
                partials.append(AvgPartial(float(total), float(matched)))
            continue
        # min / max: per-segment extreme dictId -> the segment's dictionary
        # (an empty segment reports a garbage id, masked on its count)
        ids = np.asarray(outs[f"ext:{'mx' if base == 'max' else 'mn'}:{col}"])
        vals = [
            float(fdt(seg.column(col).dictionary.get(int(ids[s]))))
            for s, seg in enumerate(live)
            if counts[s] > 0
        ]
        if not vals:
            partials.append(make_partial(base))
        elif base == "min":
            partials.append(MinPartial(min(vals)))
        else:
            partials.append(MaxPartial(max(vals)))
    return partials, matched


def try_bitsliced_path(
    executor,
    request: BrokerRequest,
    live: List[ImmutableSegment],
    ctx: TableContext,
    total_docs: int,
    deadline: Optional[float] = None,
) -> Optional[IntermediateResult]:
    """Serve an eligible scalar aggregation from the bit-sliced tier, or
    None to fall through to the scan section.  Rides the executor's lane
    dispatch (coalescing, batching, the packed fetch), keyed on
    ``("bsi", spec)`` where a scan keys on its StaticPlan, so a scan and a
    bit-sliced launch never coalesce or batch together."""
    decision, state = bitsliced_decision(
        request, live, ctx, total_docs, executor.bitsliced, executor.zone_maps
    )
    if state is None:
        return None
    spec, leaves, agg_descs, planes_total, filter_planes = state
    leaf_spec, _tree, sums, extremes = spec
    bsi_cols = sorted({col for (_, col, _, _) in leaf_spec} | {c for (c, _, _) in extremes})
    bsiv_cols = sorted({c for (c, _) in sums})
    all_cols = sorted(set(bsi_cols) | set(bsiv_cols))
    # the planes are this tier's whole column layout: the base fwd / dict
    # streams are not staged for it.  The staged table is pinned for the
    # launch, so no residency demotion takes it meanwhile
    t0 = time.perf_counter()
    with executor._stage_lock:
        staged = get_staged(
            executor._staged,
            live,
            all_cols,
            executor.device,
            executor.precision,
            skip_base_columns=all_cols,
            bsi_columns=bsi_cols,
            bsiv_columns=bsiv_cols,
            residency=executor.residency,
            pin=True,
        )
    executor._phase("staging", t0)
    try:
        return _dispatch_bitsliced(
            executor, request, live, total_docs, deadline, staged, spec, leaves, agg_descs,
            planes_total, filter_planes, bsi_cols, bsiv_cols,
        )
    finally:
        executor.residency.unpin(staged.token)


def _dispatch_bitsliced(
    executor,
    request: BrokerRequest,
    live: List[ImmutableSegment],
    total_docs: int,
    deadline: Optional[float],
    staged,
    spec,
    leaves,
    agg_descs,
    planes_total: int,
    filter_planes: int,
    bsi_cols,
    bsiv_cols,
) -> Optional[IntermediateResult]:
    for col in bsi_cols:
        if staged.columns[col].bsi is None:
            return None  # staging declined
    for col in bsiv_cols:
        if staged.columns[col].bsiv is None:
            return None

    segs: Dict[str, Any] = {"nd": staged.num_docs_arr}
    dev_bytes = 0
    for col in bsi_cols:
        segs[f"p:{col}"] = staged.columns[col].bsi
        dev_bytes += staged.columns[col].bsi.numel() * 4
    for col in bsiv_cols:
        segs[f"v:{col}"] = staged.columns[col].bsiv
        dev_bytes += staged.columns[col].bsiv.numel() * 4

    q_np = _query_inputs(leaves, live, staged.num_segments)
    key = ("bsi", spec)
    kernel = make_packed_bitsliced_kernel(spec)
    batch_spec = None
    lane = executor.lane
    if lane is not None and lane.batch_max > 1:
        batch_spec = _bsi_batch_spec(executor, spec, staged, q_np, segs)
    cost: Dict[str, float] = {}
    outs = executor._dispatch(
        (key, staged.token),
        lambda q: kernel.dispatch(segs, q),
        kernel.fetch, list(segs.values()), q_np, deadline, plan_digest(key), cost, batch_spec,
    )

    partials, matched = _finalize(agg_descs, staged, live, outs)
    res = IntermediateResult(
        num_docs_scanned=matched,
        total_docs=total_docs,
        num_segments_queried=len(live),
        # the bitwise pass reads words, not rows: planes x n/32 words of
        # 32-bit filter work per leaf plane (the O(W x n/32) claim)
        num_entries_scanned_in_filter=(filter_planes * total_docs) // 32,
        num_entries_scanned_post_filter=matched * max(1, len(agg_descs)),
    )
    res.aggregations = partials
    res.add_cost(bytesScanned=dev_bytes, deviceBytes=dev_bytes, segmentsBitsliced=len(live), **cost)
    m = executor.metrics
    m.meter("filter.bitsliced.queries").mark()
    m.meter("filter.bitsliced.planes").mark(planes_total)
    m.meter("filter.bitsliced.fusedAggs").mark(len(agg_descs))
    m.meter("filter.bitsliced.bytes").mark(dev_bytes)
    return res


def _bsi_batch_spec(executor, spec, staged, q_np, segs) -> Optional[BatchSpec]:
    """``BatchSpec`` of a bit-sliced dispatch (the executor's
    ``_batch_spec`` for this tier): key (("bsi", spec), staging token,
    input signature), so same-spec queries with other literals stack
    their bounds / points into one launch over the same resident planes.
    The row budget counts padded docs like the scan tier's; None when one
    member already fills it."""
    limit = chunk_rows_limit()
    rows = max(1, staged.num_segments * staged.n_pad)
    max_members = 0
    if limit:
        max_members = 1
        while max_members * 2 <= limit // rows:
            max_members *= 2
    if max_members == 1:
        return None
    device = executor.device
    tensors = list(segs.values())

    def launch_batched(inputs_list):
        # on the lane's stream: wait for every member's PREP, one stacked
        # upload, one batched launch, one packed copy back
        for _, ready in inputs_list:
            stream_handoff(ready, tensors)
        bkernel = make_packed_batched_bitsliced_kernel(spec)
        qb = to_device_inputs(stack_query_inputs([q for q, _ in inputs_list]), device)
        return bkernel.fetch, bkernel.dispatch(segs, qb)

    key = (("bsi", spec), staged.token, batch_input_signature(q_np))
    return BatchSpec(key, (q_np, ready_event(device)), launch_batched, max_members=max_members)
