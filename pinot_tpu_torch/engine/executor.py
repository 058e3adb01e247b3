"""Per-server query executor: segments + BrokerRequest -> IntermediateResult
(lean port of ``pinot_tpu.engine.executor.QueryExecutor``).

prune -> stage -> plan -> table kernel -> one packed fetch -> finalize.
All segments run in one table kernel over the stacked segment axis with
the cross-segment merge fused in (``kernel.py``); this class prepares the
inputs and turns the outputs into mergeable partials.

The port has no host tier: a query shape this slice does not run on the
device raises ``NotImplementedError`` naming the slice that will.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pinot_tpu_torch.common.request import BrokerRequest, FilterOperator, group_sort_ascending
from pinot_tpu_torch.common.schema import DataType
from pinot_tpu_torch.common.values import render_value
from pinot_tpu_torch.engine import config
from pinot_tpu_torch.engine.config import Precision
from pinot_tpu_torch.engine.context import TableContext, get_table_context
from pinot_tpu_torch.engine.device import (
    StagedTable,
    get_staged,
    segment_arrays,
    to_device_inputs,
)
from pinot_tpu_torch.engine.kernel import run_table_kernel
from pinot_tpu_torch.engine.packing import make_packed_kernel
from pinot_tpu_torch.engine.plan import (
    StaticPlan,
    _agg_kind,
    build_query_inputs,
    build_static_plan,
    plan_forced_host,
)
from pinot_tpu_torch.engine.results import (
    AggPartial,
    AvgPartial,
    CountPartial,
    IntermediateResult,
    MaxPartial,
    MinMaxRangePartial,
    MinPartial,
    SumPartial,
    make_partial,
    trim_group_candidates,
)
from pinot_tpu_torch.segment.immutable import ImmutableSegment

_SLICE_AGGS = ("count", "sum", "min", "max", "avg", "minmaxrange")


def prune_segments(
    segments: Sequence[ImmutableSegment], request: BrokerRequest
) -> List[ImmutableSegment]:
    """Drop empty segments (ValidSegmentPruner) and segments missing a
    referenced column (DataSchemaSegmentPruner)."""
    needed = request.referenced_columns()
    return [
        s for s in segments if s.num_docs > 0 and all(s.has_column(c) for c in needed)
    ]


def check_supported(request: BrokerRequest) -> None:
    """Raise NotImplementedError for query shapes outside this slice,
    before anything is staged."""
    if request.join is not None:
        raise NotImplementedError("joins are a later slice of the port")
    if request.is_selection:
        raise NotImplementedError("selection queries are a later slice of the port")
    for a in request.aggregations:
        if a.is_mv or a.base_function not in _SLICE_AGGS:
            raise NotImplementedError(
                f"aggregation {a.function!r}: value-state (distinctcount, percentile, "
                "HLL) and MV aggregations are later slices of the port"
            )


class QueryExecutor:
    """Executes aggregation / group-by queries over a set of immutable
    segments on one device.

    ``device``: where the segments are staged and the kernel runs; None
    means the current CUDA device, and raises when there is none.
    ``precision``: "x64" or "x32" (``engine/config.py``)."""

    def __init__(
        self,
        device: Optional[Union[str, torch.device]] = None,
        precision: Union[str, Precision] = "x64",
    ) -> None:
        self.device = config.resolve_device(device)
        self.precision = config.as_precision(precision)
        self._staged: Dict[Tuple, StagedTable] = {}
        self._contexts: Dict[Tuple, TableContext] = {}
        self._kernel = make_packed_kernel(run_table_kernel)

    def staged_bytes(self) -> int:
        """Bytes the staging cache holds on the device."""
        return sum(st.nbytes() for st in self._staged.values())

    def execute(
        self, segments: Sequence[ImmutableSegment], request: BrokerRequest
    ) -> IntermediateResult:
        check_supported(request)
        total_docs = sum(s.num_docs for s in segments)
        live = prune_segments(segments, request)
        pruned = len(segments) - len(live)
        if not live:
            res = self._empty_result(request, total_docs)
            res.add_cost(segmentsPruned=pruned)
            return res
        result = self._execute_engine(live, request)
        result.total_docs = total_docs
        result.add_cost(segmentsPruned=pruned)
        return result

    def _execute_engine(
        self, live: List[ImmutableSegment], request: BrokerRequest
    ) -> IntermediateResult:
        total_docs = sum(s.num_docs for s in live)
        needed = set(request.referenced_columns())
        # columns used only by doc-range predicates on sorted columns never
        # reach the device (the kernel compares row ids with doc bounds)
        needed -= self._docrange_only_columns(request, live)
        ctx = get_table_context(live, self._contexts)
        if plan_forced_host(request, ctx, self.precision):
            raise NotImplementedError(
                "group space beyond the dense device holder: the host tier is a "
                "later slice of the port"
            )
        raw_cols, gfwd_cols = self._role_columns(request, live)
        skip_base = self._skip_base_columns(request, live, raw_cols, gfwd_cols)
        staged = get_staged(
            self._staged,
            live,
            sorted(needed),
            self.device,
            self.precision,
            raw_columns=raw_cols,
            gfwd_columns=gfwd_cols,
            ctx=ctx,
            skip_base_columns=skip_base,
        )
        return self._device_section_staged(live, request, ctx, needed, total_docs, staged)

    def _device_section_staged(
        self,
        live: List[ImmutableSegment],
        request: BrokerRequest,
        ctx: TableContext,
        needed: set,
        total_docs: int,
        staged: StagedTable,
    ) -> IntermediateResult:
        scratch: Dict[Any, Any] = {}
        plan = build_static_plan(request, ctx, staged, scratch=scratch)
        if not plan.on_device:
            raise NotImplementedError(
                "plan is not on device: the host tier is a later slice of the port"
            )
        q_np = build_query_inputs(request, plan, ctx, staged, scratch=scratch)
        seg = segment_arrays(staged, needed)
        q = to_device_inputs(q_np, self.device)
        outs = self._kernel(plan, staged, seg, q)
        result = self._finalize(request, plan, ctx, staged, live, outs, total_docs)
        dev_bytes = sum(t.numel() * t.element_size() for t in seg.values())
        result.add_cost(bytesScanned=dev_bytes, deviceBytes=dev_bytes, segmentsFullScan=len(live))
        return result

    def _docrange_only_columns(self, request: BrokerRequest, live) -> set:
        """Filter columns whose every use qualifies for the docrange fast
        path and which appear nowhere else in the query."""
        used_elsewhere = {a.column for a in request.aggregations}
        if request.is_group_by:
            used_elsewhere.update(request.group_by.columns)
        return self._docrange_qualifying_cols(request, live) - used_elsewhere

    def _docrange_qualifying_cols(self, request: BrokerRequest, live) -> set:
        """Filter columns whose EVERY leaf use classifies docrange (sorted
        in every segment, SV, RANGE or single-value EQ) — mirrors
        build_static_plan's classification."""
        if request.filter is None:
            return set()
        qualifies: Dict[str, bool] = {}
        for node in request.filter.walk():
            if not node.is_leaf:
                continue
            col = node.column
            ok = False
            if live and live[0].has_column(col):
                meta0 = live[0].column(col).metadata
                shape_ok = node.operator == FilterOperator.RANGE or (
                    node.operator == FilterOperator.EQUALITY and len(node.values) == 1
                )
                ok = (
                    meta0.single_value
                    and shape_ok
                    and all(s.column(col).metadata.is_sorted for s in live)
                )
            qualifies[col] = qualifies.get(col, True) and ok
        return {c for c, ok in qualifies.items() if ok}

    def _skip_base_columns(self, request: BrokerRequest, live, raw_cols, gfwd_cols) -> set:
        """Columns the kernel reads only through a role array skip their
        base fwd/dict arrays; filter leaves (other than docrange ones) and
        dictionary-fed agg inputs keep them."""
        filter_cols = (
            {n.column for n in request.filter.walk() if n.is_leaf}
            if request.filter is not None
            else set()
        ) - self._docrange_qualifying_cols(request, live)
        gather_agg_cols = {
            a.column
            for a in request.aggregations
            if _agg_kind(a.base_function) in ("scalar", "pair") and a.column not in raw_cols
        }
        return (set(raw_cols) | set(gfwd_cols)) - filter_cols - gather_agg_cols

    def _role_columns(self, request: BrokerRequest, live):
        """Aggregation inputs above ``raw_card_min`` get raw value arrays;
        group-by columns get global-id forward arrays."""
        seg = live[0]

        def big_card(c: str) -> bool:
            card = max(s.column(c).metadata.cardinality for s in live)
            return card > config.raw_card_min(self.device)

        def numeric(c: str) -> bool:
            if c == "*" or c not in seg.columns:
                return False
            return seg.column(c).metadata.data_type.stored_type != DataType.STRING

        raw_cols = {
            a.column
            for a in request.aggregations
            if numeric(a.column)
            and big_card(a.column)
            and _agg_kind(a.base_function) in ("scalar", "pair")
        }
        gfwd_cols = set()
        if request.is_group_by:
            gfwd_cols.update(
                c
                for c in request.group_by.columns
                if c in seg.columns and seg.column(c).metadata.single_value
            )
        return tuple(sorted(raw_cols)), tuple(sorted(gfwd_cols))

    def _empty_result(self, request: BrokerRequest, total_docs: int) -> IntermediateResult:
        res = IntermediateResult(total_docs=total_docs)
        if request.is_group_by:
            res.groups = {}
        else:
            res.aggregations = [make_partial(a.base_function) for a in request.aggregations]
        return res

    # ------------------------------------------------------------------
    def _finalize(
        self,
        request: BrokerRequest,
        plan: StaticPlan,
        ctx: TableContext,
        staged: StagedTable,
        live: List[ImmutableSegment],
        outs: Dict[str, Any],
        total_docs: int,
    ) -> IntermediateResult:
        matched = int(outs["num_docs"])
        res = IntermediateResult(
            num_docs_scanned=matched,
            total_docs=total_docs,
            num_segments_queried=len(live),
            num_entries_scanned_in_filter=len(plan.leaves) * staged.total_docs,
            num_entries_scanned_post_filter=matched * max(1, len(plan.aggs)),
        )
        if plan.group_by is not None:
            res.groups = self._finalize_groups(plan, ctx, outs)
        elif plan.aggs:
            res.aggregations = [
                self._scalar_partial(agg, outs[f"agg_{i}"]) for i, agg in enumerate(plan.aggs)
            ]
        return res

    def _scalar_partial(self, agg, state) -> AggPartial:
        base = agg.base
        if base == "count":
            return CountPartial(float(state))
        if base == "sum":
            return SumPartial(float(state))
        if base == "min":
            return MinPartial(float(state))
        if base == "max":
            return MaxPartial(float(state))
        if base == "avg":
            return AvgPartial(float(state[0]), float(state[1]))
        if base == "minmaxrange":
            return MinMaxRangePartial(float(state[0]), float(state[1]))
        raise AssertionError(agg)

    def _finalize_groups(
        self, plan: StaticPlan, ctx: TableContext, outs
    ) -> Dict[Tuple[str, ...], List[AggPartial]]:
        gb = plan.group_by
        keys = np.nonzero(np.asarray(outs["gb_presence"]).astype(bool))[0]
        if keys.size == 0:
            return {}
        # trim candidate groups per aggregation (reference trims to
        # topN*5 per server, MCombineGroupByOperator.java:216)
        if keys.size > max(gb.top_n * 5, 100):
            keep = trim_group_candidates(
                [
                    self._group_order_values(agg, outs[f"gb_{i}"], keys)
                    for i, agg in enumerate(plan.aggs)
                ],
                [group_sort_ascending(agg.func) for agg in plan.aggs],
                gb.top_n,
                keys.size,
            )
            keys = keys[keep]
        # decompose mixed-radix keys -> per-column global ids
        gids = []
        rem = keys.copy()
        for gcard in reversed(gb.gcards):
            gids.append(rem % gcard)
            rem = rem // gcard
        gids.reverse()
        gdicts = [ctx.column(c).global_dict for c in gb.columns]
        groups: Dict[Tuple[str, ...], List[AggPartial]] = {}
        for row in range(keys.size):
            ktup = tuple(
                render_value(gdicts[j].stored_type, gdicts[j].get(int(gids[j][row])))
                for j in range(len(gb.columns))
            )
            k = int(keys[row])
            groups[ktup] = [
                self._group_partial(agg, outs[f"gb_{i}"], k) for i, agg in enumerate(plan.aggs)
            ]
        return groups

    def _group_order_values(self, agg, state, keys: np.ndarray) -> np.ndarray:
        """Exact finalized per-group values, used for trim ordering."""
        base = agg.base
        if base in ("count", "sum", "min", "max"):
            return np.asarray(state)[keys].astype(np.float64)
        if base == "avg":
            s = np.asarray(state[0])[keys].astype(np.float64)
            c = np.asarray(state[1])[keys].astype(np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                return np.where(c > 0, s / np.maximum(c, 1), -np.inf)
        if base == "minmaxrange":
            return (np.asarray(state[1])[keys] - np.asarray(state[0])[keys]).astype(np.float64)
        raise AssertionError(agg)

    def _group_partial(self, agg, state, key: int) -> AggPartial:
        base = agg.base
        if base == "count":
            return CountPartial(float(state[key]))
        if base == "sum":
            return SumPartial(float(state[key]))
        if base == "min":
            return MinPartial(float(state[key]))
        if base == "max":
            return MaxPartial(float(state[key]))
        if base == "avg":
            return AvgPartial(float(state[0][key]), float(state[1][key]))
        if base == "minmaxrange":
            return MinMaxRangePartial(float(state[0][key]), float(state[1][key]))
        raise AssertionError(agg)
