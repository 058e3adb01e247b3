"""EXPLAIN: the serving-tier decisions of a query, computed WITHOUT
serving it (port of ``pinot_tpu.engine.explain``, its plan half).

``build_explain_node`` walks the executor's decision order
(``QueryExecutor.execute`` -> ``_execute_engine``): the prune verdicts,
the star-tree split, postings, the bit-sliced tier, the host forcing, the
poison quarantine and the zone-map / full-scan split, and returns a
JSON-safe plan node for one server instead of results.

The device decisions (the StaticPlan, its digest, the zone-map candidate
fraction) read a staged table; EXPLAIN must never stage (a cold EXPLAIN of
a large table must not upload it) and never launch.  ``_phantom_staged``
builds a metadata-only ``StagedTable`` twin: the bucketing (``n_pad``,
``card_pad``, ``mv_pad``), the per-segment cards and the role PRESENCE
(zero-length host sentinels) that the port's own ``device.stage_segments``
would give.  ``build_static_plan`` and ``build_query_inputs`` read only
those, so the phantom gives the IDENTICAL ``StaticPlan``, hence the same
plan digest and poison key the executor would launch, with no byte on the
card.  The phantom goes through the executor's own helpers
(``_resolve_selection_columns``, ``_docrange_only_columns``,
``_role_columns``, ``_skip_base_columns``, ``_block_skip_ids``).

The safety contract: plain EXPLAIN submits nothing to the lane, marks no
cost meter and allocates nothing on the card.

What the port renders as the reference does with its planes absent: the
estimated cost is always ``"static"`` (plan statistics are a later
slice), ``device.batching.cacheHit`` is always false (no result cache),
``compile.state`` is never ``"persistent"`` (no compile cache) and
``compile.costAnalysis`` is ``"unavailable"``.  The mesh record is one
lane on one card.  Left out: the prewarm specs
(``build_prewarm_spec``), which belong to the compile cache.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from pinot_tpu_torch.common.request import BrokerRequest
from pinot_tpu_torch.engine import config
from pinot_tpu_torch.engine.bitsliced import bitsliced_decision
from pinot_tpu_torch.engine.context import get_table_context
from pinot_tpu_torch.engine.device import StagedColumn, StagedTable
from pinot_tpu_torch.engine.dispatch import plan_digest
from pinot_tpu_torch.engine.invindex_path import index_path_decision
from pinot_tpu_torch.engine.kernel import chunk_rows_limit
from pinot_tpu_torch.engine.plan import build_query_inputs, build_static_plan, plan_forced_host
from pinot_tpu_torch.engine.plandigest import _raw_table, plan_shape_digest, plan_shape_summary
from pinot_tpu_torch.engine.pruner import prune_explain
from pinot_tpu_torch.engine.results import SEGMENT_TIER_NAMES
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.startree.operator import is_fit_for_star_tree

# the tier name of a segment record -> its cost-vector key
# ("fullScan" -> "segmentsFullScan"), so EXPLAIN ANALYZE's estimated and
# actual tier counts line up key for key
TIER_COST_KEYS = {name: key for key, name in SEGMENT_TIER_NAMES.items()}

# the mesh record on one card: one lane, no shard axis, no collective
_ONE_CARD_MESH = {"shape": "1x1", "lanes": 1, "laneIndex": 0, "shardAxis": None, "collective": None}


def _json_safe(v: Any) -> Any:
    """numpy scalars and arrays -> plain Python, recursively (the plan node
    rides the DataTable's tagged value codec, which knows no numpy)."""
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.ndarray):
        return [_json_safe(x) for x in v.tolist()]
    if isinstance(v, np.bool_):
        return bool(v)
    return v


# a present role array, for the planner's ``is not None`` tests: empty and
# on the host
_SENTINEL = torch.zeros(0, dtype=torch.int8)


def _phantom_staged(
    segments: Sequence[ImmutableSegment],
    column_names: Sequence[str],
    raw_cols: Sequence[str],
    gfwd_cols: Sequence[str],
    hll_cols: Sequence[str],
    skip_base: Sequence[str],
    device: torch.device,
    precision: config.Precision,
) -> StagedTable:
    """Metadata-only twin of ``device.stage_segments(segments,
    sorted(column_names), ...)`` (module docstring).  It MUST mirror that
    function's bucketing and role conditions: the StaticPlan (its digest,
    its poison key) has to equal what the execution builds."""
    S = len(segments)
    st = StagedTable(
        segment_names=tuple(s.segment_name for s in segments),
        num_segments=S,
        n_pad=config.pad_docs(max(seg.num_docs for seg in segments)),
        num_docs=tuple(s.num_docs for s in segments),
        num_docs_arr=torch.tensor([s.num_docs for s in segments], dtype=torch.int32),
        device=device,
        precision=precision,
    )
    for name in sorted(set(column_names)):
        cols = [seg.column(name) for seg in segments]
        meta0 = cols[0].metadata
        cards = tuple(c.dictionary.cardinality for c in cols)
        sc = StagedColumn(
            name=name,
            stored_type=meta0.data_type.stored_type,
            single_value=meta0.single_value,
            card_pad=config.pad_card(max(cards)),
            cards=cards,
        )
        if not meta0.single_value:
            sc.mv_pad = config.pad_card(max(1, max(c.metadata.max_num_multi_values for c in cols)))
            sc.mv = sc.mv_counts = _SENTINEL
            if name in raw_cols and sc.is_numeric:
                sc.mv_raw = _SENTINEL
            if sc.is_numeric:
                sc.dict_vals = _SENTINEL
        else:
            if name not in skip_base:
                sc.fwd = _SENTINEL
                if sc.is_numeric:
                    sc.dict_vals = _SENTINEL
            if name in raw_cols and sc.is_numeric:
                sc.raw = _SENTINEL
            if name in gfwd_cols:
                sc.gfwd = _SENTINEL
            if name in hll_cols:
                sc.hll_bucket = sc.hll_rho = _SENTINEL
        st.columns[name] = sc
    return st


def _estimate_scan_bytes(segments: Sequence[ImmutableSegment], columns: Sequence[str], fraction: float) -> int:
    """Static byte estimate of a device scan: each column's forward index
    at the port's staged integer width (``config.index_dtype``), scaled by
    the zone-map candidate fraction (1.0 for a full scan)."""
    total = 0
    for seg in segments:
        for name in columns:
            col = seg.columns.get(name)
            if col is None:
                continue
            meta = col.metadata
            itemsize = np.dtype(config.index_dtype(config.pad_card(max(meta.cardinality, 1)))).itemsize
            if meta.single_value:
                total += seg.num_docs * itemsize
            else:
                total += seg.num_docs * max(1, meta.max_num_multi_values) * itemsize
    return int(total * min(max(fraction, 0.0), 1.0))


def _staged_snapshot(executor, table: str, segment_names: Sequence[str]) -> Dict[str, Any]:
    """What of this query's segments the executor ALREADY holds, read off
    its staging ledger (never staging anything): the bytes, staged tables
    and columns on the card of the entries of this table holding one of
    the segments, and each segment's residency tier ("hot", "warm",
    "cold", or "unstaged" for a segment no tier holds)."""
    wanted = set(segment_names)
    raw = _raw_table(table)
    bytes_total = 0
    columns: set = set()
    entries = 0
    for e in executor.ledger.snapshot()["entries"]:
        etable = e.get("table") or ""
        # an entry of unknown table matches on its segments alone
        if etable and _raw_table(etable) != raw:
            continue
        if not wanted.intersection(e.get("segments") or ()):
            continue
        entries += 1
        bytes_total += int(e.get("bytes") or 0)
        columns.update((e.get("columns") or {}).keys())
    tiers = executor.residency.segment_tiers(raw, segment_names, raw_match=True)
    return {
        "hbmBytes": bytes_total,
        "stagedTables": entries,
        "columns": sorted(columns),
        "residency": {s: tiers.get(s, "unstaged") for s in segment_names},
    }


def _compile_record(lane, pdigest: str) -> Dict[str, Any]:
    """The device node's compile record: "warm" with the lane's timeline
    once the digest launched there, else "cold"."""
    entry = lane.compile_info(pdigest) if lane is not None else None
    if entry is None:
        return {"state": "cold", "costAnalysis": "unavailable"}
    return {"state": "warm", **entry, "costAnalysis": "unavailable"}


def build_explain_node(
    executor,
    segments: Sequence[ImmutableSegment],
    request: BrokerRequest,
    table: str,
    server_name: str,
) -> Dict[str, Any]:
    """One server's EXPLAIN plan node (module docstring): the reference's
    with its ``plan_stats`` and ``result_cache`` absent.  ``executor``
    supplies the decision helpers and the live quarantine state."""
    total_docs = sum(s.num_docs for s in segments)
    records: List[Dict[str, Any]] = []
    tier_counts: Dict[str, int] = {}

    def record(seg: ImmutableSegment, tier: str, reason: str, **extra) -> None:
        key = TIER_COST_KEYS[tier]
        tier_counts[key] = tier_counts.get(key, 0) + 1
        records.append(dict({"segment": seg.segment_name, "tier": tier, "reason": reason}, **extra))

    verdicts = prune_explain(segments, request)
    live = [seg for seg, reason in verdicts if reason is None]
    for seg, reason in verdicts:
        if reason is not None:
            record(seg, "pruned", reason)

    device_info: Optional[Dict[str, Any]] = None
    est_bytes = 0
    star = [s for s in live if is_fit_for_star_tree(request, s)]
    normal = [s for s in live if s not in star]
    for seg in star:
        record(seg, "starTree", "conjunctive-EQ dims + aggregations covered by the segment's star-tree cube")

    if normal:
        needed = set(request.referenced_columns())
        sel_columns: Optional[List[str]] = None
        if request.is_selection:
            sel_columns = executor._resolve_selection_columns(request, normal[0])
            needed.update(sel_columns)
        needed -= executor._docrange_only_columns(request, normal, sel_columns)
        selection = executor.lane_selection(request)
        lane = selection.lane if selection is not None else executor.lane
        with executor._stage_lock:
            ctx = get_table_context(normal, executor._contexts)

        decision, state = index_path_decision(request, normal, ctx, total_docs, executor.postings)
        bsi_decision, bsi_state = None, None
        if state is None:
            # the executor's tier order: the bit-sliced tier only after
            # postings declines
            bsi_decision, bsi_state = bitsliced_decision(
                request, normal, ctx, total_docs, executor.bitsliced, executor.zone_maps
            )
        if state is not None:
            est_bytes = int(decision.get("estMatches", 0)) * (decision.get("residuals", 0) + 1) * 8
            for seg in normal:
                record(seg, "postings", decision["reason"], drivingColumn=decision.get("column"))
        elif bsi_state is not None:
            spec, _leaves, _aggs, planes_total, _fp = bsi_state
            est_bytes = (total_docs * planes_total) // 8
            for seg in normal:
                record(seg, "bitsliced", bsi_decision["reason"], planes=bsi_decision.get("planes"),
                       planeCounts=bsi_decision.get("planeCounts"), fusedAggs=bsi_decision.get("fusedAggs"))
            # the bit-sliced program is a lane-registered device plan like
            # any scan: its digest is the one try_bitsliced_path hands the
            # lane
            pdigest = plan_digest(("bsi", spec))
            device_info = {
                "planDigest": pdigest,
                "compile": _compile_record(lane, pdigest),
                "quarantined": False,
                "mesh": dict(_ONE_CARD_MESH),
            }
        elif plan_forced_host(request, ctx, executor.precision):
            est_bytes = _estimate_scan_bytes(normal, sorted(needed), 1.0)
            for seg in normal:
                record(seg, "host", "planner forces host before staging (group capacity or guaranteed "
                                    "sort-pair overflow)")
        else:
            raw_cols, gfwd_cols, hll_cols = executor._role_columns(request, normal, ctx)
            skip_base = executor._skip_base_columns(request, normal, raw_cols, gfwd_cols, hll_cols)
            phantom = _phantom_staged(normal, sorted(needed), raw_cols, gfwd_cols, hll_cols, skip_base,
                                      executor.device, executor.precision)
            scratch: Dict[Any, Any] = {}
            plan = build_static_plan(request, ctx, phantom, scratch=scratch)
            if not plan.on_device:
                est_bytes = _estimate_scan_bytes(normal, sorted(needed), 1.0)
                for seg in normal:
                    record(seg, "host", "StaticPlan is device-ineligible (group capacity, MV expansion, or "
                                        "pair-overflow guard)")
            else:
                pdigest = plan_digest(plan)
                poison = executor.poisoned_entry((pdigest, phantom.segment_names))
                device_info = {
                    "planDigest": pdigest,
                    "compile": _compile_record(lane, pdigest),
                    "quarantined": poison is not None,
                    "mesh": dict(_ONE_CARD_MESH),
                }
                if poison is not None:
                    # honesty: a quarantined plan serves from the host tier
                    est_bytes = _estimate_scan_bytes(normal, sorted(needed), 1.0)
                    for seg in normal:
                        record(seg, "host", "device plan quarantined (poisoned): "
                               f"{poison['reason']} — serving via host fallback for "
                               f"{poison['ttlRemainingS']}s more")
                else:
                    q_np = build_query_inputs(request, plan, ctx, phantom, scratch=scratch)
                    scanned_rows = executor._block_skip_ids(plan, q_np, normal, phantom)
                    if scanned_rows is not None:
                        frac = min(1.0, scanned_rows / phantom.total_docs) if phantom.total_docs else 1.0
                        est_bytes = _estimate_scan_bytes(normal, sorted(needed), frac)
                        for seg in normal:
                            record(seg, "zonemap", "zone-map block pruning engages: candidate fraction "
                                   f"{frac:.4f} of the table", candidateFraction=round(frac, 4))
                    else:
                        est_bytes = _estimate_scan_bytes(normal, sorted(needed), 1.0)
                        for seg in normal:
                            record(seg, "fullScan", "no selective tier applies: full vmapped device scan")
                    # the lane's micro-batching decision, as the executor
                    # makes it (``_run_kernel`` / ``_batch_spec``): a full
                    # scan within the row budget, at most the largest power
                    # of two of budget / rows members
                    limit = chunk_rows_limit()
                    rows_total = phantom.num_segments * phantom.n_pad
                    cap = 0
                    if lane is not None and lane.batch_max > 1:
                        cap = lane.batch_max
                        if limit:
                            members = 1
                            while members * 2 <= limit // max(rows_total, 1):
                                members *= 2
                            cap = min(cap, members)
                    device_info["batching"] = {
                        "batched": scanned_rows is None and cap > 1 and (not limit or rows_total <= limit),
                        "batchMax": cap,
                        "windowMs": round(lane.batch_window_s * 1000, 3) if lane is not None else 0.0,
                        "cacheHit": False,
                    }

    node: Dict[str, Any] = {
        "server": server_name,
        "table": table,
        "planDigest": plan_shape_digest(request),
        "summary": plan_shape_summary(request),
        "numSegments": len(segments),
        "totalDocs": int(total_docs),
        "tierCounts": tier_counts,
        "segments": records,
        "staged": _staged_snapshot(executor, table, [s.segment_name for s in segments]),
        "estimatedCost": dict({"source": "static", "bytesScanned": int(est_bytes)}, **tier_counts),
        "generatedAtMs": round(time.time() * 1000, 3),
    }
    if device_info is not None:
        node["device"] = device_info
    return _json_safe(node)
