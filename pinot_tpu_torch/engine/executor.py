"""Per-server query executor: segments + BrokerRequest -> IntermediateResult
(lean port of ``pinot_tpu.engine.executor.QueryExecutor``).

prune -> star-tree split -> postings -> bit-sliced -> stage -> plan ->
table kernel -> one packed fetch -> finalize.
All segments run in one table kernel over the stacked segment axis with
the cross-segment merge fused in (``kernel.py``); this class prepares the
inputs and turns the outputs into mergeable partials.

PRUNING (``engine/pruner.py``, the reference's three pruners: empty,
missing column, time range) runs first; a fully pruned query answers
``_empty_result`` with ``segmentsPruned``.  STAR-TREE: of the segments
left, each whose star-tree fits the query (``startree.operator.
is_fit_for_star_tree``) is answered from its pre-aggregated cube in host
numpy (``execute_star_tree``, cost ``segmentsStarTree``); only the rest
reach ``_execute_engine``, so staging, the lane's batching and
coalescing never see a star-fit segment.  Their partials merge.

THE FILTER TIERS, in the reference's order (``_execute_engine``):
postings (``engine/invindex_path.py``: a needle filter's row ids from host
postings, aggregated with numpy, nothing staged or launched; cost
``segmentsPostings``), then the bit-sliced tier (``engine/bitsliced.py``:
a filtered scalar COUNT / SUM / MIN / MAX / AVG as bitwise passes over
bit-planes on the lane; cost ``segmentsBitsliced``), then the zone-map
blocks and the full scan below.  ``postings=False`` / ``bitsliced=False``
turn the first two off (the reference's ``PINOT_TPU_INVINDEX=0`` /
``PINOT_TPU_BITSLICED=0``); an error in the bit-sliced tier counts
``heal.bitslicedFallbacks`` and falls through to the scan.

The host tier (``host_fallback.execute_host``) serves what the reference
sends there, on the same three shape conditions: a plan that
``plan_forced_host`` rules off the device (nothing is staged), a plan
that is not ``on_device``, and a pair overflow after the device run (the
host finishes exactly).  Each result carries ``_served_tier`` ("host" or
"device"), and its cost says which tier served it (``segmentsHost`` /
``segmentsFullScan``).

JOINS (``execute_join``, reached from a server's join phase): the device
hash join (``kernel.run_join_kernel``, the grouped sums through K1) over
the two sides' packed inputs (``join.build_join_plan``), under the same
ladder as a scan; a plan the device does not take, a poisoned join plan
(key ``(join plan digest, "join")``) and a failed-over one run the exact
host join (``join.host_join``).  A join request without a join phase
context goes through ``execute`` as in the reference, which does not
read the join clause: a segment missing a referenced right-side column is
pruned, and the rest are scanned as the left table.

ZONE MAPS (``engine/zonemap.py``): a filtered plan whose candidate zone
blocks are under half the table runs over those blocks only
(``_block_skip_ids``; ``kernel.run_table_kernel`` hands them to K1 and
K2, which read them in place); its ``numEntriesScannedInFilter`` counts
the candidate rows and its cost ``segmentsZonemap``.  ``zone_maps=False``
turns this off (the reference's ``PINOT_TPU_ZONEMAP=0``).

THE ROW BUDGET (``config.CHUNK_ROWS``): a table of more rows than the
budget runs a chunkable plan as segment-axis chunks
(``kernel.make_chunked_table_kernel``), and takes no block path (the block
table has no chunked form).

BATCHING (the lane's micro-batching tier, ``engine/dispatch.py``): a
full-scan dispatch on a lane, neither on the block path nor chunked,
carries a ``BatchSpec`` (``_batch_spec``): same-plan queries queued
together launch as one batched kernel, their inputs going up in one
stacked upload.  Such a dispatch uploads its own inputs inside its launch,
on the lane's stream, so a member that rides a batch never uploads twice.
A query that rode a batch counts ``batchHits`` in its cost.

RESIDENCY (``engine/residency.py``): the staging cache is bounded by the
executor's ``ResidencyManager`` (hot byte and entry caps: the coldest
unpinned tables are demoted to host snapshots, spilled to disk past the
host cap, and promoted back with a new token).  A query pins its staged
table for its whole device section.  ``staged_bytes()`` is the ledger's
count of the live staged tensors.

SELF-HEALING (the reference's ladder, around the whole device section:
staging, planning, the launch, the fetch and finalize): a device fault
(``dispatch.is_device_fault``: a typed ``DeviceExecutionError`` from the
lane's watchdog or the fault injector, a CUDA allocation failure, a
sticky CUDA fault) is classified; a transient gets one more device
attempt, a poison quarantines the (plan digest, segment set) and fails
over to the host tier (``heal.hostFailovers``), a stall goes straight to
the host, and a sticky fault takes the device off for good.  An
allocation failure gets up to two more attempts, each after
``ResidencyManager.demote_for_pressure`` frees the coldest unpinned
tables (``heal.resourceExhausted``, tagged with the freed bytes), and
never poisons the plan.  Everything else propagates: a failed kernel
build, a wrapper's own launch error, or an error in planning or finalize
is the program's fault, never answered by the host tier.  On a CUDA
device the constructor builds and loads both kernels, so a failed build
raises there, not in a query.

THE AUDIT PLANE (``utils/audit.py``): every exit of ``_execute_engine``
goes through ``_finish_tier``, which stamps ``_served_tier`` and consults
an armed wrong-answer injection of the lane's fault injector (tests and
``chip_smoke.py`` only).  ``execute_host_oracle`` re-runs a request on
the host tier over the segments' host arrays, for the shadow auditor; a
divergence quarantines the (plan digest, tier) through the poison map
(``audit_quarantine``), and ``_execute_engine`` then skips that tier for
that shape: a quarantined device tier fails over to the host until the
TTL re-admits it.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from pinot_tpu_torch.common.faults import apply_result_corruption
from pinot_tpu_torch.common.request import BrokerRequest, FilterOperator, group_sort_ascending
from pinot_tpu_torch.common.schema import DataType
from pinot_tpu_torch.common.values import render_value
from pinot_tpu_torch.engine import config
from pinot_tpu_torch.engine.config import Precision
from pinot_tpu_torch.engine.context import TableContext, get_table_context
from pinot_tpu_torch.engine.device import (
    StagedTable,
    StagingLedger,
    TransferStats,
    get_staged,
    segment_arrays,
    to_device_inputs,
    tree_leaves,
)
from pinot_tpu_torch.engine.dispatch import (
    BatchSpec,
    DeviceExecutionError,
    LaneClosedError,
    classify_device_error,
    is_device_fault,
    plan_digest,
    ready_event,
    stream_handoff,
)
from pinot_tpu_torch.engine import hll as hll_mod
from pinot_tpu_torch.engine import kernels, zonemap
from pinot_tpu_torch.engine.kernels import fused_groupby
from pinot_tpu_torch.engine.bitsliced import try_bitsliced_path
from pinot_tpu_torch.engine.host_fallback import execute_host
from pinot_tpu_torch.engine.invindex_path import try_index_path
from pinot_tpu_torch.engine import join as join_mod
from pinot_tpu_torch.engine.kernel import (
    chunk_rows_limit,
    make_chunked_table_kernel,
    run_batched_table_kernel,
    run_join_kernel,
    run_table_kernel,
)
from pinot_tpu_torch.engine.packing import (
    batch_input_signature,
    dispatch_packed,
    fetch_handle,
    kernel_cost_analysis,
    make_packed_kernel,
    output_bytes,
    stack_query_inputs,
)
from pinot_tpu_torch.engine.plan import (
    StaticPlan,
    _agg_kind,
    build_query_inputs,
    build_static_plan,
    hll_lowers_to_presence,
    plan_forced_host,
)
from pinot_tpu_torch.engine.plandigest import plan_shape_digest
from pinot_tpu_torch.engine.pruner import prune_segments
from pinot_tpu_torch.engine.residency import ResidencyManager
from pinot_tpu_torch.engine.results import (
    AggPartial,
    AvgPartial,
    CountPartial,
    DistinctPartial,
    HistogramPartial,
    HllPartial,
    IntermediateResult,
    MaxPartial,
    MinMaxRangePartial,
    MinPartial,
    SumPartial,
    make_partial,
    percentile_of,
    trim_group_candidates,
)
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.server.scheduler import QueryAbandonedError
from pinot_tpu_torch.startree.operator import execute_star_tree, is_fit_for_star_tree
from pinot_tpu_torch.utils.metrics import ServerMetrics
from pinot_tpu_torch.utils.npgroup import scatter_max_2d
from pinot_tpu_torch.utils.trace import current_trace


def _regs_from_value_gids(
    ctx, column: str, gids: np.ndarray, rows: Optional[np.ndarray] = None, n_rows: int = 0
) -> np.ndarray:
    """HLL registers from GLOBAL dictionary value ids (the
    hll_from_presence finalize: registers depend only on the distinct
    value set).  Without ``rows``: one uint8[HLL_M] register array; with
    ``rows`` (same shape as ``gids``) and ``n_rows``: uint8[n_rows, HLL_M],
    one register array per row."""
    bt, rt = hll_mod.dictionary_tables(ctx.column(column).global_dict)
    g = np.asarray(gids, dtype=np.int64)
    ok = g < bt.size  # padded slots carry no value
    g = g[ok]
    if rows is None:
        return scatter_max_2d(np.zeros(g.size, np.int64), 1, bt[g], rt[g], config.HLL_M)[0]
    return scatter_max_2d(np.asarray(rows)[ok], n_rows, bt[g], rt[g], config.HLL_M)


class _PairsState:
    """Host-side index over a compacted (group slot, valueId) pair buffer
    from the sort reduce (``kernel._reduce_distinct_pairs``): per-slot
    distinct counts for trim ordering, per-slot gid slices for the
    partials, and per-pair occurrence counts (run lengths off the carried
    start positions) for exact percentile histograms."""

    def __init__(self, state, capacity: int) -> None:
        slots, gids, starts, n, total_valid = state
        n = int(n)
        # the reduce leaves the first n entries sorted by (slot, gid)
        self._slots_sorted = np.asarray(slots)[:n].astype(np.int64)
        self._gids_sorted = np.asarray(gids)[:n]
        self._pair_counts = np.diff(
            np.append(np.asarray(starts)[:n].astype(np.int64), int(total_valid))
        )
        self._bounds = np.searchsorted(self._slots_sorted, np.arange(capacity + 1, dtype=np.int64))
        self.counts = np.diff(self._bounds).astype(np.float64)

    def gids_for(self, key: int) -> np.ndarray:
        a, b = self._bounds[key], self._bounds[key + 1]
        return self._gids_sorted[a:b]

    def gid_counts_for(self, key: int):
        """(gids ascending, occurrence counts) for one group slot."""
        a, b = self._bounds[key], self._bounds[key + 1]
        return self._gids_sorted[a:b], self._pair_counts[a:b]

    def gids_rows_for(self, keys: np.ndarray):
        """Batched slice gather: (gids, rows) where ``rows[i]`` is the
        position in ``keys`` whose slot owns ``gids[i]``, the input shape
        ``_regs_from_gids`` batch-decodes."""
        if not keys.size:
            empty = np.zeros(0, dtype=np.int64)
            return empty, empty
        lo, hi = self._bounds[keys], self._bounds[keys + 1]
        counts = hi - lo
        offs = np.concatenate(([0], np.cumsum(counts)[:-1])).astype(np.int64)
        take = np.arange(int(counts.sum())) - np.repeat(offs, counts) + np.repeat(lo, counts)
        return self._gids_sorted[take], np.repeat(np.arange(keys.size), counts)

    def percentiles_for(self, keys: np.ndarray, p: int, vals: np.ndarray) -> np.ndarray:
        """Exact percentile per requested group slot from the sparse
        (gid, count) runs, the dense-histogram math vectorized."""
        csum = np.concatenate([[0], np.cumsum(self._pair_counts)])
        lo, hi = self._bounds[keys], self._bounds[keys + 1]
        n = csum[hi] - csum[lo]
        idx = np.minimum((n * p / 100.0).astype(np.int64), np.maximum(n - 1, 0))
        # global cumulative position of each group's idx-th element
        pos = np.searchsorted(csum[1:], csum[lo] + idx, side="right")
        pos = np.minimum(pos, self._gids_sorted.size - 1) if self._gids_sorted.size else pos
        gid = self._gids_sorted[pos] if self._gids_sorted.size else np.zeros_like(pos)
        return np.where(n > 0, vals[np.minimum(gid, vals.size - 1)], -np.inf)


def _regs_from_gids(
    gids: np.ndarray, rows: Optional[np.ndarray] = None, n_rows: int = 0
) -> np.ndarray:
    """Decode packed (bucket * 64 + rho) pair gids into HLL registers (max
    rho per bucket).  Without ``rows``: one uint8[HLL_M] register array;
    with ``rows`` (same shape as ``gids``) and ``n_rows``: uint8[n_rows,
    HLL_M], one register array per row."""
    g = np.asarray(gids, dtype=np.int64)
    rho = (g & 63).astype(np.uint8)
    if rows is None:
        return scatter_max_2d(np.zeros(g.size, np.int64), 1, g >> 6, rho, config.HLL_M)[0]
    return scatter_max_2d(rows, n_rows, g >> 6, rho, config.HLL_M)


def _hist_partial(gdict, gids, cnts, p: int) -> HistogramPartial:
    counts = {
        float(gdict.get(int(g))): int(c)
        for g, c in zip(gids, cnts)
        if g < gdict.cardinality
    }
    return HistogramPartial(counts, percentile=p)


# how long a quarantined (plan digest, segment set) stays off the device: a
# plan poisoned by a transient burst is re-admitted after it
POISON_TTL_S = 300.0


def _span_start(device: torch.device):
    """A timing CUDA event recorded on the current stream (the start of an
    inline launch's device span), None on the CPU."""
    if device.type != "cuda":
        return None
    start = torch.cuda.Event(enable_timing=True)
    start.record(torch.cuda.current_stream(device))
    return start


def _device_ms(start, value, t0: float) -> float:
    """The cost vector's ``deviceMs`` of a fetched launch: on the card its
    device span, from the timing event recorded on the stream just before
    the launch's work is enqueued to the packed copy's event (the kernels,
    the torch ops around them, the packing and the device-to-host copy,
    with any gap the host's enqueue leaves between them; not the lane's
    queue), however much of it ran before the launch call returned.  On
    the CPU, or without the events, the host wall since ``t0``."""
    handle = value[1] if isinstance(value, tuple) else value
    end = getattr(handle, "event", None)
    if start is not None and end is not None:
        return start.elapsed_time(end)
    return (time.perf_counter() - t0) * 1000


def _inputs_digest(inputs: Any) -> str:
    """Content digest of the numpy query-inputs tree: the lane's coalesce
    key.  Each leaf is length-prefixed so adjacent contributions cannot
    re-split into the same byte stream."""
    h = hashlib.blake2b(digest_size=16)
    for leaf in tree_leaves(inputs):
        if isinstance(leaf, np.ndarray):
            part = str((leaf.shape, str(leaf.dtype))).encode() + leaf.tobytes()
        else:
            part = repr(leaf).encode()
        h.update(len(part).to_bytes(8, "little"))
        h.update(part)
    return h.hexdigest()


class QueryExecutor:
    """Executes aggregation, group-by and selection queries over a set of
    immutable segments on one device.

    ``device``: where the segments are staged and the kernel runs; None
    means the current CUDA device, and raises when there is none.
    ``precision``: "x64" or "x32" (``engine/config.py``).
    ``metrics``: the registry for the phase timers and the ``heal.*``
    counters (a private one when None).
    ``lane`` / ``lanes``: the server's device lane (or its one-lane
    ``LaneGroup``); None runs launch and fetch inline.
    ``zone_maps``: False always scans every row (no block skipping).
    ``postings``: False never answers from host postings (the reference's
    ``PINOT_TPU_INVINDEX=0``).
    ``bitsliced``: False never takes the bit-sliced tier, "force" takes it
    wherever it is eligible, skipping the cost model (the reference's
    ``PINOT_TPU_BITSLICED`` "0" / "force").
    ``hbm_cap_bytes`` / ``host_cap_bytes`` / ``stage_cache_entries`` /
    ``residency_dir``: the residency manager's caps and cold spool (the
    reference's ``PINOT_TPU_HBM_CAP_BYTES``, ``PINOT_TPU_HOST_CAP_BYTES``,
    ``PINOT_TPU_STAGE_CACHE_ENTRIES``, ``PINOT_TPU_RESIDENCY_DIR``)."""

    _HEAL_COUNTERS = (
        "deviceFailures",
        "deviceRetries",
        "hostFailovers",
        "poisonSkips",
        "resourceExhausted",
        "stickyFaults",
    )

    def __init__(
        self,
        device: Optional[Union[str, torch.device]] = None,
        precision: Union[str, Precision] = "x64",
        metrics=None,
        lane=None,
        lanes=None,
        zone_maps: bool = True,
        postings: bool = True,
        bitsliced: Union[bool, str] = True,
        hbm_cap_bytes: int = config.HBM_CAP_BYTES,
        host_cap_bytes: int = config.HOST_CAP_BYTES,
        stage_cache_entries: int = config.STAGE_CACHE_ENTRIES,
        residency_dir: Optional[str] = None,
    ) -> None:
        self.device = config.resolve_device(device)
        self.zone_maps = zone_maps
        self.postings = postings
        if bitsliced not in (True, False, "force"):
            raise ValueError(f"bitsliced must be True, False or 'force', got {bitsliced!r}")
        self.bitsliced = bitsliced
        if self.device.type == "cuda":
            kernels.load_all()
        self.precision = config.as_precision(precision)
        self.lanes = lanes
        if lanes is not None and lane is None:
            lane = lanes.primary
        self.lane = lane
        self.metrics = metrics if metrics is not None else ServerMetrics("executor")
        for name in self._HEAL_COUNTERS:
            self.metrics.meter(f"heal.{name}")
        self._staged: Dict[Tuple, StagedTable] = {}
        self._contexts: Dict[Tuple, TableContext] = {}
        # staging and the table contexts are shared by the scheduler's
        # workers: one lock, so a table is staged once; re-entrant, as the
        # residency manager takes it again to demote under a staging
        self._stage_lock = threading.RLock()
        self.ledger = StagingLedger()
        self.transfers = TransferStats()
        self.residency = ResidencyManager(
            self._staged, self.ledger, self.transfers, self._stage_lock, self.device, self.precision,
            hbm_cap_bytes=hbm_cap_bytes, host_cap_bytes=host_cap_bytes,
            stage_cache_entries=stage_cache_entries, spool_dir=residency_dir,
        )
        # consuming-segment name -> the (crc, staging token) of its newest
        # snapshot seen by a query (``_retire_superseded``)
        self._snapshots: Dict[str, Tuple[int, int]] = {}
        self._kernel = make_packed_kernel(run_table_kernel)
        self._join_kernel = make_packed_kernel(run_join_kernel)
        self._heal_lock = threading.Lock()
        # poison key -> (reason, expiry monotonic seconds)
        self._poisoned: Dict[Any, Tuple[str, float]] = {}
        # the sticky CUDA fault that took the device off, if any
        self._sticky: Optional[DeviceExecutionError] = None
        # True once an audit quarantine exists: the serving path derives a
        # plan digest for the quarantine check only then
        self._has_audit_poison = False

    def staged_bytes(self) -> int:
        """Bytes of the staged tables on the device (the ledger's count of
        their live tensors)."""
        return self.ledger.total_bytes()

    def staged_tables(self) -> int:
        """Segment sets the staging cache holds on the device."""
        return self.ledger.table_count()

    def free_staging(self) -> None:
        """Drop every staged table from every tier (the caller frees the
        cached memory)."""
        with self._stage_lock:
            self.residency.reset()
            self._contexts.clear()
            self._snapshots.clear()

    def _drop_entries(self, stale) -> None:
        """Drop, from every residency tier, the staged tables whose segment
        set (``((name, crc, token), ...)``) ``stale`` accepts, and the
        contexts of such sets; the caller holds ``_stage_lock``.  A query
        running over a dropped table keeps its own reference to the
        tensors: they are freed when it lets go, never under it."""
        self.residency.drop_where(stale)
        for key in [k for k in self._contexts if stale(k)]:
            del self._contexts[key]

    def _retire_superseded(self, segments: Sequence[ImmutableSegment]) -> None:
        """A consuming segment's snapshot (``metadata.custom["realtime"]``)
        is a new segment at every watermark: the tables staged for its
        older snapshots would stay on the card until it ran out of memory.
        When a query brings a newer snapshot of a name, the sets that hold
        another snapshot of that name leave every residency tier, and so
        do the sets of fewer segments that hold a snapshot (a consuming
        segment was empty and pruned then, or not yet created).  The
        caller holds ``_stage_lock``.  (The reference demotes such a set to
        the warm tier, where it stays until its segment is dropped though
        its token can never be staged again; the port drops it.)"""
        newer = {}
        for s in segments:
            if s.metadata.custom.get("realtime"):
                ident = (s.metadata.crc, s.staging_token)
                if self._snapshots.get(s.segment_name) != ident:
                    self._snapshots[s.segment_name] = ident
                    newer[s.segment_name] = ident
        if not newer:
            return
        names = {s.segment_name for s in segments}

        def stale(idents) -> bool:
            held = {i[0] for i in idents}
            if any(i[0] in newer and (i[1], i[2]) != newer[i[0]] for i in idents):
                return True
            return held < names and any(n in self._snapshots for n in held)

        self._drop_entries(stale)

    def evict_segment(self, name: str) -> None:
        """Drop every staged table (from every residency tier) and context
        that holds segment ``name`` (it was replaced, committed or dropped
        on the server)."""
        with self._stage_lock:
            self._snapshots.pop(name, None)
            self.residency.drop_segment(name)
            for key in [k for k in self._contexts if any(i[0] == name for i in k)]:
                del self._contexts[key]

    # -- self-healing bookkeeping --------------------------------------
    def _heal_mark(self, name: str, **tags) -> None:
        self.metrics.meter(f"heal.{name}").mark()
        tr = current_trace()
        if tr is not None and tr.enabled:
            tr.event(name, **tags)

    def healing_stats(self) -> Dict[str, int]:
        now = time.monotonic()
        stats = {name: self.metrics.meter(f"heal.{name}").count for name in self._HEAL_COUNTERS}
        with self._heal_lock:
            stats["poisonedPlans"] = sum(1 for _, exp in self._poisoned.values() if now < exp)
        stats["deviceOff"] = self._sticky is not None
        return stats

    def poisoned_entry(self, key: Any) -> Optional[Dict[str, Any]]:
        """The live quarantine record of a (plan digest, segment set) key,
        or None: EXPLAIN reports the host tier a poisoned plan will
        actually serve from."""
        now = time.monotonic()
        with self._heal_lock:
            entry = self._poisoned.get(key)
            if entry is None or now >= entry[1]:
                return None
            return {"reason": entry[0], "ttlRemainingS": round(entry[1] - now, 3)}

    def lane_selection(self, request: BrokerRequest):
        """The lane this query's shape executes on (``LaneGroup.select``),
        or None without a lane group."""
        return self.lanes.select(request) if self.lanes is not None else None

    def _is_poisoned(self, key: Any) -> bool:
        with self._heal_lock:
            entry = self._poisoned.get(key)
            if entry is None:
                return False
            if time.monotonic() >= entry[1]:
                self._poisoned.pop(key, None)  # TTL expired: re-admit
                return False
            return True

    def _poison(self, key: Any, reason: str) -> None:
        expiry = time.monotonic() + POISON_TTL_S
        with self._heal_lock:
            self._poisoned[key] = (reason, expiry)
            if len(self._poisoned) > 1024:  # runaway-workload backstop
                self._poisoned.clear()
                self._poisoned[key] = (reason, expiry)

    def clear_poisoned(self) -> None:
        """Re-admit quarantined plans to the device."""
        with self._heal_lock:
            self._poisoned.clear()
        self._has_audit_poison = False

    # -- the audit plane (utils/audit.py) ------------------------------
    def audit_quarantine(self, digest: str, tier: str, reason: str) -> None:
        """The shadow auditor caught ``tier`` serving a wrong answer for
        plan shape ``digest``: the serving path skips that tier for that
        shape (a quarantined device fails over to the host) until the TTL
        re-admits it."""
        self._poison(("audit", str(digest), str(tier)), f"audit: {reason}")
        self._has_audit_poison = True
        self._heal_mark("auditQuarantines", tier=tier)

    def audit_quarantined_snapshot(self) -> List[Dict[str, Any]]:
        """The live audit-quarantine entries (``/debug/audit``)."""
        now = time.monotonic()
        out: List[Dict[str, Any]] = []
        with self._heal_lock:
            for key, (reason, exp) in self._poisoned.items():
                if isinstance(key, tuple) and len(key) == 3 and key[0] == "audit" and now < exp:
                    out.append({"planDigest": key[1], "tier": key[2], "reason": reason,
                                "ttlRemainingS": round(exp - now, 3)})
        return out

    def _audit_digest(self, request: BrokerRequest) -> Optional[str]:
        """The shape digest for the quarantine checks, derived only while
        some audit quarantine exists."""
        return plan_shape_digest(request) if self._has_audit_poison else None

    def _audit_blocked(self, digest: Optional[str], tier: str) -> bool:
        if digest is None:
            return False
        if self._is_poisoned(("audit", digest, tier)):
            self._heal_mark("auditTierSkips", tier=tier)
            return True
        return False

    def _fault_injector(self):
        lanes = self.lanes.lanes if self.lanes is not None else [self.lane]
        for lane in lanes:
            inj = getattr(lane, "fault_injector", None)
            if inj is not None:
                return inj
        return None

    def _finish_tier(self, result: IntermediateResult, request: BrokerRequest, tier: str) -> IntermediateResult:
        """Every exit of ``_execute_engine``: stamp the serving tier that
        produced the answer (the audit plane's quarantine key) and consult
        the lane's armed wrong-answer injection, if any."""
        result._served_tier = tier
        inj = self._fault_injector()
        if inj is not None and inj.corruption_armed:
            delta = inj.check_corrupt(plan_shape_digest(request), tier)
            if delta is not None:
                apply_result_corruption(result, delta)
        return result

    def execute_host_oracle(self, segments: Sequence[ImmutableSegment], request: BrokerRequest) -> IntermediateResult:
        """The shadow audit's oracle: ``request`` over the exact views a
        reply served, on the host tier (numpy over the segments' own host
        arrays, never a copy back from the card): no lane, no result
        cache, no tier ladder.  Pruning keeps answers, so the payload
        (accounting aside) must equal whatever tier served the reply."""
        segments = list(segments)
        total_docs = sum(s.num_docs for s in segments)
        live = prune_segments(segments, request)
        if not live:
            res = self._empty_result(request, total_docs)
        else:
            sel_columns = self._resolve_selection_columns(request, live[0]) if request.is_selection else None
            res = execute_host(live, get_table_context(live, {}), request, total_docs, sel_columns)
        res._served_tier = "host"
        return res

    def _phase(self, name: str, t0: float, **tags) -> float:
        """Record a phase timer and, when the request is traced, a span;
        returns a fresh t0."""
        now = time.perf_counter()
        ms = (now - t0) * 1000
        self.metrics.timer(f"phase.{name}").update(ms)
        tr = current_trace()
        if tr is not None and tr.enabled:
            tr.add(name, ms, **tags)
        return now

    def execute(
        self,
        segments: Sequence[ImmutableSegment],
        request: BrokerRequest,
        deadline: Optional[float] = None,
    ) -> IntermediateResult:
        """``deadline`` (monotonic seconds) is the broker-propagated
        budget: the lane sheds a query whose budget drained while queued
        there, and the fetch never waits past it."""
        total_docs = sum(s.num_docs for s in segments)
        live = prune_segments(segments, request)
        pruned = len(segments) - len(live)
        if not live:
            res = self._empty_result(request, total_docs)
            res.add_cost(segmentsPruned=pruned)
            return res

        # star-tree routing: a fit segment answers from its pre-aggregated
        # cube on the host (startree/operator.py), the rest take the
        # engine; the partials merge below
        star = [s for s in live if is_fit_for_star_tree(request, s)]
        if star:
            normal = [s for s in live if s not in star]
            parts = [execute_star_tree(s, request) for s in star]
            if normal:
                parts.append(self._execute_engine(normal, request, deadline))
            merged = parts[0]
            for p in parts[1:]:
                merged.merge(p)
            merged.total_docs = total_docs
            merged.add_cost(segmentsPruned=pruned)
            merged._served_tier = (
                "starTree" if not normal else getattr(parts[-1], "_served_tier", "starTree")
            )
            return merged

        result = self._execute_engine(live, request, deadline)
        result.total_docs = total_docs
        result.add_cost(segmentsPruned=pruned)
        return result

    def _host(self, live, ctx, request, total_docs, sel_columns, phase: str) -> IntermediateResult:
        t0 = time.perf_counter()
        res = execute_host(live, ctx, request, total_docs, sel_columns)
        self._phase(phase, t0)
        res._served_tier = "host"
        return res

    def _execute_engine(
        self,
        live: List[ImmutableSegment],
        request: BrokerRequest,
        deadline: Optional[float] = None,
    ) -> IntermediateResult:
        t0 = time.perf_counter()
        total_docs = sum(s.num_docs for s in live)
        needed = set(request.referenced_columns())
        sel_columns: Optional[List[str]] = None
        if request.is_selection:
            sel_columns = self._resolve_selection_columns(request, live[0])
            needed.update(sel_columns)
        # columns used only by doc-range predicates on sorted columns never
        # reach the device (the kernel compares row ids with doc bounds)
        needed -= self._docrange_only_columns(request, live, sel_columns)
        with self._stage_lock:
            self._retire_superseded(live)
            ctx = get_table_context(live, self._contexts)
        # a tier the shadow audit caught lying for this shape is skipped
        audit_digest = self._audit_digest(request)
        # selective predicates answer from host postings in O(matches)
        # (engine/invindex_path.py); unselective ones fall through
        t_tier = time.perf_counter()
        res = None
        if not self._audit_blocked(audit_digest, "postings"):
            res = try_index_path(request, live, ctx, total_docs, sel_columns, self.postings)
        if res is not None:
            self._phase("indexPath", t0)
            return self._finish_tier(res, request, "postings")
        if self._sticky is None and not self._audit_blocked(audit_digest, "bitsliced"):
            # mid-selectivity scalar aggregations that postings declined
            # run as bitwise passes over bit-planes (engine/bitsliced.py)
            res = self._try_bitsliced(request, live, ctx, total_docs, deadline)
            if res is not None:
                self._phase("bitslicedPath", t0)
                return self._finish_tier(res, request, "bitsliced")
        # both tiers declined: their decisions are a phase of their own, and
        # staging goes on timing the context and the upload only
        t0 += self._phase("tierDecision", t_tier) - t_tier
        if plan_forced_host(request, ctx, self.precision):
            # a plan only the host can run never pays device staging
            return self._finish_tier(self._host(live, ctx, request, total_docs, sel_columns, "hostPath"),
                                     request, "host")
        if self._sticky is not None:
            # a sticky CUDA fault corrupted the context: the device is
            # not tried again
            self._heal_mark("hostFailovers", reason="deviceOff")
            return self._finish_tier(self._host(live, ctx, request, total_docs, sel_columns, "hostFailover"),
                                     request, "host")
        if self._audit_blocked(audit_digest, "device"):
            # a tier caught lying gets no device attempt inside the TTL
            self._heal_mark("hostFailovers", reason="auditQuarantine")
            return self._finish_tier(self._host(live, ctx, request, total_docs, sel_columns, "hostFailover"),
                                     request, "host")

        ref: Dict[str, Any] = {}
        result = self._run_healing(
            lambda: self._device_section(live, request, deadline, ctx, needed, sel_columns, total_docs, t0, ref),
            ref,
        )
        if result is None:
            result = self._host(live, ctx, request, total_docs, sel_columns, "hostFailover")
        # the device section's own host exits (a plan off the device, a
        # poisoned plan, a pair overflow) are stamped "host" there
        return self._finish_tier(result, request, result._served_tier)

    def _device_section(
        self,
        live: List[ImmutableSegment],
        request: BrokerRequest,
        deadline: Optional[float],
        ctx: TableContext,
        needed: set,
        sel_columns: Optional[List[str]],
        total_docs: int,
        t0: float,
        ref: Dict[str, Any],
    ) -> IntermediateResult:
        """Staging (pinned for the section), then ``_device_section_staged``:
        one attempt of the healing ladder.  ``ref`` tells the ladder the
        staged token (the OOM heal's demotion spares it), the poison key,
        and ``host`` once the section has left the device path."""
        raw_cols, gfwd_cols, hll_cols = self._role_columns(request, live, ctx)
        skip_base = self._skip_base_columns(request, live, raw_cols, gfwd_cols, hll_cols)
        with self._stage_lock:
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
                hll_columns=hll_cols,
                residency=self.residency,
                pin=True,
            )
        ref["token"] = staged.token
        try:
            return self._device_section_staged(live, request, deadline, ctx, needed, sel_columns, total_docs,
                                               t0, ref, staged)
        finally:
            self.residency.unpin(staged.token)

    def _device_section_staged(
        self,
        live: List[ImmutableSegment],
        request: BrokerRequest,
        deadline: Optional[float],
        ctx: TableContext,
        needed: set,
        sel_columns: Optional[List[str]],
        total_docs: int,
        t0: float,
        ref: Dict[str, Any],
        staged: StagedTable,
    ) -> IntermediateResult:
        t0 = self._phase("staging", t0)
        scratch: Dict[Any, Any] = {}
        plan = build_static_plan(request, ctx, staged, scratch=scratch)
        if not plan.on_device:
            ref["host"] = True  # the host path from here: not a device fault
            return self._host(live, ctx, request, total_docs, sel_columns, "hostPath")
        pdigest = plan_digest(plan)
        ref["key"] = (pdigest, staged.segment_names)
        if self._is_poisoned(ref["key"]):
            self._heal_mark("poisonSkips")
            ref["host"] = True
            return self._host(live, ctx, request, total_docs, sel_columns, "hostFailover")
        q_np = build_query_inputs(request, plan, ctx, staged, scratch=scratch)
        seg = segment_arrays(staged, needed)
        scanned_rows = self._block_skip_ids(plan, q_np, live, staged)
        t0 = self._phase("planBuild", t0)
        cost: Dict[str, float] = {}
        info: Dict[str, Any] = {}
        outs = self._run_kernel(plan, staged, seg, q_np, deadline, pdigest, cost, info)
        t0 = time.perf_counter()
        for i, agg in enumerate(plan.aggs):
            if agg.sort_pairs:
                state = outs[f"gb_{i}" if plan.group_by is not None else f"agg_{i}"]
                if int(state[3]) > config.DISTINCT_PAIR_CAP:
                    # more unique pairs than the device buffer returns: the
                    # host finishes exactly
                    ref["host"] = True
                    return self._host(live, ctx, request, total_docs, sel_columns, "hostPath")
        result = self._finalize(request, plan, ctx, staged, live, outs, total_docs, sel_columns)
        dev_bytes = sum(t.numel() * t.element_size() for t in seg.values())
        if scanned_rows is None:
            result.add_cost(segmentsFullScan=len(live))
        else:
            # the block path scans the candidate rows only: each row
            # stream ([S, n_pad, ...]) over the rows of the candidate
            # blocks, every other array (dictionaries, tables) whole
            result.num_entries_scanned_in_filter = len(plan.leaves) * scanned_rows
            rows = zonemap.block_rows_read(q_np["block_ids"], staged.num_docs, zonemap.zone_block_rows())
            dev_bytes = 0
            for t in seg.values():
                nbytes = t.numel() * t.element_size()
                if t.dim() >= 2 and tuple(t.shape[:2]) == (staged.num_segments, staged.n_pad):
                    nbytes = nbytes // (staged.num_segments * staged.n_pad) * rows
                dev_bytes += nbytes
            result.add_cost(segmentsZonemap=len(live))
        result.add_cost(bytesScanned=dev_bytes, deviceBytes=dev_bytes, **cost)
        # how many same-shape queries this member's launch carried
        # (EXPLAIN ANALYZE's batching actual)
        result._batch_size = int(info.get("batchSize", 1) or 1)
        self._phase("finalize", t0)
        result._served_tier = "device"
        # the device-plan digest and the lane that ran it: the server's plan
        # statistics join the lane's compile timeline (its static cost) on it
        result._device_digest = pdigest
        result._lane_index = 0
        return result

    def _try_bitsliced(self, request, live, ctx, total_docs: int, deadline) -> Optional[IntermediateResult]:
        """The bit-sliced tier (``bitsliced.try_bitsliced_path``), or None.
        As in the reference, an optimization tier never fails the query:
        deadline, lane-closed and abandon errors propagate, and any other
        error counts ``heal.bitslicedFallbacks`` and falls through to the
        scan section."""
        try:
            return try_bitsliced_path(self, request, live, ctx, total_docs, deadline)
        except (QueryAbandonedError, LaneClosedError, TimeoutError):
            raise
        except Exception as e:
            self._heal_mark("bitslicedFallbacks", error=str(e)[:200])
            return None

    def _run_healing(self, run, ref: Dict[str, Any]) -> Any:
        """``run()`` (a device section: ``_device_section`` of a scan,
        ``_join_device_section`` of a join) under the self-healing ladder:
        its value, or None when the query must fail over to the host tier.
        ``ref`` carries what the section learned: ``key`` (the poison key),
        ``token`` (its staged table: an OOM's demotion spares it) and
        ``host`` (it had left the device path, so its error is not a
        device fault).  Only device faults are caught; every other error
        propagates.  Three attempts: a transient gets one retry, an
        allocation failure two, each after demoting the coldest unpinned
        tables (the reference's ladder, ``pinot_tpu/engine/executor.py``
        ``_execute_engine``)."""
        last: Optional[DeviceExecutionError] = None
        for attempt in (0, 1, 2):
            if attempt:
                if last is None or not last.retryable:
                    break  # poison / stall / sticky: a device retry would
                    # fail (or wedge the fresh lane) identically
                if last.resource_exhausted:
                    exclude = tuple(t for t in (ref.get("token"),) if t is not None)
                    freed = self.residency.demote_for_pressure(exclude_tokens=exclude)
                    self._heal_mark("resourceExhausted", freedBytes=freed)
                elif attempt > 1:
                    break  # a plain transient gets exactly one retry
                self._heal_mark("deviceRetries")
            try:
                return run()
            except (QueryAbandonedError, LaneClosedError, TimeoutError):
                raise
            except Exception as e:
                if ref.pop("host", False) or not is_device_fault(e):
                    raise
                last = classify_device_error(e)
                # the failed attempt's frames (a half-restored table, say)
                # must not stay alive through the traceback while it retries
                e.__traceback__ = None
                self._heal_mark("deviceFailures", retryable=last.retryable, error=str(last)[:200])
                if last.sticky:
                    self._sticky = last
                    self._heal_mark("stickyFaults")
                    if self.lane is not None:
                        self.lane.mark_dead(last)
        # device exhausted: quarantine the plan (an OOM never: the plan is
        # healthy, the card was full) and fail over to the host tier
        if ref.get("key") is not None and not last.resource_exhausted:
            self._poison(ref["key"], str(last))
        self._heal_mark("hostFailovers", reason=str(last)[:200])
        return None

    def _run_kernel(
        self,
        plan: StaticPlan,
        staged: StagedTable,
        seg: Dict[str, torch.Tensor],
        q_np: Any,
        deadline: Optional[float],
        pdigest: str,
        cost: Dict[str, float],
        info: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        """The table kernel's DISPATCH + the packed fetch (``_dispatch``);
        a batch-eligible dispatch (a full scan, not chunked) carries its
        ``BatchSpec``."""
        block = zonemap.zone_block_rows() if "block_ids" in q_np else 0
        kernel = self._table_kernel(plan, staged)
        spec = None
        lane = self.lane
        if lane is not None and not block and kernel is self._kernel and lane.batch_max > 1:
            spec = self._batch_spec(plan, staged, seg, q_np)
        tensors = list(seg.values())
        rows = staged.num_segments * staged.n_pad
        ops = len(plan.leaves) + len(plan.aggs)

        def cost_provider(value):
            # the static roofline numerator, once per digest, off the lane
            return kernel_cost_analysis((tensors, q_np), output_bytes(value), rows, ops)

        return self._dispatch(
            (plan, staged.token),
            lambda q: kernel.dispatch(plan, staged, seg, q, block),
            kernel.fetch, tensors, q_np, deadline, pdigest, cost, spec, info, cost_provider,
        )

    def _dispatch(
        self,
        program_key: Tuple,
        dispatch,
        fetch,
        tensors: List[torch.Tensor],
        q_np: Any,
        deadline: Optional[float],
        pdigest: str,
        cost: Dict[str, float],
        spec: Optional[BatchSpec] = None,
        info: Optional[Dict[str, Any]] = None,
        cost_provider=None,
    ) -> Dict[str, Any]:
        """DISPATCH + the packed fetch of one device program:
        ``dispatch(q)`` launches it over the device query inputs ``q`` and
        returns its packed handle, ``fetch(handle, deadline)`` reads it
        back.  Direct (no lane): launch and fetch inline.  With a lane:
        the query inputs upload on this worker's stream (a dispatch with a
        ``BatchSpec`` uploads inside its launch, on the lane's), the
        launch runs on the lane's stream (coalesced with an identical
        in-flight dispatch, or batched with same-key peers), and this
        worker waits on the dispatch's event.  ``program_key`` is (the
        program's identity, the staged table's token): with the inputs'
        digest it is the coalesce key, since identical keys mean identical
        device outputs (the token is process-unique, so a re-staged table
        never aliases an in-flight dispatch).  ``tensors`` are the
        resident arrays the launch reads."""
        t0 = time.perf_counter()
        lane = self.lane
        if lane is None:
            start = _span_start(self.device)
            value = dispatch(to_device_inputs(q_np, self.device))
            outs = fetch(value, deadline)
        else:
            if spec is None:
                q = to_device_inputs(q_np, self.device)
                ready = ready_event(self.device)
                handed = tensors + tree_leaves(q)

                def launch():
                    stream_handoff(ready, handed)
                    return dispatch(q)
            else:
                ready = spec.inputs[1]

                def launch():
                    # alone after all: the upload goes on the lane's stream
                    stream_handoff(ready, tensors)
                    return dispatch(to_device_inputs(q_np, self.device))

            ticket = lane.submit(program_key + (_inputs_digest(q_np),), launch, deadline, plan_digest=pdigest,
                                 cost_provider=cost_provider, batch=spec)
            value = ticket.result(deadline)
            start = ticket.device_start
            t0 = self._phase("laneWait", t0, coalesced=ticket.coalesced, batchSize=ticket.batch_size)
            if ticket.coalesced:
                cost["coalesceHits"] = cost.get("coalesceHits", 0) + 1
            if ticket.batch_size > 1:
                # this query's literals rode a batched launch with
                # batch_size - 1 same-key peers
                cost["batchHits"] = cost.get("batchHits", 0) + 1
            if info is not None:
                info["batchSize"] = ticket.batch_size
            if isinstance(value, tuple):  # a member of a batched launch: its row of the batch
                member_fetch, handle = value
                outs = member_fetch(handle, deadline)
            else:
                outs = fetch(value, deadline)
        cost["deviceMs"] = cost.get("deviceMs", 0.0) + round(_device_ms(start, value, t0), 3)
        self._phase("planExec", t0)
        return outs

    def _table_kernel(self, plan: StaticPlan, staged: StagedTable):
        """The packed table kernel, or past the per-dispatch row budget
        (``config.CHUNK_ROWS``) a chunkable plan's segment-axis chunks."""
        chunked = make_chunked_table_kernel(plan, staged.num_segments, staged.n_pad)
        return self._kernel if chunked is None else chunked

    def _batch_spec(self, plan: StaticPlan, staged: StagedTable, seg: Dict[str, torch.Tensor],
                    q_np: Dict[str, Any]) -> Optional[BatchSpec]:
        """The dispatch's ``BatchSpec`` for the lane's micro-batching tier,
        keyed on (StaticPlan, staging token, input signature): one device
        program over one resident table with identically shaped inputs.
        ``max_members`` keeps batch x rows under the per-dispatch row
        budget: the largest power of two at most budget / rows (the
        reference's rule, ``pinot_tpu/engine/executor.py:1175-1206``;
        the port launches exactly the members it has).  None when one
        member already fills the budget.  Its inputs are the host inputs
        and the event recorded after this query's PREP."""
        limit = chunk_rows_limit()
        rows = max(1, staged.num_segments * staged.n_pad)
        max_members = 0
        if limit:
            max_members = 1
            while max_members * 2 <= limit // rows:
                max_members *= 2
        if max_members == 1:
            return None
        device = self.device
        tensors = list(seg.values())

        def launch_batched(inputs_list):
            # on the lane's stream: wait for every member's PREP, one
            # stacked upload, one batched launch, one packed copy back
            for _, ready in inputs_list:
                stream_handoff(ready, tensors)
            qb = to_device_inputs(stack_query_inputs([q for q, _ in inputs_list]), device)
            return fetch_handle, dispatch_packed(
                run_batched_table_kernel(plan, staged, seg, qb, len(inputs_list)))

        key = (plan, staged.token, batch_input_signature(q_np))
        return BatchSpec(key, (q_np, ready_event(device)), launch_batched, max_members=max_members)

    def _block_skip_ids(
        self, plan: StaticPlan, q_np: Dict[str, Any], live: List[ImmutableSegment], staged: StagedTable
    ) -> Optional[int]:
        """The zone-map block-pruning decision: puts ``block_ids`` [S,
        nb_pad] into the query inputs and returns the candidate rows, or
        returns None (full scan).  Engages when the padded candidate
        window is at most ``config.ZONE_MAX_FRACTION`` of the table and
        its S x nb_pad entries fit one launch's grid.  A selection's
        window grows to hold its k rows, since top-k needs k rows a
        segment.  Past the per-dispatch row budget there is no block path
        (the block table has no chunked form): the chunked full scan runs."""
        if not self.zone_maps:
            return None
        limit = chunk_rows_limit()
        if limit and staged.num_segments * staged.n_pad > limit:
            return None
        cand = zonemap.candidate_blocks(plan, q_np, live, staged.n_pad, cache=staged.zones)
        if cand is None:
            return None
        block = zonemap.zone_block_rows()
        nb_total = staged.num_segments * (staged.n_pad // block)
        per_seg = cand.sum(axis=1)
        nb_max = int(per_seg.max()) if per_seg.size else 0
        if plan.selection is not None:
            nb_max = max(nb_max, -(-plan.selection.k // block))
        nb_pad = 1
        while nb_pad < nb_max:
            nb_pad *= 2
        entries = nb_pad * staged.num_segments
        if entries > nb_total * config.ZONE_MAX_FRACTION or entries > fused_groupby.MAX_GRID_Y:
            return None
        q_np["block_ids"] = zonemap.block_ids_input(cand, nb_pad)
        return int(per_seg.sum()) * block

    def _docrange_only_columns(
        self, request: BrokerRequest, live, sel_columns: Optional[List[str]] = None
    ) -> set:
        """Filter columns whose every use qualifies for the docrange fast
        path and which appear nowhere else in the query."""
        used_elsewhere = {a.column for a in request.aggregations}
        if request.is_group_by:
            used_elsewhere.update(request.group_by.columns)
        if request.is_selection:
            used_elsewhere.update(sel_columns or [])
            used_elsewhere.update(s.column for s in request.selection.sorts)
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

    def _skip_base_columns(
        self, request: BrokerRequest, live, raw_cols, gfwd_cols, hll_cols
    ) -> set:
        """Columns the kernel reads only through a role array skip their
        base fwd/dict arrays; filter leaves (other than docrange ones),
        dictionary-fed agg inputs and a selection's columns keep them."""
        if request.is_selection:
            return set()
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
        return (set(raw_cols) | set(gfwd_cols) | set(hll_cols)) - filter_cols - gather_agg_cols

    def _resolve_selection_columns(self, request: BrokerRequest, seg: ImmutableSegment) -> List[str]:
        cols = request.selection.columns
        if not cols or cols == ["*"]:
            return list(seg.columns.keys())
        return list(cols)

    def _role_columns(self, request: BrokerRequest, live, ctx: TableContext):
        """Aggregation inputs above ``raw_card_min`` get raw value arrays;
        group-by columns, selection sort columns and presence/hist inputs
        get global-id forward arrays; HLL inputs get the global-id stream
        where they lower to presence (``hll_lowers_to_presence``), else
        the per-row HLL (register, rank) streams."""
        seg = live[0]

        def sv(c: str) -> bool:
            return c in seg.columns and seg.column(c).metadata.single_value

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
            gfwd_cols.update(c for c in request.group_by.columns if sv(c))
        if request.is_selection:
            gfwd_cols.update(s.column for s in request.selection.sorts if sv(s.column))
        gfwd_cols.update(
            a.column
            for a in request.aggregations
            if _agg_kind(a.base_function) in ("presence", "hist") and sv(a.column)
        )
        hll_cols = set()
        for a in request.aggregations:
            if _agg_kind(a.base_function) == "hll" and sv(a.column):
                if hll_lowers_to_presence(request, ctx, a.column):
                    gfwd_cols.add(a.column)
                else:
                    hll_cols.add(a.column)
        return tuple(sorted(raw_cols)), tuple(sorted(gfwd_cols)), tuple(sorted(hll_cols))

    def _empty_result(self, request: BrokerRequest, total_docs: int) -> IntermediateResult:
        res = IntermediateResult(total_docs=total_docs)
        if request.is_group_by:
            res.groups = {}
        elif request.is_aggregation:
            res.aggregations = [make_partial(a.base_function) for a in request.aggregations]
        else:
            res.selection_rows = []
        return res

    # ------------------------------------------------------------------
    # distributed joins (engine/join.py): the device hash join under the
    # scans' self-healing ladder — a device fault is classified, a
    # transient retried once, a poison quarantines the join plan digest
    # (the poison map and heal.* counters shared with scans), and the
    # exact host join answers
    # ------------------------------------------------------------------
    def execute_join(
        self,
        request: BrokerRequest,
        build,
        probe,
        deadline: Optional[float] = None,
    ) -> IntermediateResult:
        """Hash join of two extracted sides (``join.SideRows``) -> mergeable
        partials, with ``buildRows`` / ``probeRows`` in the cost and
        ``deviceBytes`` where the device program served it."""
        t0 = time.perf_counter()
        planned = join_mod.build_join_plan(request, build, probe, self.precision)
        if planned is None:
            return self._host_join(request, build, probe, "hostPath", t0)
        plan, inputs, meta = planned
        jdigest = join_mod.join_plan_digest(plan)
        poison_key = (jdigest, "join")
        if self._is_poisoned(poison_key):
            self._heal_mark("poisonSkips")
            return self._host_join(request, build, probe, "hostFailover", t0)
        if self._sticky is not None:
            self._heal_mark("hostFailovers", reason="deviceOff")
            return self._host_join(request, build, probe, "hostFailover", t0)
        result = self._run_healing(
            lambda: self._join_device_section(request, plan, inputs, meta, build, probe, deadline, jdigest),
            {"key": poison_key},
        )
        if result is None:
            return self._host_join(request, build, probe, "hostFailover", time.perf_counter())
        return result

    def _host_join(self, request: BrokerRequest, build, probe, phase: str, t0: float) -> IntermediateResult:
        res = join_mod.host_join(request, build, probe)
        res.add_cost(buildRows=build.n, probeRows=probe.n)
        self._phase(phase, t0)
        res._served_tier = "host"
        return res

    def _join_device_section(self, request, plan, inputs, meta, build, probe, deadline, jdigest) -> IntermediateResult:
        """Upload, launch through the lane (inline without one), the packed
        fetch, finalize.  Join dispatches never coalesce or batch: their
        lane key is unique (hashing a probe side of millions of rows for a
        content key costs more than the program), and they carry no
        ``BatchSpec`` (the reference's ``batch_spec=None``)."""
        t0 = time.perf_counter()
        kernel = self._join_kernel
        cost: Dict[str, float] = {}
        q = to_device_inputs(inputs, self.device)
        lane = self.lane
        if lane is None:
            start = _span_start(self.device)
            value = kernel.dispatch(plan, q)
            outs = kernel.fetch(value, deadline)
        else:
            ready = ready_event(self.device)
            tensors = tree_leaves(q)

            def launch():
                stream_handoff(ready, tensors)
                return kernel.dispatch(plan, q)

            ticket = lane.submit(("join", object()), launch, deadline, plan_digest=jdigest)
            value = ticket.result(deadline)
            start = ticket.device_start
            t0 = self._phase("laneWait", t0)
            outs = kernel.fetch(value, deadline)
        cost["deviceMs"] = round(_device_ms(start, value, t0), 3)
        self._phase("planExec", t0)
        if not bool(outs["join_ok"]):
            # the parallel-claim build ran out of rounds (it cannot with
            # unique keys and a half-full table, but a wrong answer must
            # never ship): poison the plan and heal to the host join
            raise DeviceExecutionError("join hash-table build did not converge", retryable=False)
        t_fin = time.perf_counter()
        result = join_mod.finalize_device_join(request, plan, meta, build, probe, outs)
        dev_bytes = sum(a.nbytes for a in inputs.values())
        result.add_cost(
            buildRows=build.n,
            probeRows=probe.n,
            bytesScanned=build.nbytes() + probe.nbytes(),
            deviceBytes=dev_bytes,
            **cost,
        )
        result._served_tier = "device"
        result._device_digest = jdigest
        result._lane_index = 0
        self._phase("finalize", t_fin)
        return result

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
        sel_columns: Optional[List[str]] = None,
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
                self._scalar_partial(agg, outs[f"agg_{i}"], ctx) for i, agg in enumerate(plan.aggs)
            ]
        if plan.selection is not None:
            res.selection_rows = self._finalize_selection(request, live, outs, sel_columns)
            res.selection_columns = sel_columns
        return res

    def _finalize_selection(
        self,
        request: BrokerRequest,
        live: List[ImmutableSegment],
        outs,
        sel_columns: List[str],
    ) -> List[Tuple[list, list]]:
        """(sort values, row) of every matched candidate, segment by
        segment in the kernel's order; the broker reduce sorts and cuts
        the window."""
        sel = request.selection
        docids, valid = outs["sel_docids"], outs["sel_valid"]  # [S, k]
        rows: List[Tuple[list, list]] = []
        for si, seg in enumerate(live):
            for j in range(docids.shape[1]):
                doc = int(docids[si, j])
                if not valid[si, j] or doc >= seg.num_docs:
                    continue
                full = seg.row(doc)
                sort_vals = []
                for s in sel.sorts:
                    v = full[s.column]
                    if isinstance(v, list):  # an MV column orders by its first value
                        v = v[0] if v else None
                    sort_vals.append(v)
                rows.append((sort_vals, [full[c] for c in sel_columns]))
        return rows

    def _scalar_partial(self, agg, state, ctx: TableContext) -> AggPartial:
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
        if agg.sort_pairs:
            return self._pairs_partial(agg, _PairsState(state, 1), 0, ctx)
        return self._value_partial(agg, np.asarray(state), ctx)

    def _pairs_partial(self, agg, pairs: _PairsState, key: int, ctx: TableContext) -> AggPartial:
        """The partial of one group slot's sort-dedup pairs: its distinct
        global value ids, their occurrence counts (percentile), or the HLL
        registers its (bucket, rho) gids decode to."""
        if agg.kind == "presence":
            gdict = ctx.column(agg.column).global_dict
            ids = pairs.gids_for(key).astype(np.int64)
            return DistinctPartial(gdict.value_array()[ids[ids < gdict.cardinality]])
        if agg.kind == "hist":
            return _hist_partial(
                ctx.column(agg.column).global_dict, *pairs.gid_counts_for(key), percentile_of(agg.base)
            )
        return HllPartial(_regs_from_gids(pairs.gids_for(key)))

    def _value_partial(self, agg, row: np.ndarray, ctx: TableContext) -> AggPartial:
        """The partial of one value-state holder row: presence bits over
        global value ids, histogram counts over them, or HLL registers."""
        if agg.kind == "presence":
            ids = np.nonzero(row)[0]
            if agg.hll_from_presence:
                return HllPartial(_regs_from_value_gids(ctx, agg.column, ids))
            gdict = ctx.column(agg.column).global_dict
            return DistinctPartial(gdict.value_array()[ids[ids < gdict.cardinality]])
        if agg.kind == "hist":
            ids = np.nonzero(row)[0]
            return _hist_partial(
                ctx.column(agg.column).global_dict, ids, row[ids], percentile_of(agg.base)
            )
        if agg.kind == "hll":
            return HllPartial(row)
        raise AssertionError(agg)

    def _finalize_groups(
        self, plan: StaticPlan, ctx: TableContext, outs
    ) -> Dict[Tuple[str, ...], List[AggPartial]]:
        gb = plan.group_by
        keys = np.nonzero(np.asarray(outs["gb_presence"]).astype(bool))[0]
        if keys.size == 0:
            return {}
        # sort-dedup states arrive as compacted (slot, gid) pair buffers:
        # index each once for the per-group reads
        outs = dict(outs)
        for i, agg in enumerate(plan.aggs):
            if agg.sort_pairs:
                outs[f"gb_{i}"] = _PairsState(outs[f"gb_{i}"], gb.capacity)
        # trim candidate groups per aggregation (reference trims to
        # topN*5 per server, MCombineGroupByOperator.java:216)
        if keys.size > max(gb.top_n * 5, 100):
            keep = trim_group_candidates(
                [
                    self._group_order_values(agg, outs[f"gb_{i}"], keys, ctx)
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
                self._group_partial(agg, outs[f"gb_{i}"], k, ctx) for i, agg in enumerate(plan.aggs)
            ]
        return groups

    def _group_order_values(self, agg, state, keys: np.ndarray, ctx: TableContext) -> np.ndarray:
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
        if agg.sort_pairs:
            if agg.kind == "presence":
                return state.counts[keys]
            if agg.kind == "hist":
                vals = np.asarray(ctx.column(agg.column).global_dict.values, dtype=np.float64)
                return state.percentiles_for(keys, percentile_of(base), vals)
            # one batched decode over the concatenated per-slot gid slices
            regs = _regs_from_gids(*state.gids_rows_for(keys), keys.size)
            return np.asarray(hll_mod.estimate_from_registers(regs), dtype=np.float64)
        if agg.kind == "presence":
            occ = np.asarray(state)[keys]  # [k, gcard_pad]
            if agg.hll_from_presence:
                r, c = np.nonzero(occ)
                regs = _regs_from_value_gids(ctx, agg.column, c, r, keys.size)
                return np.asarray(hll_mod.estimate_from_registers(regs), dtype=np.float64)
            return occ.sum(axis=1).astype(np.float64)
        if agg.kind == "hist":
            # exact percentile from histogram rows, vectorized:
            # sorted[int(n * p/100)] per group (PercentileUtil.java:50)
            p = percentile_of(base)
            vals = np.asarray(ctx.column(agg.column).global_dict.values, dtype=np.float64)
            cs = np.cumsum(np.asarray(state)[keys], axis=1)
            n = cs[:, -1]
            idx = np.minimum((n * p / 100.0).astype(np.int64), np.maximum(n - 1, 0))
            pos = np.minimum((cs <= idx[:, None]).sum(axis=1), vals.size - 1)
            return np.where(n > 0, vals[pos], -np.inf)
        if agg.kind == "hll":
            return np.asarray(
                hll_mod.estimate_from_registers(np.asarray(state)[keys]), dtype=np.float64
            )
        raise AssertionError(agg)

    def _group_partial(self, agg, state, key: int, ctx: TableContext) -> AggPartial:
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
        if agg.sort_pairs:
            return self._pairs_partial(agg, state, key, ctx)
        return self._value_partial(agg, np.asarray(state)[key], ctx)
