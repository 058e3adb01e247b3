"""Server instance: request handling front for one query-serving node
(trimmed port of ``pinot_tpu.server.instance``).

The reference chain (``ScheduledRequestHandler.java:55``): Netty bytes
-> Thrift InstanceRequest -> QueryScheduler -> QueryExecutor ->
serialized DataTable bytes.  Here: framed bytes -> InstanceRequest ->
fair-share scheduler -> the port's ``QueryExecutor``, launching through
the server's device lane on its own CUDA stream -> DataTable bytes.
Errors come back as a DataTable whose ``exceptions`` are set (the broker
still reduces the healthy servers' partials).

A request carrying a join context (``broker/joinplan.py``) runs its join
phase instead of a scan (``_process_join``), in the same scheduler slot:
``extract`` returns one side's matched rows as the exchange payload,
``exec`` runs the hash join (``QueryExecutor.execute_join``) under the
colocated, broadcast or shuffle strategy.

The controller wiring is ``starter.py`` (in process) and
``network_starter.py`` (a server process); they load segment files,
verify their CRCs and quarantine a bad copy through this class, and host
a realtime table's consuming segments (``realtime/mutable.py``) beside
the sealed ones: a query reads a consuming segment through its snapshot
at the row watermark, staged and launched as any segment.  The
instance's ingest governor (``ingest_backpressure``,
``realtime/backpressure.py``) watches the executor's staged bytes and
the consuming segments' host bytes.  Replacing, committing or dropping a
segment drops the executor's staged tables that hold it.

An EXPLAIN (a reference broker in a mixed fleet forwards it) is refused
with QUERY_VALIDATION before any segment is touched.

Left out of the port, for later slices: EXPLAIN itself, the result cache (of
scans and joins), the roofline window, plan stats, the profiler and the occupancy
sampler, residency, prewarm, the shadow auditor and schema evolution.
"""
from __future__ import annotations

import concurrent.futures
import logging
import time
from typing import List, Optional, Sequence, Union

import torch

from pinot_tpu_torch.common.datatable import deserialize_instance_request, serialize_result
from pinot_tpu_torch.common.request import EXPLAIN_ITEM
from pinot_tpu_torch.common.response import ErrorCode
from pinot_tpu_torch.engine import config, kernels
from pinot_tpu_torch.engine import join as join_mod
from pinot_tpu_torch.engine.dispatch import LaneGroup
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.kernels import fused_groupby, value_state_counts
from pinot_tpu_torch.engine.results import SEGMENT_TIER_KEYS, IntermediateResult
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.realtime.backpressure import IngestBackpressure, instance_mutable_bytes
from pinot_tpu_torch.realtime.mutable import MutableSegment
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.server.datamanager import InstanceDataManager
from pinot_tpu_torch.server.scheduler import (
    QueryAbandonedError,
    QueryScheduler,
    SchedulerSaturatedError,
    SchedulerShutdownError,
)
from pinot_tpu_torch.utils.metrics import ServerMetrics, prometheus_text
from pinot_tpu_torch.utils.trace import NULL_TRACE, TraceContext, reset_current, set_current

logger = logging.getLogger(__name__)


class ServerInstance:
    """One query-serving node on one device.

    ``device``: the card its lane launches on and its segments are staged
    on (None: the current CUDA device, raising without one; ``"cpu"``
    runs the port's plain torch versions, as the tests do).
    ``precision``: "x64" or "x32" (``engine/config.py``).
    ``pipeline``: True launches through the device lane (PREP on the
    scheduler's workers, launches on the lane's stream, FINALIZE back on
    the worker); False launches inline on each worker.
    ``lane_stall_timeout_s`` arms the lane's watchdog;
    ``device_fault_injector`` (``common/faults.py``) is consulted before
    every lane launch.
    ``postings`` / ``bitsliced``: the executor's filter-tier switches
    (``QueryExecutor``)."""

    # serving-tier cost-vector keys mirrored into cost.tier.* meters
    _TIER_KEYS = SEGMENT_TIER_KEYS

    def __init__(
        self,
        name: str = "server0",
        device: Optional[Union[str, torch.device]] = None,
        precision: str = "x64",
        num_workers: int = 4,
        max_pending: int = 64,
        pipeline: bool = True,
        lane_stall_timeout_s: Optional[float] = None,
        device_fault_injector=None,
        postings: bool = True,
        bitsliced: Union[bool, str] = True,
    ) -> None:
        self.name = name
        self.device = config.resolve_device(device)
        if self.device.type == "cuda":
            # a failed kernel build raises here, before any thread starts
            kernels.load_all()
        self.data_manager = InstanceDataManager()
        self.metrics = ServerMetrics(name)
        self.lanes = (
            LaneGroup(
                self.device,
                metrics=self.metrics,
                stall_timeout_s=lane_stall_timeout_s,
                fault_injector=device_fault_injector,
            )
            if pipeline
            else None
        )
        self.lane = self.lanes.primary if self.lanes is not None else None
        self.executor = QueryExecutor(
            device=self.device,
            precision=precision,
            metrics=self.metrics,
            lanes=self.lanes,
            postings=postings,
            bitsliced=bitsliced,
        )
        self.scheduler = QueryScheduler(
            num_workers=num_workers, max_pending=max_pending, metrics=self.metrics
        )
        # pre-register the serving series (zero > absent on a scrape);
        # lane.* and heal.* register in their constructors
        for m in ("queries", "queriesShed", "queriesAbandoned", "segmentsMissedServing",
                  "cost.docsScanned", "cost.bytesScanned", "crcFailures", "quarantinedSegments"):
            self.metrics.meter(m)
        for t in ("cost.deviceMs", "cost.hostMs"):
            self.metrics.timer(t)
        for k in self._TIER_KEYS:
            self.metrics.meter(f"cost.tier.{k}")
        # the distributed-join plane: extraction and hash-join counters
        for m in ("join.extracts", "join.execs", "join.buildRows",
                  "join.probeRows", "join.shuffleBytes", "join.broadcastBytes"):
            self.metrics.meter(m)
        # ingest backpressure, shared by every realtime consumer hosted
        # here: its device pool is the executor's staging cache
        self.ingest_backpressure = IngestBackpressure(
            metrics=self.metrics,
            hbm_bytes_fn=self.executor.staged_bytes,
            mutable_bytes_fn=lambda: instance_mutable_bytes(self),
        )

    # -- segment lifecycle -------------------------------------------
    def add_segment(self, table: str, segment) -> None:
        """Host ``segment`` (an ``ImmutableSegment``, or a consuming
        ``MutableSegment``); one of the same name is replaced."""
        self.data_manager.add_segment(table, segment)
        self.executor.evict_segment(segment.segment_name)

    def remove_segment(self, table: str, name: str) -> None:
        tdm = self.data_manager.table(table)
        if tdm is not None:
            tdm.remove_segment(name)
        self.executor.evict_segment(name)

    def record_crc_failure(self, table: str, name: str) -> None:
        """A copy of ``name`` failed its CRC check."""
        self.metrics.meter("crcFailures").mark()

    def quarantine_segment(self, table: str, name: str) -> None:
        """Pull a segment whose copy failed verification from serving."""
        self.remove_segment(table, name)
        self.metrics.meter("quarantinedSegments").mark()

    # -- query path ---------------------------------------------------
    def handle_request(self, payload: bytes) -> bytes:
        """Framed request bytes -> framed DataTable bytes."""
        t_start = time.perf_counter()
        req = deserialize_instance_request(payload)
        # ONE deadline for both queueing tiers: the scheduler checks it
        # at worker-dequeue time, the device lane at launch-dequeue time
        timeout_s = req["timeoutMs"] / 1000.0
        deadline = time.monotonic() + timeout_s
        t_enqueue = time.monotonic()
        try:
            result = self.scheduler.run(
                lambda: self._process(req, deadline, t_enqueue),
                timeout_s=timeout_s,
                deadline=deadline,
                table=req["table"],
            )
        except SchedulerSaturatedError as e:
            # overload shed: typed 210, which the broker fails over on
            self.metrics.meter("queriesShed").mark()
            result = IntermediateResult(exceptions=[(ErrorCode.SERVER_SCHEDULER_DOWN, str(e))])
        except SchedulerShutdownError as e:
            # draining: typed 220 so the broker retries on a replica
            result = IntermediateResult(exceptions=[(ErrorCode.SERVER_SHUTTING_DOWN, str(e))])
        except QueryAbandonedError as e:
            # the deadline expired while queued; reply without executing
            self.metrics.meter("queriesAbandoned").mark()
            result = IntermediateResult(
                exceptions=[(ErrorCode.EXECUTION_TIMEOUT, f"server {self.name}: {e}")]
            )
        except (concurrent.futures.TimeoutError, TimeoutError):
            logger.warning("query %s timed out", req.get("requestId"))
            result = IntermediateResult(
                exceptions=[
                    (ErrorCode.EXECUTION_TIMEOUT, f"server {self.name}: exceeded {req['timeoutMs']}ms")
                ]
            )
        except Exception as e:  # execution error
            logger.exception("query %s failed", req.get("requestId"))
            result = IntermediateResult(
                exceptions=[(ErrorCode.QUERY_EXECUTION, f"{type(e).__name__}: {e}")]
            )
        self.metrics.meter("cost.docsScanned").mark(int(result.num_docs_scanned))
        self.metrics.meter("cost.bytesScanned").mark(int(result.cost.get("bytesScanned", 0)))
        for key, timer in (("deviceMs", "cost.deviceMs"), ("hostMs", "cost.hostMs")):
            ms = result.cost.get(key)
            if ms:
                self.metrics.timer(timer).update(float(ms))
        for key in self._TIER_KEYS:
            n = result.cost.get(key)
            if n:
                self.metrics.meter(f"cost.tier.{key}").mark(int(n))
        self.metrics.timer("queryExecution").update((time.perf_counter() - t_start) * 1000)
        self.metrics.meter("queries").mark()
        # backpressure snapshot on EVERY reply (including sheds): the
        # broker's admission window reads it
        result.backpressure = {
            "pending": self.scheduler.pending,
            "maxPending": self.scheduler.max_pending,
            "laneDepth": 0 if self.lanes is None else self.lanes.stats().get("depth", 0),
        }
        return serialize_result(result)

    def _process(
        self,
        req: dict,
        deadline: Optional[float] = None,
        t_enqueue: Optional[float] = None,
    ) -> IntermediateResult:
        request = parse_pql(req["pql"])
        request.debug_options = dict(req.get("debugOptions") or {})
        request = optimize_request(request)
        if request.explain is not None:
            return IntermediateResult(exceptions=[(ErrorCode.QUERY_VALIDATION, EXPLAIN_ITEM)])
        request.enable_trace = bool(req.get("trace"))
        # untraced requests share the NULL context: no span allocation
        if request.enable_trace:
            trace = TraceContext(
                enabled=True, scope=self.name, trace_id=str(req.get("requestId") or "")
            )
        else:
            trace = NULL_TRACE
        token = set_current(trace if trace.enabled else None)
        try:
            return self._process_traced(req, request, trace, deadline, t_enqueue)
        finally:
            reset_current(token)

    def _process_traced(
        self,
        req: dict,
        request,
        trace: TraceContext,
        deadline: Optional[float],
        t_enqueue: Optional[float],
    ) -> IntermediateResult:
        with trace.span(
            "serverQuery", requestId=str(req.get("requestId") or ""), server=self.name
        ):
            if t_enqueue is not None:
                trace.add("queueWait", (time.monotonic() - t_enqueue) * 1000.0)
            tdm = self.data_manager.table(req["table"])
            if tdm is None:
                result = IntermediateResult(
                    exceptions=[
                        (ErrorCode.SERVER_SCHEDULER_DOWN,
                         f"table {req['table']} not on server {self.name}")
                    ]
                )
                trace.event("tableNotHosted", table=req["table"])
                if trace.enabled:
                    result.trace.update(trace.to_dict())
                return result
            names: Optional[Sequence[str]] = req["segments"] or None
            acquired = tdm.acquire_segments(names)
            try:
                # requested segments this server cannot serve are
                # REPORTED: the broker re-covers them on a replica
                missing: List[str] = []
                if names:
                    held = {a.name for a in acquired}
                    missing = [n for n in names if n not in held]
                    if missing:
                        self.metrics.meter("segmentsMissedServing").mark(len(missing))
                views = []
                for a in acquired:
                    before = getattr(a.segment, "_snapshot", None)
                    t_view = time.perf_counter()
                    views.append(a.query_view())
                    if isinstance(a.segment, MutableSegment) and views[-1] is not before:
                        # a consuming segment's snapshot at a new watermark
                        self.metrics.timer("phase.snapshot").update((time.perf_counter() - t_view) * 1000)
                if req.get("join"):
                    # a distributed-join phase over the local views, in the
                    # scheduler slot this request already holds
                    result = self._process_join(req, request, req["join"], views, deadline, trace)
                else:
                    with trace.span("planAndExecute", segments=len(acquired)):
                        result = self.executor.execute(views, request, deadline=deadline)
                result.unserved_segments = missing
            finally:
                tdm.release_segments(acquired)
        if trace.enabled:
            result.trace.update(trace.to_dict())
        return result

    # -- distributed joins (engine/join.py + broker/joinplan.py) ------
    def _extract_bytes(self, views, columns) -> int:
        total = 0
        for seg in views:
            for c in columns:
                col = seg.columns.get(c)
                if col is not None and getattr(col, "fwd", None) is not None:
                    total += col.fwd.nbytes
        return total

    def _process_join(self, req: dict, request, jctx: dict, views, deadline, trace) -> IntermediateResult:
        """One join-phase request: ``extract`` returns the side's matched
        rows as a dict-encoded exchange payload; ``exec`` runs the hash
        join (device program, host heal) over local and / or shipped
        sides and returns normal mergeable partials."""
        spec = request.join
        if spec is None:
            return IntermediateResult(
                exceptions=[(ErrorCode.QUERY_EXECUTION, "join context on a non-join query")]
            )
        phase = jctx.get("phase")
        t0 = time.perf_counter()
        try:
            left_f, right_f = join_mod.split_join_filter(request)
            left_cols, right_cols = join_mod.side_columns(request)
            if phase == "extract":
                side_name = jctx.get("side")
                if side_name == "build":
                    stripped = [spec.strip_right(c) for c in right_cols]
                    name_of = {spec.strip_right(c): c for c in right_cols}
                    rows, matched = join_mod.extract_side(views, right_f, spec.right_key, stripped, name_of)
                    read_cols = [spec.right_key, *stripped]
                else:
                    rows, matched = join_mod.extract_side(views, left_f, spec.left_key, left_cols)
                    read_cols = [spec.left_key, *left_cols]
                res = IntermediateResult(
                    num_docs_scanned=matched,
                    total_docs=sum(v.num_docs for v in views),
                    num_segments_queried=len(views),
                )
                res.add_cost(
                    hostMs=round((time.perf_counter() - t0) * 1000, 3),
                    bytesScanned=self._extract_bytes(views, read_cols),
                )
                res.join_payload = join_mod.encode_side(rows)
                self.metrics.meter("join.extracts").mark()
                self.executor._phase("joinExtract", t0, side=side_name, segments=len(views))
                return res

            if phase != "exec":
                raise join_mod.JoinValidationError(f"unknown join phase {phase!r}")
            strategy = jctx.get("strategy")
            if strategy == "colocated":
                build_table = jctx.get("buildTable") or ""
                build_names = list(jctx.get("buildSegments") or ())
                tdm_b = self.data_manager.table(build_table)
                if tdm_b is None:
                    return IntermediateResult(exceptions=[(
                        ErrorCode.SERVER_SEGMENT_MISSING, f"build table {build_table} not on server {self.name}",
                    )])
                b_acquired = tdm_b.acquire_segments(build_names or None)
                try:
                    held = {a.name for a in b_acquired}
                    miss_b = [n for n in build_names if n not in held]
                    if miss_b:
                        return IntermediateResult(exceptions=[(
                            ErrorCode.SERVER_SEGMENT_MISSING,
                            f"server {self.name}: build segments unavailable: {sorted(miss_b)}",
                        )])
                    b_views = [a.query_view() for a in b_acquired]
                    # failover re-check: a child batch may land on a replica
                    # whose local build segments cover other partitions —
                    # serve only if every probe partition is locally
                    # buildable, else 230 so the broker re-covers elsewhere
                    probe_parts = {join_mod.partition_of_segment(v.segment_name) for v in views}
                    build_parts = {join_mod.partition_of_segment(v.segment_name) for v in b_views}
                    if None in probe_parts or not probe_parts <= build_parts:
                        return IntermediateResult(exceptions=[(
                            ErrorCode.SERVER_SEGMENT_MISSING,
                            f"server {self.name}: local build side does not cover probe partitions",
                        )])
                    result = self._join_exec(request, spec, right_f, right_cols, b_views,
                                             left_f, left_cols, views, deadline, trace)
                    result.num_segments_queried = len(views) + len(b_views)
                finally:
                    tdm_b.release_segments(b_acquired)
            elif strategy == "broadcast":
                build = join_mod.decode_side(jctx["build"])
                result = self._join_exec(request, spec, None, right_cols, None,
                                         left_f, left_cols, views, deadline, trace, build=build)
                result.num_segments_queried = len(views)
                bbytes = build.nbytes()
                result.add_cost(broadcastBytes=bbytes)
                self.metrics.meter("join.broadcastBytes").mark(bbytes)
            elif strategy == "shuffle":
                build = join_mod.decode_side(jctx["build"])
                probe = join_mod.decode_side(jctx["probe"])
                sbytes = build.nbytes() + probe.nbytes()
                with trace.span("joinExec", strategy="shuffle", buildRows=build.n, probeRows=probe.n):
                    result = self.executor.execute_join(request, build, probe, deadline=deadline)
                result.add_cost(shuffleBytes=sbytes)
                self.metrics.meter("join.shuffleBytes").mark(sbytes)
            else:
                raise join_mod.JoinValidationError(f"unknown join strategy {strategy!r}")
            self.metrics.meter("join.execs").mark()
            self.metrics.meter("join.buildRows").mark(int(result.cost.get("buildRows", 0)))
            self.metrics.meter("join.probeRows").mark(int(result.cost.get("probeRows", 0)))
            return result
        except join_mod.JoinValidationError as e:
            # a typed client error, never a crash: the broker surfaces it
            # as QUERY_VALIDATION (4xx), and it is not retried
            return IntermediateResult(exceptions=[(ErrorCode.QUERY_VALIDATION, str(e))])

    def _join_exec(self, request, spec, right_f, right_cols, b_views,
                   left_f, left_cols, views, deadline, trace, build=None) -> IntermediateResult:
        """Local probe-side extraction (and the build side for colocated),
        then the healed hash join."""
        t0 = time.perf_counter()
        if build is None:
            stripped = [spec.strip_right(c) for c in right_cols]
            name_of = {spec.strip_right(c): c for c in right_cols}
            with trace.span("joinBuildLocal", segments=len(b_views)):
                build, _m = join_mod.extract_side(b_views, right_f, spec.right_key, stripped, name_of)
        with trace.span("joinProbeLocal", segments=len(views)):
            probe, _matched = join_mod.extract_side(views, left_f, spec.left_key, left_cols)
        self.metrics.timer("phase.joinExtract").update((time.perf_counter() - t0) * 1000)
        with trace.span("joinExec", buildRows=build.n, probeRows=probe.n):
            return self.executor.execute_join(request, build, probe, deadline=deadline)

    # -- observability -------------------------------------------------
    def status(self) -> dict:
        """Serving-surface snapshot: scheduler depth/shed, device-lane
        depth and coalesce/dispatch/shed counters and its micro-batching
        counters (``batchLaunches``, ``batchedQueries``), the phase timers
        (staging, planBuild, laneWait, planExec, finalize) inside the
        metrics snapshot, and the self-healing counters."""
        heal = self.executor.healing_stats()
        heal["laneRestarts"] = 0 if self.lanes is None else self.lanes.restart_count
        return {
            "name": self.name,
            "device": str(self.device),
            "scheduler": self.scheduler.stats(),
            "lane": None if self.lanes is None else self.lanes.stats(),
            "selfHealing": heal,
            "stagedBytes": self.executor.staged_bytes(),
            "stagedTables": self.executor.staged_tables(),
            "ingest": self.ingest_backpressure.snapshot(),
            # the kernel wrappers' launch counts in this process (one-member
            # and batched launches apart)
            "kernelLaunches": {"k1": fused_groupby.launches, "k2": value_state_counts.launches,
                               "k1Batched": fused_groupby.batched_launches,
                               "k2Batched": value_state_counts.batched_launches},
            "metrics": self.metrics.snapshot(),
        }

    def metrics_text(self) -> str:
        """Prometheus exposition of this server's registry."""
        return prometheus_text(self.metrics)

    def shutdown(self) -> None:
        """Idempotent: drain-stop the scheduler and close the device lane
        (queued lane waiters fail fast with ``LaneClosedError``), then
        wait (bounded) for their threads to exit: a daemon thread still
        inside torch while the interpreter tears down aborts the
        process."""
        self.scheduler.shutdown()
        if self.lanes is not None:
            self.lanes.close()
        self.scheduler.join()
        if self.lanes is not None:
            self.lanes.join()
