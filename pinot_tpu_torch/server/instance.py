"""Server instance: request handling front for one query-serving node
(trimmed port of ``pinot_tpu.server.instance``).

The reference chain (``ScheduledRequestHandler.java:55``): Netty bytes
-> Thrift InstanceRequest -> QueryScheduler -> QueryExecutor ->
serialized DataTable bytes.  Here: framed bytes -> InstanceRequest ->
fair-share scheduler -> the port's ``QueryExecutor``, launching through
the server's device lane on its own CUDA stream -> DataTable bytes.
Errors come back as a DataTable whose ``exceptions`` are set (the broker
still reduces the healthy servers' partials).

The controller wiring is ``starter.py`` (in process) and
``network_starter.py`` (a server process); they load segment files,
verify their CRCs and quarantine a bad copy through this class.

Left out of the port, for later slices: EXPLAIN, the result cache,
joins, the roofline window, plan stats, the profiler and the occupancy
sampler, residency, prewarm, the shadow auditor, schema evolution and
the ingest planes.
"""
from __future__ import annotations

import concurrent.futures
import logging
import time
from typing import List, Optional, Sequence, Union

import torch

from pinot_tpu_torch.common.datatable import deserialize_instance_request, serialize_result
from pinot_tpu_torch.common.response import ErrorCode
from pinot_tpu_torch.engine import config, kernels
from pinot_tpu_torch.engine.dispatch import LaneGroup
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.kernels import fused_groupby, value_state_counts
from pinot_tpu_torch.engine.results import SEGMENT_TIER_KEYS, IntermediateResult
from pinot_tpu_torch.pql import optimize_request, parse_pql
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
    every lane launch."""

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

    # -- segment lifecycle -------------------------------------------
    def add_segment(self, table: str, segment: ImmutableSegment) -> None:
        self.data_manager.add_segment(table, segment)

    def remove_segment(self, table: str, name: str) -> None:
        tdm = self.data_manager.table(table)
        if tdm is not None:
            tdm.remove_segment(name)

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
                views = [a.query_view() for a in acquired]
                with trace.span("planAndExecute", segments=len(acquired)):
                    result = self.executor.execute(views, request, deadline=deadline)
                result.unserved_segments = missing
            finally:
                tdm.release_segments(acquired)
        if trace.enabled:
            result.trace.update(trace.to_dict())
        return result

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
