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
the consuming segments' host bytes (and, with an HBM cap, the residency
pressure).  Replacing, committing or dropping a segment drops the
executor's staged tables that hold it from every residency tier.

RESIDENCY (``engine/residency.py``): the executor's staging keeps the
card within ``hbm_cap_bytes`` and ``stage_cache_entries``, demoting the
coldest tables to host snapshots (spilled to disk past
``host_cap_bytes``); ``residency.*`` gauges, ``status()["residency"]``
and ``status()["hbm"]`` (the staging ledger) show the tiers.

EXPLAIN (``engine/explain.py``): ``EXPLAIN`` / ``EXPLAIN PLAN FOR``
returns this server's plan node INSTEAD of executing (no lane submission,
no cost, nothing staged; ``plan.explains``); ``EXPLAIN ANALYZE`` executes,
then builds the node and annotates it with the reply's cost
(``actualCost``, ``actualDocsScanned``, the batching actual).

SCHEMA EVOLUTION (``segment/default_column.py``): ``set_table_schema``
registers a table's schema and patches the loaded sealed segments with
default columns for the fields they lack; ``add_segment`` patches each
sealed segment it hosts the same way.

UTILIZATION: per plan shape (``utils/planstats.py``, ``plan_stats``) the
handled requests' latency, cost vector and tier mix, joined to the lane's
compile timeline (the digest's static cost) through the device-plan
digest the executor stamps; ``/debug/plans`` serves it, and EXPLAIN's
``estimatedCost`` reads it once a shape has run here ("history").  The
recent device-served queries' achieved bytes/s and FLOP/s against the
card's declared peaks (``_RooflineWindow``, ``utils/platform.py``), the
lane's windowed occupancy and the transfer totals make
``device_utilization()`` (``/debug/device``, ``status()["device"]``, the
``device.util.*`` gauges).  ``profile_start`` / ``profile_stop`` bracket a
``torch.profiler`` capture (``server/profiler.py``) with the lane's
``OccupancySampler``.

WARM START (``server/prewarm.py``): with a workload feed wired (the
starters' ``workload_source``), a segment load triggers a prewarm pass
that launches the fleet's hot plan shapes ahead on their own stream;
``prewarm.warming`` rides the heartbeats.

THE SERVING PLANES.  The result cache (``engine/rescache.py``, off unless
``PINOT_TPU_RESULT_CACHE=1``) answers a repeated scan, or a colocated
join, over the same data generation without launching anything; a
segment's add or removal and an LLC offset advance invalidate the
table's entries.  The shadow auditor (``utils/audit.py``) re-checks a
1-in-N sample of the device's replies against the host oracle on a
background thread and quarantines a tier that lies.  A realtime table's
reply carries its stalest partition's event-time watermark
(``broker/freshness.py``).  One history thread (``utils/timeseries.py``,
``/debug/history``) samples the registry; its tick dumps a flight-recorder
bundle (``utils/flightrec.py``) on heal activity.
"""
from __future__ import annotations

import collections
import concurrent.futures
import logging
import tempfile
import threading
import time
from typing import List, Optional, Sequence, Union

import torch

from pinot_tpu_torch.broker.freshness import WATERMARKS
from pinot_tpu_torch.common.datatable import deserialize_instance_request, serialize_result
from pinot_tpu_torch.common.fencing import ServingLease
from pinot_tpu_torch.common.response import ErrorCode
from pinot_tpu_torch.engine import config, kernels
from pinot_tpu_torch.engine import join as join_mod
from pinot_tpu_torch.engine.dispatch import LaneGroup, OccupancySampler
from pinot_tpu_torch.engine.executor import QueryExecutor
from pinot_tpu_torch.engine.explain import _json_safe, build_explain_node
from pinot_tpu_torch.engine.kernels import fused_groupby, value_state_counts
from pinot_tpu_torch.engine.plandigest import _raw_table, plan_shape_digest, plan_shape_summary
from pinot_tpu_torch.engine.rescache import ResultCache
from pinot_tpu_torch.engine.results import SEGMENT_TIER_KEYS, IntermediateResult
from pinot_tpu_torch.pql import optimize_request, parse_pql
from pinot_tpu_torch.realtime.backpressure import IngestBackpressure, instance_mutable_bytes
from pinot_tpu_torch.realtime.mutable import MutableSegment
from pinot_tpu_torch.segment.default_column import inject_default_columns
from pinot_tpu_torch.segment.format import SegmentIntegrityError, verify_segment_crc, write_segment
from pinot_tpu_torch.segment.immutable import ImmutableSegment, new_staging_token
from pinot_tpu_torch.server.datamanager import InstanceDataManager
from pinot_tpu_torch.server.prewarm import PrewarmWorker
from pinot_tpu_torch.server.profiler import DeviceProfiler
from pinot_tpu_torch.server.scheduler import (
    QueryAbandonedError,
    QueryScheduler,
    SchedulerSaturatedError,
    SchedulerShutdownError,
)
from pinot_tpu_torch.utils.audit import ShadowAuditor
from pinot_tpu_torch.utils.flightrec import FlightRecorder
from pinot_tpu_torch.utils.metrics import ServerMetrics, prometheus_text
from pinot_tpu_torch.utils.planstats import PlanStatsStore
from pinot_tpu_torch.utils.platform import platform_peaks, roofline_fractions
from pinot_tpu_torch.utils.timeseries import HistoryRecorder
from pinot_tpu_torch.utils.trace import NULL_TRACE, TraceContext, reset_current, set_current

logger = logging.getLogger(__name__)


class _RooflineWindow:
    """Rolling window of device-served query records behind the
    ``device.util.achieved*`` gauges: the achieved bytes/s and FLOP/s of
    the trailing ``window_s`` seconds (each record's ``deviceMs`` and
    ``deviceBytes`` from the cost vector, its flops from the digest's
    static cost), and the roofline fraction against the card's declared
    peaks.  Records happen on the request path, on the host."""

    def __init__(self, window_s: float = 300.0, capacity: int = 2048) -> None:
        self.window_s = window_s
        self._dq = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._cached: Optional[tuple] = None  # (monotonic t, snapshot)

    def record(self, device_ms: float, device_bytes: float, flops: float) -> None:
        with self._lock:
            self._dq.append((time.monotonic(), float(device_ms), float(device_bytes), float(flops)))
            self._cached = None

    def snapshot(self, since: Optional[float] = None) -> dict:
        """``since`` (a ``time.monotonic()`` stamp) narrows the window to
        the records at or after it (a caller excluding warm-up queries);
        the 0.5 s read cache serves only the full window."""
        now = time.monotonic()
        with self._lock:
            if since is None and self._cached is not None and now - self._cached[0] < 0.5:
                return dict(self._cached[1])
            horizon = now - self.window_s
            while self._dq and self._dq[0][0] < horizon:
                self._dq.popleft()
            records = list(self._dq) if since is None else [r for r in self._dq if r[0] >= since]
        ms = sum(r[1] for r in records)
        nbytes = sum(r[2] for r in records)
        flops = sum(r[3] for r in records)
        out = {
            "windowS": self.window_s,
            "queries": len(records),
            "deviceMs": round(ms, 3),
            "deviceBytes": int(nbytes),
            "achievedBytesPerSec": round(nbytes * 1000.0 / ms, 3) if ms > 0 else 0.0,
            "achievedFlopsPerSec": round(flops * 1000.0 / ms, 3) if ms > 0 else 0.0,
        }
        out["rooflineFraction"] = roofline_fractions(
            out["achievedBytesPerSec"], out["achievedFlopsPerSec"], peaks=platform_peaks()
        )["rooflineFraction"]
        if since is None:
            with self._lock:
                self._cached = (now, dict(out))
        return out


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
    (``QueryExecutor``).
    ``hbm_cap_bytes`` / ``host_cap_bytes`` / ``stage_cache_entries`` /
    ``residency_dir``: the executor's residency caps and cold spool."""

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
        hbm_cap_bytes: int = config.HBM_CAP_BYTES,
        host_cap_bytes: int = config.HOST_CAP_BYTES,
        stage_cache_entries: int = config.STAGE_CACHE_ENTRIES,
        residency_dir: Optional[str] = None,
    ) -> None:
        self.name = name
        self.device = config.resolve_device(device)
        if self.device.type == "cuda":
            # a failed kernel build raises here, before any thread starts
            kernels.load_all()
        self.data_manager = InstanceDataManager()
        # the controller's drain flag, as its heartbeat replies carry it
        self.draining = False
        self._table_schemas = {}  # raw table name -> Schema (set_table_schema)
        self.metrics = ServerMetrics(name)
        # the serving lease, renewed from heartbeat replies by the networked
        # starter: while it is expired the server keeps serving but has no
        # write authority (no commit, no new CONSUMING role); never granted
        # (in process, no gateway) is implicit authority
        self.lease = ServingLease(metrics=self.metrics)
        for m in ("lease.blockedCommits", "lease.blockedTransitions"):
            self.metrics.meter(m)
        # 1 while consecutive heartbeats to the controller fail
        self.metrics.gauge("controller.unreachable").set(0)
        self.metrics.meter("controller.heartbeatFailures")
        self.lanes = (
            LaneGroup(
                self.device,
                metrics=self.metrics,
                stall_timeout_s=lane_stall_timeout_s,
                fault_injector=device_fault_injector,
                precision=precision,
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
            hbm_cap_bytes=hbm_cap_bytes,
            host_cap_bytes=host_cap_bytes,
            stage_cache_entries=stage_cache_entries,
            residency_dir=residency_dir,
        )
        self.scheduler = QueryScheduler(
            num_workers=num_workers, max_pending=max_pending, metrics=self.metrics
        )
        # pre-register the serving series (zero > absent on a scrape);
        # lane.* and heal.* register in their constructors
        for m in ("queries", "queriesShed", "queriesAbandoned", "segmentsMissedServing",
                  "cost.docsScanned", "cost.bytesScanned", "crcFailures", "quarantinedSegments",
                  "plan.explains"):
            self.metrics.meter(m)
        for t in ("cost.deviceMs", "cost.hostMs"):
            self.metrics.timer(t)
        for k in self._TIER_KEYS:
            self.metrics.meter(f"cost.tier.{k}")
        # the distributed-join plane: extraction and hash-join counters
        for m in ("join.extracts", "join.execs", "join.buildRows",
                  "join.probeRows", "join.shuffleBytes", "join.broadcastBytes"):
            self.metrics.meter(m)
        # the staging ledger and the residency tiers (the executor's own)
        ledger, residency = self.executor.ledger, self.executor.residency
        self.metrics.gauge("hbm.stagedBytes").set_fn(ledger.total_bytes)
        self.metrics.gauge("hbm.highWatermarkBytes").set_fn(lambda: ledger.high_watermark)
        self.metrics.gauge("hbm.stagedTables").set_fn(ledger.table_count)
        self.metrics.gauge("hbm.evictedBytes").set_fn(lambda: ledger.evicted_bytes)
        self.metrics.gauge("residency.hotBytes").set_fn(residency.hot_bytes)
        self.metrics.gauge("residency.warmBytes").set_fn(residency.warm_bytes)
        self.metrics.gauge("residency.coldBytes").set_fn(residency.cold_bytes)
        self.metrics.gauge("residency.pressure").set_fn(residency.pressure)
        for counter in ("demotions", "promotions", "coldDemotions", "coldLoads", "pressureDemotions", "prefetches"):
            self.metrics.gauge(f"residency.{counter}").set_fn((lambda n: lambda: residency.counter(n))(counter))
        for tier in ("hot", "warm", "cold"):
            self.metrics.gauge(f"residency.{tier}Tables").set_fn(
                (lambda t: lambda: residency.snapshot()[f"{t}Tables"])(tier))
        # ingest backpressure, shared by every realtime consumer hosted
        # here: its device pool is the executor's staging ledger, and with
        # an HBM cap its residency pool the manager's pressure
        self.ingest_backpressure = IngestBackpressure(
            metrics=self.metrics,
            hbm_bytes_fn=self.executor.staged_bytes,
            mutable_bytes_fn=lambda: instance_mutable_bytes(self),
            residency=residency,
        )
        # the workload plane: per-plan-digest statistics of every handled
        # request (module docstring)
        self.plan_stats = PlanStatsStore()
        self.metrics.meter("plan.recorded")
        self.metrics.gauge("plan.digests").set_fn(self.plan_stats.digest_count)
        # the utilization plane: the roofline window, the profiler and the
        # lane's occupancy sampler (opt-in: the profiler brackets it)
        self._roofline_window = _RooflineWindow()
        self.profiler = DeviceProfiler(name=name, metrics=self.metrics)
        self.occupancy_sampler = OccupancySampler(self.lane) if self.lane is not None else None
        if self.occupancy_sampler is not None:
            # the sampler parks again when a capture ends (stop or auto-stop)
            self.profiler.on_capture_end = self._stop_samplers
            lanes = self.lanes
            self.metrics.gauge("device.util.busyFraction").set_fn(
                lambda: lanes.occupancy_read("gauge", min_interval_s=0.05)["busyFraction"])
            self.metrics.gauge("device.util.avgQueueDepth").set_fn(
                lambda: lanes.occupancy_read("gauge", min_interval_s=0.05)["avgQueueDepth"])
        else:
            self.metrics.gauge("device.util.busyFraction").set(0)
            self.metrics.gauge("device.util.avgQueueDepth").set(0)
        transfers = self.executor.transfers
        self.metrics.gauge("device.util.h2dBytes").set_fn(lambda: transfers.h2d_bytes)
        self.metrics.gauge("device.util.d2hBytes").set_fn(lambda: transfers.d2h_bytes)
        self.metrics.gauge("device.util.achievedBytesPerSec").set_fn(
            lambda: self._roofline_window.snapshot()["achievedBytesPerSec"])
        self.metrics.gauge("device.util.achievedFlopsPerSec").set_fn(
            lambda: self._roofline_window.snapshot()["achievedFlopsPerSec"])
        self.metrics.gauge("device.util.rooflineFraction").set_fn(
            lambda: self._roofline_window.snapshot()["rooflineFraction"])
        # the warm-start plane: inert until a starter wires a workload feed
        self.prewarm = PrewarmWorker(self)
        # the result cache, keyed on the exact data generation served
        # (segment names and staging tokens); off unless enabled
        self.result_cache = ResultCache(metrics=self.metrics)
        # the history plane: one thread samples this registry; heal activity
        # seen on its tick dumps a flight-recorder bundle (disabled unless
        # PINOT_TPU_FLIGHTREC_DIR is set)
        self.history = HistoryRecorder(self.metrics, metrics=self.metrics)
        self.flightrec = FlightRecorder(
            "server", name, metrics=self.metrics,
            sources={
                "history": lambda: self.history.query(window_s=900),
                "plans": lambda: self.plan_stats.snapshot(top=20),
                "device": self.device_utilization,
                "status": self.status,
                "audit": lambda: self.auditor.snapshot(),
            },
        )
        self._last_heal_total = 0
        self.history.add_tick_hook(self._history_tick)
        # the shadow audit: a 1-in-N sample of the device's replies re-run
        # on the host oracle in the background (PINOT_TPU_AUDIT_SAMPLE_N=0
        # turns it off)
        self.auditor = ShadowAuditor(self)

    # -- segment lifecycle -------------------------------------------
    def set_table_schema(self, table: str, schema) -> None:
        """Register (or evolve) the table's schema.  The loaded sealed
        segments get default columns for the fields they lack, so old rows
        keep answering after the schema grew instead of being pruned (the
        reference's SegmentPreProcessor -> BaseDefaultColumnHandler)."""
        raw = _raw_table(table)
        if self._table_schemas.get(raw) == schema:
            return  # unchanged: no retro-patch pass (a reload's CRC-skip path)
        self._table_schemas[raw] = schema
        for tname in self.data_manager.table_names():
            if _raw_table(tname) != raw:
                continue
            tdm = self.data_manager.table(tname)
            acquired = tdm.acquire_segments()
            try:
                for sdm in acquired:
                    # sealed segments only: a consuming MutableSegment keeps
                    # the schema it was created with until it seals (the
                    # reference applies a schema change to consuming
                    # segments at the next rollover)
                    if isinstance(sdm.segment, ImmutableSegment) and inject_default_columns(sdm.segment, schema):
                        # a patched segment is a new data generation: a new
                        # staging token, so no answer cached over its old
                        # columns can match it again
                        sdm.segment.staging_token = new_staging_token()
                        self.executor.evict_segment(sdm.segment.segment_name)
            finally:
                tdm.release_segments(acquired)
            self.result_cache.invalidate_table(raw)

    def add_segment(self, table: str, segment) -> None:
        """Host ``segment`` (an ``ImmutableSegment``, or a consuming
        ``MutableSegment``); one of the same name is replaced.  A sealed
        segment gets default columns for the table schema's fields it
        lacks.  The starters verify a copy's CRC before they call this:
        injected columns are not part of the on-disk CRC."""
        schema = self._table_schemas.get(_raw_table(table))
        if schema is not None and isinstance(segment, ImmutableSegment):
            inject_default_columns(segment, schema)
        self.data_manager.add_segment(table, segment)
        self.executor.evict_segment(segment.segment_name)
        # the segment set changed: answers cached over the old cover go
        self.result_cache.invalidate_table(_raw_table(table))
        # the hot working set may have grown: a prewarm pass (debounced;
        # inert without a workload feed)
        self.prewarm.request_prewarm(_raw_table(table))

    @staticmethod
    def _raw_table(table: str) -> str:
        return _raw_table(table)

    def remove_segment(self, table: str, name: str) -> None:
        tdm = self.data_manager.table(table)
        if tdm is not None:
            tdm.remove_segment(name)
        self.executor.evict_segment(name)
        self.result_cache.invalidate_table(_raw_table(table))

    def segment_crcs(self) -> dict:
        """``/debug/segments``: every hosted sealed segment's claimed CRC,
        for the controller's cross-replica CRC sweep (``CrcAuditManager``).
        Consuming mutable segments claim none yet and are left out."""
        out = {}
        for tname in self.data_manager.table_names():
            tdm = self.data_manager.table(tname)
            if tdm is None:
                continue
            acquired = tdm.acquire_segments()
            try:
                for sdm in acquired:
                    crc = getattr(getattr(sdm.segment, "metadata", None), "crc", None)
                    if crc is not None:
                        out.setdefault(tname, {})[sdm.name] = int(crc)
            finally:
                tdm.release_segments(acquired)
        return {"segments": out}

    def segment_copy_bytes(self, table: str, segment: str) -> Optional[bytes]:
        """This server's loaded copy of a sealed segment as segment-file
        bytes, for the deep-store scrubber repairing a lost or corrupt
        store copy from a live replica.  The copy is CRC-verified first, so
        a donor never launders its own rot into the store; None when the
        segment is not hosted here, is still consuming, or fails the check."""
        tdm = self.data_manager.table(table)
        if tdm is None:
            return None
        acquired = tdm.acquire_segments()
        try:
            for sdm in acquired:
                if sdm.name != segment:
                    continue
                seg = sdm.segment
                if not isinstance(seg, ImmutableSegment):
                    return None  # a consuming segment has no durable form
                try:
                    verify_segment_crc(seg, source=f"donor:{self.name}")
                except SegmentIntegrityError:
                    return None
                with tempfile.TemporaryDirectory() as td:
                    with open(write_segment(seg, td), "rb") as f:
                        return f.read()
        finally:
            tdm.release_segments(acquired)
        return None

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
        outcome = "ok"  # or "shed" / "failed": the plan statistics' verdict
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
            outcome = "shed"
            result = IntermediateResult(exceptions=[(ErrorCode.SERVER_SCHEDULER_DOWN, str(e))])
        except SchedulerShutdownError as e:
            # draining: typed 220 so the broker retries on a replica
            outcome = "shed"
            result = IntermediateResult(exceptions=[(ErrorCode.SERVER_SHUTTING_DOWN, str(e))])
        except QueryAbandonedError as e:
            # the deadline expired while queued; reply without executing
            self.metrics.meter("queriesAbandoned").mark()
            outcome = "shed"
            result = IntermediateResult(
                exceptions=[(ErrorCode.EXECUTION_TIMEOUT, f"server {self.name}: {e}")]
            )
        except (concurrent.futures.TimeoutError, TimeoutError):
            logger.warning("query %s timed out", req.get("requestId"))
            outcome = "failed"
            result = IntermediateResult(
                exceptions=[
                    (ErrorCode.EXECUTION_TIMEOUT, f"server {self.name}: exceeded {req['timeoutMs']}ms")
                ]
            )
        except Exception as e:  # execution error
            logger.exception("query %s failed", req.get("requestId"))
            outcome = "failed"
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
        exec_ms = (time.perf_counter() - t_start) * 1000
        self._record_plan_stats(req, result, outcome, exec_ms)
        self.metrics.timer("queryExecution").update(exec_ms)
        self.metrics.meter("queries").mark()
        # the event-time freshness stamp: a realtime table's reply carries
        # its stalest consumed partition's watermark; an offline table has
        # none and stamps nothing
        wm = WATERMARKS.table_min_ms(req["table"])
        if wm is not None:
            result.freshness = {"minEventMs": wm}
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
            result = self._process_traced(req, request, trace, deadline, t_enqueue)
        finally:
            reset_current(token)
        # the plan statistics' key, where the parsed request exists, so
        # the recording needs no second parse
        result._plan_digest = plan_shape_digest(request)
        result._plan_summary = plan_shape_summary(request)
        result._explain_mode = request.explain
        return result

    def _record_plan_stats(self, req: dict, result: IntermediateResult, outcome: str, exec_ms: float) -> None:
        """Fold one handled request into the per-plan-digest registry.
        Plain EXPLAIN is left out (it executed nothing).  A result without
        a digest was never parsed: a shed one is not re-parsed (the
        overload path must stay cheap), a failed one is, so failures link
        to their shape."""
        digest = getattr(result, "_plan_digest", None)
        summary = getattr(result, "_plan_summary", "")
        explain_mode = getattr(result, "_explain_mode", None)
        if digest is None:
            if outcome == "shed":
                return
            try:
                preq = optimize_request(parse_pql(req["pql"]))
            except Exception:
                return  # unparseable: nothing to key on
            digest, summary, explain_mode = plan_shape_digest(preq), plan_shape_summary(preq), preq.explain
        if explain_mode == "plan":
            return
        # the device-plan digest links the shape's measured time to the
        # lane's static cost of that digest (the roofline numerator)
        device_ms = float(result.cost.get("deviceMs", 0) or 0)
        host_ms = float(result.cost.get("hostMs", 0) or 0)
        device_info = None
        ddigest = getattr(result, "_device_digest", None)
        if ddigest is not None and self.lanes is not None:
            ci = self.lanes.compile_info(ddigest)
            if ci is not None:
                device_info = {"digest": ddigest}
                analysis = ci.get("costAnalysis")
                if isinstance(analysis, dict):
                    device_info.update({k: analysis[k] for k in ("flops", "bytesAccessed") if k in analysis})
        if device_ms > 0:
            self._roofline_window.record(
                device_ms, float(result.cost.get("deviceBytes", 0) or 0),
                float((device_info or {}).get("flops", 0) or 0))
        self.plan_stats.record(
            digest,
            summary=summary,
            table=req["table"],
            latency_ms=exec_ms,
            cost=result.cost,
            num_docs=result.num_docs_scanned,
            shed=(outcome == "shed"),
            failed=(outcome == "failed"),
            device_ms=device_ms or None,
            host_ms=host_ms or None,
            device_info=device_info,
        )
        self.metrics.meter("plan.recorded").mark()

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
                elif request.explain == "plan":
                    # EXPLAIN: the plan INSTEAD of execution, with no lane
                    # submission, no cost and nothing staged
                    with trace.span("explainPlan", segments=len(acquired)):
                        node = build_explain_node(self.executor, views, request, req["table"], self.name,
                                                  plan_stats=self.plan_stats, result_cache=self.result_cache)
                    node["mode"] = "plan"
                    self.metrics.meter("plan.explains").mark()
                    result = IntermediateResult(total_docs=int(node.get("totalDocs") or 0), plan_info=[node])
                else:
                    # the result cache: the key is the exact data generation
                    # (segment names and staging tokens), so a hit is as
                    # fresh as a re-execution and launches nothing.  EXPLAIN
                    # ANALYZE and partial covers bypass it; a result with
                    # exceptions is never stored
                    cache = self.result_cache
                    ckey = cache.key_for(request, views, req["table"]) if cache.enabled and not missing else None
                    result = cache.get(ckey) if ckey is not None else None
                    if result is not None:
                        trace.event("rescacheHit")
                    else:
                        with trace.span("planAndExecute", segments=len(acquired)):
                            result = self.executor.execute(views, request, deadline=deadline)
                        if ckey is not None and not result.exceptions:
                            cache.put(ckey, result)
                    if request.explain == "analyze":
                        result.plan_info = [self._analyze_node(views, request, req["table"], result)]
                    if not missing:
                        # the shadow audit's sampling hook: the job holds the
                        # views, so it re-runs over the snapshot served
                        self.auditor.offer(req, request, views, result)
                result.unserved_segments = missing
            finally:
                tdm.release_segments(acquired)
        if trace.enabled:
            result.trace.update(trace.to_dict())
        return result

    def _analyze_node(self, views, request, table: str, result: IntermediateResult) -> dict:
        """EXPLAIN ANALYZE's node: the prediction built AFTER the execution
        (so the quarantine and compile state say what just happened),
        annotated with this reply's cost: the per-server actuals sum
        exactly to the broker's merged cost."""
        node = build_explain_node(self.executor, views, request, table, self.name, plan_stats=self.plan_stats,
                                  result_cache=self.result_cache)
        node["mode"] = "analyze"
        node["actualCost"] = _json_safe(dict(result.cost))
        node["actualDocsScanned"] = int(result.num_docs_scanned)
        dev_node = node.get("device")
        if isinstance(dev_node, dict) and "batching" in dev_node:
            # how many same-shape queries this execution's launch carried
            dev_node["batching"]["actualBatchSize"] = int(getattr(result, "_batch_size", 1) or 1)
        return node

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
                    # the result cache keys a colocated join on BOTH sides'
                    # data generations, so an advance on either side misses
                    cache = self.result_cache
                    ckey = (cache.key_for_join(request, views, b_views, req["table"], build_table)
                            if cache.enabled else None)
                    cached = cache.get(ckey) if ckey is not None else None
                    if cached is not None:
                        trace.event("rescacheHit")
                        return cached
                    result = self._join_exec(request, spec, right_f, right_cols, b_views,
                                             left_f, left_cols, views, deadline, trace)
                    result.num_segments_queried = len(views) + len(b_views)
                    if ckey is not None and not result.exceptions:
                        cache.put(ckey, result)
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
    def _history_tick(self, now: float) -> None:
        """The flight-recorder trigger on the history cadence: heal activity
        since the last sample (device failures, host failovers, CRC
        failures, lane restarts) dumps a bundle."""
        total = (
            self.metrics.meter("heal.deviceFailures").count
            + self.metrics.meter("heal.hostFailovers").count
            + self.metrics.meter("crcFailures").count
            + (0 if self.lanes is None else self.lanes.restart_count)
        )
        delta = total - self._last_heal_total
        self._last_heal_total = total
        if delta > 0:
            self.flightrec.maybe_dump("healEvent", {"healEventsThisTick": delta})

    def audit_snapshot(self) -> dict:
        """``/debug/audit``: the shadow auditor's counters and the
        quarantined (plan digest, tier) pairs."""
        return self.auditor.snapshot()

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
            "draining": self.draining,
            "warming": self.prewarm.warming,
            "ready": not self.prewarm.warming,
            "prewarm": self.prewarm.state(),
            "lease": self.lease.snapshot(),
            "scheduler": self.scheduler.stats(),
            "lane": None if self.lanes is None else self.lanes.stats(),
            "selfHealing": heal,
            "stagedBytes": self.executor.staged_bytes(),
            "stagedTables": self.executor.staged_tables(),
            "hbm": self.executor.ledger.snapshot(),
            # the caching allocator's bytes on the card, the staged tables'
            # and everything else (0 on the CPU)
            "memory": self._device_memory(),
            "residency": self.executor.residency.snapshot(),
            "transfers": self.executor.transfers.snapshot(),
            "ingest": self.ingest_backpressure.snapshot(),
            # the kernel wrappers' launch counts in this process (one-member
            # and batched launches apart)
            "kernelLaunches": {"k1": fused_groupby.launches, "k2": value_state_counts.launches,
                               "k1Batched": fused_groupby.batched_launches,
                               "k2Batched": value_state_counts.batched_launches},
            # the utilization plane (device_utilization) and the plan
            # statistics' head
            "device": self.device_utilization(),
            "rescache": self.result_cache.snapshot(),
            "audit": self.auditor.snapshot(),
            "plans": self.plan_stats.snapshot(top=20),
            "metrics": self.metrics.snapshot(),
        }

    def profile_start(self, timeout_s: Optional[float] = None) -> dict:
        """Begin (or join) an on-demand profile capture: the
        ``torch.profiler`` session and, for its duration, the lane's
        occupancy sampler.  Raises ``ProfilerUnavailableError`` (a typed
        404 on the admin surface) without a working profiler."""
        snap = self.profiler.start(timeout_s)
        if self.occupancy_sampler is not None:
            self.occupancy_sampler.start()
        return snap

    def _stop_samplers(self) -> None:
        if self.occupancy_sampler is not None:
            self.occupancy_sampler.stop()

    def profile_stop(self) -> dict:
        """Release one profile start; the sampler parks when the capture
        ends (the count at zero, the ``on_capture_end`` hook)."""
        return self.profiler.stop()

    def device_utilization(self, roofline_since: Optional[float] = None) -> dict:
        """The utilization snapshot (``status()["device"]``,
        ``/debug/device``, the unit of the controller's
        ``/debug/utilization``): the device and its declared peaks, the
        lane's windowed occupancy, the transfer totals, the recent
        achieved-rate window (narrowed to records at or after the
        ``roofline_since`` monotonic stamp), the profiler's state and,
        while the sampler runs or has run, its series."""
        occupancy = None
        if self.lanes is not None:
            occupancy = self.lanes.occupancy_read("status")
            occupancy["open"] = self.lanes.stats().get("open", 0)
        out = {
            "device": str(self.device),
            "platform": platform_peaks(),
            "occupancy": occupancy,
            "transfers": self.executor.transfers.snapshot(),
            "recent": self._roofline_window.snapshot(since=roofline_since),
            "profiler": self.profiler.snapshot(),
        }
        sampler = self.occupancy_sampler
        if sampler is not None and (sampler.running or sampler.samples_taken):
            out["sampler"] = sampler.snapshot()
        return out

    def _device_memory(self) -> dict:
        if self.device.type != "cuda":
            return {"allocatedBytes": 0, "reservedBytes": 0}
        return {"allocatedBytes": torch.cuda.memory_allocated(self.device),
                "reservedBytes": torch.cuda.memory_reserved(self.device)}

    def metrics_text(self) -> str:
        """Prometheus exposition of this server's registry."""
        return prometheus_text(self.metrics)

    def shutdown(self) -> None:
        """Idempotent: drain-stop the scheduler, stop the prewarm worker,
        the occupancy sampler and any profile capture, and close the device
        lane (queued lane waiters fail fast with ``LaneClosedError``), then
        wait (bounded) for their threads to exit: a daemon thread still
        inside torch while the interpreter tears down aborts the
        process.  The auditor and the history recorder stop first."""
        self.scheduler.shutdown()
        self.prewarm.stop()
        self.auditor.stop()
        self.history.stop()
        self._stop_samplers()
        self.profiler.shutdown()
        if self.lanes is not None:
            self.lanes.close()
        self.scheduler.join()
        if self.lanes is not None:
            self.lanes.join()
