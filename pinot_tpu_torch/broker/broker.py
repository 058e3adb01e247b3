"""Broker: PQL front door — parse, route, scatter-gather, reduce (trimmed
port of ``pinot_tpu.broker.broker``).

The reference flow (``BrokerRequestHandler.java:139``): compile PQL ->
optimize -> look up routing table -> scatter InstanceRequests ->
gather DataTables (per-server errors become response exceptions, the
healthy partials still reduce, :443-460) -> BrokerReduceService ->
JSON.  Hybrid tables federate into offline+realtime sub-queries split
at the time boundary (``broker/time_boundary.py``).

The gather loop is an event loop over attempt futures that fails over:
a transport error, a per-attempt timeout, or a retryable server error
(210 saturated / 220 shutting down / 230 segments missing) re-issues the
failed attempt's segment set to an alternate replica with capped
exponential backoff, under the query's total deadline.  With
``hedge_delay_ms`` > 0 (off by default) a straggling attempt's segment set
is re-sent once to an alternate replica covering all of it, after the
observed server-latency percentile (the static delay until 20 samples),
and the first reply wins; the loser's launch still runs to its end on
its server, only its reply is dropped.  Each attempt
carries the REMAINING deadline, so servers shed work the broker already
gave up on; a per-server circuit breaker (``broker/health.py``) steers
routing off repeat offenders; segments still unserved after retries
flip ``partialResponse`` and count into ``numSegmentsUnserved``.

A two-table join goes to the join coordinator (``broker/joinplan.py``):
the colocated, broadcast or shuffle strategy, each phase a scatter-gather
whose requests carry the phase's join context (``extra_fn``).

``BrokerHttpServer`` is the client's endpoint: ``GET /query?pql=`` and
``POST /query {"pql": ...}`` answer the broker response JSON.

EXPLAIN: every response carries the literal-erased plan digest
(``engine/plandigest.py``).  ``EXPLAIN`` / ``EXPLAIN PLAN FOR`` scatters
as any query; each server answers its plan node instead of executing, and
the broker returns the assembled tree (``_assemble_explain``) INSTEAD of
results.  ``EXPLAIN ANALYZE`` reduces the results as usual and adds the
tree, whose actual cost is the response's.  A join's EXPLAIN is the join
coordinator's shell (``broker/joinplan.py``).

ADMISSION (``broker/admission.py``): one front door for every shed tier:
a table's query-rate quota (``broker/quota.py``, fed from the table
configs), the per-table in-flight cap, and, after routing, the AIMD
per-server windows fed by each reply's backpressure snapshot.  Each sheds
with ``TOO_MANY_REQUESTS`` (429) before any scatter.

WORKLOAD: every merged response lands in a per-plan-digest registry
(``utils/planstats.py``; plain EXPLAIN left out), behind
``/debug/workload`` (top-K by frequency and by cost, each with an
exemplar query): the fleet feed a prewarming server pulls through the
controller.  Its roofline is suppressed: a fleet-merged rate over this
process's peak is not a roofline.

THE OBSERVABILITY PLANES: the slow-query log (``broker/querylog.py``,
``/debug/queries``); one history thread (``utils/timeseries.py``,
``/debug/history``) whose tick evaluates the per-table SLO burn rates
(``utils/slo.py``, ``/debug/slo``) and the flight recorder's triggers
(``utils/flightrec.py``, ``/debug/flightrec``); the tail sampler
(``utils/tailsample.py``, ``/debug/tails``), which arms the span tree on
every query and keeps the slow, failed and partial ones; the replica
auditor (``utils/audit.py``, ``/debug/audit``).  A realtime answer carries
``freshnessMs``: now minus the stalest watermark the servers stamped
(``broker/freshness.py``).
"""
from __future__ import annotations

import concurrent.futures
import json
import logging
import math
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Set, Tuple
from urllib.parse import parse_qs, urlparse

from pinot_tpu_torch.broker.admission import AdmissionController
from pinot_tpu_torch.broker.freshness import WATERMARKS, now_ms
from pinot_tpu_torch.broker.health import ServerHealthTracker
from pinot_tpu_torch.broker.joinplan import JoinCoordinator
from pinot_tpu_torch.broker.querylog import SlowQueryLog
from pinot_tpu_torch.broker.quota import QueryQuotaManager
from pinot_tpu_torch.broker.routing import RoutingTableProvider
from pinot_tpu_torch.broker.time_boundary import TimeBoundaryService
from pinot_tpu_torch.common.conf import env_int
from pinot_tpu_torch.common.datatable import deserialize_result, serialize_instance_request
from pinot_tpu_torch.common.request import BrokerRequest
from pinot_tpu_torch.common.response import BrokerResponse, ErrorCode, QueryException
from pinot_tpu_torch.engine.plandigest import plan_shape_digest, plan_shape_summary
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.engine.results import IntermediateResult
from pinot_tpu_torch.pql import PqlParseError, optimize_request, parse_pql
from pinot_tpu_torch.utils.audit import ReplicaAuditor
from pinot_tpu_torch.utils.flightrec import FlightRecorder
from pinot_tpu_torch.utils.planstats import PlanStatsStore
from pinot_tpu_torch.utils.metrics import BrokerMetrics, prometheus_text
from pinot_tpu_torch.utils.slo import SloTracker
from pinot_tpu_torch.utils.tailsample import TailSampler
from pinot_tpu_torch.utils.timeseries import HistoryRecorder
from pinot_tpu_torch.utils.trace import NULL_TRACE, TraceContext, merge_scope

logger = logging.getLogger(__name__)

OFFLINE_SUFFIX = "_OFFLINE"
REALTIME_SUFFIX = "_REALTIME"

# server-reply error codes that mean "this replica cannot serve right
# now, another may": the attempt fails over instead of degrading the
# query (fatal codes like QUERY_EXECUTION would fail identically on
# every replica and do not retry)
RETRYABLE_SERVER_CODES = frozenset(
    {
        ErrorCode.SERVER_SCHEDULER_DOWN,
        ErrorCode.SERVER_SHUTTING_DOWN,
        ErrorCode.SERVER_SEGMENT_MISSING,
    }
)


class _Batch:
    """One segment set bound for one server: the unit of scatter, failover
    and hedging.  A failover spawns child batches (possibly splitting
    segments across replicas); the parent is then superseded."""

    __slots__ = (
        "table", "pql", "segments", "server", "excluded",
        "reissues", "errors", "done", "inflight", "order",
        "hedged", "first_sent",
    )

    def __init__(
        self,
        table: str,
        pql: str,
        segments: List[str],
        server: str,
        excluded: Optional[Set[str]] = None,
        reissues: int = 0,
        errors: Optional[List[QueryException]] = None,
        order: int = 0,
    ) -> None:
        self.table = table
        self.pql = pql
        self.segments = list(segments)
        self.server = server
        self.order = order
        self.excluded: Set[str] = set(excluded or ()) | {server}
        self.reissues = reissues
        self.errors: List[QueryException] = list(errors or ())
        self.done = False
        self.inflight = 0
        self.hedged = False
        self.first_sent = 0.0


class BrokerRequestHandler:
    """``transport``: ``request(address, payload, timeout) -> bytes``
    (``transport/local.py`` or ``transport/tcp.py``).
    ``server_addresses``: server name -> transport address.
    ``routing``: the table -> {server: segments} covers.
    ``timeout_ms``: the broker's per-query budget, also the ceiling of a
    per-query override.  ``hedge_delay_ms`` (0: no hedging),
    ``hedge_latency_percentile`` and ``hedge_min_quota_headroom`` (no
    hedge while the table's quota headroom is below it) arm hedging;
    ``max_inflight_per_table`` and the ``admission_*`` arguments set the
    admission controller (None: the environment's knobs)."""

    def __init__(
        self,
        transport,
        server_addresses: Dict[str, Tuple[str, int]],
        routing: Optional[RoutingTableProvider] = None,
        timeout_ms: float = 15_000.0,
        time_boundary: Optional[TimeBoundaryService] = None,
        name: str = "broker0",
        retry_attempts: int = 2,
        retry_backoff_ms: float = 25.0,
        retry_backoff_cap_ms: float = 1_000.0,
        hedge_delay_ms: float = 0.0,
        hedge_latency_percentile: float = 95.0,
        hedge_min_quota_headroom: float = 0.1,
        health: Optional[ServerHealthTracker] = None,
        max_inflight_per_table: Optional[int] = None,
        admission_window_init: Optional[float] = None,
        admission_window_max: Optional[float] = None,
        admission_pending_high_water: Optional[float] = None,
    ) -> None:
        self.transport = transport
        self.server_addresses = dict(server_addresses)
        self.routing = routing or RoutingTableProvider()
        self.time_boundary = time_boundary or TimeBoundaryService()
        self.timeout_ms = timeout_ms
        self.name = name
        self.metrics = BrokerMetrics(name)
        self.retry_attempts = max(0, retry_attempts)
        self.retry_backoff_ms = retry_backoff_ms
        self.retry_backoff_cap_ms = retry_backoff_cap_ms
        self.hedge_delay_ms = hedge_delay_ms
        self.hedge_latency_percentile = hedge_latency_percentile
        self.hedge_min_quota_headroom = hedge_min_quota_headroom
        self.health = health or ServerHealthTracker()
        self._request_id = 0
        self._id_lock = threading.Lock()
        # globally-unique request ids: broker name + a process-unique
        # token + a per-broker sequence
        self._id_prefix = f"{name}-{uuid.uuid4().hex[:6]}"
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=16)
        # per-table query-rate quotas (QuotaConfig.maxQueriesPerSecond),
        # fed by the controller's table configs, behind the admission
        # controller's front door
        self.quota = QueryQuotaManager()
        self.admission = AdmissionController(
            quota=self.quota,
            max_inflight_per_table=max_inflight_per_table,
            initial_window=admission_window_init,
            max_window=admission_window_max,
            pending_high_water=admission_pending_high_water,
            metrics=self.metrics,
        )
        self.querylog = SlowQueryLog()
        # the workload plane (module docstring)
        self.planstats = PlanStatsStore()
        for m in ("queries", "failoverRetries", "hedgesSent", "slowQueries", "cost.docsScanned",
                  "cost.bytesScanned", "explain.queries", "queriesDropped", "workload.recorded"):
            self.metrics.meter(m)
        for t in ("cost.deviceMs", "cost.hostMs", "freshness.lagMs"):
            self.metrics.timer(t)
        # the distributed join plane: strategy planner and multi-phase
        # exchange coordinator (registers its join.* meters)
        self.joinplan = JoinCoordinator(self)
        # the SLO and tail planes: one history thread samples this registry
        # and the per-table SLO counters; burn evaluation and the flight
        # recorder's triggers ride its tick
        self.history = HistoryRecorder(self.metrics, metrics=self.metrics)
        self.slo = SloTracker(history=self.history, metrics=self.metrics)
        self.history.register_provider(self.slo.series)
        self.tail = TailSampler(metrics=self.metrics)
        self.flightrec = FlightRecorder(
            "broker", name, metrics=self.metrics,
            sources={
                "history": lambda: self.history.query(window_s=900),
                "slowQueries": self.querylog.snapshot,
                "tails": lambda: self.tail.snapshot(include_traces=True),
                "slo": self.slo.snapshot,
                "workload": lambda: self.workload_snapshot(top=20),
                "admission": self.admission.snapshot,
                "audit": lambda: self.replica_audit.snapshot(),
            },
        )
        # the replica auditor (PINOT_TPU_AUDIT_REPLICA_N=0 turns it off)
        self.replica_audit = ReplicaAuditor(self)
        self._last_dropped = 0
        self._shed_burst_threshold = max(1, env_int("PINOT_TPU_FLIGHTREC_SHED_BURST", 32))
        self.history.add_tick_hook(self._history_tick)

    @classmethod
    def from_conf(cls, transport, server_addresses, conf, **overrides) -> "BrokerRequestHandler":
        """A handler from a ``BrokerConf`` (``pinot.broker.*`` keys): the
        retry, hedge, circuit-breaker and admission knobs."""
        kwargs = dict(
            timeout_ms=float(conf.timeout_ms),
            name=conf.instance_id,
            routing=RoutingTableProvider(num_tables=conf.routing_table_count),
            retry_attempts=conf.retry_attempts,
            retry_backoff_ms=conf.retry_backoff_ms,
            retry_backoff_cap_ms=conf.retry_backoff_cap_ms,
            hedge_delay_ms=conf.hedge_delay_ms,
            hedge_latency_percentile=conf.hedge_latency_percentile,
            hedge_min_quota_headroom=conf.hedge_min_quota_headroom,
            health=ServerHealthTracker(
                failure_threshold=conf.health_failure_threshold, penalty_ms=conf.health_penalty_ms),
            max_inflight_per_table=conf.admission_table_inflight,
            admission_window_init=conf.admission_window_init,
            admission_window_max=conf.admission_window_max,
            admission_pending_high_water=conf.admission_pending_high_water,
        )
        kwargs.update(overrides)
        return cls(transport, server_addresses, **kwargs)

    def set_server_address(self, server: str, address: Tuple[str, int]) -> None:
        self.server_addresses[server] = address

    def _next_request_id(self) -> str:
        with self._id_lock:
            self._request_id += 1
            n = self._request_id
        return f"{self._id_prefix}-{n}"

    def shutdown(self) -> None:
        """Stop the replica auditor and the history thread, then the
        scatter pool (in-flight attempts finish)."""
        self.replica_audit.stop()
        self.history.stop()
        self._pool.shutdown(wait=False)

    def _history_tick(self, now: float) -> None:
        """On every history sample: the SLO burn evaluation and the
        broker's flight-recorder triggers (a burn crossing, a shed
        burst)."""
        ev = self.slo.evaluate()
        for table in ev.get("crossed", ()):
            t = ev["tables"].get(table, {})
            self.flightrec.maybe_dump(
                "sloBurn", {"table": table, "burnRate5m": t.get("burnRate5m"), "burnRate1h": t.get("burnRate1h")})
        dropped = self.metrics.meter("queriesDropped").count
        delta = dropped - self._last_dropped
        self._last_dropped = dropped
        if delta >= self._shed_burst_threshold:
            self.flightrec.maybe_dump("shedBurst", {"droppedThisTick": delta})

    # ------------------------------------------------------------------
    def handle_pql(
        self,
        pql: str,
        trace: bool = False,
        debug_options: Optional[Dict[str, str]] = None,
        timeout_ms: Optional[float] = None,
    ) -> BrokerResponse:
        t0 = time.perf_counter()
        self.metrics.meter("queries").mark()
        request_id = self._next_request_id()
        # with the tail sampler armed (the default) every query carries the
        # span tree, so the retention decision can happen at completion;
        # with it off (PINOT_TPU_TAIL_TRACE=0) untraced queries share the
        # NULL context and allocate no spans
        ctx = (
            TraceContext(enabled=True, scope=self.name, trace_id=request_id)
            if trace or self.tail.armed
            else NULL_TRACE
        )
        resp: Optional[BrokerResponse] = None
        request: Optional[BrokerRequest] = None
        plan_digest = ""
        plan_summary = ""
        with ctx.span("query", requestId=request_id, pql=pql[:200]):
            t_parse = time.perf_counter()
            try:
                with ctx.span("parse"):
                    request = parse_pql(pql)
                    if debug_options:
                        request.debug_options = dict(debug_options)
                    request = optimize_request(request)
                # the literal-erased shape digest rides every response
                plan_digest = plan_shape_digest(request)
                plan_summary = plan_shape_summary(request)
                if request.explain:
                    self.metrics.meter("explain.queries").mark()
            except PqlParseError as e:
                resp = BrokerResponse(exceptions=[QueryException(ErrorCode.PQL_PARSING, str(e))])
            parse_ms = (time.perf_counter() - t_parse) * 1000
            self.metrics.timer("phase.parse").update(parse_ms)
            if resp is None:
                request.enable_trace = ctx.enabled
                resp = self.handle_request(
                    request, pql, timeout_ms=timeout_ms, request_id=request_id, trace_ctx=ctx
                )
        # traceInfo rides the response only when the caller asked: the
        # armed span trees reach the tail sampler through the side channel
        resp.trace_info = {}
        resp.request_id = request_id
        resp.time_used_ms = (time.perf_counter() - t0) * 1000
        self.metrics.timer("queryTotal").update(resp.time_used_ms)
        table = getattr(request, "table_name", "") or ""
        shed = any(e.error_code == ErrorCode.TOO_MANY_REQUESTS for e in resp.exceptions)
        failed = bool(resp.exceptions)
        if plan_digest:
            resp.plan_digest = plan_digest
            if request.explain != "plan":
                # every executed query lands in the per-digest registry
                # (plain EXPLAIN did no work and must not skew the rankings)
                self.planstats.record(
                    plan_digest, summary=plan_summary, table=table, latency_ms=resp.time_used_ms,
                    cost=resp.cost, num_docs=resp.num_docs_scanned, shed=shed, failed=failed and not shed,
                    pql=pql,
                )
                self.metrics.meter("workload.recorded").mark()
        tail_reason = None
        if ctx.enabled:

            def build_scopes() -> Dict[str, Any]:
                # the per-server span trees re-parented under the scatter
                # attempts that carried them, next to this broker's own
                # tree; deferred, so a tail that is not kept never merges
                scopes: Dict[str, Any] = {}
                merge_scope(scopes, ctx.to_dict())
                for attempt_id, server_trace in getattr(resp, "_server_traces", ()) or ():
                    merge_scope(scopes, server_trace, root_parent=attempt_id)
                return scopes

            built = None
            if trace:
                built = build_scopes()
                resp.trace_info = {"traceId": request_id, "scopes": built}
            if self.tail.armed:
                # a shed is a typed overload verdict, not a tail worth a
                # span tree (the SLO still counts it below)
                tail_reason = self.tail.observe(
                    request_id, resp.time_used_ms, failed and not shed, resp.partial_response,
                    (lambda b=built: b) if built is not None else build_scopes,
                    table=table, plan_digest=plan_digest, summary=plan_summary,
                )
        self.slo.observe(table, resp.time_used_ms, failed, freshness_ms=resp.freshness_ms)
        phases = dict(getattr(resp, "phase_ms", ()) or ())
        phases["parse"] = round(parse_ms, 3)
        if self.querylog.observe({
            "traceRetained": bool(tail_reason),
            **({"traceRef": f"/debug/tails?requestId={request_id}"} if tail_reason else {}),
            "requestId": request_id,
            "pql": pql[:500],
            "planDigest": plan_digest,
            "table": getattr(request, "table_name", None),
            "timeUsedMs": round(resp.time_used_ms, 3),
            "freshnessMs": round(resp.freshness_ms, 3) if resp.freshness_ms is not None else None,
            "phasesMs": phases,
            "numDocsScanned": resp.num_docs_scanned,
            "cost": {k: (round(v, 3) if isinstance(v, float) else v) for k, v in sorted(resp.cost.items())},
            "partialResponse": resp.partial_response,
            "numServersQueried": resp.num_servers_queried,
            "numServersResponded": resp.num_servers_responded,
            "numSegmentsUnserved": resp.num_segments_unserved,
            "numRetries": resp.num_retries,
            "numHedges": resp.num_hedges,
            "exceptions": [e.error_code for e in resp.exceptions],
            "traced": trace,
        }):
            self.metrics.meter("slowQueries").mark()
        if failed and any(e.error_code not in (ErrorCode.TOO_MANY_REQUESTS, ErrorCode.PQL_PARSING)
                          for e in resp.exceptions):
            # a query that really failed (not a shed, not a client's parse
            # error) dumps the state that explains it
            self.flightrec.maybe_dump(
                "failedQuery",
                {"requestId": request_id, "table": getattr(request, "table_name", None),
                 "codes": [e.error_code for e in resp.exceptions]},
            )
        return resp

    def workload_snapshot(self, top: int = 20, tables=None) -> Dict[str, Any]:
        """``/debug/workload``: the per-plan-digest roll-up, top-K by
        frequency and by total cost.  ``top`` at the registry's capacity
        returns all of it (the controller's fleet roll-up merges whole
        registries); ``tables`` narrows it to the shapes of those tables
        (the feed of a prewarming server)."""
        return {
            "digests": self.planstats.digest_count(),
            "totalRecorded": self.planstats.total_recorded,
            "topByCount": self.planstats.top(top, by="count", tables=tables),
            "topByCost": self.planstats.top(top, by="cost", tables=tables),
        }

    def handle_request(
        self,
        request: BrokerRequest,
        pql: str,
        timeout_ms: Optional[float] = None,
        request_id: Optional[str] = None,
        trace_ctx: Optional[TraceContext] = None,
    ) -> BrokerResponse:
        ctx = trace_ctx if trace_ctx is not None else NULL_TRACE
        if request_id is None:
            request_id = self._next_request_id()
        # a per-query override may shorten the broker's timeout, never
        # extend it; a present-but-invalid one is a client error
        try:
            timeout_ms = _parse_timeout(timeout_ms)
        except InvalidTimeoutError as e:
            return BrokerResponse(
                exceptions=[QueryException(ErrorCode.QUERY_VALIDATION, str(e))],
                request_id=request_id,
            )
        timeout_ms = self.timeout_ms if timeout_ms is None else min(timeout_ms, self.timeout_ms)
        table = request.table_name
        # the admission front door: the quota's bucket, then the per-table
        # in-flight cap, each shed with a typed 429 naming its tier
        decision = self.admission.try_admit(table)
        if not decision.admitted:
            self.metrics.meter("queriesDropped").mark()
            return BrokerResponse(
                exceptions=[QueryException(ErrorCode.TOO_MANY_REQUESTS, decision.message)],
                request_id=request_id,
            )
        try:
            return self._handle_admitted(request, pql, timeout_ms, request_id, ctx, table)
        finally:
            # the in-flight slot frees when the query leaves the broker
            self.admission.release(table)

    def _handle_admitted(
        self,
        request: BrokerRequest,
        pql: str,
        timeout_ms: float,
        request_id: str,
        ctx: TraceContext,
        table: str,
    ) -> BrokerResponse:
        if request.join is not None:
            # a broker-planned distributed join: strategy choice and a
            # scatter-gather per phase
            with ctx.span("joinPlan", table=table):
                resp = self.joinplan.handle(request, pql, timeout_ms, request_id, ctx, table)
            resp.request_id = request_id
            resp._server_traces = getattr(resp, "_server_traces", [])
            return resp
        t_route = time.perf_counter()
        try:
            with ctx.span("route", table=table):
                physical = self._physical_tables(table, pql)
                if not physical:
                    return BrokerResponse(
                        exceptions=[
                            QueryException(
                                ErrorCode.BROKER_RESOURCE_MISSING, f"no routing for table {table}"
                            )
                        ],
                        request_id=request_id,
                    )
                exceptions: List[QueryException] = []
                batches: List[_Batch] = []
                routing_gap = False
                for phys_table, sub_pql in physical:
                    routing = self.routing.find_servers(phys_table, health=self.health)
                    if not routing:
                        # unknown table, or an external view refilling
                        # after a restart: surface a retriable error
                        # rather than silently dropping the table
                        routing_gap = True
                        exceptions.append(
                            QueryException(
                                ErrorCode.BROKER_RESOURCE_MISSING,
                                f"no servers currently serving table {phys_table}",
                            )
                        )
                        continue
                    for server, segments in routing.items():
                        batches.append(
                            _Batch(phys_table, sub_pql, segments, server, order=len(batches))
                        )
        finally:
            self.metrics.timer("phase.route").update((time.perf_counter() - t_route) * 1000)

        # the AIMD check: when every server covering the table is past its
        # window, a scatter could only end in 210s or timeouts
        if batches:
            cover = self.admission.check_cover(table, sorted({b.server for b in batches}))
            if not cover.admitted:
                self.metrics.meter("queriesDropped").mark()
                return BrokerResponse(
                    exceptions=exceptions + [QueryException(ErrorCode.TOO_MANY_REQUESTS, cover.message)],
                    request_id=request_id,
                )

        t_sg = time.perf_counter()
        with ctx.span("scatterGather", batches=len(batches)):
            parts, sg = self._scatter_gather(request, batches, timeout_ms, table, request_id, ctx)
        exceptions.extend(sg["exceptions"])
        sg_ms = (time.perf_counter() - t_sg) * 1000
        self.metrics.timer("scatterGather").update(sg_ms)

        t_red = time.perf_counter()
        for p in parts:
            for code, msg in p.exceptions:
                exceptions.append(QueryException(code, msg))
        # the plan nodes are collected BEFORE the reduce, which folds the
        # parts in place: each server's node must survive it
        plan_nodes = [n for p in parts for n in (p.plan_info or [])] if request.explain else []
        if request.explain == "plan":
            # EXPLAIN returns the plan INSTEAD of results: the servers
            # executed nothing, there is nothing to reduce
            resp = BrokerResponse(exceptions=exceptions)
        else:
            with ctx.span("reduce", parts=len(parts)):
                resp = reduce_to_response(request, parts, exceptions)
        red_ms = (time.perf_counter() - t_red) * 1000
        self.metrics.timer("reduce").update(red_ms)
        resp.request_id = request_id
        # event-time freshness: now minus the stalest realtime watermark
        # that reached this answer (the servers' stamps, MIN-combined); an
        # offline-only answer has no stamp and keeps the key absent
        fmins = [p.freshness["minEventMs"] for p in parts
                 if p.freshness is not None and p.freshness.get("minEventMs") is not None]
        if fmins:
            resp.freshness_ms = max(0.0, now_ms() - min(fmins))
            self.metrics.timer("freshness.lagMs").update(resp.freshness_ms)
            self.metrics.gauge(f"freshness.{table}.lagMs").set(round(resp.freshness_ms, 3))
        if request.explain:
            resp.explain = self._assemble_explain(request, plan_nodes, resp)
        self.metrics.meter("cost.docsScanned").mark(int(resp.num_docs_scanned))
        self.metrics.meter("cost.bytesScanned").mark(int(resp.cost.get("bytesScanned", 0)))
        self.metrics.meter(f"table.{table}.docsScanned").mark(int(resp.num_docs_scanned))
        self.metrics.meter(f"table.{table}.bytesScanned").mark(
            int(resp.cost.get("bytesScanned", 0))
        )
        for key, timer in (("deviceMs", "cost.deviceMs"), ("hostMs", "cost.hostMs")):
            ms = resp.cost.get(key)
            if ms:
                self.metrics.timer(timer).update(float(ms))
        # the join planner's size estimator learns table totals from every
        # merged scan reply
        if resp.total_docs:
            self.joinplan.stats.observe(table, resp.total_docs)
        resp.num_servers_queried = len(sg["servers_queried"])
        resp.num_servers_responded = len(sg["servers_responded"])
        resp.num_segments_unserved = len(sg["unserved"])
        resp.partial_response = bool(sg["unserved"]) or routing_gap
        resp.num_retries = sg["retries"]
        resp.num_hedges = sg["hedges"]
        # side channel for handle_pql (not serialized into the response):
        # per-server trace trees keyed by the attempt span that carried
        # them, and the phase split
        resp._server_traces = sg["server_traces"]
        resp.phase_ms = {"scatterGather": round(sg_ms, 3), "reduce": round(red_ms, 3)}
        # the replica audit's sampling hook: a counter for the majority, a
        # bounded background re-issue for the sampled
        self.replica_audit.offer(request, batches, request_id, timeout_ms, resp)
        return resp

    # ------------------------------------------------------------------
    # resilient scatter-gather
    # ------------------------------------------------------------------
    def _backoff_s(self, reissues: int) -> float:
        return (
            min(self.retry_backoff_ms * (2 ** max(0, reissues - 1)), self.retry_backoff_cap_ms)
            / 1000.0
        )

    def _assemble_explain(
        self, request: BrokerRequest, nodes: List[Dict[str, Any]], resp: BrokerResponse
    ) -> Dict[str, Any]:
        """The broker's EXPLAIN tree: the servers' plan nodes under one roof,
        with the tier counts and estimated bytes summed.  For ANALYZE the top
        level carries the merged actuals (equal to ``BrokerResponse.cost``:
        only merged replies' nodes reach here)."""
        tier_counts: Dict[str, int] = {}
        est_bytes = 0.0
        for n in nodes:
            for k, v in (n.get("tierCounts") or {}).items():
                tier_counts[k] = tier_counts.get(k, 0) + int(v)
            est_bytes += float((n.get("estimatedCost") or {}).get("bytesScanned", 0))
        out: Dict[str, Any] = {
            "mode": request.explain,
            "planDigest": plan_shape_digest(request),
            "summary": plan_shape_summary(request),
            "numServers": len(nodes),
            "tierCounts": tier_counts,
            "estimatedCost": {"bytesScanned": int(est_bytes)},
            "servers": nodes,
        }
        if request.explain == "analyze":
            out["actualCost"] = {k: (round(v, 3) if isinstance(v, float) else v) for k, v in sorted(resp.cost.items())}
            out["actualDocsScanned"] = resp.num_docs_scanned
            if resp.freshness_ms is not None:
                out["freshnessMs"] = round(resp.freshness_ms, 3)
        return out

    def _hedge_delay_s(self) -> Optional[float]:
        """The hedge's trigger delay: the observed server-latency
        percentile once 20 samples exist, else the configured delay;
        None (no hedging) while ``hedge_delay_ms`` <= 0."""
        if self.hedge_delay_ms <= 0:
            return None
        timer = self.metrics.timer("serverLatency")
        if timer.count >= 20:
            return max(timer.percentile(self.hedge_latency_percentile), 1.0) / 1000.0
        return self.hedge_delay_ms / 1000.0

    def _scatter_gather(
        self,
        request: BrokerRequest,
        batches: List[_Batch],
        timeout_ms: float,
        logical_table: str,
        request_id: str,
        ctx: TraceContext,
        extra_fn=None,
    ) -> Tuple[List[IntermediateResult], Dict[str, Any]]:
        """``extra_fn(server)``: the join context of a join phase's request
        to ``server``, derived at send time, so a failover child carries
        the context of its own server (``broker/joinplan.py``)."""
        deadline = time.monotonic() + timeout_ms / 1000.0
        # (batch.order, result): parts merge in BATCH CREATION order, not
        # completion order — ties in sort keys must not depend on which
        # server replied first
        ordered_parts: List[Tuple[int, IntermediateResult]] = []
        exceptions: List[QueryException] = []
        unserved: List[str] = []
        servers_queried: Set[str] = set()
        servers_responded: Set[str] = set()
        retries = 0
        hedges = 0
        hedge_delay_s = self._hedge_delay_s()
        if hedge_delay_s is not None and self.quota.headroom(logical_table) < self.hedge_min_quota_headroom:
            # a hedge doubles the table's scatter traffic: near its quota
            # that would starve first tries
            hedge_delay_s = None
        # future -> (batch, server, is_hedge, sent_at, wall_sent_ms)
        pending: Dict[concurrent.futures.Future, Tuple[_Batch, str, bool, float, float]] = {}
        all_batches: List[_Batch] = list(batches)
        delayed: List[Tuple[float, _Batch]] = []  # (fire_time, batch) backoff queue
        open_lineages = len(batches)  # batches neither completed nor superseded
        server_traces: List[Tuple[Optional[str], Dict[str, Any]]] = []

        def attempt_span(batch, server, hedge, sent_at, wall_sent, status, **tags) -> Optional[str]:
            return ctx.add(
                "serverAttempt",
                (time.monotonic() - sent_at) * 1000.0,
                start_ms=wall_sent,
                server=server,
                hedge=hedge,
                reissues=batch.reissues,
                segments=len(batch.segments),
                status=status,
                **tags,
            )

        def submit(batch: _Batch, server: str, hedge: bool = False) -> None:
            now = time.monotonic()
            remaining_ms = max(1.0, (deadline - now) * 1000.0)
            servers_queried.add(server)
            self.health.allow_request(server)
            # with retries in reserve AND an untried replica to fail over
            # to, wait only half the remaining budget on this attempt, so
            # a hung replica surfaces while there is time to re-issue
            attempt_ms = remaining_ms
            if self.retry_attempts - batch.reissues > 0 and not hedge and self.routing.has_alternate(
                batch.table, batch.segments, batch.excluded
            ):
                attempt_ms = remaining_ms / 2.0
            fut = self._pool.submit(
                self._send_one,
                server,
                batch.table,
                batch.pql,
                batch.segments,
                request.enable_trace,
                request.debug_options or None,
                remaining_ms,
                attempt_ms,
                request_id,
                extra_fn(server) if extra_fn is not None else None,
            )
            # the AIMD windows observe every attempt's outcome exactly
            # once, also an attempt that outlives this gather loop
            self.admission.on_attempt_start(server)
            fut.add_done_callback(lambda f, s=server: self._observe_attempt(f, s))
            batch.inflight += 1
            if not hedge:
                batch.first_sent = now
            pending[fut] = (batch, server, hedge, now, time.time() * 1000.0)

        def fail_batch(batch: _Batch) -> None:
            nonlocal open_lineages
            unserved.extend(batch.segments)
            exceptions.extend(batch.errors)
            batch.done = True
            open_lineages -= 1

        def spawn(parent: _Batch, server: str, segments: List[str], errors) -> _Batch:
            nonlocal open_lineages, retries
            child = _Batch(
                parent.table,
                parent.pql,
                segments,
                server,
                excluded=parent.excluded,
                reissues=parent.reissues + 1,
                errors=errors,
                order=parent.order,  # failover keeps the merge slot
            )
            all_batches.append(child)
            open_lineages += 1
            retries += 1
            self.metrics.meter("failoverRetries").mark()
            return child

        def failover(batch: _Batch) -> None:
            """All inflight attempts for this lineage failed: re-cover
            its segments on untried replicas, or declare them unserved."""
            nonlocal open_lineages
            if batch.reissues >= self.retry_attempts:
                fail_batch(batch)
                return
            assignment, leftover = self.routing.alternates(
                batch.table, batch.segments, batch.excluded, health=self.health
            )
            child_errors = batch.errors
            if leftover:
                exceptions.extend(batch.errors)
                unserved.extend(leftover)
                child_errors = []  # already reported
            if not assignment:
                if not leftover:
                    fail_batch(batch)
                else:
                    batch.done = True
                    open_lineages -= 1
                return
            batch.done = True  # superseded by its children
            open_lineages -= 1
            for server, segments in assignment.items():
                child = spawn(batch, server, segments, child_errors)
                ctx.event(
                    "failover",
                    fromServer=batch.server,
                    toServer=server,
                    segments=len(segments),
                    reissues=child.reissues,
                )
                fire = time.monotonic() + self._backoff_s(child.reissues)
                if fire >= deadline:
                    submit(child, server)  # no budget to back off
                else:
                    delayed.append((fire, child))

        for batch in batches:
            submit(batch, batch.server)

        while open_lineages > 0 and (pending or delayed):
            now = time.monotonic()
            if now >= deadline:
                break
            due = [(f, b) for f, b in delayed if f <= now]
            if due:
                delayed = [(f, b) for f, b in delayed if f > now]
                for _, batch in due:
                    submit(batch, batch.server)
            # arm hedges on stragglers
            next_hedge = math.inf
            if hedge_delay_s is not None:
                for batch, server, hedge, _sent, _wall in list(pending.values()):
                    if hedge or batch.done or batch.hedged:
                        continue
                    fire = batch.first_sent + hedge_delay_s
                    if fire > now:
                        next_hedge = min(next_hedge, fire)
                        continue
                    assignment, leftover = self.routing.alternates(
                        batch.table, batch.segments, batch.excluded, health=self.health
                    )
                    batch.hedged = True  # one hedge round a lineage
                    # a hedge's reply REPLACES the primary's, so it must
                    # cover the identical segment set: a split cover gets
                    # no hedge (failover still handles a primary failure).
                    # It goes to another replica, never to the same server,
                    # whose lane could fold it into the original's launch
                    if len(assignment) == 1 and not leftover:
                        alt_server = next(iter(assignment))
                        batch.excluded.add(alt_server)
                        hedges += 1
                        self.metrics.meter("hedgesSent").mark()
                        ctx.event("hedge", fromServer=server, toServer=alt_server, segments=len(batch.segments))
                        submit(batch, alt_server, hedge=True)
            if not pending:
                # nothing inflight: sleep until the next backoff fire
                next_fire = min((f for f, _ in delayed), default=deadline)
                time.sleep(max(0.0, min(next_fire, deadline) - time.monotonic()))
                continue
            next_event = min([deadline, next_hedge] + [f for f, _ in delayed])
            done, _ = concurrent.futures.wait(
                list(pending.keys()),
                timeout=max(0.0, next_event - time.monotonic()),
                return_when=concurrent.futures.FIRST_COMPLETED,
            )
            for fut in done:
                batch, server, hedge, sent_at, wall_sent = pending.pop(fut)
                batch.inflight -= 1
                try:
                    result = fut.result()
                except concurrent.futures.CancelledError:
                    continue
                except Exception as e:
                    self.health.record_failure(server)
                    logger.warning("server %s failed: %s", server, e)
                    attempt_span(
                        batch, server, hedge, sent_at, wall_sent, "error",
                        error=f"{type(e).__name__}: {e}"[:200],
                    )
                    batch.errors.append(
                        QueryException(
                            ErrorCode.BROKER_GATHER, f"server {server}: {type(e).__name__}: {e}"
                        )
                    )
                    if not batch.done and batch.inflight == 0:
                        failover(batch)
                    continue
                retryable = result.exceptions and all(
                    code in RETRYABLE_SERVER_CODES for code, _ in result.exceptions
                )
                if retryable:
                    # the server answered "not me, not now": fail over
                    self.health.record_failure(server)
                    attempt_span(
                        batch, server, hedge, sent_at, wall_sent, "refused",
                        errorCode=result.exceptions[0][0],
                    )
                    batch.errors.append(
                        QueryException(result.exceptions[0][0], result.exceptions[0][1])
                    )
                    if not batch.done and batch.inflight == 0:
                        failover(batch)
                    continue
                self.health.record_success(server)
                # per-ATTEMPT latency: a winning hedge measures from its own
                # send, else the percentile that arms hedges inflates itself
                self.metrics.timer("serverLatency").update((time.monotonic() - sent_at) * 1000.0)
                if batch.done:
                    # a hedge race's loser: its launch ran to its end on its
                    # server; only the reply is dropped
                    attempt_span(batch, server, hedge, sent_at, wall_sent, "hedgeLoser")
                    continue
                aid = attempt_span(batch, server, hedge, sent_at, wall_sent, "ok")
                if result.trace:
                    # snapshot: reduce later merges parts IN PLACE
                    server_traces.append((aid, {k: list(v) for k, v in result.trace.items()}))
                batch.done = True
                open_lineages -= 1
                servers_responded.add(server)
                ordered_parts.append((batch.order, result))
                # server-reported unserved segments re-cover on an
                # untried replica or degrade honestly
                batch_set = set(batch.segments)
                missing = [s for s in result.unserved_segments if s in batch_set]
                if missing:
                    merr = QueryException(
                        ErrorCode.SERVER_SEGMENT_MISSING,
                        f"server {server}: segments unavailable: {sorted(missing)}",
                    )
                    assignment: Dict[str, List[str]] = {}
                    leftover = list(missing)
                    if batch.reissues < self.retry_attempts:
                        assignment, leftover = self.routing.alternates(
                            batch.table, missing, batch.excluded, health=self.health
                        )
                    if leftover:
                        exceptions.append(merr)
                        unserved.extend(leftover)
                    for alt_server, alt_segments in assignment.items():
                        submit(
                            spawn(batch, alt_server, alt_segments, [] if leftover else [merr]),
                            alt_server,
                        )
                # best effort: free the loser's queued twin if it never started
                for other, (ob, _osrv, _oh, _osent, _owall) in list(pending.items()):
                    if ob is batch:
                        other.cancel()

        # deadline expired (or queue drained): account every lineage that
        # never completed
        for fut, (pbatch, pserver, phedge, sent, wall) in pending.items():
            if not pbatch.done and not fut.cancel():
                attempt_span(pbatch, pserver, phedge, sent, wall, "timeout")
                self.health.record_failure(pserver)
        for batch in all_batches:
            if not batch.done and batch.inflight > 0:
                batch.errors.append(
                    QueryException(
                        ErrorCode.BROKER_TIMEOUT,
                        f"server {batch.server}: no reply within {timeout_ms:.0f}ms budget",
                    )
                )
                fail_batch(batch)
            elif not batch.done:
                fail_batch(batch)

        ordered_parts.sort(key=lambda pair: pair[0])  # stable: children keep arrival order
        return [result for _, result in ordered_parts], {
            "exceptions": exceptions,
            "unserved": unserved,
            "servers_queried": servers_queried,
            "servers_responded": servers_responded,
            "retries": retries,
            "hedges": hedges,
            "server_traces": server_traces,
        }

    def _observe_attempt(self, fut: concurrent.futures.Future, server: str) -> None:
        """One finished scatter attempt into the AIMD windows: a transport
        failure or a retryable refusal is saturation evidence; a healthy
        reply grows the window unless its backpressure snapshot shows the
        server's scheduler past the high-water mark."""
        if fut.cancelled():
            self.admission.on_attempt_cancelled(server)
            return
        if fut.exception() is not None:
            self.admission.on_attempt_done(server, saturated=True)
            return
        result = fut.result()
        refused = bool(result.exceptions) and all(code in RETRYABLE_SERVER_CODES for code, _ in result.exceptions)
        self.admission.on_attempt_done(server, saturated=refused, backpressure=result.backpressure)

    # ------------------------------------------------------------------
    def _physical_tables(self, table: str, pql: str) -> List[Tuple[str, str]]:
        """Logical table -> [(physical table, sub-query pql)].  A table
        with both OFFLINE and REALTIME physical tables gets the query
        duplicated with a time-boundary filter on each side."""
        known = set(self.routing.tables())
        if table in known:
            return [(table, pql)]
        offline = table + OFFLINE_SUFFIX
        realtime = table + REALTIME_SUFFIX
        if offline in known and realtime in known:
            boundary = self.time_boundary.get(offline)
            if boundary is not None:
                col, value = boundary
                return [
                    (offline, self._with_time_filter(pql, col, value, is_offline=True)),
                    (realtime, self._with_time_filter(pql, col, value, is_offline=False)),
                ]
            return [(offline, pql)]
        if offline in known:
            return [(offline, pql)]
        if realtime in known:
            return [(realtime, pql)]
        return []

    def _with_time_filter(self, pql: str, col: str, value: int, is_offline: bool) -> str:
        """Append the hybrid time-boundary predicate to the PQL text
        (offline: col <= boundary; realtime: col > boundary)."""
        op = "<=" if is_offline else ">"
        upper = pql.upper()
        pred = f"{col} {op} {value}"
        if " WHERE " in upper:
            idx = upper.index(" WHERE ") + len(" WHERE ")
            rest = pql[idx:]
            end = len(rest)
            for kw in (" GROUP BY ", " ORDER BY ", " HAVING ", " TOP ", " LIMIT "):
                j = rest.upper().find(kw)
                if j != -1:
                    end = min(end, j)
            return pql[:idx] + f"({rest[:end]}) AND {pred}" + rest[end:]
        ufrom = upper.index(" FROM ")
        after = pql[ufrom + len(" FROM "):]
        stop = len(after)
        for kw in (" WHERE ", " GROUP BY ", " ORDER BY ", " HAVING ", " TOP ", " LIMIT "):
            j = after.upper().find(kw)
            if j != -1:
                stop = min(stop, j)
        return pql[: ufrom + len(" FROM ")] + after[:stop] + f" WHERE {pred}" + after[stop:]

    def _send_one(
        self,
        server: str,
        table: str,
        pql: str,
        segments: List[str],
        trace: bool,
        debug_options: Optional[Dict[str, str]],
        timeout_ms: float,
        attempt_timeout_ms: Optional[float],
        request_id: str,
        join: Optional[Dict[str, Any]] = None,
    ) -> IntermediateResult:
        # timeout_ms is the REMAINING budget at (re-)issue time (the
        # server pins it as its dequeue deadline); attempt_timeout_ms caps
        # how long the broker waits on this one attempt
        address = self.server_addresses[server]
        payload = serialize_instance_request(
            request_id, pql, table, segments, timeout_ms, trace=trace, debug_options=debug_options,
            join=join,
        )
        wait_ms = timeout_ms if attempt_timeout_ms is None else attempt_timeout_ms
        reply = self.transport.request(address, payload, timeout=wait_ms / 1000.0)
        return deserialize_result(reply)


class InvalidTimeoutError(ValueError):
    """A timeoutMs override was present but not a positive number."""


def _parse_timeout(v) -> Optional[float]:
    """Strict per-query timeoutMs: absent (None/empty) means "use the
    broker default"; anything present must be a positive finite number."""
    if v is None or v == "":
        return None
    if isinstance(v, bool):
        raise InvalidTimeoutError(f"timeoutMs must be a positive number, got {v!r}")
    try:
        t = float(v)
    except (TypeError, ValueError):
        raise InvalidTimeoutError(f"timeoutMs must be a positive number, got {v!r}")
    if math.isnan(t) or math.isinf(t) or t <= 0:
        raise InvalidTimeoutError(f"timeoutMs must be a positive number, got {v!r}")
    return t


def _parse_debug_options(s: str) -> Optional[Dict[str, str]]:
    """``"k=v;k2=v2"`` -> dict (the reference's debug option string)."""
    out: Dict[str, str] = {}
    for part in (s or "").split(";"):
        k, sep, v = part.strip().partition("=")
        if sep and k.strip():
            out[k.strip()] = v.strip()
    return out or None


class BrokerHttpServer:
    """HTTP endpoint: GET /query?pql=... and POST /query {"pql": ...}
    (``PinotClientRequestServlet.java:54/:73``), plus ``/health``,
    ``/metrics``, ``/debug/metrics``, ``/debug/routing`` (each table's
    view of segment -> {server: state}, as this broker routes it),
    ``/debug/workload?top=&n=&tables=`` (``workload_snapshot``) and the
    serving planes' ``/debug/queries``, ``/debug/admission``,
    ``/debug/history?series=&windowS=``, ``/debug/slo``,
    ``/debug/tails?top=&traces=&requestId=``, ``/debug/flightrec`` and
    ``/debug/audit``."""

    def __init__(self, handler: BrokerRequestHandler, host: str = "127.0.0.1", port: int = 0):
        broker = handler

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, body: bytes, ctype: str, status: int = 200) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _respond(self, payload: Dict[str, Any], status: int = 200) -> None:
                self._send(json.dumps(payload).encode("utf-8"), "application/json", status)

            def _query(self, pql: str, trace: bool, debug, timeout_raw) -> None:
                try:
                    timeout_ms = _parse_timeout(timeout_raw)
                except InvalidTimeoutError as e:
                    resp = BrokerResponse(exceptions=[QueryException(ErrorCode.QUERY_VALIDATION, str(e))])
                    return self._respond(resp.to_json())
                resp = broker.handle_pql(pql, trace=trace, debug_options=debug, timeout_ms=timeout_ms)
                self._respond(resp.to_json())

            def do_GET(self):
                url = urlparse(self.path)
                if url.path not in ("/query", "/"):
                    if url.path == "/health":
                        return self._respond({"status": "ok"})
                    if url.path == "/metrics":
                        return self._send(prometheus_text(broker.metrics).encode("utf-8"),
                                          "text/plain; version=0.0.4")
                    if url.path == "/debug/metrics":
                        return self._respond(broker.metrics.snapshot())
                    if url.path == "/debug/routing":
                        return self._respond({t: broker.routing.view_of(t) for t in broker.routing.tables()})
                    if url.path == "/debug/queries":
                        return self._respond(broker.querylog.snapshot())
                    if url.path == "/debug/admission":
                        return self._respond(broker.admission.snapshot())
                    if url.path == "/debug/history":
                        return self._respond(broker.history.query_from_qs(url.query))
                    if url.path == "/debug/slo":
                        return self._respond(broker.slo.snapshot())
                    if url.path == "/debug/tails":
                        qs = parse_qs(url.query)
                        rid = (qs.get("requestId") or [""])[0]
                        if rid:
                            entry = broker.tail.get(rid)
                            if entry is None:
                                return self._respond({"error": f"no retained tail for {rid}"}, 404)
                            return self._respond(entry)
                        try:
                            top = int((qs.get("top") or ["20"])[0])
                        except ValueError:
                            top = 20
                        traces = (qs.get("traces") or ["false"])[0].lower() == "true"
                        return self._respond(broker.tail.snapshot(top=max(1, top), include_traces=traces))
                    if url.path == "/debug/flightrec":
                        return self._respond(broker.flightrec.snapshot())
                    if url.path == "/debug/audit":
                        # the replica audit's counters and the event-time
                        # watermarks
                        return self._respond(
                            {"replica": broker.replica_audit.snapshot(), "freshness": WATERMARKS.snapshot()})
                    if url.path == "/debug/workload":
                        qs = parse_qs(url.query)
                        # ?n= is the prewarm feed's alias of ?top=
                        try:
                            top = int((qs.get("n") or qs.get("top") or ["20"])[0])
                        except ValueError:
                            top = 20
                        tables = [t.strip() for t in (qs.get("tables") or [""])[0].split(",") if t.strip()]
                        return self._respond(broker.workload_snapshot(top=max(1, top), tables=tables or None))
                    return self._respond({"error": "not found"}, 404)
                qs = parse_qs(url.query)
                pql = (qs.get("pql") or qs.get("bql") or [""])[0]
                trace = (qs.get("trace") or ["false"])[0].lower() == "true"
                debug = _parse_debug_options((qs.get("debugOptions") or [""])[0])
                self._query(pql, trace, debug, (qs.get("timeoutMs") or [""])[0])

            def do_POST(self):
                n = int(self.headers.get("Content-Length", "0"))
                try:
                    body = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError as e:
                    return self._respond({"exceptions": [{"errorCode": ErrorCode.JSON_PARSING, "message": str(e)}]})
                debug = body.get("debugOptions") or ""
                if isinstance(debug, dict):
                    debug = {str(k): str(v) for k, v in debug.items()}
                else:
                    debug = _parse_debug_options(debug if isinstance(debug, str) else "")
                self._query(body.get("pql") or body.get("bql") or "", bool(body.get("trace")), debug,
                            body.get("timeoutMs"))

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
