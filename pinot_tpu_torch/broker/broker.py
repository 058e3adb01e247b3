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
exponential backoff, under the query's total deadline.  Each attempt
carries the REMAINING deadline, so servers shed work the broker already
gave up on; a per-server circuit breaker (``broker/health.py``) steers
routing off repeat offenders; segments still unserved after retries
flip ``partialResponse`` and count into ``numSegmentsUnserved``.

A two-table join goes to the join coordinator (``broker/joinplan.py``):
the colocated, broadcast or shuffle strategy, each phase a scatter-gather
whose requests carry the phase's join context (``extra_fn``).

``BrokerHttpServer`` is the client's endpoint: ``GET /query?pql=`` and
``POST /query {"pql": ...}`` answer the broker response JSON.

Left out of the port, for later slices: admission and quota, hedging,
the SLO / tail-sample / flight-recorder / history planes, the slow-query
log, plan statistics, EXPLAIN, the freshness stamp and the replica
auditor.
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

from pinot_tpu_torch.broker.health import ServerHealthTracker
from pinot_tpu_torch.broker.joinplan import JoinCoordinator
from pinot_tpu_torch.broker.routing import RoutingTableProvider
from pinot_tpu_torch.broker.time_boundary import TimeBoundaryService
from pinot_tpu_torch.common.datatable import deserialize_result, serialize_instance_request
from pinot_tpu_torch.common.request import EXPLAIN_ITEM, BrokerRequest
from pinot_tpu_torch.common.response import BrokerResponse, ErrorCode, QueryException
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.engine.results import IntermediateResult
from pinot_tpu_torch.pql import PqlParseError, optimize_request, parse_pql
from pinot_tpu_torch.utils.metrics import BrokerMetrics, prometheus_text
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
    """One segment set bound for one server: the unit of scatter and
    failover.  A failover spawns child batches (possibly splitting
    segments across replicas); the parent is then superseded."""

    __slots__ = (
        "table", "pql", "segments", "server", "excluded",
        "reissues", "errors", "done", "inflight", "order",
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


class BrokerRequestHandler:
    """``transport``: ``request(address, payload, timeout) -> bytes``
    (``transport/local.py`` or ``transport/tcp.py``).
    ``server_addresses``: server name -> transport address.
    ``routing``: the table -> {server: segments} covers.
    ``timeout_ms``: the broker's per-query budget, also the ceiling of a
    per-query override."""

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
        health: Optional[ServerHealthTracker] = None,
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
        self.health = health or ServerHealthTracker()
        self._request_id = 0
        self._id_lock = threading.Lock()
        # globally-unique request ids: broker name + a process-unique
        # token + a per-broker sequence
        self._id_prefix = f"{name}-{uuid.uuid4().hex[:6]}"
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=16)
        for m in ("queries", "failoverRetries", "cost.docsScanned", "cost.bytesScanned"):
            self.metrics.meter(m)
        for t in ("cost.deviceMs", "cost.hostMs"):
            self.metrics.timer(t)
        # the distributed join plane: strategy planner and multi-phase
        # exchange coordinator (registers its join.* meters)
        self.joinplan = JoinCoordinator(self)

    def set_server_address(self, server: str, address: Tuple[str, int]) -> None:
        self.server_addresses[server] = address

    def _next_request_id(self) -> str:
        with self._id_lock:
            self._request_id += 1
            n = self._request_id
        return f"{self._id_prefix}-{n}"

    def shutdown(self) -> None:
        """Stop the scatter pool (in-flight attempts finish)."""
        self._pool.shutdown(wait=False)

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
        # untraced queries share the NULL context: no span allocation
        ctx = (
            TraceContext(enabled=True, scope=self.name, trace_id=request_id)
            if trace
            else NULL_TRACE
        )
        resp: Optional[BrokerResponse] = None
        with ctx.span("query", requestId=request_id, pql=pql[:200]):
            t_parse = time.perf_counter()
            try:
                with ctx.span("parse"):
                    request = parse_pql(pql)
                    if debug_options:
                        request.debug_options = dict(debug_options)
                    request = optimize_request(request)
            except PqlParseError as e:
                resp = BrokerResponse(exceptions=[QueryException(ErrorCode.PQL_PARSING, str(e))])
            self.metrics.timer("phase.parse").update((time.perf_counter() - t_parse) * 1000)
            if resp is None:
                request.enable_trace = ctx.enabled
                resp = self.handle_request(
                    request, pql, timeout_ms=timeout_ms, request_id=request_id, trace_ctx=ctx
                )
        if trace:
            # the per-server span trees re-parented under the scatter
            # attempts that carried them, next to this broker's own tree
            scopes: Dict[str, Any] = {}
            merge_scope(scopes, ctx.to_dict())
            for attempt_id, server_trace in getattr(resp, "_server_traces", ()) or ():
                merge_scope(scopes, server_trace, root_parent=attempt_id)
            resp.trace_info = {"traceId": request_id, "scopes": scopes}
        else:
            resp.trace_info = {}
        resp.request_id = request_id
        resp.time_used_ms = (time.perf_counter() - t0) * 1000
        self.metrics.timer("queryTotal").update(resp.time_used_ms)
        return resp

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
        if request.explain is not None:
            # no plan introspection yet: a typed refusal, and nothing is
            # scattered to a server
            return BrokerResponse(
                exceptions=[QueryException(ErrorCode.QUERY_VALIDATION, EXPLAIN_ITEM)],
                request_id=request_id,
            )
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

        t_sg = time.perf_counter()
        with ctx.span("scatterGather", batches=len(batches)):
            parts, sg = self._scatter_gather(request, batches, timeout_ms, request_id, ctx)
        exceptions.extend(sg["exceptions"])
        sg_ms = (time.perf_counter() - t_sg) * 1000
        self.metrics.timer("scatterGather").update(sg_ms)

        t_red = time.perf_counter()
        for p in parts:
            for code, msg in p.exceptions:
                exceptions.append(QueryException(code, msg))
        with ctx.span("reduce", parts=len(parts)):
            resp = reduce_to_response(request, parts, exceptions)
        red_ms = (time.perf_counter() - t_red) * 1000
        self.metrics.timer("reduce").update(red_ms)
        resp.request_id = request_id
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
        # side channel for handle_pql (not serialized into the response):
        # per-server trace trees keyed by the attempt span that carried
        # them, and the phase split
        resp._server_traces = sg["server_traces"]
        resp.phase_ms = {"scatterGather": round(sg_ms, 3), "reduce": round(red_ms, 3)}
        return resp

    # ------------------------------------------------------------------
    # resilient scatter-gather
    # ------------------------------------------------------------------
    def _backoff_s(self, reissues: int) -> float:
        return (
            min(self.retry_backoff_ms * (2 ** max(0, reissues - 1)), self.retry_backoff_cap_ms)
            / 1000.0
        )

    def _scatter_gather(
        self,
        request: BrokerRequest,
        batches: List[_Batch],
        timeout_ms: float,
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
        # future -> (batch, server, sent_at, wall_sent_ms)
        pending: Dict[concurrent.futures.Future, Tuple[_Batch, str, float, float]] = {}
        all_batches: List[_Batch] = list(batches)
        delayed: List[Tuple[float, _Batch]] = []  # (fire_time, batch) backoff queue
        open_lineages = len(batches)  # batches neither completed nor superseded
        server_traces: List[Tuple[Optional[str], Dict[str, Any]]] = []

        def attempt_span(batch, server, sent_at, wall_sent, status, **tags) -> Optional[str]:
            return ctx.add(
                "serverAttempt",
                (time.monotonic() - sent_at) * 1000.0,
                start_ms=wall_sent,
                server=server,
                reissues=batch.reissues,
                segments=len(batch.segments),
                status=status,
                **tags,
            )

        def submit(batch: _Batch, server: str) -> None:
            now = time.monotonic()
            remaining_ms = max(1.0, (deadline - now) * 1000.0)
            servers_queried.add(server)
            self.health.allow_request(server)
            # with retries in reserve AND an untried replica to fail over
            # to, wait only half the remaining budget on this attempt, so
            # a hung replica surfaces while there is time to re-issue
            attempt_ms = remaining_ms
            if self.retry_attempts - batch.reissues > 0 and self.routing.has_alternate(
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
            batch.inflight += 1
            pending[fut] = (batch, server, now, time.time() * 1000.0)

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
            if not pending:
                # nothing inflight: sleep until the next backoff fire
                next_fire = min((f for f, _ in delayed), default=deadline)
                time.sleep(max(0.0, min(next_fire, deadline) - time.monotonic()))
                continue
            next_event = min([deadline] + [f for f, _ in delayed])
            done, _ = concurrent.futures.wait(
                list(pending.keys()),
                timeout=max(0.0, next_event - time.monotonic()),
                return_when=concurrent.futures.FIRST_COMPLETED,
            )
            for fut in done:
                batch, server, sent_at, wall_sent = pending.pop(fut)
                batch.inflight -= 1
                try:
                    result = fut.result()
                except concurrent.futures.CancelledError:
                    continue
                except Exception as e:
                    self.health.record_failure(server)
                    logger.warning("server %s failed: %s", server, e)
                    attempt_span(
                        batch, server, sent_at, wall_sent, "error",
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
                        batch, server, sent_at, wall_sent, "refused",
                        errorCode=result.exceptions[0][0],
                    )
                    batch.errors.append(
                        QueryException(result.exceptions[0][0], result.exceptions[0][1])
                    )
                    if not batch.done and batch.inflight == 0:
                        failover(batch)
                    continue
                self.health.record_success(server)
                self.metrics.timer("serverLatency").update((time.monotonic() - sent_at) * 1000.0)
                if batch.done:
                    attempt_span(batch, server, sent_at, wall_sent, "late")
                    continue
                aid = attempt_span(batch, server, sent_at, wall_sent, "ok")
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

        # deadline expired (or queue drained): account every lineage that
        # never completed
        for fut, (pbatch, pserver, sent, wall) in pending.items():
            if not pbatch.done and not fut.cancel():
                attempt_span(pbatch, pserver, sent, wall, "timeout")
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
            "server_traces": server_traces,
        }

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
    ``/metrics``, ``/debug/metrics`` and ``/debug/routing`` (each table's
    view of segment -> {server: state}, as this broker routes it)."""

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
