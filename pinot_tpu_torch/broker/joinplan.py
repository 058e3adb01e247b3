"""Broker join planner + exchange coordinator (copy of
``pinot_tpu.broker.joinplan``, trimmed to the port's broker).

The broker turns a parsed two-table equi-join into one of three
physical strategies (decision order; the ``joinStrategy`` debug option
forces one):

1. **colocated** — both tables declare partitioning on their join key
   (``TableConfig.partitioning``), segment names carry their partition
   (``..._pN`` / ``...__pN``), and every server in the probe cover
   locally holds build segments for every partition its probe segments
   span.  One scatter round: each probe server builds from its OWN
   build segments and probes its local probe segments — zero exchange
   bytes.

2. **broadcast** — the build side (right table, filters pushed down)
   fits the budget (``config.JOIN_BROADCAST_ROWS`` /
   ``JOIN_BROADCAST_BYTES``): the broker extracts it once from the build cover, then
   ships the SAME dict-encoded payload inside every probe server's
   scatter request.

3. **shuffle** — everything else: both sides extract, and the broker
   (the exchange fabric of this scatter-gather architecture) routes
   key-hash partitions of both sides to owner servers drawn from the
   probe cover.  Heavy-hitter keys — detected from the extracted
   per-key counts (``engine/join.py plan_shuffle_partitions``) — get
   split-and-replicated instead of hot-spotting one owner, so no
   server receives >2x the mean exchange bytes even under zipf keys.

Every phase rides the broker's resilient ``_scatter_gather`` (failover
to replicas, circuit breaker, deadline propagation), and every
per-server reply's cost vector merges into the final response —
``broker cost == Σ server costs`` holds for joins exactly as for scans
(buildRows / probeRows / shuffleBytes / broadcastBytes are additive
COST_KEYS).  Server-side, every phase request queues through the
fair-share scheduler under its own table.

The strategy size estimator learns table totals from every merged
response (``TableStatsRegistry``) and measured build sizes after each
join.  EXPLAIN of a join answers the coordinator's plan node in an
EXPLAIN shell (``_explain_shell``: no server node, nothing scattered):
the strategy real execution would pick, the colocation verdict, the build
side's estimate and the budgets; EXPLAIN ANALYZE executes and adds what
ran (``actual``) and the response's cost.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from pinot_tpu_torch.common.response import BrokerResponse, ErrorCode, QueryException
from pinot_tpu_torch.engine import config
from pinot_tpu_torch.engine.plandigest import plan_shape_digest, plan_shape_summary
from pinot_tpu_torch.engine.join import (
    JoinValidationError,
    decode_side,
    encode_side,
    merge_sides,
    partition_of_segment,
    plan_shuffle_partitions,
    side_take,
    split_join_filter,
)
from pinot_tpu_torch.engine.reduce import reduce_to_response
from pinot_tpu_torch.engine.results import IntermediateResult

OFFLINE_SUFFIX = "_OFFLINE"
REALTIME_SUFFIX = "_REALTIME"


def _raw(table: str) -> str:
    """The raw table name of a physical one (suffix stripped)."""
    for suffix in (OFFLINE_SUFFIX, REALTIME_SUFFIX):
        if table.endswith(suffix):
            return table[: -len(suffix)]
    return table


class TableStatsRegistry:
    """Learned per-raw-table size statistics feeding the strategy
    estimator: total docs from every merged scan reply, measured build
    extract rows/bytes after every join."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._docs: Dict[str, int] = {}
        self._build: Dict[str, Tuple[int, int]] = {}  # raw -> (rows, bytes)

    def observe(self, table: str, total_docs: int) -> None:
        with self._lock:
            self._docs[_raw(table)] = int(total_docs)

    def observe_build(self, table: str, rows: int, nbytes: int) -> None:
        with self._lock:
            self._build[_raw(table)] = (int(rows), int(nbytes))

    def estimate(self, table: str) -> Optional[Dict[str, Any]]:
        """Best build-size estimate: a measured extract wins over a
        docs-count guess (8 bytes/row placeholder width)."""
        raw = _raw(table)
        with self._lock:
            b = self._build.get(raw)
            d = self._docs.get(raw)
        if b is not None:
            return {"rows": b[0], "bytes": b[1], "source": "measured"}
        if d is not None:
            return {"rows": d, "bytes": d * 8, "source": "totalDocs"}
        return None


class PartitionRegistry:
    """Declared table partitioning (TableConfig.partitioning), fed by
    the broker starters over the same propagation paths as quotas —
    in-process config apply and the networked clusterstate poll."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_raw: Dict[str, Tuple[str, int]] = {}

    def set_partitioning(
        self, table: str, column: Optional[str], num_partitions: Optional[int]
    ) -> None:
        raw = _raw(table)
        with self._lock:
            if column and num_partitions:
                self._by_raw[raw] = (column, int(num_partitions))
            else:
                self._by_raw.pop(raw, None)

    def get(self, table: str) -> Optional[Tuple[str, int]]:
        with self._lock:
            return self._by_raw.get(_raw(table))


class JoinCoordinator:
    def __init__(self, broker) -> None:
        self.broker = broker
        self.stats = TableStatsRegistry()
        self.partitions = PartitionRegistry()
        for m in (
            "join.queries",
            "join.failed",
            "join.strategy.colocated",
            "join.strategy.broadcast",
            "join.strategy.shuffle",
            "join.heavyHitterSplits",
            "join.shuffleBytes",
            "join.broadcastBytes",
        ):
            broker.metrics.meter(m)
        broker.metrics.timer("join.planMs")

    # -- knobs (engine/config.py constants, read per query) -----------
    @staticmethod
    def _budget_rows() -> int:
        return config.JOIN_BROADCAST_ROWS

    @staticmethod
    def _budget_bytes() -> int:
        return config.JOIN_BROADCAST_BYTES

    @staticmethod
    def _split_enabled() -> bool:
        return config.JOIN_SPLIT

    @staticmethod
    def _heavy_factor() -> float:
        return config.JOIN_HEAVY_FACTOR

    # ------------------------------------------------------------------
    def handle(
        self, request, pql: str, timeout_ms: float, request_id: str, ctx, table: str
    ) -> BrokerResponse:
        t0 = time.perf_counter()
        deadline = time.monotonic() + timeout_ms / 1000.0
        spec = request.join
        try:
            split_join_filter(request)  # mixed-side predicates -> typed 4xx
            left_phys = self._resolve_physical(table)
            right_phys = self._resolve_physical(spec.right_table)
            # inside the try: a bogus client-supplied joinStrategy is a
            # typed 4xx too, never an unhandled broker exception
            forced = self._forced_strategy(request)
        except JoinValidationError as e:
            return BrokerResponse(
                exceptions=[QueryException(ErrorCode.QUERY_VALIDATION, str(e))]
            )
        m = self.broker.metrics
        m.meter("join.queries").mark()
        colo = self._colocated_plan(left_phys, right_phys, spec)
        est = self.stats.estimate(spec.right_table)

        if request.explain == "plan":
            node = self._plan_node(spec, colo, est, forced, executed=None)
            resp = BrokerResponse()
            resp.explain = self._explain_shell(request, "plan", node)
            m.timer("join.planMs").update((time.perf_counter() - t0) * 1000)
            return resp

        if forced == "colocated" and not colo["eligible"]:
            return BrokerResponse(
                exceptions=[
                    QueryException(
                        ErrorCode.QUERY_VALIDATION,
                        "joinStrategy=colocated forced but the tables are not "
                        f"colocated: {colo['reason']}",
                    )
                ]
            )

        try:
            resp, executed = self._execute(
                request, pql, spec, left_phys, right_phys, colo, forced,
                deadline, request_id, ctx, table,
            )
        except JoinValidationError as e:
            return BrokerResponse(
                exceptions=[QueryException(ErrorCode.QUERY_VALIDATION, str(e))]
            )
        m.meter(f"join.strategy.{executed['strategy']}").mark()
        if executed.get("shuffleBytes"):
            m.meter("join.shuffleBytes").mark(int(executed["shuffleBytes"]))
        if executed.get("broadcastBytes"):
            m.meter("join.broadcastBytes").mark(int(executed["broadcastBytes"]))
        if executed.get("heavyHitterSplits"):
            m.meter("join.heavyHitterSplits").mark(int(executed["heavyHitterSplits"]))
        if resp.exceptions:
            m.meter("join.failed").mark()
        if request.explain == "analyze":
            node = self._plan_node(spec, colo, est, forced, executed=executed)
            resp.explain = self._explain_shell(request, "analyze", node)
            resp.explain["actualCost"] = {
                k: (round(v, 3) if isinstance(v, float) else v) for k, v in sorted(resp.cost.items())
            }
            resp.explain["actualDocsScanned"] = resp.num_docs_scanned
        m.timer("join.planMs").update((time.perf_counter() - t0) * 1000)
        return resp

    # -- planning pieces ----------------------------------------------
    @staticmethod
    def _forced_strategy(request) -> Optional[str]:
        forced = (request.debug_options or {}).get("joinStrategy")
        if not forced:
            return None
        forced = str(forced).lower()
        if forced not in ("colocated", "broadcast", "shuffle"):
            raise JoinValidationError(
                f"unknown joinStrategy {forced!r} (colocated|broadcast|shuffle)"
            )
        return forced

    def _resolve_physical(self, table: str) -> str:
        known = set(self.broker.routing.tables())
        if table in known:
            return table
        offline, realtime = table + OFFLINE_SUFFIX, table + REALTIME_SUFFIX
        if offline in known and realtime in known:
            raise JoinValidationError(
                f"table {table} is hybrid (OFFLINE + REALTIME): hybrid join "
                "sides are not supported yet"
            )
        if offline in known:
            return offline
        if realtime in known:
            return realtime
        raise JoinValidationError(f"no routing for join table {table}")

    def _colocated_plan(self, left_phys: str, right_phys: str, spec) -> Dict[str, Any]:
        """Colocation verdict + (when eligible) the probe cover and the
        per-server build segment lists."""
        lp = self.partitions.get(left_phys)
        rp = self.partitions.get(right_phys)
        if lp is None or rp is None:
            return {"eligible": False, "reason": "partitioning not declared on both tables"}
        if lp[0] != spec.left_key or rp[0] != spec.right_key:
            return {
                "eligible": False,
                "reason": "partition columns do not match the join keys "
                f"({lp[0]}/{rp[0]} vs {spec.left_key}/{spec.right_key})",
            }
        if lp[1] != rp[1]:
            return {
                "eligible": False,
                "reason": f"partition counts differ ({lp[1]} vs {rp[1]})",
            }
        cover = self.broker.routing.find_servers(left_phys, health=self.broker.health)
        right_view = self.broker.routing.view_of(right_phys)
        if not cover or not right_view:
            return {"eligible": False, "reason": "no live cover for one side"}
        server_build: Dict[str, List[str]] = {}
        for seg, replicas in right_view.items():
            for srv, st in replicas.items():
                if st in ("ONLINE", "CONSUMING"):
                    server_build.setdefault(srv, []).append(seg)
        build_segments: Dict[str, List[str]] = {}
        for server, probe_segs in cover.items():
            probe_parts = {partition_of_segment(s) for s in probe_segs}
            if None in probe_parts:
                return {
                    "eligible": False,
                    "reason": "probe segments without partition ids",
                }
            local = server_build.get(server, [])
            local_parts = {partition_of_segment(s) for s in local}
            if not probe_parts <= local_parts:
                return {
                    "eligible": False,
                    "reason": f"server {server} lacks local build partitions "
                    f"{sorted(probe_parts - local_parts)}",
                }
            build_segments[server] = sorted(
                s for s in local if partition_of_segment(s) in probe_parts
            )
        return {
            "eligible": True,
            "reason": "partition-aligned covers",
            "cover": cover,
            "build_segments": build_segments,
            "server_build": server_build,
        }

    def _size_strategy(self, est: Optional[Dict[str, Any]]) -> Optional[str]:
        if est is None:
            return None
        within = (
            est["rows"] <= self._budget_rows() and est["bytes"] <= self._budget_bytes()
        )
        return "broadcast" if within else "shuffle"

    def _plan_node(self, spec, colo, est, forced, executed: Optional[Dict[str, Any]]) -> Dict[str, Any]:
        """The join's EXPLAIN node: the strategy (what ran, else what was
        forced, else colocated when eligible, else the size estimate's
        pick), the colocation verdict, the build side's estimate, the
        broadcast budget and the skew settings; with ``executed``, what
        ran."""
        if executed is not None:
            strategy = executed["strategy"]
        elif forced:
            strategy = forced
        elif colo["eligible"]:
            strategy = "colocated"
        else:
            strategy = self._size_strategy(est) or "broadcast|shuffle (size probe at execution)"
        node: Dict[str, Any] = {
            "strategy": strategy,
            "forced": bool(forced),
            "on": f"{spec.left_key} = {spec.right_table}.{spec.right_key}",
            "colocated": {"eligible": colo["eligible"], "reason": colo["reason"]},
            "build": {
                "table": spec.right_table,
                "estRows": est["rows"] if est else None,
                "estBytes": est["bytes"] if est else None,
                "estSource": est["source"] if est else None,
            },
            "budget": {"broadcastRows": self._budget_rows(), "broadcastBytes": self._budget_bytes()},
            "skew": {"splitEnabled": self._split_enabled(), "heavyFactor": self._heavy_factor()},
        }
        if executed is not None:
            node["actual"] = {
                k: executed[k]
                for k in ("strategy", "buildRows", "probeRows", "broadcastBytes", "shuffleBytes",
                          "heavyHitterSplits", "shuffleBytesPerServer", "owners")
                if k in executed
            }
        return node

    def _explain_shell(self, request, mode: str, node: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "mode": mode,
            "planDigest": plan_shape_digest(request),
            "summary": plan_shape_summary(request),
            "numServers": 0,
            "tierCounts": {},
            "estimatedCost": {"bytesScanned": int(node["build"].get("estBytes") or 0)},
            "join": node,
            "servers": [],
        }

    # -- execution -----------------------------------------------------
    def _remaining_ms(self, deadline: float) -> float:
        return max(1.0, (deadline - time.monotonic()) * 1000.0)

    def _cover_batches(self, phys: str, pql: str):
        from pinot_tpu_torch.broker.broker import _Batch

        cover = self.broker.routing.find_servers(phys, health=self.broker.health)
        if not cover:
            return None, None
        batches = [
            _Batch(phys, pql, segments, server, order=i)
            for i, (server, segments) in enumerate(sorted(cover.items()))
        ]
        return cover, batches

    def _execute(
        self, request, pql, spec, left_phys, right_phys, colo, forced,
        deadline, request_id, ctx, table,
    ) -> Tuple[BrokerResponse, Dict[str, Any]]:
        sg_union = {
            "servers_queried": set(),
            "servers_responded": set(),
            "retries": 0,
            "unserved": [],
            "server_traces": [],
        }
        exceptions: List[QueryException] = []
        all_parts: List[IntermediateResult] = []
        executed: Dict[str, Any] = {}

        def run_phase(phys: str, batches, extra_fn, span: str):
            with ctx.span(span, servers=len(batches)):
                parts, sg = self.broker._scatter_gather(
                    request,
                    batches,
                    self._remaining_ms(deadline),
                    request_id,
                    ctx,
                    extra_fn=extra_fn,
                )
            exceptions.extend(sg["exceptions"])
            sg_union["servers_queried"] |= sg["servers_queried"]
            sg_union["servers_responded"] |= sg["servers_responded"]
            sg_union["retries"] += sg["retries"]
            sg_union["unserved"].extend(sg["unserved"])
            sg_union["server_traces"].extend(sg["server_traces"])
            return parts

        strategy = forced if forced else ("colocated" if colo["eligible"] else None)

        if strategy == "colocated":
            build_map = colo["build_segments"]
            server_build = colo.get("server_build", {})
            from pinot_tpu_torch.broker.broker import _Batch

            batches = [
                _Batch(left_phys, pql, segments, server, order=i)
                for i, (server, segments) in enumerate(sorted(colo["cover"].items()))
            ]

            def extra_fn(server: str) -> Dict[str, Any]:
                # failover children recompute for THEIR server: any
                # local build segments it holds (the server re-checks
                # partition coverage against the probe segments it
                # actually serves and 230s when it cannot)
                segs = build_map.get(server)
                if segs is None:
                    segs = sorted(server_build.get(server, []))
                return {
                    "phase": "exec",
                    "strategy": "colocated",
                    "buildTable": right_phys,
                    "buildSegments": segs,
                }

            all_parts.extend(run_phase(left_phys, batches, extra_fn, "joinColocated"))
            executed.update({"strategy": "colocated"})
        else:
            # -- phase 1a: build-side extraction --------------------------
            cover, batches = self._cover_batches(right_phys, pql)
            if batches is None:
                raise JoinValidationError(
                    f"no servers currently serving join table {right_phys}"
                )
            extract_extra = {"phase": "extract", "side": "build"}
            bparts = run_phase(
                right_phys, batches, lambda s: dict(extract_extra), "joinBuildExtract"
            )
            build = merge_sides(
                [decode_side(p.join_payload) for p in bparts if p.join_payload]
            )
            for p in bparts:
                p.join_payload = None
            all_parts.extend(bparts)
            executed["buildRows"] = build.n
            self.stats.observe_build(spec.right_table, build.n, build.nbytes())
            if strategy is None:
                # the JUST-measured extract is exact and in hand: it
                # always wins over a learned estimate (a stale small
                # estimate must not broadcast an over-budget build side)
                strategy = self._size_strategy(
                    {"rows": build.n, "bytes": build.nbytes(), "source": "measured"}
                )
            executed["strategy"] = strategy

            if strategy == "broadcast":
                payload = encode_side(build)
                _cov, pbatches = self._cover_batches(left_phys, pql)
                if pbatches is None:
                    raise JoinValidationError(
                        f"no servers currently serving join table {left_phys}"
                    )
                exec_extra = {
                    "phase": "exec",
                    "strategy": "broadcast",
                    "build": payload,
                }
                eparts = run_phase(
                    left_phys, pbatches, lambda s: exec_extra, "joinBroadcast"
                )
                all_parts.extend(eparts)
                executed["broadcastBytes"] = build.nbytes() * max(1, len(pbatches))
            else:
                # -- phase 1b: probe-side extraction ----------------------
                _cov, pbatches = self._cover_batches(left_phys, pql)
                if pbatches is None:
                    raise JoinValidationError(
                        f"no servers currently serving join table {left_phys}"
                    )
                # owners: EVERY live server holding any probe replica —
                # not just the cover draw — so small tables still
                # spread partitions and an owner death has alternates.
                # Penalty-boxed servers are excluded up front (they
                # remain failover alternates of last resort only).
                view = self.broker.routing.view_of(left_phys) or {}
                candidates = {
                    srv
                    for replicas in view.values()
                    for srv, st in replicas.items()
                    if st in ("ONLINE", "CONSUMING")
                } or {b.server for b in pbatches}
                healthy = {
                    s for s in candidates if self.broker.health.is_healthy(s)
                }
                owners = sorted(healthy or candidates)
                pparts = run_phase(
                    left_phys,
                    pbatches,
                    lambda s: {"phase": "extract", "side": "probe"},
                    "joinProbeExtract",
                )
                probe = merge_sides(
                    [decode_side(p.join_payload) for p in pparts if p.join_payload]
                )
                for p in pparts:
                    p.join_payload = None
                all_parts.extend(pparts)
                executed["probeRows"] = probe.n

                # -- phase 2: skew-aware exchange + owner execution -------
                assignments, n_heavy = plan_shuffle_partitions(
                    build,
                    probe,
                    len(owners),
                    split_heavy=self._split_enabled(),
                    heavy_factor=self._heavy_factor(),
                )
                executed["heavyHitterSplits"] = n_heavy
                executed["owners"] = len(owners)
                eparts, per_server, shuffle_excs = self._dispatch_shuffle(
                    request, pql, left_phys, owners, assignments, build, probe,
                    deadline, request_id, ctx, sg_union,
                )
                exceptions.extend(shuffle_excs)
                all_parts.extend(eparts)
                executed["shuffleBytes"] = sum(per_server.values())
                executed["shuffleBytesPerServer"] = per_server

        for code, msg in [
            (c, m) for p in all_parts for c, m in p.exceptions
        ]:
            exceptions.append(QueryException(code, msg))
        for p in all_parts:
            p.exceptions = []
        with ctx.span("reduce", parts=len(all_parts)):
            resp = reduce_to_response(request, all_parts, exceptions)
        resp.num_servers_queried = len(sg_union["servers_queried"])
        resp.num_servers_responded = len(sg_union["servers_responded"])
        resp.num_segments_unserved = len(sg_union["unserved"])
        # lost shuffle partitions land in "unserved" too (the
        # join-partitions:N marker from _dispatch_shuffle)
        resp.partial_response = bool(sg_union["unserved"])
        resp.num_retries = sg_union["retries"]
        resp._server_traces = sg_union["server_traces"]
        # the actuals off the merged cost (covers colocated, whose rows
        # are known on the servers only)
        executed.setdefault("buildRows", int(resp.cost.get("buildRows", 0)))
        executed.setdefault("probeRows", int(resp.cost.get("probeRows", 0)))
        # per-table cost attribution, as the single-table path does
        self.broker.metrics.meter("cost.docsScanned").mark(int(resp.num_docs_scanned))
        self.broker.metrics.meter("cost.bytesScanned").mark(
            int(resp.cost.get("bytesScanned", 0))
        )
        self.broker.metrics.meter(f"table.{table}.docsScanned").mark(
            int(resp.num_docs_scanned)
        )
        return resp, executed

    def _dispatch_shuffle(
        self, request, pql, left_phys, owners, assignments, build, probe,
        deadline, request_id, ctx, sg_union,
    ):
        """Phase-2 owner dispatch: each owner receives its build/probe
        partitions and executes the hash join; an owner failure retries
        its partition on the remaining owners (the payload is
        broker-held, so ANY server can execute it) before degrading to
        a partial response."""
        import concurrent.futures

        exceptions: List[QueryException] = []
        per_server: Dict[str, int] = {}
        parts: List[IntermediateResult] = []
        payloads: List[Tuple[str, Dict[str, Any], int]] = []
        for owner, (b_idx, p_idx) in zip(owners, assignments):
            b_sub = side_take(build, b_idx)
            p_sub = side_take(probe, p_idx)
            extra = {
                "phase": "exec",
                "strategy": "shuffle",
                "build": encode_side(b_sub),
                "probe": encode_side(p_sub),
            }
            payloads.append((owner, extra, b_sub.nbytes() + p_sub.nbytes()))

        def send(server: str, extra: Dict[str, Any]):
            return self.broker._send_one(
                server,
                left_phys,
                pql,
                [],
                request.enable_trace,
                request.debug_options or None,
                self._remaining_ms(deadline),
                None,
                request_id,
                extra,
            )

        def submit(server: str, extra: Dict[str, Any]):
            # the per-attempt accounting every _scatter_gather attempt
            # performs: the half-open circuit probe claim
            self.broker.health.allow_request(server)
            return self.broker._pool.submit(send, server, extra)

        futs = {
            submit(owner, extra): (i, owner, extra, nbytes)
            for i, (owner, extra, nbytes) in enumerate(payloads)
        }
        failed_partitions = 0
        with ctx.span("joinShuffleExec", owners=len(payloads)):
            pending = dict(futs)
            while pending:
                done, _ = concurrent.futures.wait(
                    list(pending.keys()),
                    timeout=max(0.0, deadline - time.monotonic()),
                    return_when=concurrent.futures.FIRST_COMPLETED,
                )
                if not done:
                    for _f, (_i, owner, _e, _n) in pending.items():
                        exceptions.append(
                            QueryException(
                                ErrorCode.BROKER_TIMEOUT,
                                f"join owner {owner}: no reply within deadline",
                            )
                        )
                        failed_partitions += 1
                    break
                for fut in done:
                    i, owner, extra, nbytes = pending.pop(fut)
                    sg_union["servers_queried"].add(owner)
                    try:
                        result = fut.result()
                        retryable = result.exceptions and all(
                            c
                            in (
                                ErrorCode.SERVER_SCHEDULER_DOWN,
                                ErrorCode.SERVER_SHUTTING_DOWN,
                            )
                            for c, _m in result.exceptions
                        )
                        if retryable:
                            raise RuntimeError(result.exceptions[0][1])
                    except Exception as e:
                        self.broker.health.record_failure(owner)
                        tried = extra.setdefault("_tried", [owner])
                        if owner not in tried:
                            tried.append(owner)
                        alternates = [o for o in owners if o not in tried]
                        if alternates and time.monotonic() < deadline:
                            alt = alternates[0]
                            extra["_tried"] = tried + [alt]
                            sg_union["retries"] += 1
                            ctx.event(
                                "joinOwnerFailover", fromServer=owner, toServer=alt
                            )
                            clean = {
                                k: v for k, v in extra.items() if k != "_tried"
                            }
                            nf = submit(alt, clean)
                            pending[nf] = (i, alt, extra, nbytes)
                            continue
                        exceptions.append(
                            QueryException(
                                ErrorCode.BROKER_GATHER,
                                f"join owner {owner}: {type(e).__name__}: {e}",
                            )
                        )
                        failed_partitions += 1
                        continue
                    self.broker.health.record_success(owner)
                    sg_union["servers_responded"].add(owner)
                    per_server[owner] = per_server.get(owner, 0) + nbytes
                    if result.trace:
                        sg_union["server_traces"].append(
                            (None, {k: list(v) for k, v in result.trace.items()})
                        )
                    parts.append(result)
        if failed_partitions:
            # a lost partition means missing joined rows: degrade
            # honestly, exactly like unserved segments
            sg_union["unserved"].append(f"join-partitions:{failed_partitions}")
        return parts, per_server, exceptions
