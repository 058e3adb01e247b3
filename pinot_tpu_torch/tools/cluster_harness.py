"""In-process cluster harness: a controller, N servers and a broker in one
process (port of ``pinot_tpu.tools.cluster_harness``, trimmed).

The reference's ``PerfBenchmarkDriver.java:61`` and the integration
tests' ``ClusterTest`` start the whole cluster in one process the same
way.  The servers join the controller as participants
(``server/starter.py``) and the broker's routing and hybrid time
boundaries follow the controller's external views through a view
listener (the reference's ``broker/starter.py``).  A REALTIME table's
consumers are stepped by the caller (``consume_step`` / ``try_commit`` of
``controller.realtime_manager.consumers_of(segment)``) unless an
``IngestConsumerPool`` is set as ``controller.realtime_manager.ingest_pool``.

The self-stabilization scenarios (``run_kill_server_scenario``,
``run_drain_scenario``, ``run_rolling_restart_scenario``,
``run_rolling_restart_warm_scenario``) run closed-loop query load
(``ClosedLoopLoad``) over an in-process cluster while a server dies,
drains or every server rolls, stepping the stabilizer with ``run_once``;
``run_split_brain_scenario`` starts a second controller over the first's
property store and checks that every write of the fenced-off first one
raises ``StaleEpochError``.  Each returns the reference's result dict.

``NetworkedCluster`` runs a controller, servers and a broker in one
process over their real protocols (HTTP and TCP), every link through one
seeded ``NetworkFaultInjector``; the partition scenarios
(``run_partition_server_scenario``, ``run_partition_controller_scenario``,
``run_asymmetric_partition_scenario``) run on it.
``run_disaster_recovery_scenario`` backs an in-process cluster up while it
serves, destroys its property store and restores it from the archive and
the deep store (``tools/backup.py``).

Left out, ROADMAP queue 1 item 30 (b): the elastic-fleet, noisy-neighbour,
flood, backpressure, HBM-pressure and audit-divergence scenarios and the
``--scenario`` command line.
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Union

import torch

from pinot_tpu_torch.broker.broker import OFFLINE_SUFFIX, BrokerHttpServer, BrokerRequestHandler
from pinot_tpu_torch.broker.routing import RoutingTableProvider
from pinot_tpu_torch.common.conf import BrokerConf, ServerConf
from pinot_tpu_torch.common.response import BrokerResponse
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.tableconfig import StreamConfig, TableConfig
from pinot_tpu_torch.controller.controller import Controller
from pinot_tpu_torch.controller.resource_manager import InstanceState
from pinot_tpu_torch.segment.immutable import ImmutableSegment
from pinot_tpu_torch.server.instance import ServerInstance
from pinot_tpu_torch.server.starter import ServerStarter, residency_options
from pinot_tpu_torch.transport.local import LocalTransport


class InProcessCluster:
    """``device``: the servers' device (None: the current CUDA device;
    ``"cpu"`` for tests).  ``http=True`` also serves the broker over HTTP
    (``BrokerHttpServer``, ``self.http``), its URL registered on the
    broker's instance.  ``broker_conf`` (a ``BrokerConf``) builds the
    broker through ``BrokerRequestHandler.from_conf`` (hedging, retries,
    admission); ``server_conf`` (a ``ServerConf``) gives each server its
    worker count (``query_worker_threads``).  ``server_kwargs`` reach every
    ``ServerInstance`` (a ``device_fault_injector``, a ``result_cache``
    ...)."""

    def __init__(
        self,
        num_servers: int = 2,
        data_dir: Optional[str] = None,
        http: bool = False,
        timeout_ms: float = 15_000.0,
        max_pending: int = 64,
        device: Optional[Union[str, torch.device]] = None,
        broker_conf: Optional[BrokerConf] = None,
        server_conf: Optional[ServerConf] = None,
        server_kwargs: Optional[Dict] = None,
    ) -> None:
        self.data_dir = data_dir or tempfile.mkdtemp(prefix="pinot_tpu_torch_cluster_")
        self.device = device
        self.max_pending = max_pending
        self.server_conf = server_conf
        self.server_kwargs = dict(server_kwargs or {})
        self.controller = Controller(self.data_dir)
        self.transport = LocalTransport()
        self.servers: List[ServerInstance] = []
        self.server_starters: List[ServerStarter] = []
        if broker_conf is not None:
            self.broker = BrokerRequestHandler.from_conf(self.transport, {}, broker_conf, name="broker0")
        else:
            self.broker = BrokerRequestHandler(self.transport, {}, name="broker0", timeout_ms=timeout_ms)
        self.http: Optional[BrokerHttpServer] = None
        self.broker_url: Optional[str] = None
        if http:
            self.http = BrokerHttpServer(self.broker)
            self.http.start()
            self.broker_url = f"http://{self.http.host}:{self.http.port}"
        self._attach_broker()
        for _ in range(num_servers):
            self.add_server()

    def _attach_broker(self) -> None:
        """Register the broker on the controller and follow its views: the
        routing of every table it already has is seeded now."""
        resources = self.controller.resources
        resources.register_instance(InstanceState(self.broker.name, role="broker", url=self.broker_url))
        resources.add_view_listener(self._on_view_change)
        # a liveness flip reaches the broker's health tracker on the same
        # path that rebuilds its routing
        resources.add_instance_listener(self._on_instance_change)
        for table in resources.tables():
            self._on_view_change(table, resources.get_external_view(table))

    def attach_controller(self, controller: Controller) -> None:
        """Join every server and the broker to ``controller`` (a restored or
        restarted one over the same data directory): the servers first,
        whose replays refill its external views, then the broker, whose
        routing is seeded from those views (the reference restarts its
        ``ServerStarter`` and ``BrokerStarter`` the same way)."""
        self.controller = controller
        self.server_starters = []
        for server in self.servers:
            starter = ServerStarter(server, controller.resources)
            starter.start()
            self.server_starters.append(starter)
        self._attach_broker()

    def _on_instance_change(self, name: str, alive: bool) -> None:
        if alive:
            self.broker.health.mark_alive(name)
        else:
            self.broker.health.mark_dead(name)

    def _on_view_change(self, table: str, view: Dict[str, Dict[str, str]]) -> None:
        """The broker's routing, quota, SLO objectives, declared
        partitioning and time boundary follow each view change."""
        resources = self.controller.resources
        if table not in resources.tables():
            self.broker.routing.remove(table)
            self.broker.time_boundary.remove(table)
            # the SLO override goes once no physical half of the raw table
            # remains (a hybrid table's two halves share one)
            raw = table.rsplit("_", 1)[0]
            if not any(t.rsplit("_", 1)[0] == raw for t in resources.tables()):
                self.broker.slo.set_objective(raw, None)
            return
        self.broker.routing.update(table, view)
        config = resources.table_configs.get(table)
        if config is not None:
            # idempotent for an unchanged quota (a re-notify never refills
            # a drained bucket); None clears a removed one
            self.broker.quota.set_quota(
                config.raw_name, config.quota.max_queries_per_second, config.quota.burst_queries)
            self.broker.slo.set_objective(config.raw_name, config.slo.to_json() if config.slo is not None else None)
            # declared partitioning feeds the join planner's colocation check
            p = config.partitioning
            self.broker.joinplan.partitions.set_partitioning(
                config.raw_name, p.column if p is not None else None, p.num_partitions if p is not None else None)
        if table.endswith(OFFLINE_SUFFIX):
            metas = []
            for seg in resources.segments_of(table):
                info = resources.get_segment_metadata(table, seg)
                if info and info.get("metadata") is not None:
                    metas.append(info["metadata"])
            self.broker.time_boundary.update_from_segments(table, metas)

    def add_server(self, name: Optional[str] = None) -> ServerInstance:
        """Join a new server into the running cluster."""
        name = name or f"server{len(self.servers)}"
        kwargs = dict(residency_options(), **self.server_kwargs)
        if self.server_conf is not None:
            kwargs["num_workers"] = self.server_conf.query_worker_threads
        server = ServerInstance(name, device=self.device, max_pending=self.max_pending, **kwargs)
        address = (server.name, 0)
        self.transport.register(address, server.handle_request)
        self.broker.set_server_address(server.name, address)
        starter = ServerStarter(server, self.controller.resources)
        starter.start()
        self.servers.append(server)
        self.server_starters.append(starter)
        return server

    # -- convenience API ---------------------------------------------
    def add_offline_table(self, schema: Schema, table_name: Optional[str] = None, **config_kwargs) -> str:
        self.controller.add_schema(schema)
        config = TableConfig(table_name=table_name or schema.schema_name, table_type="OFFLINE", **config_kwargs)
        return self.controller.add_table(config)

    def add_realtime_table(self, schema: Schema, stream, table_name: Optional[str] = None,
                           rows_per_segment: int = 1000, replication: int = 1) -> str:
        self.controller.add_schema(schema)
        config = TableConfig(
            table_name=table_name or schema.schema_name,
            table_type="REALTIME",
            replication=replication,
            stream=StreamConfig(stream_type="memory", rows_per_segment=rows_per_segment),
        )
        return self.controller.add_realtime_table(config, stream)

    def upload(self, physical_table: str, segment: ImmutableSegment) -> None:
        self.controller.upload_segment(physical_table, segment)

    def query(self, pql: str, trace: bool = False) -> BrokerResponse:
        return self.broker.handle_pql(pql, trace=trace)

    def stop(self) -> None:
        """Stop the broker's HTTP front, the ingest pool and every
        consumer, the broker, the servers (their scheduler workers and
        device lanes) and the controller (its history thread, managers and
        property store)."""
        if self.http is not None:
            self.http.stop()
        rm = self.controller.realtime_manager
        if rm.ingest_pool is not None:
            rm.ingest_pool.stop()
        for dm in list(rm._consumers.values()):
            dm.stop()
        self.broker.shutdown()
        for s in self.servers:
            s.shutdown()
        self.controller.stop()


def single_server_broker(table: str, segments, timeout_ms: float = 600_000.0, max_pending: int = 64,
                         **server_kwargs) -> BrokerRequestHandler:
    """One in-process server and a broker over ``LocalTransport``, the
    smallest serving topology.  Extra keyword arguments reach the
    ``ServerInstance`` (``device="cpu"`` in tests, ``pipeline=False`` for
    the serial path); the instance is ``broker.local_servers[0]``."""
    server = ServerInstance("benchServer", max_pending=max_pending, **server_kwargs)
    for seg in segments:
        server.add_segment(table, seg)
    transport = LocalTransport()
    transport.register(("benchServer", 0), server.handle_request)
    routing = RoutingTableProvider()
    routing.update(table, {s.segment_name: {"benchServer": "ONLINE"} for s in segments})
    broker = BrokerRequestHandler(transport, {"benchServer": ("benchServer", 0)}, routing=routing,
                                  timeout_ms=timeout_ms)
    broker.local_servers = [server]
    return broker


# ---------------------------------------------------------------------------
# Self-stabilization scenarios: closed-loop load over an in-process cluster
# while a server is killed, drained, or the whole fleet restarts in turn,
# the stabilizer stepped with run_once (no background sleeps).
# ---------------------------------------------------------------------------


class ClosedLoopLoad:
    """N client threads sending one query back to back and classifying
    every answer: ok (complete and correct), partial (a transient
    ``partialResponse``, allowed while healing) or failed (a wrong count,
    or exceptions on an answer that claims to be complete)."""

    def __init__(self, cluster: "InProcessCluster", pql: str, expected_docs: Optional[int],
                 clients: int = 3) -> None:
        self.cluster = cluster
        self.pql = pql
        # None: any complete answer is ok (a live realtime table)
        self.expected_docs = expected_docs
        self.clients = clients
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self.total = 0
        self.ok = 0
        self.partials = 0
        self.failed = 0
        self.failures: List[str] = []  # the first few failures
        self.latencies_ms: List[float] = []

    def _loop(self) -> None:
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                resp = self.cluster.broker.handle_pql(self.pql)
            except Exception as e:  # a raised handler is always a failure
                with self._lock:
                    self.total += 1
                    self.failed += 1
                    if len(self.failures) < 8:
                        self.failures.append(f"{type(e).__name__}: {e}")
                continue
            ms = (time.perf_counter() - t0) * 1000.0
            with self._lock:
                self.total += 1
                self.latencies_ms.append(ms)
                if resp.partial_response:
                    self.partials += 1
                elif resp.exceptions or (
                        self.expected_docs is not None and resp.num_docs_scanned != self.expected_docs):
                    self.failed += 1
                    if len(self.failures) < 8:
                        self.failures.append(f"docs={resp.num_docs_scanned}/{self.expected_docs} "
                                             f"exceptions={[e.message for e in resp.exceptions][:2]}")
                else:
                    self.ok += 1

    def start(self) -> "ClosedLoopLoad":
        for i in range(self.clients):
            t = threading.Thread(target=self._loop, name=f"load-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    @staticmethod
    def _pct(sorted_ms: List[float], p: float) -> float:
        if not sorted_ms:
            return 0.0
        i = min(len(sorted_ms) - 1, int(round(p / 100.0 * (len(sorted_ms) - 1))))
        return sorted_ms[i]

    def stop(self) -> Dict[str, Any]:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)
        lat = sorted(self.latencies_ms)
        return {
            "queries": self.total,
            "okQueries": self.ok,
            "partialQueries": self.partials,
            "failedQueries": self.failed,
            "failures": list(self.failures),
            "p50Ms": round(self._pct(lat, 50), 3),
            "p99Ms": round(self._pct(lat, 99), 3),
        }


def _build_scenario_cluster(num_servers: int, replication: int, num_segments: int,
                            data_dir: Optional[str] = None, seed: int = 5, device=None):
    from pinot_tpu_torch.segment.builder import build_segment
    from pinot_tpu_torch.tools.datagen import make_test_schema, random_rows

    cluster = InProcessCluster(num_servers=num_servers, data_dir=data_dir, device=device)
    # the scenarios step rounds themselves: act on a death at once
    cluster.controller.stabilizer.grace_s = 0.0
    schema = make_test_schema(with_mv=False)
    physical = cluster.add_offline_table(schema, replication=replication)
    rows = random_rows(schema, 260, seed=seed)
    total = 0
    for i in range(num_segments):
        # skewed sizes: the stabilizer's doc-weighted placement keeps the
        # re-replication balanced under this skew
        n = 30 + 45 * (i % 5)
        cluster.upload(physical, build_segment(schema, rows[:n], physical, f"seg{i}"))
        total += n
    return cluster, physical, total


def _replication_state(cluster, physical: str, excluded=()) -> Dict[str, Any]:
    res = cluster.controller.resources
    ideal = res.get_ideal_state(physical)
    return {
        "segments": len(ideal),
        "replicaSetSizes": sorted({len(r) for r in ideal.values()}) if ideal else [],
        "onExcluded": sum(1 for r in ideal.values() if any(s in r for s in excluded)),
        "viewConverged": res.get_external_view(physical) == ideal,
    }


def run_kill_server_scenario(num_servers: int = 3, replication: int = 2, num_segments: int = 6,
                             clients: int = 3, rounds: int = 2, victim: str = "server0",
                             data_dir: Optional[str] = None, device=None) -> Dict[str, Any]:
    """Kill one server under closed-loop load: no failed query (replica
    failover absorbs the loss), full replication restored by the
    stabilizer within ``rounds`` rounds, the dead replicas dropped."""
    cluster, physical, total = _build_scenario_cluster(num_servers, replication, num_segments, data_dir,
                                                       device=device)
    try:
        load = ClosedLoopLoad(cluster, "SELECT count(*) FROM testTable", total, clients).start()
        time.sleep(0.15)  # some queries complete before the fault
        # the data plane goes dark, then the control plane declares the
        # death (the heartbeat expiry calls the same liveness flip)
        cluster.transport.set_down((victim, 0))
        cluster.controller.resources.set_instance_alive(victim, False)
        for _ in range(rounds):
            cluster.controller.stabilizer.run_once()
        time.sleep(0.15)  # the healed steady state under load
        summary = load.stop()
        state = _replication_state(cluster, physical, excluded=[victim])
        final = cluster.query("SELECT count(*) FROM testTable")
        want = min(replication, num_servers - 1)
        return {
            "scenario": "kill-server",
            "victim": victim,
            "rounds": rounds,
            **summary,
            **state,
            "replicationRestored": state["replicaSetSizes"] == [want] and state["onExcluded"] == 0,
            "finalDocs": final.num_docs_scanned,
            "expectedDocs": total,
            "finalComplete": not final.partial_response and not final.exceptions,
            "stabilizer": cluster.controller.stabilizer.metrics.snapshot()["meters"],
        }
    finally:
        cluster.stop()


def _drain_one(cluster, name: str, max_rounds: int = 6) -> int:
    """Drain ``name`` and step the stabilizer until its replicas have all
    moved; returns the rounds used."""
    cluster.controller.drain_instance(name)
    used = 0
    while used < max_rounds:
        if cluster.controller.drain_status(name)["drained"]:
            break
        cluster.controller.stabilizer.run_once()
        used += 1
    return used


def run_drain_scenario(num_servers: int = 3, replication: int = 2, num_segments: int = 6,
                       clients: int = 3, victim: str = "server0", data_dir: Optional[str] = None,
                       device=None) -> Dict[str, Any]:
    """Drain one server under load: new routing stops covering it, the
    stabilizer moves every replica off, the drain status reports drained,
    and no query fails on the way."""
    cluster, physical, total = _build_scenario_cluster(num_servers, replication, num_segments, data_dir,
                                                       device=device)
    try:
        load = ClosedLoopLoad(cluster, "SELECT count(*) FROM testTable", total, clients).start()
        time.sleep(0.15)
        rounds = _drain_one(cluster, victim)
        status = cluster.controller.drain_status(victim)
        time.sleep(0.15)
        summary = load.stop()
        state = _replication_state(cluster, physical, excluded=[victim])
        final = cluster.query("SELECT count(*) FROM testTable")
        return {
            "scenario": "drain",
            "victim": victim,
            "roundsToDrain": rounds,
            "drainStatus": {k: status[k] for k in ("draining", "remainingSegments", "drained")},
            **summary,
            **state,
            "finalDocs": final.num_docs_scanned,
            "expectedDocs": total,
            "finalComplete": not final.partial_response and not final.exceptions,
        }
    finally:
        cluster.stop()


def run_rolling_restart_scenario(num_servers: int = 3, replication: int = 2, num_segments: int = 6,
                                 clients: int = 3, data_dir: Optional[str] = None,
                                 device=None) -> Dict[str, Any]:
    """Restart every server under load, one at a time: drain, let the
    replicas move, restart (down and dead, then back), undrain, next.  No
    failed query, no segment lost."""
    cluster, physical, total = _build_scenario_cluster(num_servers, replication, num_segments, data_dir,
                                                       device=device)
    res = cluster.controller.resources
    try:
        load = ClosedLoopLoad(cluster, "SELECT count(*) FROM testTable", total, clients).start()
        time.sleep(0.1)
        rounds_per_server: Dict[str, int] = {}
        for server in [s.name for s in cluster.servers]:
            rounds_per_server[server] = _drain_one(cluster, server)
            assert cluster.controller.drain_status(server)["drained"], server
            # the restart: the process goes away (data plane down, death
            # declared) and comes back; it holds nothing, so queries do not
            # see it
            cluster.transport.set_down((server, 0))
            res.set_instance_alive(server, False)
            cluster.transport.set_down((server, 0), False)
            res.set_instance_alive(server, True)
            cluster.controller.undrain_instance(server)
            cluster.controller.stabilizer.run_once()
        time.sleep(0.1)
        summary = load.stop()
        state = _replication_state(cluster, physical)
        final = cluster.query("SELECT count(*) FROM testTable")
        return {
            "scenario": "rolling-restart",
            "roundsPerServer": rounds_per_server,
            **summary,
            **state,
            "noSegmentLoss": state["replicaSetSizes"] == [replication]
            and final.num_docs_scanned == total and not final.partial_response,
            "finalDocs": final.num_docs_scanned,
            "expectedDocs": total,
        }
    finally:
        cluster.stop()


def _mirror_warming(cluster) -> None:
    """The in-process stand-in for the heartbeat's readiness feed: copy
    each server's ``prewarm.warming`` into the controller's instance state
    (the stabilizer's trim gate) and the broker's health tracker (routing
    deprioritizes a warming server)."""
    res = cluster.controller.resources
    for s in cluster.servers:
        w = bool(s.prewarm.warming)
        res.set_instance_warming(s.name, w)
        cluster.broker.health.set_warming(s.name, w)


def run_rolling_restart_warm_scenario(
    num_servers: int = 3, replication: int = 2, num_segments: int = 6, clients: int = 1,
    data_dir: Optional[str] = None, cache_dir: Optional[str] = None, steady_s: float = 0.7,
    prewarm_timeout_s: float = 10.0, p99_multiple: float = 8.0, p99_floor_ms: float = 150.0,
    max_rounds: int = 120, device=None,
) -> Dict[str, Any]:
    """Rolling restart with warm starts: every server is drained, killed
    and replaced by a fresh ``ServerInstance`` (empty compile registries)
    that shares only the persistent compile cache, while a closed loop
    replays the steady query mix.  No failed query; no cold compile on a
    restarted server (the steady phase recorded every plan digest in the
    persistent ledger); the stabilizer's trims wait for warming
    destinations (``rebalanceTrimDeferred`` events); the roll's p99 stays
    bounded by the steady one's.  ``clients=1`` keeps the plan shapes the
    steady phase's, which makes the no-cold-compile bar deterministic."""
    cache_dir = cache_dir or tempfile.mkdtemp(prefix="pinot_tpu_torch_warmcache_")
    prev_env = os.environ.get("PINOT_TPU_COMPILE_CACHE_DIR")
    os.environ["PINOT_TPU_COMPILE_CACHE_DIR"] = cache_dir
    cluster, physical, total = _build_scenario_cluster(num_servers, replication, num_segments, data_dir,
                                                       device=device)
    res = cluster.controller.resources
    stab = cluster.controller.stabilizer
    stab.prewarm_timeout_s = prewarm_timeout_s
    stab.rebalance_hysteresis = 1  # rounds are stepped here
    restarted: List[str] = []
    try:
        # in-process, the broker's own plan statistics are the fleet roll-up
        def workload_source(tables, n):
            return cluster.broker.workload_snapshot(top=n, tables=tables)["topByCount"]

        for s in cluster.servers:
            s.prewarm.workload_source = workload_source
            s.prewarm.timeout_s = prewarm_timeout_s

        pql = "SELECT sum(metInt), count(*) FROM testTable GROUP BY dimStr TOP 5"
        count_pql = "SELECT count(*) FROM testTable"
        # both shapes warm before measuring: the steady baseline holds no
        # one-time cold, and every digest a restarted server can see is in
        # the persistent ledger before the first restart
        for warm_pql in (pql, count_pql):
            r = cluster.broker.handle_pql(warm_pql)
            assert not r.exceptions, r.exceptions
        steady_load = ClosedLoopLoad(cluster, pql, total, clients).start()
        time.sleep(steady_s)
        steady = steady_load.stop()
        assert steady["failedQueries"] == 0, steady["failures"]

        roll_load = ClosedLoopLoad(cluster, pql, total, clients).start()
        rounds_per_server: Dict[str, int] = {}
        for i in range(len(cluster.servers)):
            old = cluster.servers[i]
            name = old.name
            # drain: each destination warms as the moved segments load, so
            # dropping the draining copy waits for readiness
            cluster.controller.drain_instance(name)
            used = 0
            while used < max_rounds:
                _mirror_warming(cluster)
                stab.run_once()
                used += 1
                if cluster.controller.drain_status(name)["drained"]:
                    break
                time.sleep(0.05)
            assert cluster.controller.drain_status(name)["drained"], name
            rounds_per_server[name] = used
            # the restart: a fresh instance under the same name, with the
            # same persistent cache
            cluster.transport.set_down((name, 0))
            res.set_instance_alive(name, False)
            old.shutdown()
            kwargs = dict(residency_options(), **cluster.server_kwargs)
            fresh = ServerInstance(name, device=cluster.device, max_pending=cluster.max_pending, **kwargs)
            fresh.prewarm.timeout_s = prewarm_timeout_s
            starter = ServerStarter(fresh, res, workload_source=workload_source)
            starter.start()
            cluster.transport.register((name, 0), fresh.handle_request)
            cluster.transport.set_down((name, 0), False)
            res.set_instance_alive(name, True)
            cluster.controller.undrain_instance(name)
            cluster.servers[i] = fresh
            cluster.server_starters[i] = starter
            restarted.append(name)
            # recovery: the proactive rebalance moves load onto the empty
            # restart and its trims wait for it to finish warming.  The
            # skew bar drops for this loop only (an empty restart is a
            # ~1.5x skew the default bar tolerates)
            default_skew = stab.rebalance_skew_ratio
            stab.rebalance_skew_ratio = 1.2
            used = 0
            while used < max_rounds:
                _mirror_warming(cluster)
                stab.run_once()
                _mirror_warming(cluster)
                hosts = any(name in reps for reps in res.get_ideal_state(physical).values())
                if hosts and not fresh.prewarm.warming and not stab._pending_moves:
                    break
                used += 1
                time.sleep(0.05)
            stab.rebalance_skew_ratio = default_skew
        time.sleep(0.15)  # the steady tail under the recovered fleet
        roll = roll_load.stop()

        state = _replication_state(cluster, physical)
        events = stab.events()
        deferrals = [e for e in events if e["event"] == "rebalanceTrimDeferred"]
        timeouts = [e for e in events if e["event"] == "rebalancePrewarmTimeout"]
        per_server: Dict[str, Dict[str, Any]] = {}
        for s in cluster.servers:
            m = s.metrics.snapshot()["meters"]

            def count(name: str) -> int:
                return int(m.get(name, {}).get("count", 0))

            per_server[s.name] = {
                "compileCold": count("compile.cold"),
                "compileWarm": count("compile.warm"),
                "persistentHits": count("compile.persistentHit"),
                "prewarmed": count("compile.prewarmed"),
                "prewarmCompiled": count("prewarm.compiled"),
                "prewarmFailed": count("prewarm.failed"),
                "laneRestarts": count("lane.restarts"),
                "laneDeviceFailures": count("lane.deviceFailures"),
            }
        restarted_stats = [per_server[n] for n in restarted]
        p99_limit = p99_multiple * max(steady["p99Ms"], p99_floor_ms)
        by_class: Dict[str, int] = {}
        for e in deferrals:
            by_class[e["class"]] = by_class.get(e["class"], 0) + 1
        final = cluster.query(count_pql)
        return {
            "scenario": "rolling-restart-warm",
            "cacheDir": cache_dir,
            "roundsPerServer": rounds_per_server,
            "restarted": restarted,
            "steady": steady,
            **roll,
            **state,
            "servers": per_server,
            "coldCompilesOnRestarted": sum(s["compileCold"] for s in restarted_stats),
            "warmStartsOnRestarted": sum(s["persistentHits"] + s["prewarmed"] for s in restarted_stats),
            "laneWatchdogClean": all(s["laneRestarts"] == 0 and s["laneDeviceFailures"] == 0
                                     for s in restarted_stats),
            "trimDeferrals": len(deferrals),
            "trimDeferralsByClass": by_class,
            "trimDeferralSample": deferrals[:3],
            "prewarmTimeouts": len(timeouts),
            "prewarmDeferralMeter": int(stab.metrics.snapshot()["meters"]
                                        .get("rebalance.prewarmDeferrals", {}).get("count", 0)),
            "steadyP99Ms": steady["p99Ms"],
            "rollP99Ms": roll["p99Ms"],
            "p99LimitMs": round(p99_limit, 3),
            "p99Bounded": roll["p99Ms"] <= p99_limit,
            "finalDocs": final.num_docs_scanned,
            "expectedDocs": total,
            "finalComplete": not final.partial_response and not final.exceptions,
            "noSegmentLoss": state["replicaSetSizes"] == [replication]
            and final.num_docs_scanned == total and not final.partial_response,
        }
    finally:
        for s in cluster.servers:
            s.prewarm.stop()
        cluster.stop()
        if prev_env is None:
            os.environ.pop("PINOT_TPU_COMPILE_CACHE_DIR", None)
        else:
            os.environ["PINOT_TPU_COMPILE_CACHE_DIR"] = prev_env


def run_split_brain_scenario(data_dir: Optional[str] = None, device=None) -> Dict[str, Any]:
    """Two controllers over one property store: A builds the cluster, then
    B claims the store (epoch + 1) and A is a zombie.  Every write A tries
    (a stabilizer round, an upload, a quota, a delete, a drain) raises
    ``StaleEpochError`` and changes nothing durable; commit-plane calls
    under the other incarnation's epoch are refused both ways; and the
    ideal state converges to B's fixpoint."""
    from pinot_tpu_torch.common.fencing import StaleEpochError
    from pinot_tpu_torch.segment.builder import build_segment
    from pinot_tpu_torch.tools.datagen import make_test_schema, random_rows

    data_dir = data_dir or tempfile.mkdtemp(prefix="pinot_tpu_torch_splitbrain_")
    cluster_a = InProcessCluster(num_servers=2, data_dir=data_dir, device=device)
    ctrl_a = cluster_a.controller
    schema = make_test_schema(with_mv=False)
    physical = cluster_a.add_offline_table(schema, replication=2)
    rows = random_rows(schema, 120, seed=11)
    for i in range(3):
        cluster_a.upload(physical, build_segment(schema, rows[:30 + 10 * i], physical, f"sb{i}"))

    # B claims the store: A is fenced from here on
    ctrl_b = Controller(data_dir)
    ctrl_b.stabilizer.grace_s = 0.0
    servers_b: List[ServerInstance] = []
    for name in ("server0", "server1"):
        s = ServerInstance(name, device=cluster_a.device)
        ServerStarter(s, ctrl_b.resources).start()
        servers_b.append(s)

    stale_rejections: Dict[str, bool] = {}

    def _stale(label: str, fn) -> None:
        try:
            fn()
            stale_rejections[label] = False
        except StaleEpochError:
            stale_rejections[label] = True
        except Exception:
            stale_rejections[label] = False

    try:
        store_ideal_before = ctrl_b.property_store.get("idealstates", physical)
        # the stabilizer first: the later attempts change the zombie's own
        # memory (a fenced write fails after its in-memory change), which
        # could leave it nothing live to re-replicate onto
        _stale("stabilizerWrite", lambda: _zombie_stabilizer_write(ctrl_a, physical))
        _stale("upload", lambda: ctrl_a.upload_segment(
            physical, build_segment(schema, rows[:20], physical, "zombie")))
        _stale("quota", lambda: ctrl_a.resources.update_table_quota(physical, 5.0))
        _stale("delete", lambda: ctrl_a.delete_segment(physical, "sb0"))
        _stale("drain", lambda: ctrl_a.drain_instance("server0"))
        # the commit plane, both ways: B's epoch at A, A's epoch at B
        _stale("commitPlaneAtZombie", lambda: ctrl_a.realtime_manager.completion.segment_consumed(
            f"{physical}__0__0", "server0", 10, epoch=ctrl_b.epoch))
        _stale("commitPlaneAtLive", lambda: ctrl_b.realtime_manager.completion.segment_consumed(
            f"{physical}__0__0", "server0", 10, epoch=ctrl_a.epoch))
        store_unchanged = store_ideal_before == ctrl_b.property_store.get("idealstates", physical)

        # the live controller converges to its fixpoint (a server killed to
        # force real stabilizer work after the fence)
        ctrl_b.resources.set_instance_alive("server0", False)
        for _ in range(3):
            ctrl_b.stabilizer.run_once()
        ideal_b = ctrl_b.resources.get_ideal_state(physical)
        converged = (
            all("server0" not in r for r in ideal_b.values())
            and all(len(r) == 1 for r in ideal_b.values())
            and ctrl_b.resources.get_external_view(physical) == ideal_b
        )
        # idempotent: one more round changes nothing
        ctrl_b.stabilizer.run_once()
        converged = converged and ctrl_b.resources.get_ideal_state(physical) == ideal_b
        all_rejected = all(stale_rejections.values())
        return {
            "scenario": "split-brain",
            "epochA": ctrl_a.epoch,
            "epochB": ctrl_b.epoch,
            "staleRejections": stale_rejections,
            "allStaleWritesRejected": all_rejected,
            "durableStoreUnchangedByZombie": store_unchanged,
            "liveControllerConverged": converged,
            "staleEpochRejectionsMetered": ctrl_a.metrics.meter("fence.staleEpochRejections").count
            + ctrl_b.metrics.meter("fence.staleEpochRejections").count,
            "failedQueries": 0 if (all_rejected and store_unchanged and converged) else 1,
        }
    finally:
        for s in servers_b:
            s.shutdown()
        ctrl_b.stop()
        cluster_a.stop()


def _zombie_stabilizer_write(ctrl_a, physical: str) -> None:
    """Make the zombie's stabilizer try a persisted write (its own view
    says a server died); the write must raise ``StaleEpochError``."""
    ctrl_a.resources.set_instance_alive("server1", False)
    ctrl_a.stabilizer.grace_s = 0.0
    before = ctrl_a.resources.get_ideal_state(physical)
    ctrl_a.stabilizer.run_once()
    # a fenced write raises through run_once: getting here means no write
    # was attempted
    if before == ctrl_a.resources.get_ideal_state(physical):
        raise RuntimeError("stabilizer made no write attempt")


# ---------------------------------------------------------------------------
# Network-partition scenarios: a controller, servers and a broker as real
# HTTP and TCP endpoints in one process, every link routed through a shared
# NetworkFaultInjector: the topology where "unreachable" and "dead" are
# different things.
# ---------------------------------------------------------------------------


class NetworkedCluster:
    """One-process networked cluster wired for link-level chaos.

    Unlike ``InProcessCluster`` (direct callbacks), every role here talks
    over its real protocol (the servers and the broker register, heartbeat,
    poll and scatter over HTTP and TCP) and every link consults one
    seedable ``NetworkFaultInjector``, so a scenario can cut exactly the
    broker -> controller poll or exactly the controller -> server reply
    direction.  The timing knobs default tight so the partition scenarios
    run at tier-1 speed.  ``device`` is every server's (None: the current
    CUDA device; ``"cpu"`` for tests)."""

    def __init__(
        self,
        num_servers: int = 3,
        data_dir: Optional[str] = None,
        seed: int = 0,
        lease_s: float = 2.5,
        heartbeat_interval_s: float = 0.2,
        heartbeat_timeout_s: float = 1.2,
        poll_interval_s: float = 0.1,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        from pinot_tpu_torch.broker.network_starter import NetworkedBrokerStarter
        from pinot_tpu_torch.common.faults import NetworkFaultInjector
        from pinot_tpu_torch.controller.controller import ControllerHttpServer
        from pinot_tpu_torch.server.network_starter import NetworkedServerStarter

        self.data_dir = data_dir or tempfile.mkdtemp(prefix="pinot_tpu_torch_netchaos_")
        self.faults = NetworkFaultInjector(seed=seed)
        self.lease_s = lease_s
        # the clients (the starters and the scatter transport) consult the
        # injector, so the controller's gateway edge must not: wiring both
        # would apply delay, error_rate and duplicate twice on controller
        # links.  The gateway hook is for harnesses that cannot reach the
        # client processes.
        self.controller = Controller(self.data_dir, lease_s=lease_s)
        self.controller.gateway.heartbeat_timeout_s = heartbeat_timeout_s
        self.controller.gateway._check_interval_s = max(0.05, heartbeat_timeout_s / 4)
        self.http = ControllerHttpServer(self.controller)
        self.http.start()
        self.url = f"http://{self.http.host}:{self.http.port}"
        self.server_starters: List[NetworkedServerStarter] = []
        for i in range(num_servers):
            s = NetworkedServerStarter(
                self.url, f"srv{i}", data_dir=os.path.join(self.data_dir, f"cache{i}"),
                heartbeat_interval_s=heartbeat_interval_s, poll_interval_s=poll_interval_s,
                device=device, fault_injector=self.faults,
            )
            s.start()
            self.server_starters.append(s)
        self.broker_starter = NetworkedBrokerStarter(
            self.url, "brk0", heartbeat_interval_s=heartbeat_interval_s, poll_interval_s=poll_interval_s,
            fault_injector=self.faults,
        )
        self.broker_starter.start()

    @property
    def broker(self):
        """The broker's request handler (what ``ClosedLoopLoad`` drives)."""
        return self.broker_starter.handler

    def server(self, name: str):
        return next(s for s in self.server_starters if s.name == name)

    def query(self, pql: str) -> BrokerResponse:
        return self.broker.handle_pql(pql)

    def wait(self, cond, timeout_s: float = 25.0, what: str = "condition") -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            try:
                if cond():
                    return
            except Exception:
                pass
            time.sleep(0.05)
        raise AssertionError(f"timed out waiting for {what}")

    def stop(self) -> None:
        self.faults.heal()  # stop() never races injected cuts
        self.broker_starter.stop()
        for s in self.server_starters:
            s.stop()
        self.http.stop()
        self.controller.stop()


def _build_partition_cluster(num_servers: int = 3, replication: int = 2, num_segments: int = 6,
                             data_dir: Optional[str] = None, seed: int = 5, **cluster_kwargs: Any):
    """An OFFLINE table over a ``NetworkedCluster``, converged (every
    replica ONLINE, the broker serving the complete count) before any
    weather is injected."""
    from pinot_tpu_torch.segment.builder import build_segment
    from pinot_tpu_torch.tools.datagen import make_test_schema, random_rows

    cluster = NetworkedCluster(num_servers=num_servers, data_dir=data_dir, seed=seed, **cluster_kwargs)
    try:
        # grace zero: the lease window is the guard these scenarios test
        cluster.controller.stabilizer.grace_s = 0.0
        schema = make_test_schema(with_mv=False)
        cluster.controller.add_schema(schema)
        physical = cluster.controller.add_table(
            TableConfig(table_name="testTable", table_type="OFFLINE", replication=replication))
        rows = random_rows(schema, 260, seed=seed)
        total = 0
        for i in range(num_segments):
            n = 30 + 45 * (i % 5)
            cluster.controller.upload_segment(physical, build_segment(schema, rows[:n], physical, f"seg{i}"))
            total += n
        res = cluster.controller.resources

        def converged():
            ideal = res.get_ideal_state(physical)
            view = res.get_external_view(physical)
            return (len(ideal) == num_segments and view == ideal
                    and all(len(r) == replication for r in ideal.values())
                    and all(st == "ONLINE" for r in view.values() for st in r.values()))

        cluster.wait(converged, what="all replicas ONLINE")

        def serving():
            r = cluster.query("SELECT count(*) FROM testTable")
            return r.num_docs_scanned == total and not r.exceptions and not r.partial_response

        cluster.wait(serving, what="broker serving the full count")
    except BaseException:
        cluster.stop()
        raise
    return cluster, physical, total


def run_partition_server_scenario(num_servers: int = 3, replication: int = 2, num_segments: int = 6,
                                  clients: int = 3, lease_s: float = 3.0, victim: str = "srv0",
                                  data_dir: Optional[str] = None, device=None) -> Dict[str, Any]:
    """Sever one server's controller link (both directions) for longer
    than its lease under closed-loop load:

    - zero failed queries (the broker re-covers through the replicas; the
      victim keeps answering in-flight work: it is alive, only unreachable
      from the controller);
    - its replicas move only after the lease window (the stabilizer
      defers while the lease could still be live: leaseDeferrals > 0),
      never on the first missed heartbeat;
    - the victim fences itself (its lease expires on its side) and rides
      the outage visibly (the controller.unreachable gauge);
    - on heal it rejoins cleanly: re-admitted, no duplicate replicas."""
    cluster, physical, total = _build_partition_cluster(num_servers, replication, num_segments,
                                                        data_dir=data_dir, lease_s=lease_s, device=device)
    res = cluster.controller.resources
    st = cluster.controller.stabilizer
    vsrv = cluster.server(victim).server
    try:
        load = ClosedLoopLoad(cluster, "SELECT count(*) FROM testTable", total, clients).start()
        time.sleep(0.2)  # some queries complete before the fault

        ideal_pre = res.get_ideal_state(physical)
        cluster.faults.partition(victim, "controller")
        cluster.wait(lambda: not res.instances[victim].alive, what="controller declaring the victim dead")
        # the single-missed-heartbeat point: dead at the gateway, but the
        # lease has not expired; a stabilizer round must move nothing (the
        # ideal state stays identical: a drop and a replace in one round
        # would otherwise pass)
        st.run_once()
        ideal_mid = res.get_ideal_state(physical)
        held_through_lease = ideal_mid == ideal_pre
        moved_on_heartbeat = ideal_mid != ideal_pre
        lease_deferrals = st.metrics.meter("stabilizer.leaseDeferrals").count

        # the victim notices on its side: its lease expires, the gauge flips
        cluster.wait(lambda: not vsrv.lease.held(), what="victim lease expiry")
        cluster.wait(lambda: vsrv.metrics.gauge("controller.unreachable").value == 1,
                     what="victim unreachable gauge")
        # the controller's side: wait out the lease window, then re-replicate
        cluster.wait(lambda: res.instances[victim].lease_until is not None
                     and time.monotonic() >= res.instances[victim].lease_until, what="lease window elapsing")
        # a dead replica leaves once the view shows its new copy ONLINE, so
        # the rounds go on until the drops land (one round a check)
        cluster.wait(lambda: st.run_once() or not any(victim in r for r in res.get_ideal_state(physical).values()),
                     what="victim replicas dropped after lease expiry")
        cluster.wait(lambda: res.get_external_view(physical) == res.get_ideal_state(physical)
                     and all(len(r) == min(replication, num_servers - 1)
                             for r in res.get_ideal_state(physical).values()),
                     what="re-replication converged")

        # heal: the victim rejoins cleanly
        cluster.faults.heal()
        cluster.wait(lambda: res.instances[victim].alive, what="victim re-admitted")
        cluster.wait(lambda: vsrv.lease.held(), what="victim lease renewed")
        st.run_once()
        time.sleep(0.2)
        summary = load.stop()

        ideal = res.get_ideal_state(physical)
        final = cluster.query("SELECT count(*) FROM testTable")
        return {
            "scenario": "partition-server",
            "victim": victim,
            "leaseSeconds": lease_s,
            **summary,
            "heldThroughLeaseWindow": held_through_lease,
            "movedOnFirstMissedHeartbeat": moved_on_heartbeat,
            "leaseDeferrals": lease_deferrals,
            "victimSelfFenced": True,  # waited on lease.held() == False
            "replicationRestored": all(len(r) == min(replication, num_servers - 1) for r in ideal.values())
            or all(len(r) == replication for r in ideal.values()),
            "noDuplicateReplicas": all(len(r) <= replication for r in ideal.values()),
            "victimReadmitted": res.instances[victim].alive,
            "finalDocs": final.num_docs_scanned,
            "expectedDocs": total,
            "finalComplete": not final.partial_response and not final.exceptions,
            "stabilizer": st.metrics.snapshot()["meters"],
        }
    finally:
        cluster.stop()


def run_partition_controller_scenario(num_servers: int = 2, replication: int = 2, num_segments: int = 4,
                                      clients: int = 3, lease_s: float = 1.2, data_dir: Optional[str] = None,
                                      device=None) -> Dict[str, Any]:
    """Sever the controller from every other role: the data plane rides out
    the control-plane outage.  The broker serves from its last versioned
    snapshot (controller.unreachable = 1), the servers fence their writes
    but keep answering queries, the stabilizer moves nothing (no live
    target exists), and on heal everyone is re-admitted with the ideal
    state identical to the one before the outage."""
    cluster, physical, total = _build_partition_cluster(num_servers, replication, num_segments,
                                                        data_dir=data_dir, lease_s=lease_s, device=device)
    res = cluster.controller.resources
    st = cluster.controller.stabilizer
    try:
        load = ClosedLoopLoad(cluster, "SELECT count(*) FROM testTable", total, clients).start()
        time.sleep(0.2)
        ideal_before = res.get_ideal_state(physical)

        # cut the broker first: its last applied snapshot must be the
        # healthy one (a poll racing the server cuts could otherwise
        # deliver a snapshot that already lists the servers dead)
        cluster.faults.partition("brk0", "controller")
        time.sleep(0.15)
        for s in cluster.server_starters:
            cluster.faults.partition(s.name, "controller")

        cluster.wait(lambda: all(not res.instances[s.name].alive for s in cluster.server_starters),
                     what="controller declaring every server dead")
        cluster.wait(lambda: cluster.broker.metrics.gauge("controller.unreachable").value == 1,
                     what="broker unreachable gauge")
        cluster.wait(lambda: all(not s.server.lease.held() for s in cluster.server_starters),
                     what="server leases expiring")
        # stabilizer rounds during the outage: nowhere to move anything
        for _ in range(3):
            st.run_once()
        unchanged_during = res.get_ideal_state(physical) == ideal_before

        cluster.faults.heal()
        cluster.wait(lambda: all(res.instances[s.name].alive for s in cluster.server_starters),
                     what="servers re-admitted")
        cluster.wait(lambda: cluster.broker.metrics.gauge("controller.unreachable").value == 0,
                     what="broker poll recovery")
        cluster.wait(lambda: all(s.server.lease.held() for s in cluster.server_starters), what="leases renewed")
        # recovery has converged (not just re-admitted) once every
        # replica's ONLINE re-ack has landed: the bounded unavailability
        # ends here, and the final query must be complete
        cluster.wait(lambda: res.get_external_view(physical) == res.get_ideal_state(physical),
                     what="external view reconverged after heal")
        st.run_once()
        # ... and the broker has applied it (one poll cycle), bounded by
        # the wait's timeout, which is the unavailability bound
        cluster.wait(lambda: (lambda r: r.num_docs_scanned == total and not r.partial_response
                              and not r.exceptions)(cluster.query("SELECT count(*) FROM testTable")),
                     what="broker serving the full count after heal")
        summary = load.stop()
        final = cluster.query("SELECT count(*) FROM testTable")
        return {
            "scenario": "partition-controller",
            "leaseSeconds": lease_s,
            **summary,
            "idealUnchangedDuringOutage": unchanged_during,
            "idealUnchangedAfterHeal": res.get_ideal_state(physical) == ideal_before,
            "brokerServedFromSnapshot": True,  # waited on the gauge flip
            "finalDocs": final.num_docs_scanned,
            "expectedDocs": total,
            "finalComplete": not final.partial_response and not final.exceptions,
        }
    finally:
        cluster.stop()


def run_asymmetric_partition_scenario(data_dir: Optional[str] = None, lease_s: float = 1.2,
                                      rows_initial: int = 40, rows_appended: int = 30, rows_per_segment: int = 30,
                                      victim: str = "srv0", device=None) -> Dict[str, Any]:
    """One-way partition on the REALTIME commit plane: the victim's
    requests reach the controller (it keeps looking alive: its heartbeats
    arrive) but every reply is lost, so only the victim knows it is
    partitioned.  Its lease expires on its side and fences its write
    authority: its completion rounds freeze with their offsets intact, no
    replica moves (the controller sees a healthy server), reads keep
    serving, and the other replica is elected committer after the hold
    window: exactly one committed segment, nothing lost or doubled.  On
    heal the victim renews, downloads the committed copy (the same CRC)
    and the lagging partition catches up."""
    import json as _json

    from pinot_tpu_torch.common.schema import DataType, FieldSpec, FieldType, TimeFieldSpec
    from pinot_tpu_torch.realtime.llc import make_segment_name
    from pinot_tpu_torch.realtime.stream import FileBasedStreamProvider

    cluster = NetworkedCluster(num_servers=2, data_dir=data_dir, lease_s=lease_s, device=device)
    cluster.controller.stabilizer.grace_s = 0.0
    res = cluster.controller.resources
    st = cluster.controller.stabilizer
    try:
        schema = Schema(
            "rsvpNet",
            dimensions=[FieldSpec("venue", DataType.STRING)],
            metrics=[FieldSpec("rsvps", DataType.INT, FieldType.METRIC)],
            time_field=TimeFieldSpec("mtime", DataType.LONG, time_unit="MILLISECONDS"),
        )

        def _row(i: int) -> Dict[str, Any]:
            return {"venue": f"v{i % 3}", "rsvps": i % 5, "mtime": 10_000 + i}

        stream_path = os.path.join(cluster.data_dir, "stream_p0.jsonl")
        with open(stream_path, "w") as f:
            for i in range(rows_initial):
                f.write(_json.dumps(_row(i)) + "\n")

        cluster.controller.add_schema(schema)
        config = TableConfig(
            table_name="rsvpNet", table_type="REALTIME", replication=2,
            stream=StreamConfig(stream_type="file", rows_per_segment=rows_per_segment,
                                properties={"paths": [stream_path]}),
        )
        physical = cluster.controller.add_realtime_table(config, FileBasedStreamProvider([stream_path]))

        def count() -> int:
            r = cluster.query("SELECT count(*) FROM rsvpNet")
            return -1 if r.exceptions else r.num_docs_scanned

        # the first segment commits (both replicas reachable), the rest
        # consumes into the next sequence
        seg0 = make_segment_name(physical, 0, 0)
        cluster.wait(lambda: res.get_ideal_state(physical).get(seg0, {})
                     and all(stt == "ONLINE" for stt in res.get_ideal_state(physical)[seg0].values()),
                     what="first segment committed")
        cluster.wait(lambda: count() == rows_initial, what="all initial rows served")

        # one-way cut: victim -> controller requests still flow, every
        # controller -> victim reply is lost
        cluster.faults.cut("controller", victim)
        vsrv = cluster.server(victim).server
        cluster.wait(lambda: not vsrv.lease.held(), what="victim lease self-fencing")
        blocked_before = vsrv.metrics.meter("lease.blockedCommits").count

        # the next threshold arrives mid-partition: only the healthy
        # replica can run the completion protocol
        with open(stream_path, "a") as f:
            for i in range(rows_initial, rows_initial + rows_appended):
                f.write(_json.dumps(_row(i)) + "\n")

        seg1 = make_segment_name(physical, 0, 1)
        cluster.wait(lambda: res.get_ideal_state(physical).get(seg1, {})
                     and any(stt == "ONLINE" for stt in res.get_ideal_state(physical)[seg1].values()),
                     timeout_s=30.0, what="mid-partition commit by the healthy replica")
        st.run_once()
        controller_saw_alive = res.instances[victim].alive
        no_movement = st.metrics.meter("stabilizer.replicasAdded").count == 0
        blocked_commits = vsrv.metrics.meter("lease.blockedCommits").count > blocked_before
        total = rows_initial + rows_appended
        served_during = count()

        # heal: the victim renews, downloads the committed copy, catches up
        cluster.faults.heal()
        cluster.wait(lambda: vsrv.lease.held(), what="victim lease renewal")
        cluster.wait(lambda: res.get_external_view(physical).get(seg1, {}).get(victim) == "ONLINE",
                     timeout_s=30.0, what="victim downloading the committed copy")
        cluster.wait(lambda: count() == total, what="full count after heal")

        # both replicas loaded the same committed bytes
        crcs = []
        for s in cluster.server_starters:
            tdm = s.server.data_manager.table(physical)
            acquired = tdm.acquire_segments([seg1])
            try:
                crcs.extend(d.segment.metadata.crc for d in acquired)
            finally:
                tdm.release_segments(acquired)
        byte_identical = len(crcs) == 2 and len(set(crcs)) == 1

        final = cluster.query("SELECT count(*) FROM rsvpNet")
        ok = (final.num_docs_scanned == total and not final.exceptions and blocked_commits
              and controller_saw_alive and no_movement and byte_identical)
        return {
            "scenario": "asymmetric-partition",
            "victim": victim,
            "leaseSeconds": lease_s,
            "victimSelfFenced": blocked_commits,
            "controllerSawVictimAlive": controller_saw_alive,
            "noReplicaMovement": no_movement,
            "servedDuringPartition": served_during,
            "committedByteIdentical": byte_identical,
            "finalDocs": final.num_docs_scanned,
            "expectedDocs": total,
            "failedQueries": 0 if ok else 1,
        }
    finally:
        cluster.stop()


# ---------------------------------------------------------------------------
# Disaster recovery: a consistent online backup under closed-loop load, a
# seeded deep-store corruption scrubbed and repaired from a live replica,
# then the controller's property store destroyed mid-load and the cluster
# restored from the archive and the deep store alone.
# ---------------------------------------------------------------------------


def _tenant_schema(name: str):
    from pinot_tpu_torch.tools.datagen import make_test_schema

    schema = make_test_schema(with_mv=False)
    schema.schema_name = name
    return schema


def run_disaster_recovery_scenario(num_servers: int = 3, replication: int = 2, num_segments: int = 6,
                                   clients: int = 3, rt_rows_per_segment: int = 40, window_s: float = 0.5,
                                   data_dir: Optional[str] = None, archive_path: Optional[str] = None,
                                   seed: int = 2020, device=None) -> Dict[str, Any]:
    """Byte-identical answers after the restore, zero committed-row loss,
    the drain flag and the epoch fence preserved, and zero failed queries
    throughout (the reference's scenario and report keys)."""
    import json
    import shutil as _shutil

    from pinot_tpu_torch.common.fencing import StaleEpochError
    from pinot_tpu_torch.realtime.llc import RESP_KEEP, make_segment_name
    from pinot_tpu_torch.realtime.stream import FileBasedStreamProvider
    from pinot_tpu_torch.tools.backup import create_backup, restore_backup
    from pinot_tpu_torch.tools.datagen import random_rows
    from pinot_tpu_torch.utils.audit import SamplerBudget, strip_accounting

    cluster, physical, total = _build_scenario_cluster(num_servers, replication, num_segments, data_dir,
                                                       seed=seed, device=device)
    old_ctrl = cluster.controller
    archive = archive_path or os.path.join(cluster.data_dir, "dr_backup.tar.gz")
    try:
        # 1. drain one server (the flag must survive the disaster)
        drained = "server2" if num_servers >= 3 else None
        if drained:
            _drain_one(cluster, drained)

        # 2. a realtime table: two segments' worth of rows committed
        rt_schema = _tenant_schema("rtTable")
        stream_file = os.path.join(cluster.data_dir, "rt_p0.jsonl")
        rt_rows = random_rows(rt_schema, rt_rows_per_segment * 3, seed=seed + 1)
        with open(stream_file, "w") as f:
            for r in rt_rows[: rt_rows_per_segment * 2]:
                f.write(json.dumps(r) + "\n")
        cluster.controller.add_schema(rt_schema)
        rt_config = TableConfig(table_name="rtTable", table_type="REALTIME", replication=1,
                                stream=StreamConfig(rows_per_segment=rt_rows_per_segment))
        rt_physical = cluster.controller.add_realtime_table(rt_config, FileBasedStreamProvider([stream_file]))
        rt_seg = [make_segment_name(rt_physical, 0, i) for i in range(3)]
        for seg in rt_seg[:2]:
            dm = cluster.controller.realtime_manager.consumers_of(seg)[0]
            dm.consume_step(max_rows=100_000)
            if dm.try_commit() != RESP_KEEP:
                raise AssertionError(f"{seg} did not commit")
        rt_committed = rt_rows_per_segment * 2
        rt_pql = "SELECT count(*) FROM rtTable"
        if cluster.query(rt_pql).num_docs_scanned != rt_committed:
            raise AssertionError("the committed realtime rows are not served")

        # 3. the canonical answers before the disaster (the identity bar)
        canon = ["SELECT count(*) FROM testTable",
                 "SELECT sum(metInt), max(dimInt) FROM testTable GROUP BY dimStr", rt_pql]
        baseline_payloads = {}
        for q in canon:
            resp = cluster.query(q)
            if resp.exceptions or resp.partial_response:
                raise AssertionError(f"{q}: {resp.to_json()}")
            baseline_payloads[q] = strip_accounting(resp.to_json())

        # 4. closed-loop load for the rest of the scenario
        load = ClosedLoopLoad(cluster, "SELECT count(*) FROM testTable", total, clients).start()
        t0 = time.monotonic()
        time.sleep(window_s)
        ok0, t_a = load.ok, time.monotonic()
        baseline_qps = ok0 / max(1e-6, t_a - t0)

        # 5. a consistent online backup (timed, under load)
        backup_stats = create_backup(cluster.data_dir, archive)

        # 6. seeded deep-store corruption; the scrub detects and repairs it
        store = cluster.controller.store
        victim_seg = "seg0"
        with open(store.segment_file_path(physical, victim_seg), "r+b") as f:
            f.seek(-16, os.SEEK_END)
            f.write(b"\xde\xad\xbe\xef" * 4)

        def in_process_copy(name, url, table, segment):
            for s in cluster.servers:
                if s.name == name:
                    return s.segment_copy_bytes(table, segment)
            return None

        scrub = cluster.controller.deepstore_scrubber
        scrub.copy_fn = in_process_copy
        scrub.budget = SamplerBudget(per_s=100_000.0, burst=10_000.0)
        scrub_t0 = time.monotonic()
        ok_a = load.ok
        scrub.run_once()
        time.sleep(window_s)  # a serving window with the scrub round in it
        scrub_t1, ok_b = time.monotonic(), load.ok
        scrub_qps = (ok_b - ok_a) / max(1e-6, scrub_t1 - scrub_t0)
        scrub_snap = scrub.snapshot()
        scrub_repaired = False
        try:
            info = cluster.controller.resources.get_segment_metadata(physical, victim_seg) or {}
            store.verify_copy(physical, victim_seg, expected_crc=getattr(info.get("metadata"), "crc", None))
            scrub_repaired = True
        except Exception:
            pass
        ok_qps_ratio = min(1.0, scrub_qps / max(1e-6, baseline_qps))

        # 7. the disaster: the property store destroyed mid-load
        _shutil.rmtree(os.path.join(cluster.data_dir, "property_store"))
        time.sleep(0.2)  # queries keep flowing: the broker's routing survives
        old_ctrl.stop()

        # 8. restore: a new controller from the archive and the deep store;
        # the servers first (their replays refill the external views),
        # then the broker (its routing seeded from those views)
        restore_t0 = time.monotonic()
        restore_stats = restore_backup(archive, cluster.data_dir)
        new_ctrl = Controller(cluster.data_dir)
        new_ctrl.stabilizer.grace_s = 0.0
        cluster.attach_controller(new_ctrl)
        first_query_s = None
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            resp = cluster.query("SELECT count(*) FROM testTable")
            if not resp.exceptions and not resp.partial_response and resp.num_docs_scanned == total:
                first_query_s = time.monotonic() - restore_t0
                break
            time.sleep(0.05)
        time.sleep(window_s)  # a serving window after the restore, under load
        summary = load.stop()

        # 9. the accounting
        byte_identical = True
        for q in canon:
            resp = cluster.query(q)
            if resp.exceptions or resp.partial_response or strip_accounting(resp.to_json()) != baseline_payloads[q]:
                byte_identical = False
        drain_preserved = drained is None or drained in new_ctrl.resources._draining_flags
        # fencing: the controller from before the disaster is still fenced
        # off the restored store
        try:
            old_ctrl.property_store.put("tables", "zombieWrite", {"x": 1})
            fencing_preserved = False
        except StaleEpochError:
            fencing_preserved = True
        # realtime: the committed rows exactly once, and consumption resumes
        rt_after = cluster.query(rt_pql).num_docs_scanned
        rt_committed_preserved = rt_after == rt_committed
        rt_resumed = False
        try:
            with open(stream_file, "a") as f:
                for r in rt_rows[rt_rows_per_segment * 2:]:
                    f.write(json.dumps(r) + "\n")
            dm2 = new_ctrl.realtime_manager.consumers_of(rt_seg[2])[0]
            dm2.consume_step(max_rows=100_000)
            rt_resumed = (dm2.try_commit() == RESP_KEEP
                          and cluster.query(rt_pql).num_docs_scanned == rt_rows_per_segment * 3)
        except Exception:
            rt_resumed = False

        scrub_detected = scrub_snap["corruptCopies"] >= 1
        failed = (summary["failedQueries"] + (0 if first_query_s is not None else 1)
                  + (0 if byte_identical else 1) + (0 if drain_preserved else 1)
                  + (0 if fencing_preserved else 1) + (0 if rt_committed_preserved else 1)
                  + (0 if rt_resumed else 1) + (0 if (scrub_detected and scrub_repaired) else 1))
        return {
            "scenario": "disaster-recovery",
            "metric": "dr_restore_first_query_s",
            "platform": str(cluster.servers[0].device.type),
            "num_segments": num_segments,
            "clients": clients,
            "value": round(first_query_s, 4) if first_query_s else None,
            "backup": backup_stats,
            "restore": {
                "restoreToFirstQuerySeconds": round(first_query_s, 4) if first_query_s else None,
                "restoreSeconds": round(restore_stats["restoreSeconds"], 4),
                "segmentsVerified": restore_stats["segmentsVerified"],
                "segmentsMissing": restore_stats["segmentsMissing"],
                "segmentsCorrupt": restore_stats["segmentsCorrupt"],
                "byteIdentical": byte_identical,
                "drainFlagPreserved": drain_preserved,
                "fencingPreserved": fencing_preserved,
                "rtCommittedPreserved": rt_committed_preserved,
                "rtResumed": rt_resumed,
            },
            "scrub": {
                "detected": scrub_detected,
                "repaired": scrub_repaired,
                "okQpsRatio": round(ok_qps_ratio, 4),
                "baselineQps": round(baseline_qps, 2),
                "scrubQps": round(scrub_qps, 2),
                "snapshot": scrub_snap,
            },
            "load": summary,
            "failedQueries": failed,
        }
    finally:
        cluster.stop()
