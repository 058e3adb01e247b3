"""In-process cluster harness: a controller, N servers and a broker in one
process (port of ``pinot_tpu.tools.cluster_harness``).

The reference's ``PerfBenchmarkDriver.java:61`` and the integration
tests' ``ClusterTest`` start the whole cluster in one process the same
way.  The servers join the controller as participants
(``server/starter.py``) and the broker's routing and hybrid time
boundaries follow the controller's external views (``broker/starter.py``).
A REALTIME table's consumers are stepped by the caller (``consume_step`` /
``try_commit`` of ``controller.realtime_manager.consumers_of(segment)``)
unless an ``IngestConsumerPool`` is set as
``controller.realtime_manager.ingest_pool``.

The chaos scenarios each return the reference's result dict, whose
``failedQueries`` is the command line's exit code, and take ``device`` (the
servers' device: None is the current CUDA card, ``"cpu"`` for tests):

- self-stabilization (``run_kill_server_scenario``, ``run_drain_scenario``,
  ``run_rolling_restart_scenario``, ``run_rolling_restart_warm_scenario``):
  closed-loop query load (``ClosedLoopLoad``) while a server dies, drains
  or every server rolls, the stabilizer stepped with ``run_once``;
- overload (``run_noisy_neighbor_scenario``,
  ``run_join_under_flood_scenario``): a tenant flooding scans or joins at
  many times its quota (``FloodLoad``) beside a steady tenant, and
  ``run_ingest_backpressure_scenario``: a consumer paused by the staging
  ledger and drained after;
- residency and audit (``run_hbm_pressure_scenario``,
  ``run_audit_divergence_scenario``): tables ~8x the hot-tier cap cycling
  the tiers with a seeded allocation failure healed, and a seeded wrong
  device answer caught and quarantined by the shadow auditor;
- ``run_elastic_fleet_scenario``: 100+ tables under ingest and query load,
  a forced skew, a live rebalance and a controller restart in the middle of
  it;
- ``run_split_brain_scenario``: a second controller over the first's
  property store, every write of the fenced-off first raising
  ``StaleEpochError``;
- on ``NetworkedCluster`` (a controller, servers and a broker in one
  process over HTTP and TCP, every link through one seeded
  ``NetworkFaultInjector``): ``run_partition_server_scenario``,
  ``run_partition_controller_scenario``,
  ``run_asymmetric_partition_scenario``;
- ``run_disaster_recovery_scenario``: a backup while serving, the property
  store destroyed, the cluster restored from the archive and the deep store
  (``tools/backup.py``).

The sizes are the reference's unless a size parameter says otherwise; past
a few thousand rows a scenario's segments come from seeded numpy columns.

    python -m pinot_tpu_torch.tools.cluster_harness --scenario <name> [--device cpu]
"""
from __future__ import annotations

import os
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from pinot_tpu_torch.broker.broker import BrokerHttpServer, BrokerRequestHandler
from pinot_tpu_torch.broker.routing import RoutingTableProvider
from pinot_tpu_torch.broker.starter import BrokerStarter
from pinot_tpu_torch.common.conf import BrokerConf, ServerConf
from pinot_tpu_torch.common.response import BrokerResponse
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.tableconfig import StreamConfig, TableConfig
from pinot_tpu_torch.controller.controller import Controller
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
        try:
            for _ in range(num_servers):
                self.add_server()
        except BaseException:
            self.stop()  # no card and no device given: nothing left running
            raise

    def _attach_broker(self) -> None:
        """Register the broker on the controller and follow its views
        (``BrokerStarter``): the routing of every table it already has is
        seeded now."""
        self.broker_starter = BrokerStarter(self.broker, self.controller.resources, url=self.broker_url)
        self.broker_starter.start()

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


# ---------------------------------------------------------------------------
# Overload-protection scenarios: the multi-tenant noisy neighbour, the join
# under a flood and ingest backpressure.
# ---------------------------------------------------------------------------


class FloodLoad:
    """An open-throttle tenant: ``clients`` threads sending one query back
    to back, every reply classified by the tier that shed it: the noisy
    neighbour whose overflow must come back as typed 429 / 210, never as
    timeouts."""

    def __init__(self, cluster: "InProcessCluster", pql: str, clients: int = 4) -> None:
        self.cluster = cluster
        self.pql = pql
        self.clients = clients
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self.total = 0
        self.ok = 0
        self.shed_429 = 0  # broker admission (quota, concurrency, overload)
        self.shed_210 = 0  # server scheduler saturation (a drain's 220 too)
        self.timeouts = 0  # the failure mode overload protection must prevent
        self.other_failures = 0
        self.samples: List[str] = []

    def _classify(self, codes) -> str:
        from pinot_tpu_torch.common.response import ErrorCode

        if ErrorCode.TOO_MANY_REQUESTS in codes:
            return "429"
        if ErrorCode.SERVER_SCHEDULER_DOWN in codes or ErrorCode.SERVER_SHUTTING_DOWN in codes:
            return "210"
        if ErrorCode.EXECUTION_TIMEOUT in codes or ErrorCode.BROKER_TIMEOUT in codes:
            return "timeout"
        return "other"

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                resp = self.cluster.broker.handle_pql(self.pql)
            except Exception as e:
                with self._lock:
                    self.total += 1
                    self.other_failures += 1
                    if len(self.samples) < 8:
                        self.samples.append(f"{type(e).__name__}: {e}")
                continue
            with self._lock:
                self.total += 1
                if not resp.exceptions:
                    self.ok += 1
                    continue
                kind = self._classify({e.error_code for e in resp.exceptions})
                if kind == "429":
                    self.shed_429 += 1
                elif kind == "210":
                    self.shed_210 += 1
                elif kind == "timeout":
                    self.timeouts += 1
                else:
                    self.other_failures += 1
                    if len(self.samples) < 8:
                        self.samples.append(f"codes={[e.error_code for e in resp.exceptions]} "
                                            f"{resp.exceptions[0].message[:120]}")

    def start(self) -> "FloodLoad":
        for i in range(self.clients):
            t = threading.Thread(target=self._loop, name=f"flood-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> Dict[str, Any]:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)
        return {
            "queries": self.total,
            "okQueries": self.ok,
            "shed429": self.shed_429,
            "shed210": self.shed_210,
            "timeouts": self.timeouts,
            "otherFailures": self.other_failures,
            "samples": list(self.samples),
        }


def _tenant_schema(name: str):
    from pinot_tpu_torch.tools.datagen import make_test_schema

    schema = make_test_schema(with_mv=False)
    schema.schema_name = name
    return schema


# past this many rows a scenario's segments come from seeded numpy columns;
# at the reference's sizes they are ``random_rows``' own rows
_COLUMNAR_ROWS = 4096


def _random_columns(schema: Schema, num_rows: int, seed: int, cardinality: int = 20) -> Dict[str, Any]:
    """``num_rows`` rows of a single-value schema as seeded numpy columns,
    each drawn from a pool of ``cardinality`` values of ``random_rows``'
    kinds (lowercase words of 3 to 8 letters, ints in 0-10,000, floats in
    -100-100 to 3 decimals).  Strings are a fixed-width unicode array: the
    segment build's ``np.unique`` sorts it without a Python object a row."""
    import numpy as np

    from pinot_tpu_torch.common.schema import DataType

    rng = np.random.default_rng(seed)
    cols: Dict[str, Any] = {}
    for spec in schema.all_fields():
        st = spec.stored_type
        if st == DataType.STRING:
            pool = np.array(["".join(chr(97 + c) for c in rng.integers(0, 26, int(rng.integers(3, 9))))
                             for _ in range(cardinality)])
        elif st in (DataType.INT, DataType.LONG):
            pool = rng.integers(0, 10_001, cardinality).astype(np.int32 if st == DataType.INT else np.int64)
        else:
            pool = np.round(rng.uniform(-100.0, 100.0, cardinality), 3)
            pool = pool.astype(np.float32 if st == DataType.FLOAT else np.float64)
        cols[spec.name] = pool[rng.integers(0, cardinality, num_rows)]
    return cols


def _columns_segment(schema: Schema, cols: Dict[str, Any], lo: int, hi: int, table: str, name: str):
    from pinot_tpu_torch.segment.columnar import build_segment_from_columns

    return build_segment_from_columns(schema, {k: v[lo:hi] for k, v in cols.items()}, hi - lo, table, name)


def _tenant_segment(schema: Schema, rows: List[Dict[str, Any]], num_rows: int, table: str, name: str,
                    seed: int):
    """A tenant table's segment of ``num_rows`` rows: the first rows of
    ``rows`` (the reference's) up to ``_COLUMNAR_ROWS``, seeded numpy
    columns past it."""
    from pinot_tpu_torch.segment.builder import build_segment

    if num_rows <= _COLUMNAR_ROWS:
        return build_segment(schema, rows[:num_rows], table, name)
    return _columns_segment(schema, _random_columns(schema, num_rows, seed), 0, num_rows, table, name)


def _renamed(segment: ImmutableSegment, table: str, name: str) -> ImmutableSegment:
    """The same column arrays under another table's and segment's name (the
    scenarios whose tables hold identical rows build them once)."""
    import dataclasses

    return ImmutableSegment(metadata=dataclasses.replace(segment.metadata, segment_name=name, table_name=table),
                            columns=segment.columns)


def _isolation_report(scenario: str, quota_qps: float, flood_s: float, a_summary: Dict[str, Any],
                      b_summary: Dict[str, Any], baseline: Dict[str, Any], p99_floor_ms: float,
                      p99_multiple: float) -> Dict[str, Any]:
    """The keys the noisy-neighbour and join-under-flood reports share.  The
    absolute floor absorbs scheduler jitter on a near-zero baseline (3x of
    2 ms is no isolation bar)."""
    loaded_p99 = b_summary["p99Ms"]
    p99_limit = p99_multiple * max(baseline["p99Ms"], p99_floor_ms)
    offered_qps = a_summary["queries"] / max(flood_s, 1e-9)
    return {
        "scenario": scenario,
        "quotaQps": quota_qps,
        "offeredQpsA": round(offered_qps, 1),
        "offeredMultiple": round(offered_qps / quota_qps, 1),
        "tenantA": a_summary,
        "tenantB": b_summary,
        "tenantBBaseline": baseline,
        "tenantBLoadedP99Ms": loaded_p99,
        "tenantBP99LimitMs": round(p99_limit, 3),
        "tenantBP99Within": loaded_p99 <= p99_limit,
        "sheddingTyped": a_summary["timeouts"] == 0 and a_summary["otherFailures"] == 0,
    }


# the interpreter's switch interval while a flood runs in the servers'
# process: every torch op of a server's lane releases the interpreter lock,
# and a flood client's thread, which never blocks, then keeps it for a whole
# interval (5 ms by default), so a lane op waits that long and tenant B's
# queries queue behind A's admitted joins (B's p99 ~0.5 s on the CPU at 5 ms,
# ~0.06 s at 0.1 ms).  The clients of a deployed cluster run in processes of
# their own.
_FLOOD_SWITCH_INTERVAL_S = 1e-4


def _flood(cluster: "InProcessCluster", pql_a: str, pql_b: str, total_b: int, clients: int, flood_clients: int,
           baseline_s: float, flood_s: float, quota_physical: str, quota_qps: float):
    """Tenant B's unloaded baseline, then the quota on tenant A through the
    live update path (as an operator applies it), then A flooding at an open
    throttle while B keeps its closed loop: (A, B, baseline) summaries.  The
    baseline and the flood run at ``_FLOOD_SWITCH_INTERVAL_S``."""
    for pql in (pql_a, pql_b):  # warm both paths (staging, plan build) first
        r = cluster.broker.handle_pql(pql)
        assert not r.exceptions, r.exceptions
    interval = sys.getswitchinterval()
    sys.setswitchinterval(_FLOOD_SWITCH_INTERVAL_S)
    try:
        base_load = ClosedLoopLoad(cluster, pql_b, total_b, clients).start()
        time.sleep(baseline_s)
        baseline = base_load.stop()
        cluster.controller.resources.update_table_quota(quota_physical, quota_qps)
        b_load = ClosedLoopLoad(cluster, pql_b, total_b, clients).start()
        a_flood = FloodLoad(cluster, pql_a, clients=flood_clients).start()
        time.sleep(flood_s)
        a_summary = a_flood.stop()
        return a_summary, b_load.stop(), baseline
    finally:
        sys.setswitchinterval(interval)


def _tenant_table(cluster: "InProcessCluster", tenant: str, replication: int, num_segments: int,
                  segment_rows: Optional[int], built: Dict[int, ImmutableSegment]) -> Tuple[str, int]:
    """A tenant table of ``num_segments`` segments (the reference's skewed
    40-100 rows, or ``segment_rows`` each): (physical, rows).  Past
    ``_COLUMNAR_ROWS`` segment i is built once into ``built`` and renamed
    for every tenant (the reference's tenants hold the same rows)."""
    from pinot_tpu_torch.tools.datagen import random_rows

    schema = _tenant_schema(tenant)
    physical = cluster.add_offline_table(schema, replication=replication)
    rows = random_rows(schema, max(240, min(segment_rows or 0, _COLUMNAR_ROWS)), seed=7)
    total = 0
    for i in range(num_segments):
        n = segment_rows or 40 + 30 * (i % 3)
        name = f"{tenant}s{i}"
        if n <= _COLUMNAR_ROWS:
            seg = _tenant_segment(schema, rows, n, physical, name, seed=7)
        else:
            if i not in built:
                built[i] = _tenant_segment(schema, rows, n, physical, name, seed=7_000 + i)
            seg = _renamed(built[i], physical, name)
        cluster.upload(physical, seg)
        total += n
    return physical, total


def run_noisy_neighbor_scenario(num_servers: int = 2, replication: int = 1, num_segments: int = 3,
                                clients: int = 3, flood_clients: int = 4, quota_qps: float = 8.0,
                                baseline_s: float = 1.0, flood_s: float = 2.5, max_pending: int = 16,
                                data_dir: Optional[str] = None, p99_floor_ms: float = 25.0,
                                p99_multiple: float = 3.0, device=None,
                                segment_rows: Optional[int] = None) -> Dict[str, Any]:
    """Tenant A floods its table while tenant B runs a steady closed loop.
    The overload plane must contain A end to end: B suffers no failed query
    and its p99 stays within a fixed multiple of its unloaded baseline; A's
    overflow is shed with typed errors (429 at the broker's admission, 210
    at the servers' fair-share schedulers), never with timeouts; the quota
    lands through the live update path (``update_table_quota``).
    ``segment_rows``: rows a segment of each tenant (None: the reference's
    40-100)."""
    cluster = InProcessCluster(num_servers=num_servers, data_dir=data_dir, max_pending=max_pending, device=device)
    try:
        built: Dict[int, ImmutableSegment] = {}
        physical_a, _ = _tenant_table(cluster, "tenantA", replication, num_segments, segment_rows, built)
        _, total_b = _tenant_table(cluster, "tenantB", replication, num_segments, segment_rows, built)
        del built
        a_summary, b_summary, baseline = _flood(
            cluster, "SELECT count(*) FROM tenantA", "SELECT count(*) FROM tenantB", total_b, clients,
            flood_clients, baseline_s, flood_s, physical_a, quota_qps)
        return {
            **_isolation_report("noisy-neighbor", quota_qps, flood_s, a_summary, b_summary, baseline,
                                p99_floor_ms, p99_multiple),
            "admission": cluster.broker.admission.snapshot(),
            "scheduler": {s.name: s.scheduler.stats() for s in cluster.servers},
            # main()'s exit code: any tenant-B failure or any untyped
            # tenant-A overflow fails the scenario
            "failedQueries": b_summary["failedQueries"] + a_summary["timeouts"] + a_summary["otherFailures"],
        }
    finally:
        cluster.stop()


def run_join_under_flood_scenario(num_servers: int = 2, replication: int = 1, clients: int = 3,
                                  flood_clients: int = 4, quota_qps: float = 8.0, baseline_s: float = 1.0,
                                  flood_s: float = 2.5, max_pending: int = 16, data_dir: Optional[str] = None,
                                  p99_floor_ms: float = 25.0, p99_multiple: float = 3.0, device=None,
                                  segment_rows: Optional[int] = None) -> Dict[str, Any]:
    """Tenant A floods two-table joins at many times its quota while tenant
    B runs steady scans.  The broker's admission sheds A's overflow before
    any join phase scatters (typed 429); the phase requests that run queue
    under A's tables in the servers' fair-share schedulers, so B's p99
    holds within a fixed multiple of its baseline and B suffers no failed
    query.  ``segment_rows``: rows of each of ``aFact``'s two segments and
    of each tenant-B segment (None: the reference's 150 and 40-100)."""
    import numpy as np

    from pinot_tpu_torch.common.schema import DataType, FieldSpec, FieldType
    from pinot_tpu_torch.segment.builder import build_segment
    from pinot_tpu_torch.segment.columnar import build_segment_from_columns

    cluster = InProcessCluster(num_servers=num_servers, data_dir=data_dir, max_pending=max_pending, device=device)
    try:
        fact_schema = Schema("aFact", dimensions=[FieldSpec("k", DataType.INT, FieldType.DIMENSION)],
                             metrics=[FieldSpec("v", DataType.INT, FieldType.METRIC)])
        dim_schema = Schema("aDim", dimensions=[FieldSpec("k", DataType.INT, FieldType.DIMENSION)],
                            metrics=[FieldSpec("w", DataType.INT, FieldType.METRIC)])
        fact_phys = cluster.add_offline_table(fact_schema, replication=replication)
        dim_phys = cluster.add_offline_table(dim_schema, replication=replication)
        rng = np.random.default_rng(11)
        fact_rows = segment_rows or 150
        for i in range(2):
            k, v = rng.integers(0, 60, fact_rows), rng.integers(0, 99, fact_rows)
            if segment_rows is None:
                seg = build_segment(fact_schema, [{"k": int(a), "v": int(b)} for a, b in zip(k, v)], fact_phys,
                                    f"aFact_s{i}")
            else:
                seg = build_segment_from_columns(fact_schema, {"k": k.astype(np.int32), "v": v.astype(np.int32)},
                                                 fact_rows, fact_phys, f"aFact_s{i}")
            cluster.upload(fact_phys, seg)
        cluster.upload(dim_phys, build_segment(dim_schema, [{"k": k, "w": k * 2} for k in range(60)], dim_phys,
                                               "aDim_s0"))
        _, total_b = _tenant_table(cluster, "tenantB", replication, 3, segment_rows, {})
        # the quota lands on the join's left table: the broker's admission
        # keys a join on it
        a_summary, b_summary, baseline = _flood(
            cluster, "SELECT count(*), sum(f.v) FROM aFact f JOIN aDim d ON f.k = d.k",
            "SELECT count(*) FROM tenantB", total_b, clients, flood_clients, baseline_s, flood_s, fact_phys,
            quota_qps)
        meters = cluster.broker.metrics.snapshot().get("meters", {})
        return {
            **_isolation_report("join-under-flood", quota_qps, flood_s, a_summary, b_summary, baseline,
                                p99_floor_ms, p99_multiple),
            "joinMeters": {k: v["count"] for k, v in meters.items() if k.startswith("join.")},
            "failedQueries": b_summary["failedQueries"] + a_summary["timeouts"] + a_summary["otherFailures"],
        }
    finally:
        cluster.stop()


def run_ingest_backpressure_scenario(rows: int = 400, rows_per_segment: int = 1000, hbm_high_bytes: float = 256.0,
                                     data_dir: Optional[str] = None, device=None,
                                     segment_rows: Optional[int] = None) -> Dict[str, Any]:
    """The ingest watermark contract end to end: a consumer pauses when the
    server's staging ledger crosses the high watermark (query-driven
    staging: the query flood squeezes ingest), its offset freezes while its
    lag stays visible, and after the pressure clears it resumes and drains
    its lag to 0, no row lost or skipped.  ``segment_rows``: rows of the
    pressure table's one segment (None: the reference's 200)."""
    from pinot_tpu_torch.realtime.backpressure import IngestBackpressure
    from pinot_tpu_torch.realtime.llc import make_segment_name
    from pinot_tpu_torch.realtime.stream import MemoryStreamProvider
    from pinot_tpu_torch.tools.datagen import random_rows

    cluster = InProcessCluster(num_servers=1, data_dir=data_dir, device=device)
    try:
        server = cluster.servers[0]
        # tight watermarks on the server's own staging ledger, installed
        # before the consumer exists so that it binds to this governor
        server.ingest_backpressure = IngestBackpressure(
            metrics=server.metrics, hbm_high_bytes=hbm_high_bytes, hbm_low_bytes=hbm_high_bytes / 2.0,
            hbm_bytes_fn=server.executor.staged_bytes, poll_interval_s=0.0)

        # an offline table whose staging pushes the ledger over the high
        # watermark (the query side of the squeeze)
        offline_schema = _tenant_schema("pressure")
        offline_physical = cluster.add_offline_table(offline_schema)
        n = segment_rows or 200
        rows_p = random_rows(offline_schema, n, seed=3) if n <= _COLUMNAR_ROWS else []
        cluster.upload(offline_physical, _tenant_segment(offline_schema, rows_p, n, offline_physical, "p0", seed=3))

        rt_schema = _tenant_schema("rtTable")
        stream = MemoryStreamProvider(num_partitions=1)
        physical = cluster.add_realtime_table(rt_schema, stream, rows_per_segment=rows_per_segment)
        for row in random_rows(rt_schema, rows, seed=5):
            stream.produce(row)
        dm = cluster.controller.realtime_manager.consumers_of(make_segment_name(physical, 0, 0))[0]
        # a fetch's rows: the reference's 100, more for a larger stream
        batch = max(100, rows // 100)

        # 1. unpressured consumption advances
        consumed_free = dm.consume_step(max_rows=batch)

        # 2. a query stages the offline table's columns: the ledger crosses
        # the high watermark and the consumer pauses, its offset frozen.  A
        # group-by stages forward indexes and dictionaries (a bare count(*)
        # would stage only the doc counts)
        cluster.query("SELECT sum(metInt) FROM pressure GROUP BY dimStr TOP 5")
        staged_bytes = server.executor.staged_bytes()
        paused_consumed = dm.consume_step(max_rows=batch)
        offset_at_pause = dm.offset
        dm.consume_step(max_rows=batch)  # still paused: the offset must not move
        paused_state = {
            "paused": server.ingest_backpressure.paused,
            "reason": server.ingest_backpressure.reason,
            "lagWhilePaused": dm.lag(),
            "offsetFrozen": dm.offset == offset_at_pause,
        }

        # 3. the pressure clears: the consumer resumes and drains its lag
        server.executor.free_staging()
        drained = 0
        for _ in range(200):
            drained += dm.consume_step(max_rows=batch)
            if dm.lag() == 0:
                break
        return {
            "scenario": "ingest-backpressure",
            "hbmHighBytes": hbm_high_bytes,
            "stagedBytesAtPause": staged_bytes,
            "consumedBeforePressure": consumed_free,
            "consumedWhilePaused": paused_consumed,
            **paused_state,
            "resumed": not server.ingest_backpressure.paused,
            "consumedAfterResume": drained,
            "finalLag": dm.lag(),
            "governor": server.ingest_backpressure.snapshot(),
            "failedQueries": 0 if (paused_state["offsetFrozen"] and paused_consumed == 0 and dm.lag() == 0) else 1,
        }
    finally:
        cluster.stop()


# ---------------------------------------------------------------------------
# HBM pressure: addressable staged data ~8x the server's hot-tier cap under
# closed-loop mixed load.  The residency manager (engine/residency.py) keeps
# the hot set resident while cold tables cycle hot <-> warm <-> cold, and an
# injected allocation failure heals by demotion, never by poisoning a plan.
# ---------------------------------------------------------------------------


def _pair_of_segments(schema: Schema, rows_per_table: int, seed: int, table: str, name: str, shared=None):
    """A table's two halves of ``rows_per_table`` identical rows (the
    reference's ``random_rows`` per table up to ``_COLUMNAR_ROWS``; past it
    one seeded column set, built once into ``shared`` and renamed)."""
    from pinot_tpu_torch.segment.builder import build_segment
    from pinot_tpu_torch.tools.datagen import random_rows

    half = rows_per_table // 2
    if rows_per_table <= _COLUMNAR_ROWS:
        rows = random_rows(schema, rows_per_table, seed=seed)
        return [build_segment(schema, rows[:half], table, f"{name}s0"),
                build_segment(schema, rows[half:], table, f"{name}s1")]
    if not shared:
        cols = _random_columns(schema, rows_per_table, seed)
        shared.extend([_columns_segment(schema, cols, 0, half, table, f"{name}s0"),
                       _columns_segment(schema, cols, half, rows_per_table, table, f"{name}s1")])
    return [_renamed(seg, table, f"{name}s{i}") for i, seg in enumerate(shared)]


def run_hbm_pressure_scenario(num_tables: int = 10, rows_per_table: int = 96, clients: int = 3,
                              baseline_s: float = 1.0, load_s: float = 4.0, data_dir: Optional[str] = None,
                              seed: int = 421, device=None) -> Dict[str, Any]:
    """One server hosting ``num_tables`` identical tables whose staged
    footprint is ~8x the hot-tier cap the scenario then imposes on it:

    - a hot table runs a closed loop while a sweeper queries every cold
      table in turn, forcing demotion (hot tier over its cap), spill (warm
      tier over its cap) and promotion (cold tables queried again); the
      counters must show all three tiers cycled, with no failed query and
      exact counts;
    - the hot set stays protected: its p99 under pressure beside its own
      uncapped baseline;
    - a seeded allocation failure (``DeviceFaultInjector.alloc_fail_next``)
      lands on a hot query under pressure: the executor classifies
      ``resource_exhausted``, demotes, retries and answers right, with no
      poisoned plan and no host failover.

    The caps are measured, not assumed: a table's footprint is the staging
    ledger's growth on its first staging.  The caps go on the server's
    residency manager and are put back at the end."""
    from pinot_tpu_torch.common.faults import DeviceFaultInjector

    cluster = InProcessCluster(num_servers=1, data_dir=data_dir, device=device)
    server = cluster.servers[0]
    residency = server.executor.residency
    saved_caps = (residency.hbm_cap_bytes, residency.host_cap_bytes)
    try:
        names = [f"tierT{i}" for i in range(num_tables)]
        totals: Dict[str, int] = {}
        shared: List[ImmutableSegment] = []
        for name in names:
            schema = _tenant_schema(name)
            physical = cluster.add_offline_table(schema, replication=1)
            for seg in _pair_of_segments(schema, rows_per_table, seed, physical, name, shared):
                cluster.upload(physical, seg)
            totals[name] = rows_per_table
        del shared
        hot = names[0]

        # several columns, so that each table stages a real footprint (a
        # bare count(*) stages only the doc counts)
        def pql_for(name: str) -> str:
            return (f"SELECT sum(metInt), sum(metFloat), sum(metDouble), max(dimInt), max(dimLong) FROM {name} "
                    "GROUP BY dimStr")

        hot_pql = pql_for(hot)
        # a table's footprint from the ledger's growth on its first staging,
        # then every table warmed, so "addressable" is the uncapped total
        before = server.executor.staged_bytes()
        r = cluster.broker.handle_pql(hot_pql)
        assert not r.exceptions, r.exceptions
        table_bytes = max(1, int(server.executor.staged_bytes() - before))
        for name in names[1:]:
            r = cluster.broker.handle_pql(pql_for(name))
            assert not r.exceptions, r.exceptions
        addressable = int(server.executor.staged_bytes())

        # 1. the hot table's uncapped baseline
        base = ClosedLoopLoad(cluster, hot_pql, totals[hot], clients).start()
        time.sleep(baseline_s)
        baseline = base.stop()

        # 2. the caps: the hot tier holds ~1.25 tables (addressable / cap ~8
        # for 10 tables), the warm tier ~2.5 more, the rest lives on disk;
        # enforced on the resident set at once, as an operator's change is
        cap = max(1, int(table_bytes * num_tables / 8.0))
        residency.hbm_cap_bytes = cap
        residency.host_cap_bytes = int(table_bytes * 2.5)
        residency.enforce()
        counters0 = {n: residency.counter(n) for n in ("demotions", "promotions", "coldDemotions", "coldLoads")}

        # 3. the hot closed loop and a cold-table sweeper, concurrently
        stop = threading.Event()
        sweep_errors: List[str] = []
        sweeps = [0]

        def sweeper() -> None:
            i = 0
            while not stop.is_set():
                name = names[1 + (i % (num_tables - 1))]
                i += 1
                try:
                    resp = cluster.broker.handle_pql(pql_for(name))
                except Exception as e:
                    sweep_errors.append(f"{name}: {type(e).__name__}: {e}")
                    continue
                sweeps[0] += 1
                if (resp.exceptions or resp.num_docs_scanned != totals[name]) and len(sweep_errors) < 8:
                    sweep_errors.append(f"{name}: docs={resp.num_docs_scanned}/{totals[name]} "
                                        f"exc={[e.message for e in resp.exceptions][:2]}")

        hot_load = ClosedLoopLoad(cluster, hot_pql, totals[hot], clients).start()
        sweep_thread = threading.Thread(target=sweeper, daemon=True)
        sweep_thread.start()
        time.sleep(load_s)
        stop.set()
        hot_summary = hot_load.stop()
        sweep_thread.join(timeout=10)

        # 4. a seeded allocation failure on a hot query, still under the
        # caps: it must heal by demotion, never poison
        inj = DeviceFaultInjector(seed=seed)
        lanes = server.lanes.lanes if server.lanes is not None else []
        for lane in lanes:
            lane.fault_injector = inj
        heal_before = dict(server.executor.healing_stats())
        inj.alloc_fail_next(1)
        try:
            resp = cluster.broker.handle_pql(hot_pql)
        finally:
            for lane in lanes:
                lane.fault_injector = None
        heal_after = dict(server.executor.healing_stats())
        oom_healed = (not resp.exceptions and resp.num_docs_scanned == totals[hot]
                      and heal_after["resourceExhausted"] > heal_before["resourceExhausted"]
                      and heal_after["hostFailovers"] == heal_before["hostFailovers"]
                      and heal_after["poisonedPlans"] == 0)
        deltas = {n: residency.counter(n) - counters0[n] for n in counters0}
        hot_p99, base_p99 = hot_summary["p99Ms"], baseline["p99Ms"]
        failed = hot_summary["failedQueries"] + len(sweep_errors) + (0 if oom_healed else 1)
        return {
            "scenario": "hbm-pressure",
            "metric": "tiered_hbm_pressure",
            "value": round(addressable / cap, 3),
            "addressable_over_cap": round(addressable / cap, 3),
            "num_tables": num_tables,
            # the reference reports jax.default_backend(); the port the
            # server's device type ("cuda", "cpu")
            "platform": str(server.device.type),
            "tableBytes": table_bytes,
            "addressableBytes": addressable,
            "hbmCapBytes": cap,
            "hot_p99_ms": hot_p99,
            "baseline_p99_ms": base_p99,
            "hot_p99_over_baseline": round(hot_p99 / max(base_p99, 1e-3), 3),
            "demotions": deltas["demotions"],
            "promotions": deltas["promotions"],
            "cold_demotions": deltas["coldDemotions"],
            "cold_loads": deltas["coldLoads"],
            "coldSweeps": sweeps[0],
            "hotLoad": hot_summary,
            "hotBaseline": baseline,
            "sweepErrors": sweep_errors,
            "oomHealed": oom_healed,
            "selfHealing": heal_after,
            "residency": residency.snapshot(),
            "failedQueries": failed,
        }
    finally:
        cluster.stop()
        residency.hbm_cap_bytes, residency.host_cap_bytes = saved_caps
        server.executor.free_staging()  # the capped era's tiers go with the server


# ---------------------------------------------------------------------------
# Audit divergence: a seeded fault injector makes the device tier return
# silently wrong aggregates under closed-loop load; the shadow differential
# auditor must catch it and quarantine the (plan digest, tier), and the
# cluster keeps answering right (off the quarantined tier) with no failed
# query.
# ---------------------------------------------------------------------------


def run_audit_divergence_scenario(num_segments: int = 2, rows: int = 96, clients: int = 2, load_s: float = 2.0,
                                  detect_budget_s: float = 12.0, corrupt_n: int = 3, data_dir: Optional[str] = None,
                                  seed: int = 1907, device=None, corrupt_delta: float = 100.0) -> Dict[str, Any]:
    """One server, one offline table, a closed query loop, and a seeded
    ``DeviceFaultInjector.corrupt_results`` perturbing the next
    ``corrupt_n`` served aggregates of the device tier.  Nothing raises, so
    the self-healing ladder never sees it: only the shadow auditor can.
    The divergence must be detected within ``detect_budget_s`` and the
    (plan digest, tier) quarantined; every answer after the quarantine must
    be identical to the others and equivalent to the pre-corruption one;
    no query may fail.  The shadow oracle runs in a forked child, so the
    detection time includes the fork.  ``corrupt_delta``: the perturbation
    (the reference's 100 dominates the audit band at its 96 rows; a larger
    table's group sums need one past rel 5e-4 of them)."""
    from pinot_tpu_torch.common.faults import DeviceFaultInjector
    from pinot_tpu_torch.tools.datagen import random_rows
    from pinot_tpu_torch.utils.audit import SamplerBudget, payloads_equivalent, strip_accounting

    # every completed query sampled (the auditor reads the rate when it is
    # made), on an effectively unmetered budget of its own, so the
    # detection time measures the audit loop, not the sampler
    saved_sample_n = os.environ.get("PINOT_TPU_AUDIT_SAMPLE_N")
    os.environ["PINOT_TPU_AUDIT_SAMPLE_N"] = "1"
    try:
        cluster = InProcessCluster(num_servers=1, data_dir=data_dir, device=device)
    finally:
        if saved_sample_n is None:
            os.environ.pop("PINOT_TPU_AUDIT_SAMPLE_N", None)
        else:
            os.environ["PINOT_TPU_AUDIT_SAMPLE_N"] = saved_sample_n
    inj = DeviceFaultInjector(seed=seed)
    server = cluster.servers[0]
    server.auditor.budget = SamplerBudget(per_s=1000.0, burst=64.0)
    lanes = server.lanes.lanes if server.lanes is not None else []
    try:
        schema = _tenant_schema("auditT")
        physical = cluster.add_offline_table(schema, replication=1)
        per = max(1, rows // num_segments)
        if rows <= _COLUMNAR_ROWS:
            all_rows = random_rows(schema, rows, seed=seed)
            for i in range(num_segments):
                chunk = all_rows[i * per:(i + 1) * per] or all_rows[-per:]
                cluster.upload(physical, _tenant_segment(schema, chunk, len(chunk), physical, f"audits{i}", seed))
        else:
            cols = _random_columns(schema, rows, seed)
            for i in range(num_segments):
                cluster.upload(physical, _columns_segment(schema, cols, i * per, (i + 1) * per, physical,
                                                          f"audits{i}"))
            del cols
        pql = "SELECT sum(metInt), sum(metFloat), max(dimInt) FROM auditT GROUP BY dimStr"

        # the pre-corruption payload, accounting stripped (the auditor's own
        # comparison)
        ref_resp = cluster.broker.handle_pql(pql)
        assert not ref_resp.exceptions, ref_resp.exceptions
        reference = strip_accounting(ref_resp.to_json())
        load = ClosedLoopLoad(cluster, pql, ref_resp.num_docs_scanned, clients).start()
        time.sleep(min(0.5, load_s))  # steady state before the fault

        for lane in lanes:
            lane.fault_injector = inj
        # a delta orders of magnitude past the audit band on these sums: the
        # wrong answer is unambiguously wrong, not a rounding argument
        inj.corrupt_results(n=corrupt_n, delta=corrupt_delta)
        armed_at = time.monotonic()
        detected_s: Optional[float] = None
        quarantined: List[Dict[str, Any]] = []
        while time.monotonic() - armed_at < detect_budget_s:
            quarantined = server.executor.audit_quarantined_snapshot()
            if quarantined:
                detected_s = time.monotonic() - armed_at
                break
            time.sleep(0.05)
        inj.heal()  # an unfired corruption budget must not leak forward
        time.sleep(min(1.0, load_s))  # serving after the quarantine
        summary = load.stop()

        # after the quarantine: answers identical to each other (one tier
        # serves now, no flapping) and equivalent to the pre-corruption one
        post_mismatches = 0
        post_baseline = None
        for _ in range(8):
            resp = cluster.broker.handle_pql(pql)
            payload = strip_accounting(resp.to_json())
            if post_baseline is None:
                post_baseline = payload
            if resp.exceptions or payload != post_baseline or not payloads_equivalent(payload, reference):
                post_mismatches += 1
        audit_snap = server.auditor.snapshot()
        heal = server.executor.healing_stats()
        recent = audit_snap.get("recentDivergences") or []
        detect_ms = max((d.get("detectMs") or 0.0) for d in recent) if recent else None
        failed = summary["failedQueries"] + (0 if detected_s is not None else 1) + post_mismatches
        return {
            "scenario": "audit-divergence",
            "metric": "audit_detect_s",
            "value": round(detected_s, 3) if detected_s is not None else None,
            "detected": detected_s is not None,
            "detectWallS": round(detected_s, 3) if detected_s is not None else None,
            "detectMs": detect_ms,
            "divergences": audit_snap["divergences"],
            "quarantined": quarantined,
            "auditTierSkips": heal.get("auditTierSkips", 0),
            "postQuarantineMismatches": post_mismatches,
            "load": summary,
            "audit": audit_snap,
            "failedQueries": failed,
        }
    finally:
        for lane in lanes:
            lane.fault_injector = None
        cluster.stop()


# ---------------------------------------------------------------------------
# Elastic fleet: 100+ tables under mixed ingest and query closed-loop load,
# a forced hot-tenant skew, a live make-before-break rebalance and a
# controller restart in the middle of it.
# ---------------------------------------------------------------------------


def _fleet_loads_by_server(res, tables) -> Dict[str, float]:
    """Doc-weighted ideal-state load a server (the scenario's own balance
    check, independent of the planner's)."""
    load: Dict[str, float] = {}
    for table in tables:
        for seg, replicas in res.get_ideal_state(table).items():
            info = res.get_segment_metadata(table, seg)
            meta = info.get("metadata") if info else None
            docs = max(1, int(getattr(meta, "num_docs", 0) or 0))
            for s in replicas:
                load[s] = load.get(s, 0.0) + docs
    return load


def run_elastic_fleet_scenario(num_tables: int = 104, num_servers: int = 3, clients: int = 3, hot_segments: int = 6,
                               hot_docs: int = 400, fleet_docs: int = 20, rt_tables: int = 2, rt_partitions: int = 2,
                               rows_per_segment: int = 40, rt_segments_per_partition: int = 2,
                               pool_workers: int = 4, max_rounds: int = 40, data_dir: Optional[str] = None,
                               device=None) -> Dict[str, Any]:
    """The elastic-fleet acceptance, end to end:

    1. breadth: ``num_tables`` tables on ``num_servers`` servers, mostly
       tiny offline tables, plus ``rt_tables`` REALTIME tables whose
       partitions the shared ``IngestConsumerPool`` consumes;
    2. mixed load: closed-loop clients over a fleet table, the hot table
       and a live realtime table while ingest runs;
    3. forced skew: ``hot_segments`` doc-heavy segments pinned on server0
       and a cost-rate hint naming the hot table, so that the stabilizer's
       skew evaluation trips;
    4. live rebalance: the planner's make-before-break moves run under
       load, and every round checks that no segment loses its last serving
       replica (against the external view);
    5. a controller restart mid-rebalance: with moves pending, the
       controller is stopped and a new one recovers from the property
       store; the servers (``ServerStarter``) and the broker
       (``BrokerStarter``) join it and its stabilizer finishes the moves
       from derived state.

    Acceptance: no failed query, no lost or duplicate row (realtime counts
    exact), exactly one committed copy a (partition, sequence), and a final
    doc-weighted imbalance under the skew threshold."""
    from pinot_tpu_torch.realtime.llc import make_segment_name
    from pinot_tpu_torch.realtime.pool import IngestConsumerPool
    from pinot_tpu_torch.realtime.stream import MemoryStreamProvider
    from pinot_tpu_torch.tools.datagen import random_rows

    cluster = InProcessCluster(num_servers=num_servers, data_dir=data_dir, device=device)
    ctrl_a = cluster.controller
    res = ctrl_a.resources
    st = ctrl_a.stabilizer
    st.grace_s = 0.0
    # tight knobs so the scenario converges in bounded rounds (the defaults
    # are production-paced: ratio 2.0, 3 rounds, 2 moves)
    st.rebalance_skew_ratio = 1.4
    st.rebalance_hysteresis = 2
    st.rebalance_max_moves = 4
    pool_a = IngestConsumerPool(workers=pool_workers, name="elasticA")
    ctrl_a.realtime_manager.ingest_pool = pool_a
    ctrl_b: Optional[Controller] = None
    pool_b: Optional[IngestConsumerPool] = None
    loads: List[ClosedLoopLoad] = []
    try:
        # 1. breadth: the fleet of small offline tables, every one of the
        # same rows (built once past _COLUMNAR_ROWS)
        template = _tenant_schema("fleet0")
        fleet_rows = random_rows(template, min(fleet_docs, _COLUMNAR_ROWS), seed=13)
        hot_rows = random_rows(template, min(hot_docs, _COLUMNAR_ROWS), seed=14)
        fleet_seg = (_tenant_segment(template, fleet_rows, fleet_docs, "fleet0_OFFLINE", "fleet0s0", seed=13)
                     if fleet_docs > _COLUMNAR_ROWS else None)
        hot_seg = (_tenant_segment(template, hot_rows, hot_docs, "hotTable_OFFLINE", "hot0", seed=14)
                   if hot_docs > _COLUMNAR_ROWS else None)
        num_offline = num_tables - rt_tables - 1  # -1: the hot table
        fleet_physicals: List[str] = []
        for i in range(num_offline):
            schema = _tenant_schema(f"fleet{i}")
            physical = cluster.add_offline_table(schema, replication=1)
            fleet_physicals.append(physical)
            cluster.upload(physical, _renamed(fleet_seg, physical, f"fleet{i}s0") if fleet_seg is not None
                           else _tenant_segment(schema, fleet_rows, fleet_docs, physical, f"fleet{i}s0", seed=13))

        # the realtime tables on the shared consumer pool
        rt_rows_per_partition = rows_per_segment * rt_segments_per_partition
        rt_physicals: List[str] = []
        for i in range(rt_tables):
            schema = _tenant_schema(f"rtFleet{i}")
            stream = MemoryStreamProvider(num_partitions=rt_partitions)
            physical = cluster.add_realtime_table(schema, stream, rows_per_segment=rows_per_segment)
            rt_physicals.append(physical)
            rows = random_rows(schema, rt_rows_per_partition, seed=20 + i)
            for p in range(rt_partitions):
                for row in rows:
                    stream.produce(row, partition=p)

        # 3. the forced hot-tenant skew: every hot segment on server0
        hot_schema = _tenant_schema("hotTable")
        hot_physical = cluster.add_offline_table(hot_schema, replication=1)
        for i in range(hot_segments):
            seg = (_renamed(hot_seg, hot_physical, f"hot{i}") if hot_seg is not None
                   else _tenant_segment(hot_schema, hot_rows, hot_docs, hot_physical, f"hot{i}", seed=14))
            path = ctrl_a.store.save(hot_physical, seg)
            res.add_segment(hot_physical, seg.metadata,
                            {"dir": path, "downloadUri": "file://" + os.path.abspath(path)}, servers=["server0"])
        del fleet_seg, hot_seg
        # the cost axis: the hot table is also the hot query tenant (what
        # /debug/capacity reports once brokers attribute it)
        st.cost_rate_fn = lambda: {"hotTable": 50.0}
        expected_hot = hot_segments * hot_docs
        total_rt = rt_partitions * rt_rows_per_partition

        # 2. mixed ingest and query closed-loop load
        loads = [
            ClosedLoopLoad(cluster, "SELECT count(*) FROM hotTable", expected_hot, clients).start(),
            ClosedLoopLoad(cluster, "SELECT count(*) FROM fleet0", fleet_docs, 1).start(),
            # a live realtime table: any complete answer is right while
            # ingest moves the count
            ClosedLoopLoad(cluster, "SELECT count(*) FROM rtFleet0", None, 1).start(),
        ]
        time.sleep(0.2)

        def coverage_ok(r=None) -> bool:
            """No segment may lose its last serving replica (checked on the
            controller that owns the round)."""
            r = r or res
            for table in [hot_physical] + fleet_physicals[:3]:
                view = r.get_external_view(table)
                for seg, replicas in r.get_ideal_state(table).items():
                    if not any(view.get(seg, {}).get(s) == "ONLINE" for s in replicas):
                        return False
            return True

        def surplus_of(r) -> int:
            return sum(1 for table in [hot_physical] + fleet_physicals
                       for replicas in r.get_ideal_state(table).values() if len(replicas) > 1)

        # 4. the live rebalance, stopped mid-flight
        coverage_never_lost = True
        moves_started_at_restart = 0
        rounds_a = 0
        for _ in range(max_rounds):
            st.run_once()
            rounds_a += 1
            coverage_never_lost = coverage_never_lost and coverage_ok()
            moves_started_at_restart = st.metrics.meter("rebalance.movesStarted").count
            if moves_started_at_restart and st._pending_moves:
                break  # mid-rebalance: the first phase done, the second pending
            time.sleep(0.02)
        pending_at_restart = len(st._pending_moves)
        surplus_at_restart = surplus_of(res)

        # realtime must be quiescent before the in-process restart (a memory
        # stream's buffered rows die with the manager, so the tip consumer
        # must be empty: everything produced is durable)
        def rt_quiescent() -> bool:
            for physical in rt_physicals:
                ideal = res.get_ideal_state(physical)
                for p in range(rt_partitions):
                    for seq in range(rt_segments_per_partition):
                        seg = ideal.get(make_segment_name(physical, p, seq))
                        if not seg or "ONLINE" not in seg.values():
                            return False
            return True

        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not rt_quiescent():
            time.sleep(0.05)
        rt_committed = rt_quiescent()

        # 5. the controller restart mid-rebalance
        pool_a.stop()
        ctrl_a.stop()
        ctrl_b = Controller(cluster.data_dir)
        ctrl_b.stabilizer.grace_s = 0.0
        ctrl_b.stabilizer.rebalance_skew_ratio = st.rebalance_skew_ratio
        ctrl_b.stabilizer.rebalance_hysteresis = st.rebalance_hysteresis
        ctrl_b.stabilizer.rebalance_max_moves = st.rebalance_max_moves
        ctrl_b.stabilizer.cost_rate_fn = st.cost_rate_fn
        pool_b = IngestConsumerPool(workers=pool_workers, name="elasticB")
        ctrl_b.realtime_manager.ingest_pool = pool_b
        # the servers first (their replays refill B's external views), then
        # the broker (its routing seeded from those views); the broker serves
        # from its last routing meanwhile, and make-before-break never dropped
        # a serving replica, so no query has anywhere to fail
        cluster.attach_controller(ctrl_b)
        st_b = ctrl_b.stabilizer
        rounds_b = 0
        for _ in range(max_rounds):
            st_b.run_once()
            rounds_b += 1
            coverage_never_lost = coverage_never_lost and coverage_ok(ctrl_b.resources)
            if (surplus_of(ctrl_b.resources) == 0 and not st_b._pending_moves
                    and st_b.metrics.gauge("rebalance.imbalanceRatio").value < st_b.rebalance_skew_ratio):
                break
            time.sleep(0.02)
        time.sleep(0.2)
        summaries = [load.stop() for load in loads]
        loads = []

        # acceptance
        res_b = ctrl_b.resources
        final_hot = cluster.query("SELECT count(*) FROM hotTable")
        rt_counts = [cluster.query(f"SELECT count(*) FROM rtFleet{i}").num_docs_scanned for i in range(rt_tables)]
        # exactly one committed copy a (partition, sequence): the ideal state
        # holds exactly the expected segment names, each committed one with
        # exactly one ONLINE replica
        one_copy_per_seq = True
        for physical in rt_physicals:
            ideal = res_b.get_ideal_state(physical)
            expected_names = set()
            for p in range(rt_partitions):
                for seq in range(rt_segments_per_partition):
                    name = make_segment_name(physical, p, seq)
                    expected_names.add(name)
                    if list(ideal.get(name, {}).values()).count("ONLINE") != 1:
                        one_copy_per_seq = False
                # the tip consuming segment, one a partition
                expected_names.add(make_segment_name(physical, p, rt_segments_per_partition))
            if set(ideal) != expected_names:
                one_copy_per_seq = False
        balance = _fleet_loads_by_server(res_b, [hot_physical] + fleet_physicals)
        mean_load = sum(balance.values()) / max(1, len(balance))
        final_ratio = max(balance.values()) / mean_load if mean_load > 0 else 0.0
        failed = sum(s["failedQueries"] for s in summaries)
        rt_exact = rt_counts == [total_rt] * rt_tables
        ok = (failed == 0 and coverage_never_lost and rt_committed and rt_exact and one_copy_per_seq
              and moves_started_at_restart > 0 and (pending_at_restart > 0 or surplus_at_restart > 0)
              and final_ratio < st.rebalance_skew_ratio
              and final_hot.num_docs_scanned == expected_hot and not final_hot.exceptions)
        return {
            "scenario": "elastic-fleet",
            "tables": num_tables,
            "servers": num_servers,
            "load": summaries,
            "queries": sum(s["queries"] for s in summaries),
            "okQueries": sum(s["okQueries"] for s in summaries),
            "partialQueries": sum(s["partialQueries"] for s in summaries),
            "failures": [f for s in summaries for f in s["failures"]],
            "roundsBeforeRestart": rounds_a,
            "roundsAfterRestart": rounds_b,
            "movesStartedBeforeRestart": moves_started_at_restart,
            "pendingMovesAtRestart": pending_at_restart,
            "surplusReplicasAtRestart": surplus_at_restart,
            "movesCompletedAfterRestart": st_b.metrics.meter("rebalance.movesCompleted").count,
            "coverageNeverLost": coverage_never_lost,
            "rtRowsExpected": total_rt,
            "rtRowsServed": rt_counts,
            "oneCommittedCopyPerSequence": one_copy_per_seq,
            "finalLoadByServer": {k: round(v, 1) for k, v in sorted(balance.items())},
            "finalImbalanceRatio": round(final_ratio, 3),
            "skewRatioThreshold": st.rebalance_skew_ratio,
            "ingestPool": {"a": pool_a.snapshot(), "b": pool_b.snapshot()},
            "failedQueries": 0 if ok else max(1, failed),
        }
    finally:
        for load in loads:
            load.stop()
        pool_a.stop()
        if pool_b is not None:
            pool_b.stop()
        if ctrl_b is not None and cluster.controller is not ctrl_b:
            ctrl_b.stop()  # made, but not joined: cluster.stop() stops a joined one
        cluster.stop()


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


SCENARIOS = {
    "kill-server": run_kill_server_scenario,
    "drain": run_drain_scenario,
    "rolling-restart": run_rolling_restart_scenario,
    "rolling-restart-warm": run_rolling_restart_warm_scenario,
    "elastic-fleet": run_elastic_fleet_scenario,
    "noisy-neighbor": run_noisy_neighbor_scenario,
    "join-under-flood": run_join_under_flood_scenario,
    "ingest-backpressure": run_ingest_backpressure_scenario,
    "hbm-pressure": run_hbm_pressure_scenario,
    "audit-divergence": run_audit_divergence_scenario,
    "partition-server": run_partition_server_scenario,
    "partition-controller": run_partition_controller_scenario,
    "asymmetric-partition": run_asymmetric_partition_scenario,
    "split-brain": run_split_brain_scenario,
    "disaster-recovery": run_disaster_recovery_scenario,
}


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m pinot_tpu_torch.tools.cluster_harness --scenario <name>
    [--device cpu]``: one scenario, its report printed as JSON; exit 0 when
    ``failedQueries`` is 0.  The reference's flags, and ``--device`` (the
    servers' device: the current CUDA card unless ``cpu`` is given)."""
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scenario", choices=sorted(SCENARIOS), required=True)
    p.add_argument("--servers", type=int, default=3)
    p.add_argument("--replication", type=int, default=2)
    p.add_argument("--segments", type=int, default=6)
    p.add_argument("--clients", type=int, default=3)
    p.add_argument("--quota-qps", type=float, default=8.0)
    p.add_argument("--flood-clients", type=int, default=4)
    p.add_argument("--tables", type=int, default=104)
    p.add_argument("--device", default=None, help="the servers' device (default: the current CUDA card)")
    args = p.parse_args(argv)
    run = SCENARIOS[args.scenario]
    if args.scenario == "elastic-fleet":
        out = run(num_tables=args.tables, num_servers=args.servers, clients=args.clients, device=args.device)
    elif args.scenario in ("ingest-backpressure", "hbm-pressure", "audit-divergence", "asymmetric-partition",
                           "split-brain"):
        out = run(device=args.device)
    elif args.scenario == "partition-controller":
        out = run(num_servers=min(args.servers, 3), replication=args.replication,
                  num_segments=min(args.segments, 4), clients=args.clients, device=args.device)
    elif args.scenario == "rolling-restart-warm":
        # a sequential replay (clients=1): compile.cold == 0 is deterministic
        # only when no new micro-batched shape can first appear mid-roll
        out = run(num_servers=args.servers, replication=args.replication, num_segments=args.segments,
                  device=args.device)
    elif args.scenario == "noisy-neighbor":
        out = run(num_servers=min(args.servers, 2), replication=args.replication, num_segments=args.segments,
                  clients=args.clients, flood_clients=args.flood_clients, quota_qps=args.quota_qps,
                  device=args.device)
    elif args.scenario == "join-under-flood":
        # the reference's main sends this one --segments, which it does not
        # take (a TypeError there); its tables have fixed segment counts
        out = run(num_servers=min(args.servers, 2), replication=args.replication, clients=args.clients,
                  flood_clients=args.flood_clients, quota_qps=args.quota_qps, device=args.device)
    else:
        out = run(num_servers=args.servers, replication=args.replication, num_segments=args.segments,
                  clients=args.clients, device=args.device)
    print(json.dumps(out, indent=2, default=str))
    return 0 if out["failedQueries"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
