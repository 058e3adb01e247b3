"""Networked broker starter: a broker process joining a remote controller
(port of ``pinot_tpu.broker.network_starter``, trimmed).

It registers, heartbeats, and polls the controller's versioned cluster
state (the ZK-watch analog) to rebuild the per-table routing, the server
name -> TCP address map, the circuit breaker's dead servers and the
hybrid time boundaries, each table's query-rate quota and SLO objectives
(``TableConfig.slo``; updates and removals included) and its declared key
partitioning (``TableConfig.partitioning``, given through ``AddTable``),
which the join planner's colocation check reads.  Queries go HTTP front
-> ``BrokerRequestHandler`` (from a ``BrokerConf`` when one is given) ->
TCP scatter-gather -> reduce.  While the controller is unreachable the
broker keeps routing from its last snapshot.  With a ``fault_injector``
(``common/faults.NetworkFaultInjector``) the cluster-state poll and the
heartbeat ride the link ``name -> controller`` and the scatter transport
consults the injector on each server link (``LinkFaultTransport``).
"""
from __future__ import annotations

import json
import logging
import threading
import urllib.request
from typing import Any, Dict

from pinot_tpu_torch.broker.broker import BrokerHttpServer, BrokerRequestHandler
from pinot_tpu_torch.common.faults import LinkFaultTransport, call_on_controller_link
from pinot_tpu_torch.transport.tcp import TcpTransport
from pinot_tpu_torch.utils.retry import FullJitterBackoff, tighten_liveness_budget

logger = logging.getLogger(__name__)


class NetworkedBrokerStarter:
    def __init__(
        self,
        controller_url: str,
        name: str = "broker0",
        host: str = "127.0.0.1",
        port: int = 0,
        heartbeat_interval_s: float = 1.0,
        poll_interval_s: float = 0.3,
        timeout_ms: float = 15_000.0,
        conf=None,
        fault_injector=None,
    ) -> None:
        """``conf``: a ``BrokerConf`` (its retry, hedge, circuit-breaker and
        admission knobs, ``BrokerRequestHandler.from_conf``); without one
        the handler takes ``timeout_ms`` and the defaults."""
        self.controller_url = controller_url.rstrip("/")
        self.name = name
        self.fault_injector = fault_injector
        transport = TcpTransport()
        if fault_injector is not None:
            transport = LinkFaultTransport(transport, fault_injector, src=name, resolve=self._server_of_address)
        if conf is not None:
            self.handler = BrokerRequestHandler.from_conf(transport, {}, conf, name=name)
        else:
            self.handler = BrokerRequestHandler(transport, {}, timeout_ms=timeout_ms, name=name)
        if fault_injector is not None:
            # netfaults.* marks land on this broker's registry, which
            # exists only now
            transport.metrics = self.handler.metrics
        self.http = BrokerHttpServer(self.handler, host=host, port=port)
        self.heartbeat_interval_s = heartbeat_interval_s
        self.poll_interval_s = poll_interval_s
        self._version = -1
        self._epoch = ""  # the controller's incarnation (see /clusterstate)
        self._dead_servers: set = set()
        self._stop = threading.Event()
        self._threads: list = []
        self._poll_backoff = FullJitterBackoff(initial_s=max(0.1, poll_interval_s), cap_s=10.0)
        self._hb_backoff = FullJitterBackoff(initial_s=max(0.1, heartbeat_interval_s), cap_s=2.0)
        self._hb_timeout_s = 10.0
        self.handler.metrics.gauge("controller.unreachable").set(0)
        self.handler.metrics.meter("controller.pollFailures")
        self.handler.metrics.meter("controller.allDeadSnapshotsHeld")

    def _server_of_address(self, address) -> str:
        """A TCP address's server instance name, for the link injector
        (``host:port`` when no server has that address)."""
        addr = (address[0], int(address[1]))
        # a copy: the poll thread changes the map while scatters resolve
        for server, known in list(self.handler.server_addresses.items()):
            if (known[0], int(known[1])) == addr:
                return server
        return f"{address[0]}:{address[1]}"

    def _link(self, fn):
        return call_on_controller_link(self.fault_injector, self.name, fn, metrics=self.handler.metrics)

    def _post(self, path: str, payload: Dict[str, Any], timeout_s: float = 10.0) -> Dict[str, Any]:
        def send():
            req = urllib.request.Request(
                self.controller_url + path, data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=timeout_s) as r:
                return json.loads(r.read())

        return self._link(send)

    def _get(self, path: str) -> Dict[str, Any]:
        def send():
            with urllib.request.urlopen(self.controller_url + path, timeout=10) as r:
                return json.loads(r.read())

        return self._link(send)

    def start(self) -> None:
        self.http.start()
        self._register()
        self._refresh(force=True)
        for fn in (self._heartbeat_loop, self._poll_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)
        self.http.stop()
        self.handler.shutdown()

    def _register(self) -> None:
        out = self._post("/instances", {"name": self.name, "role": "broker", "url": self.http.url},
                         timeout_s=self._hb_timeout_s)
        timeout = out.get("heartbeatTimeoutSeconds")
        if timeout:
            self._hb_timeout_s = tighten_liveness_budget(self._hb_backoff, float(timeout), self._hb_timeout_s)

    def _heartbeat_loop(self) -> None:
        wait_s = self.heartbeat_interval_s
        while not self._stop.wait(wait_s):
            try:
                out = self._post(f"/instances/{self.name}/heartbeat", {}, timeout_s=self._hb_timeout_s)
                if out.get("reregister"):
                    self._register()
                self._hb_backoff.reset()
                wait_s = self.heartbeat_interval_s
            except Exception as e:
                wait_s = self._hb_backoff.next_delay()
                logger.warning("heartbeat to controller failed (retry in %.2fs): %s", wait_s, e)

    def _poll_loop(self) -> None:
        wait_s = self.poll_interval_s
        unreachable = self.handler.metrics.gauge("controller.unreachable")
        while not self._stop.wait(wait_s):
            try:
                self._refresh()
                self._poll_backoff.reset()
                unreachable.set(0)
                wait_s = self.poll_interval_s
            except Exception as e:
                self.handler.metrics.meter("controller.pollFailures").mark()
                unreachable.set(1)
                wait_s = self._poll_backoff.next_delay()
                logger.warning("cluster-state poll failed (retry in %.2fs): %s", wait_s, e)

    def _refresh(self, force: bool = False) -> None:
        state = self._get(f"/clusterstate?ifNewer={-1 if force else self._version}&epoch={self._epoch}")
        if not state.get("unchanged"):
            self._apply_state(state)

    def _apply_state(self, state: Dict[str, Any]) -> None:
        """Apply one versioned cluster-state snapshot."""
        if not state.get("servers") and self.handler.server_addresses:
            # every server gone while this broker routes to live ones: as
            # likely the controller is the partitioned one; keep the last
            # snapshot, and refetch on every poll (version not advanced)
            self.handler.metrics.meter("controller.allDeadSnapshotsHeld").mark()
            logger.warning("cluster-state snapshot lists no live servers; holding version %d", self._version)
            return
        self._version = state["version"]
        self._epoch = state.get("epoch", "")
        for server, addr in state["servers"].items():
            self.handler.set_server_address(server, (addr[0], int(addr[1])))
        dead = set(state.get("deadServers", []))
        for server in dead - self._dead_servers:
            self.handler.health.mark_dead(server)
        for server in self._dead_servers - dead:
            self.handler.health.mark_alive(server)
        self._dead_servers = dead
        self.handler.health.set_warming_servers(state.get("warmingServers", []))
        known = set(self.handler.routing.tables())
        for table, view in state["tables"].items():
            self.handler.routing.update(table, view)
            known.discard(table)
        for stale in known:
            self.handler.routing.remove(stale)
            self.handler.time_boundary.remove(stale)
        for table, (col, value) in state.get("timeBoundaries", {}).items():
            self.handler.time_boundary.set(table, col, value)
        # per table: the query-rate quota (an update reconfigures the live
        # bucket in place, so a re-poll never refills a flooding table) and
        # the declared partitioning the join planner's colocation check
        # reads (an absent block clears it)
        quota_raw_names = set()
        for q in state.get("quotas", {}).values():
            raw = q["rawName"]
            quota_raw_names.add(raw)
            self.handler.quota.set_quota(raw, q.get("maxQueriesPerSecond"), q.get("burstQueries"))
            # the SLO objectives ride the same snapshot; an absent block
            # clears the override back to the env defaults
            self.handler.slo.set_objective(raw, q.get("slo"))
            p = q.get("partitioning") or {}
            self.handler.joinplan.partitions.set_partitioning(
                raw, p.get("column"), p.get("numPartitions")
            )
        # a removed table's quota leaves with it, and its SLO objectives (a
        # table with an slo block and no quota has no bucket to clear)
        for stale in set(self.handler.quota.tables()) - quota_raw_names:
            self.handler.quota.set_quota(stale, None)
        for stale in set(self.handler.slo.objective_tables()) - quota_raw_names:
            self.handler.slo.set_objective(stale, None)
