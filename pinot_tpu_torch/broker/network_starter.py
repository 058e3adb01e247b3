"""Networked broker starter: a broker process joining a remote controller
(port of ``pinot_tpu.broker.network_starter``, trimmed).

It registers, heartbeats, and polls the controller's versioned cluster
state (the ZK-watch analog) to rebuild the per-table routing, the server
name -> TCP address map, the circuit breaker's dead servers and the
hybrid time boundaries.  Queries go HTTP front -> ``BrokerRequestHandler``
-> TCP scatter-gather -> reduce.  While the controller is unreachable
the broker keeps routing from its last snapshot.  Left out, ROADMAP
queue 1 item 28: quotas, SLO objectives and join partitioning from the
snapshot, the link fault injector.
"""
from __future__ import annotations

import json
import logging
import threading
import urllib.request
from typing import Any, Dict

from pinot_tpu_torch.broker.broker import BrokerHttpServer, BrokerRequestHandler
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
    ) -> None:
        self.controller_url = controller_url.rstrip("/")
        self.name = name
        self.handler = BrokerRequestHandler(TcpTransport(), {}, timeout_ms=timeout_ms, name=name)
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

    def _post(self, path: str, payload: Dict[str, Any], timeout_s: float = 10.0) -> Dict[str, Any]:
        req = urllib.request.Request(
            self.controller_url + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            return json.loads(r.read())

    def _get(self, path: str) -> Dict[str, Any]:
        with urllib.request.urlopen(self.controller_url + path, timeout=10) as r:
            return json.loads(r.read())

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
