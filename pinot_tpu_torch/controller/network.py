"""Networked control plane over HTTP (port of
``pinot_tpu.controller.network``, trimmed): the ZooKeeper / Helix role.

- ``MessageBoard``: per-instance queues of transition messages;
- ``RemoteParticipant``: the controller-side stub of a server in another
  process, which queues the message and answers "pending"; the server
  acks with the resulting state (``ClusterResourceManager.report_state``);
- ``ParticipantGateway``: registration, heartbeat liveness (the ZK
  session timeout), message fetch and ack, serving leases, and the
  versioned cluster-state snapshot that remote brokers poll.

The JSON of every call is the reference's, so a port server registers
with the reference controller and the other way round.  Left out,
ROADMAP queue 1 item 30: flap hysteresis, the link fault injector,
CONSUMING messages, the snapshot cache.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

from pinot_tpu_torch.broker.time_boundary import compute_boundary
from pinot_tpu_torch.common.fencing import default_lease_s, epoch_int
from pinot_tpu_torch.controller.resource_manager import (
    ERROR,
    ClusterResourceManager,
    InstanceState,
    Participant,
)

logger = logging.getLogger(__name__)


class MessageBoard:
    """Per-instance FIFO of transition messages.  At-least-once, as Helix
    messages: ``fetch`` peeks and a message stays until the server acks
    its id, so a reply lost on the wire is redelivered (transitions are
    idempotent on the server: CRC-skip load, idempotent drop)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._queues: Dict[str, List[Dict[str, Any]]] = {}
        self._next_id = 0

    def post(self, instance: str, msg: Dict[str, Any]) -> int:
        with self._lock:
            self._next_id += 1
            self._queues.setdefault(instance, []).append(dict(msg, msgId=self._next_id))
            return self._next_id

    def fetch(self, instance: str) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._queues.get(instance, []))

    def remove(self, instance: str, msg_id: Optional[int]) -> None:
        if msg_id is None:
            return
        with self._lock:
            q = self._queues.get(instance)
            if q is not None:
                self._queues[instance] = [m for m in q if m["msgId"] != msg_id]

    def clear(self, instance: str) -> None:
        with self._lock:
            self._queues.pop(instance, None)


class RemoteParticipant(Participant):
    """Controller-side stub of a server process reachable over HTTP."""

    def __init__(self, name: str, board: MessageBoard) -> None:
        super().__init__(name, self._enqueue)
        self.board = board

    def _enqueue(self, table: str, segment: str, target: str, info: Dict[str, Any]) -> Optional[bool]:
        meta = info.get("metadata")
        msg: Dict[str, Any] = {
            "type": "transition",
            "table": table,
            "segment": segment,
            "target": target,
            "crc": getattr(meta, "crc", None),
        }
        # a file:// URI names the controller's own disk: remote servers
        # download through the controller's HTTP route instead
        uri = info.get("downloadUri")
        if uri and not uri.startswith("file://"):
            msg["downloadUri"] = uri
        if info.get("invertedIndexColumns"):
            msg["invertedIndexColumns"] = list(info["invertedIndexColumns"])
        if info.get("schema") is not None:
            msg["schemaJson"] = info["schema"].to_json()
        self.board.post(self.name, msg)
        return None


class ParticipantGateway:
    """Controller-side state of remote instances."""

    def __init__(
        self,
        resources: ClusterResourceManager,
        heartbeat_timeout_s: float = 6.0,
        check_interval_s: float = 1.0,
        metrics=None,
        epoch: Optional[int] = None,
        lease_s: Optional[float] = None,
    ) -> None:
        self.resources = resources
        self.board = MessageBoard()
        self.metrics = metrics
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self._check_interval_s = check_interval_s
        self._heartbeats: Dict[str, float] = {}
        self.lease_s = lease_s if lease_s is not None else default_lease_s()
        # the controller's incarnation: cluster-state versions compare
        # only within one epoch
        self.epoch = str(int(epoch)) if epoch is not None else str(int(time.time() * 1000))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _mark(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.meter(name).mark()

    # -- lifecycle -----------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._monitor_loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self._check_interval_s):
            now = time.monotonic()
            with self._lock:
                expired = [n for n, ts in self._heartbeats.items() if now - ts > self.heartbeat_timeout_s]
            for name in expired:
                inst = self.resources.instances.get(name)
                if inst is not None and inst.alive:
                    logger.warning("instance %s missed heartbeats; marking dead", name)
                    self._mark("instancesMarkedDead")
                    self.board.clear(name)
                    self.resources.set_instance_alive(name, False)

    @property
    def fencing_epoch(self) -> int:
        return epoch_int(self.epoch)

    def _grant_lease(self, name: str) -> Dict[str, Any]:
        inst = self.resources.instances.get(name)
        if inst is not None:
            inst.lease_until = time.monotonic() + self.lease_s
        self._mark("lease.granted")
        return {"epoch": self.fencing_epoch, "durationS": self.lease_s}

    # -- instance API (the HTTP handlers call these) -------------------
    def register(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        name = payload["name"]
        role = payload.get("role", "server")
        self._mark("instanceRegistrations")
        prev = self.resources.instances.get(name)
        tags = set(payload.get("tags") or (prev.tags if prev is not None else {"DefaultTenant"}))
        state = InstanceState(
            name,
            role=role,
            url=payload.get("url"),
            addr=tuple(payload["addr"]) if payload.get("addr") else None,
            tags=tags,
        )
        participant = RemoteParticipant(name, self.board) if role == "server" else None
        with self._lock:
            self._heartbeats[name] = time.monotonic()
        self.resources.register_instance(state, participant)
        if role == "server":
            # replay the ideal-state transitions that target this server
            self.resources.reconcile_instance(name)
        return {
            "status": "ok",
            "heartbeatTimeoutSeconds": self.heartbeat_timeout_s,
            "draining": False,
            "lease": self._grant_lease(name),
        }

    def heartbeat(self, name: str, payload: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        self._mark("heartbeats")
        inst = self.resources.instances.get(name)
        if inst is None:
            return {"error": "unknown instance", "reregister": True}
        with self._lock:
            self._heartbeats[name] = time.monotonic()
        if not inst.alive:
            self.resources.set_instance_alive(name, True)
        return {"status": "ok", "draining": False, "lease": self._grant_lease(name)}

    def messages(self, name: str) -> List[Dict[str, Any]]:
        return self.board.fetch(name)

    def ack(self, name: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        self._mark("transitionAcks")
        self.board.remove(name, payload.get("msgId"))
        state = payload["state"] if payload.get("ok", True) else ERROR
        self.resources.report_state(name, payload["table"], payload["segment"], state)
        return {"status": "ok"}

    # -- broker API ----------------------------------------------------
    def cluster_state(self) -> Dict[str, Any]:
        """The versioned snapshot remote brokers poll: routing views of
        live servers, server addresses, dead servers, quotas and hybrid
        time boundaries."""
        self._mark("clusterStatePolls")
        res = self.resources
        with res._lock:
            version = res.version  # captured first: a concurrent bump refetches
            instances = dict(res.instances)
            configs = dict(res.table_configs)
        tables: Dict[str, Any] = {}
        boundaries: Dict[str, Any] = {}
        quotas: Dict[str, Any] = {}
        for table in res.tables():
            tables[table] = {
                seg: {
                    srv: st for srv, st in replicas.items()
                    if instances.get(srv) is not None and instances[srv].alive
                }
                for seg, replicas in res.get_external_view(table).items()
            }
            config = configs.get(table)
            if config is not None:
                quotas[table] = {
                    "rawName": config.raw_name,
                    "maxQueriesPerSecond": config.quota.max_queries_per_second,
                    "burstQueries": config.quota.burst_queries,
                    "slo": config.slo,
                    "partitioning": config.partitioning,
                }
            if table.endswith("_OFFLINE"):
                metas = []
                for seg in res.segments_of(table):
                    info = res.get_segment_metadata(table, seg)
                    if info and info.get("metadata") is not None:
                        metas.append(info["metadata"])
                boundary = compute_boundary(metas)
                if boundary is not None:
                    boundaries[table] = list(boundary)
        servers = {
            name: list(inst.addr) for name, inst in instances.items()
            if inst.role == "server" and inst.alive and inst.addr is not None
        }
        dead = [name for name, inst in instances.items() if inst.role == "server" and not inst.alive]
        return {
            "version": version,
            "epoch": self.epoch,
            "tables": tables,
            "servers": servers,
            "deadServers": dead,
            "drainingServers": [],
            "warmingServers": [],
            "quotas": quotas,
            "timeBoundaries": boundaries,
        }
