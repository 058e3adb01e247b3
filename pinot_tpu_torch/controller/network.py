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
with the reference controller and the other way round.  A dead instance
that keeps coming back is held out of routing for a growing window (flap
hysteresis, ``_flap_gate``); the cluster state is built once a version.
A ``NetworkFaultInjector`` (``common/faults.py``) given as
``fault_injector`` runs every instance-named call (register, heartbeat,
message fetch and ack) over the link ``name -> controller`` at the
controller's edge (``_linked``).
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

from pinot_tpu_torch.broker.time_boundary import compute_boundary
from pinot_tpu_torch.common.faults import call_on_controller_link
from pinot_tpu_torch.common.fencing import default_lease_s, epoch_int
from pinot_tpu_torch.controller.resource_manager import (
    CONSUMING,
    DROPPED,
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
    """Controller-side stub of a server process reachable over HTTP.

    A DROPPED message is posted ``drop_delay_s`` after the controller took
    the replica out of its views: brokers poll the cluster state
    (0.3 s), and a server that unloaded at once would leave a broker
    still routing to it with a segment nobody answers for.  The message is
    not posted when the replica is back in the ideal state by then."""

    drop_delay_s = 1.0

    def __init__(self, name: str, board: MessageBoard, resources: Optional[ClusterResourceManager] = None) -> None:
        super().__init__(name, self._enqueue)
        self.board = board
        self.resources = resources

    def _post_drop(self, table: str, segment: str, msg: Dict[str, Any]) -> None:
        res = self.resources
        with res._lock:
            back = self.name in res.ideal_states.get(table, {}).get(segment, {})
        if not back:
            self.board.post(self.name, msg)

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
        if target == CONSUMING:
            # the whole consume spec: the server process runs the consumer
            # and the completion protocol on its own
            desc = info.get("streamDescriptor")
            if desc is None:
                logger.warning("remote participant %s cannot host CONSUMING %s/%s: "
                               "the stream is not network-describable", self.name, table, segment)
                return False
            msg.update({
                "streamDescriptor": desc,
                "partition": info.get("partition", 0),
                "startOffset": info.get("startOffset", 0),
                "rowsPerSegment": info.get("rowsPerSegment", 100_000),
                "schemaJson": info.get("schemaJson"),
                "consumerType": info.get("consumerType", "lowlevel"),
            })
        if target == DROPPED and self.resources is not None and self.drop_delay_s > 0:
            t = threading.Timer(self.drop_delay_s, self._post_drop, args=(table, segment, msg))
            t.daemon = True
            t.start()
            return None
        self.board.post(self.name, msg)
        return None


class ParticipantGateway:
    """Controller-side state for remote instances: registration,
    heartbeats, liveness, messages, and broker-facing cluster state."""

    def __init__(
        self,
        resources: ClusterResourceManager,
        heartbeat_timeout_s: float = 6.0,
        check_interval_s: float = 1.0,
        metrics=None,
        flap_window_s: float = 60.0,
        flap_threshold: int = 3,
        flap_hold_base_s: float = 5.0,
        flap_hold_max_s: float = 300.0,
        clock=None,
        epoch: Optional[int] = None,
        lease_s: Optional[float] = None,
        fault_injector=None,
    ) -> None:
        self.resources = resources
        self.board = MessageBoard()
        # optional ControllerMetrics: control-plane traffic counters
        self.metrics = metrics
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self._check_interval_s = check_interval_s
        self._heartbeats: Dict[str, float] = {}
        # serving leases (common/fencing.py): every heartbeat reply
        # grants write authority for lease_s; the stabilizer will not
        # move a dead server's replicas before its lease window closes
        self.lease_s = lease_s if lease_s is not None else default_lease_s()
        # the link-level chaos hook (common/faults.py): instance-named
        # control-plane calls consult it at the controller's edge, so a cut
        # server -> controller link drops heartbeats even when the client
        # was not given the injector
        self.fault_injector = fault_injector
        # flap hysteresis: dead->alive cycles inside flap_window_s; at
        # flap_threshold the re-admit is HELD for an escalating window
        # (doubling per extra flap, capped) so the stabilizer never
        # thrashes segments onto a host that keeps dying
        self.flap_window_s = flap_window_s
        self.flap_threshold = flap_threshold
        self.flap_hold_base_s = flap_hold_base_s
        self.flap_hold_max_s = flap_hold_max_s
        self._clock = clock or time.monotonic
        self._revives: Dict[str, List[float]] = {}  # dead->alive times
        self._readmit_hold: Dict[str, float] = {}  # name -> held until
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # deferred-repair callback, wired by the Controller to the
        # realtime manager's ensure_consuming_segments
        self.on_server_available = None
        # incarnation id: cluster-state versions are only comparable
        # within one controller process lifetime (see /clusterstate).
        # Wired from the Controller this is the PERSISTED integer
        # fencing epoch (property store cluster/epoch) — the cluster-
        # wide write-fencing token; standalone gateways fall back to a
        # process-unique string (snapshot identity only, fence unarmed).
        if epoch is not None:
            self.epoch = str(int(epoch))
        else:
            self.epoch = f"{os.getpid()}-{time.monotonic_ns()}"
        # versioned snapshot cache (fleet breadth): building the full
        # cluster state walks every table's external view + segment
        # metadata (time boundaries), so at 100+ tables x N brokers
        # polling, an unchanged cluster must serve ONE build per
        # version, not one per poll.  Keyed on the resource version the
        # build captured; any bump (view change, registration, drain)
        # naturally invalidates it.
        self._state_cache: Optional[Dict[str, Any]] = None
        self._state_cache_lock = threading.Lock()

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
                expired = [
                    name
                    for name, ts in self._heartbeats.items()
                    if now - ts > self.heartbeat_timeout_s
                ]
            for name in expired:
                inst = self.resources.instances.get(name)
                if inst is not None and inst.alive:
                    logger.warning("instance %s missed heartbeats; marking dead", name)
                    if self.metrics is not None:
                        self.metrics.meter("instancesMarkedDead").mark()
                    self.board.clear(name)
                    # one code path: this liveness flip rewrites external
                    # views (version bump -> remote brokers refetch) AND
                    # fires instance listeners (in-process broker health
                    # trackers force the circuit open) — no separate
                    # health poll that could race the routing update
                    self.resources.set_instance_alive(name, False)

    # -- flap hysteresis ----------------------------------------------
    def _flap_gate(self, name: str) -> Optional[float]:
        """Called when a DEAD instance asks to be re-admitted.  Returns
        the seconds remaining on a re-admit hold (refuse), or None
        (admit now).  Only ADMITTED dead->alive cycles count as flaps,
        so a stable survivor is never punished for heartbeating through
        its own hold window."""
        now = self._clock()
        with self._lock:
            hold_until = self._readmit_hold.get(name, 0.0)
            if now < hold_until:
                return hold_until - now
            revives = [
                t
                for t in self._revives.get(name, ())
                if now - t < self.flap_window_s
            ]
            if len(revives) >= self.flap_threshold:
                excess = len(revives) - self.flap_threshold
                hold = min(
                    self.flap_hold_base_s * (2**excess), self.flap_hold_max_s
                )
                self._readmit_hold[name] = now + hold
                # the refused attempt itself counts into the window (one
                # entry per hold — heartbeats DURING a hold return above
                # without appending), so repeated holds escalate; once
                # holds outgrow the window the entries age out and a
                # now-stable host is re-admitted
                revives.append(now)
                self._revives[name] = revives
                logger.warning(
                    "instance %s flapped %d times in %.0fs; holding re-admit "
                    "for %.1fs",
                    name, len(revives) - 1, self.flap_window_s, hold,
                )
                return hold
            revives.append(now)
            self._revives[name] = revives
            flapped = len(revives) > 1
        if flapped and self.metrics is not None:
            self.metrics.meter("gateway.flaps").mark()
        return None

    # -- leases --------------------------------------------------------
    def _grant_lease(self, name: str) -> Dict[str, Any]:
        """Record + serialize a serving lease for one instance.  The
        lease rides every heartbeat/registration reply; its epoch is the
        controller's fencing incarnation, so a commit sent under an old
        controller's lease is typed-rejected after a failover."""
        now = self._clock()
        inst = self.resources.instances.get(name)
        if inst is not None:
            inst.lease_until = now + self.lease_s
        if self.metrics is not None:
            self.metrics.meter("lease.granted").mark()
        return {"epoch": self.fencing_epoch, "durationS": self.lease_s}

    def server_lease_valid(self, name: str) -> bool:
        """True while ``name`` holds an unexpired serving lease.  An
        instance that was never granted one (in-process participant, no
        heartbeats) keeps implicit authority — the fence only arms once
        leases are being issued for it."""
        inst = self.resources.instances.get(name)
        if inst is None or inst.lease_until is None:
            return inst is not None
        return self._clock() < inst.lease_until

    @property
    def fencing_epoch(self) -> int:
        # derived from the string epoch when it is an integer
        # incarnation (Controller-wired); -1 disarms the fence
        return epoch_int(self.epoch)

    def _linked(self, src: str, fn):
        """Run one instance-named control-plane call through the link
        injector (a plain call without one).  This is the controller-edge
        hook, for harnesses that cannot wire the client processes; a
        harness that gives its clients the injector must not also give it
        to the gateway, or the faults apply twice on these links."""
        return call_on_controller_link(self.fault_injector, src, fn, metrics=self.metrics)

    # -- instance API (called from HTTP handlers) ----------------------
    def register(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        return self._linked(payload["name"], lambda: self._register(payload))

    def _register(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        name = payload["name"]
        role = payload.get("role", "server")
        if self.metrics is not None:
            self.metrics.meter("instanceRegistrations").mark()
        prev = self.resources.instances.get(name)
        was_dead = prev is not None and not prev.alive
        # a crash-looping process re-REGISTERS on every loop: the same
        # hysteresis that gates heartbeat revives gates registration, or
        # the hold would be trivially bypassed
        hold = self._flap_gate(name) if was_dead else None
        if payload.get("tags"):
            tags = set(payload["tags"])
        else:
            # tenant tags are controller-assigned state (create_tenant):
            # a restarting instance that doesn't announce tags must keep
            # the ones it had, not fall back to DefaultTenant
            prev = self.resources.instances.get(name)
            tags = set(prev.tags) if prev is not None else {"DefaultTenant"}
        state = InstanceState(
            name,
            role=role,
            url=payload.get("url"),
            addr=tuple(payload["addr"]) if payload.get("addr") else None,
            tags=tags,
        )
        participant = RemoteParticipant(name, self.board, self.resources) if role == "server" else None
        with self._lock:
            self._heartbeats[name] = time.monotonic()
        self.resources.register_instance(state, participant)
        if hold is not None:
            # flapping host: registered (address/participant current)
            # but NOT re-admitted to routing until the hold expires —
            # its heartbeats will revive it once the gate clears
            self.resources.set_instance_alive(name, False)
            return {
                "status": "held",
                "holdSeconds": round(hold, 3),
                "heartbeatTimeoutSeconds": self.heartbeat_timeout_s,
            }
        if role == "server":
            # replay any ideal-state transitions targeting this server:
            # covers re-registration after a server crash AND first
            # registration with a *recovered* controller whose ideal
            # states came from the property store (the fresh
            # InstanceState is already alive, so set_instance_alive
            # would no-op; a truly new server replays nothing)
            self.resources.reconcile_instance(name)
            self._kick_server_available()
        return {
            "status": "ok",
            "heartbeatTimeoutSeconds": self.heartbeat_timeout_s,
            "draining": state.draining,
            "lease": self._grant_lease(name),
        }

    def heartbeat(
        self, name: str, payload: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        return self._linked(name, lambda: self._heartbeat(name, payload))

    def _heartbeat(
        self, name: str, payload: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        if self.metrics is not None:
            self.metrics.meter("heartbeats").mark()
        inst = self.resources.instances.get(name)
        if inst is None:
            return {"error": "unknown instance", "reregister": True}
        with self._lock:
            self._heartbeats[name] = time.monotonic()
        # warm-start readiness rides the liveness beat (absent key =
        # legacy heartbeat, leave the flag alone so a plain {} body
        # cannot clear a warming state it knows nothing about)
        if payload is not None and "warming" in payload:
            self.resources.set_instance_warming(name, bool(payload["warming"]))
        if not inst.alive:
            hold = self._flap_gate(name)
            if hold is not None:
                # flapping: stays out of routing until the hold expires
                # (the heartbeat is still recorded so the monitor loop
                # doesn't pile a fresh death on top) — and NO lease: a
                # held instance has no write authority either
                return {
                    "status": "held",
                    "holdSeconds": round(hold, 3),
                    "draining": inst.draining,
                }
            self.resources.set_instance_alive(name, True)
            self._kick_server_available()
        # drain ack rides the heartbeat reply: a draining server learns
        # its state without a dedicated poll and surfaces it in status()
        return {"status": "ok", "draining": inst.draining, "lease": self._grant_lease(name)}

    def _kick_server_available(self) -> None:
        """A server just became available: run deferred repairs (e.g.
        recreate missing CONSUMING segments whose creation failed while
        no replica was registered) without waiting for the periodic
        ValidationManager tick."""
        cb = self.on_server_available
        if cb is None:
            return

        def run():
            try:
                cb()
            except Exception:
                logger.warning("server-available repair failed", exc_info=True)

        threading.Thread(target=run, daemon=True).start()

    def messages(self, name: str) -> List[Dict[str, Any]]:
        return self._linked(name, lambda: self.board.fetch(name))

    def ack(self, name: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        return self._linked(name, lambda: self._ack(name, payload))

    def _ack(self, name: str, payload: Dict[str, Any]) -> Dict[str, Any]:
        if self.metrics is not None:
            self.metrics.meter("transitionAcks").mark()
        self.board.remove(name, payload.get("msgId"))
        state = payload["state"] if payload.get("ok", True) else ERROR
        self.resources.report_state(
            name, payload["table"], payload["segment"], state
        )
        return {"status": "ok"}

    # -- broker API ----------------------------------------------------
    def cluster_state(self) -> Dict[str, Any]:
        """Versioned snapshot remote brokers poll to rebuild routing,
        server addresses, quotas, and hybrid time boundaries.  Built at
        most once per resource version: concurrent brokers polling an
        unchanged cluster share the cached document (the O(tables)
        walk happens on change, not per poll)."""
        if self.metrics is not None:
            self.metrics.meter("clusterStatePolls").mark()
        res = self.resources
        with self._state_cache_lock:
            cached = self._state_cache
        if cached is not None and cached["version"] == res.version:
            if self.metrics is not None:
                self.metrics.meter("clusterStateCacheHits").mark()
            return cached
        built = self._build_cluster_state()
        with self._state_cache_lock:
            self._state_cache = built
        return built

    def _build_cluster_state(self) -> Dict[str, Any]:
        res = self.resources
        with res._lock:
            # version captured BEFORE the snapshot: a concurrent bump then
            # makes the broker refetch (at-least-once), never miss forever
            version = res.version
            instances = dict(res.instances)
            configs = dict(res.table_configs)
        out_epoch = self.epoch
        tables: Dict[str, Any] = {}
        boundaries: Dict[str, Any] = {}
        quotas: Dict[str, Any] = {}
        for table in res.tables():
            # dead and draining servers hidden as _notify_view hides them
            # (a draining server keeps the last copy of a segment); a
            # segment of the ideal state no server has reported yet (a
            # restarted controller's views refill as the servers replay)
            # is listed with no replica, so a broker counts it unserved
            # instead of answering over fewer segments
            with res._lock:
                view = res.routing_view(table, instances)
                for seg in res.ideal_states.get(table, {}):
                    view.setdefault(seg, {})
            tables[table] = view
            config = configs.get(table)
            if config is not None:
                quotas[table] = {
                    "rawName": config.raw_name,
                    "maxQueriesPerSecond": config.quota.max_queries_per_second,
                    "burstQueries": config.quota.burst_queries,
                    # per-table SLO objectives propagate with the quota
                    # (broker/network_starter applies them per poll)
                    "slo": config.slo.to_json() if config.slo is not None else None,
                    # declared key partitioning feeds the remote broker's
                    # join planner (colocated strategy eligibility)
                    "partitioning": (
                        config.partitioning.to_json()
                        if config.partitioning is not None
                        else None
                    ),
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
            name: list(inst.addr)
            for name, inst in instances.items()
            if inst.role == "server" and inst.alive and inst.addr is not None
        }
        # declared-dead servers ride the same versioned snapshot that
        # carries the routing rebuild, so a remote broker's health
        # tracker and routing table update from ONE event, atomically
        dead_servers = [
            name
            for name, inst in instances.items()
            if inst.role == "server" and not inst.alive
        ]
        # draining servers stay in "servers" (their addresses must keep
        # resolving for in-flight work) but are listed here so remote
        # brokers/ops can tell deliberate drain from failure
        draining_servers = [
            name
            for name, inst in instances.items()
            if inst.role == "server" and inst.alive and inst.draining
        ]
        # warming servers stay fully routable; remote brokers just
        # prefer a ready replica until the prewarm pass completes
        warming_servers = [
            name
            for name, inst in instances.items()
            if inst.role == "server" and inst.alive and inst.warming
        ]
        return {
            "version": version,
            "epoch": out_epoch,
            "tables": tables,
            "servers": servers,
            "deadServers": dead_servers,
            "drainingServers": draining_servers,
            "warmingServers": warming_servers,
            "quotas": quotas,
            "timeBoundaries": boundaries,
        }
