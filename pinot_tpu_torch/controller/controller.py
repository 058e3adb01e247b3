"""Controller: cluster CRUD facade and REST API (port of
``pinot_tpu.controller.controller``).

``Controller`` keeps schemas, table configs and the ideal state
(``ClusterResourceManager``) durable in a journaled property store
(``controller/property_store.py``), the segment copies in the
``SegmentStore``, the remote-instance control plane
(``ParticipantGateway``), the LLC realtime manager, the periodic
managers (retention, validation, status checking, the CRC audit, the
deep-store scrubber) and the stabilizer.  A restarted controller claims
the next fencing epoch and recovers every table, schema, ideal state,
segment record, LLC offset checkpoint and drain flag (``_recover``).
``ControllerHttpServer`` serves the reference's paths and JSON:

  GET    /  /dashboard  /dashboard/table/<t>|metrics|capacity|workload|
         utilization|slo|query   (HTML pages)
         /pql?pql=&trace=   (a query proxied to an alive broker)
         /health  /metrics  /debug/metrics  /clusterstate?ifNewer=&epoch=
         /debug/clustermetrics|capacity|workload?n=&tables=|utilization|
         slo|history|flightrec|audit|deepstore|stabilizer
         /instances/<name>/messages|drain  /segments/<table>/<segment>/file
         /tables  /tables/<table>/segments|idealstate|externalview|size
         /tenants  /tenants/<name>  /schemas/<name>  /brokers
  POST   /pql  /instances  /instances/<name>/heartbeat|ack|drain|undrain
         /schemas  /tables   (a REALTIME config's streamConfigs name its stream)
         /tenants   ({"name", "role", "count"})
         /tables/<table>/quota   ({"maxQueriesPerSecond", "burstQueries"})
         /tables/<table>/rebalance?dryRun=
         /segments/<table>?server=   (the segment file's bytes; refused
                              past the table's storage quota; ``server``
                              pins the assignment)
         /deepstore/suspect   ({"table", "segment", "source"})
         /realtime/consumed   (segmentConsumed: {segment, server, offset, epoch})
         /realtime/commit/<segment>/<server>?epoch=   (segmentCommit: the
                              committed segment file's bytes)
         /realtime/hlc/roll   ({table, server, idx, seq}: an HLC server's
                              next CONSUMING segment)
  DELETE /tables/<table>  /tables/<table>/segments/<segment>

A write of a fenced-off (older) controller, or a commit under an older
epoch, answers a typed 409.
"""
from __future__ import annotations

import concurrent.futures
import json
import logging
import os
import random
import tempfile
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, unquote, urlparse

from pinot_tpu_torch.common.fencing import StaleEpochError
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.tableconfig import TableConfig
from pinot_tpu_torch.controller import dashboard
from pinot_tpu_torch.controller.managers import (
    CrcAuditManager,
    DeepStoreScrubber,
    RetentionManager,
    SegmentStatusChecker,
    ValidationManager,
)
from pinot_tpu_torch.controller.network import ParticipantGateway
from pinot_tpu_torch.controller.property_store import PropertyStore
from pinot_tpu_torch.controller.resource_manager import ClusterResourceManager
from pinot_tpu_torch.controller.stabilizer import SelfStabilizer
from pinot_tpu_torch.controller.store import SegmentStore
from pinot_tpu_torch.engine.plandigest import _raw_table
from pinot_tpu_torch.realtime.llc import RealtimeSegmentManager
from pinot_tpu_torch.realtime.stream import stream_provider_from_config
from pinot_tpu_torch.segment.format import SEGMENT_FILE_NAME, read_segment, read_segment_metadata, write_segment
from pinot_tpu_torch.segment.immutable import ImmutableSegment, SegmentMetadata
from pinot_tpu_torch.utils.flightrec import FlightRecorder
from pinot_tpu_torch.utils.metrics import ControllerMetrics, prometheus_text
from pinot_tpu_torch.utils.planstats import PlanStatsStore
from pinot_tpu_torch.utils.timeseries import HistoryRecorder

logger = logging.getLogger(__name__)


class Controller:
    """``data_dir`` holds the property store (schemas, table configs, ideal
    states, segment records, stream descriptors, drain flags and the
    fencing epoch, each write journaled) and the segment store.  A
    controller started over an existing ``data_dir`` claims the next
    epoch, which fences off any older controller still running over it,
    and recovers everything the store holds (``_recover``).
    ``start_managers`` starts the periodic managers and the stabilizer
    on their threads (``StartController`` does); tests step them with
    ``run_once``.  ``heartbeat_timeout_s`` is the remote instances'
    liveness window."""

    def __init__(
        self,
        data_dir: str,
        start_managers: bool = False,
        lease_s: Optional[float] = None,
        heartbeat_timeout_s: float = 6.0,
        fault_injector=None,
    ) -> None:
        """``fault_injector``: a ``NetworkFaultInjector`` the gateway's edge
        consults on every instance-named call (``ParticipantGateway``)."""
        self.property_store = PropertyStore(os.path.join(data_dir, "property_store"))
        # the cluster-wide fencing epoch (ZK's leader generation): from here
        # on this incarnation owns the store, and an older controller over
        # the same store is a zombie whose writes raise StaleEpochError
        self.epoch = self.property_store.claim_epoch()
        self.resources = ClusterResourceManager(property_store=self.property_store)
        self.store = SegmentStore(os.path.join(data_dir, "segments"))
        self.metrics = ControllerMetrics("controller")
        for m in ("instanceRegistrations", "heartbeats", "instancesMarkedDead", "transitionAcks",
                  "clusterStatePolls", "clusterStateCacheHits", "segmentUploads", "lease.granted",
                  "fence.staleEpochRejections", "fence.leaseRejections", "fence.committerReElections"):
            self.metrics.meter(m)
        self.metrics.gauge("fence.epoch").set(self.epoch)
        self.realtime_manager = RealtimeSegmentManager(self.resources, self.store, metrics=self.metrics)
        # arms the commit plane's epoch fence: segmentConsumed and
        # segmentCommit carry the caller's lease epoch
        self.realtime_manager.epoch = self.epoch
        self.retention_manager = RetentionManager(self.resources, self.store)
        self.validation_manager = ValidationManager(self.resources, realtime_manager=self.realtime_manager)
        self.status_checker = SegmentStatusChecker(self.resources)
        # the cross-replica CRC sweep over every alive server's
        # /debug/segments
        self.crc_audit = CrcAuditManager(self.resources)
        # re-verifies the store's copies and repairs a lost or corrupt one
        # from a live server's verified replica
        self.deepstore_scrubber = DeepStoreScrubber(self.resources, self.store)
        # servers that download CRC-failing bytes report the copy suspect
        self.resources.report_store_suspect = self.deepstore_scrubber.report_suspect
        # the convergence loop: re-replicates off dead or draining servers,
        # retires orphaned consuming segments and rebalances a skewed
        # placement
        self.stabilizer = SelfStabilizer(self.resources, realtime_manager=self.realtime_manager)
        # the planner's skew inputs: TTL-cached roll-ups of the fleet's
        # /debug/capacity (cost rates, residency pressure) and
        # /debug/utilization (busy fractions); in-process instances
        # advertise no admin URL, so the planner then weighs docs alone
        probe = _SkewProbe(self)
        self.stabilizer.cost_rate_fn = probe.cost_rates
        self.stabilizer.busy_fn = probe.busy
        self.stabilizer.pressure_fn = probe.pressure
        # a destination still prewarming (its heartbeat's warming flag)
        # holds the old replica's trim until it is ready or the prewarm
        # window times out
        self.stabilizer.readiness_fn = lambda name: not self.resources.is_instance_warming(name)
        self.gateway = ParticipantGateway(
            self.resources, heartbeat_timeout_s=heartbeat_timeout_s, metrics=self.metrics,
            epoch=self.epoch, lease_s=lease_s, fault_injector=fault_injector,
        )
        # a server that becomes available runs the deferred consuming
        # repairs at once instead of waiting for the validation tick
        self.gateway.on_server_available = self.realtime_manager.ensure_consuming_segments
        # a committer whose lease expired mid-protocol is re-electable
        self.realtime_manager.completion.lease_checker = self.gateway.server_lease_valid
        # one history thread over the controller's and the stabilizer's
        # registries (/debug/history); servers declared dead or stabilizer
        # repairs seen on its tick dump a flight-recorder bundle
        self.history = HistoryRecorder([self.metrics, self.stabilizer.metrics], metrics=self.metrics)
        # gauges such as aliveServers refresh lazily: the provider keeps
        # every sample current without a second thread
        self.history.register_provider(lambda: self._refresh_gauges() or {})
        self.flightrec = FlightRecorder(
            "controller", "controller", metrics=self.metrics,
            sources={
                "history": lambda: self.history.query(window_s=900),
                "metrics": self.metrics_snapshot,
                "stabilizer": lambda: self.stabilizer.debug_snapshot(),
            },
        )
        self._last_notable = 0
        self.history.add_tick_hook(self._history_tick)
        t0 = time.perf_counter()
        self._recover()
        # what the restart measurements read: the recovery's wall and the
        # journal's size when it ran
        self.recovery_ms = (time.perf_counter() - t0) * 1000.0
        self.metrics.gauge("recoveryMs").set(round(self.recovery_ms, 3))
        if start_managers:
            for mgr in self._managers():
                mgr.start()

    def _managers(self) -> List[Any]:
        return [self.retention_manager, self.validation_manager, self.status_checker, self.crc_audit,
                self.deepstore_scrubber, self.stabilizer]

    def _recover(self) -> None:
        """Reload the cluster's metadata from the property store after a
        restart (the reference recovers everything from ZK,
        ``PinotHelixResourceManager.java:103``).  External views start
        empty and refill as the servers re-register and replay their
        ideal-state transitions (``reconcile_instance``); a REALTIME
        table's consumption resumes from its checkpointed offsets
        (``RealtimeSegmentManager.recover_table``)."""
        ps = self.property_store
        res = self.resources
        for name in ps.list_keys("schemas"):
            rec = ps.get("schemas", name)
            if rec is not None:
                with res._lock:
                    res.schemas[name] = Schema.from_json(rec)
        recovered_tables: List[str] = []
        for physical in ps.list_keys("tables"):
            rec = ps.get("tables", physical)
            if rec is None:
                continue
            config = TableConfig.from_json(rec)
            with res._lock:
                res.table_configs[physical] = config
                res.ideal_states.setdefault(physical, {})
                res.external_views.setdefault(physical, {})
            recovered_tables.append(physical)
            ideal = ps.get("idealstates", physical)
            if ideal:
                with res._lock:
                    res.ideal_states[physical] = {seg: dict(replicas) for seg, replicas in ideal.items()}
            for seg in ps.list_keys(f"segments/{physical}"):
                rec = ps.get(f"segments/{physical}", seg)
                if rec is None:
                    continue
                info: Dict[str, Any] = {k: v for k, v in rec.items() if k != "metadata"}
                if rec.get("metadata") is not None:
                    info["metadata"] = SegmentMetadata.from_json(rec["metadata"])
                with res._lock:
                    res.segment_metadata[(physical, seg)] = info
        for physical in recovered_tables:
            config = res.table_configs[physical]
            schema = res.get_schema(config.raw_name)
            if schema is not None and config.table_type == "REALTIME":
                if not self.realtime_manager.recover_table(physical, config, schema):
                    logger.error("realtime table %s recovered without a stream descriptor: "
                                 "consumption cannot resume; re-create the table", physical)
        # the drain flags were reloaded by ClusterResourceManager from the
        # store's "instances" namespace: an in-flight drain, or a partly
        # applied stabilizer plan (persisted ideal-state writes), resumes
        # where the crash left it
        if res._draining_flags:
            logger.info("recovered draining flags for %s", sorted(res._draining_flags))
        if recovered_tables:
            logger.info("recovered %d tables, %d schemas from the property store",
                        len(recovered_tables), len(res.schemas))

    # -- CRUD -----------------------------------------------------------
    def add_schema(self, schema: Schema) -> None:
        existing = self.resources.get_schema(schema.schema_name)
        evolving = existing is not None and existing != schema
        self.resources.add_schema(schema)
        if evolving:
            # schema evolution: the realtime manager's stored schema is
            # swapped, so the next consuming segment's rollover ingests the
            # new columns, and every table on the schema is reloaded, so its
            # loaded segments get default columns for the added fields
            self.realtime_manager.update_schema(schema.schema_name, schema)
            for physical in self.resources.tables_of_schema(schema.schema_name):
                self.resources.reload_table(physical)

    def add_table(self, config: TableConfig) -> str:
        if self.resources.get_schema(config.raw_name) is None:
            raise ValueError(f"no schema named {config.raw_name!r}; upload the schema first")
        self.resources.validate_tenants(config)
        return self.resources.add_table(config)

    def rebalance_table(self, table_physical: str, dry_run: bool = False) -> Dict[str, Any]:
        return self.resources.rebalance_table(table_physical, dry_run=dry_run)

    # -- drain ----------------------------------------------------------
    def drain_status(self, name: str) -> Dict[str, Any]:
        """Drained-versus-remaining accounting for one instance: a rolling
        restart polls it until ``drained`` turns true."""
        remaining = self.resources.segments_on(name)
        total = sum(len(v) for v in remaining.values())
        inst = self.resources.instances.get(name)
        if inst is None and not remaining and name not in self.resources._draining_flags:
            # never registered, holds nothing, no recovered drain flag: a
            # mistyped name is an error, never drained=true
            raise KeyError(f"unknown instance {name!r}")
        return {
            "instance": name,
            "draining": name in self.resources._draining_flags,
            "alive": inst.alive if inst is not None else False,
            "remainingSegments": total,
            "remaining": remaining,
            "drained": total == 0,
        }

    def drain_instance(self, name: str) -> Dict[str, Any]:
        """Mark an instance draining: brokers stop routing new queries to
        it (in-flight ones finish) and the stabilizer moves its replicas
        off.  A rolling restart is drain, poll until drained, restart,
        undrain."""
        self.resources.set_instance_draining(name, True)
        return self.drain_status(name)

    def undrain_instance(self, name: str) -> Dict[str, Any]:
        """Re-admit a drained instance to routing and placement
        (registration alone never clears the flag)."""
        self.resources.set_instance_draining(name, False)
        return self.drain_status(name)

    def add_realtime_table(self, config: TableConfig, stream) -> str:
        """Create a REALTIME table and open its first CONSUMING segments,
        one a stream partition (PinotLLCRealtimeSegmentManager)."""
        schema = self.resources.get_schema(config.raw_name)
        if schema is None:
            raise ValueError(f"no schema named {config.raw_name!r}; upload the schema first")
        self.resources.validate_tenants(config)
        return self.realtime_manager.setup_table(config, schema, stream)

    def _assign(self, table_physical: str, meta: SegmentMetadata, stored: str,
                servers: Optional[List[str]] = None) -> List[str]:
        self.metrics.meter("segmentUploads").mark()
        return self.resources.add_segment(
            table_physical, meta,
            {"dir": stored, "downloadUri": "file://" + os.path.abspath(stored)}, servers=servers,
        )

    def _check_storage_quota(self, table_physical: str, segment_name: str, incoming_bytes: int) -> None:
        """Raise BEFORE the store is touched when the upload would push the
        table's durable copy past its storage quota (the reference's
        StorageQuotaChecker); a rejected upload, fresh or a refresh,
        leaves the previous copy intact."""
        config = self.resources.table_configs.get(table_physical)
        quota = config.quota.storage_bytes() if config is not None else None
        if quota is None:
            return
        used = self.store.table_size_bytes(table_physical)
        # a refresh replaces the old copy, so it does not count twice
        used -= self.store.segment_size_bytes(table_physical, segment_name)
        if used + incoming_bytes > quota:
            raise ValueError(
                f"storage quota exceeded for {table_physical}: "
                f"{used} used + {incoming_bytes} incoming > {quota} quota"
            )

    def upload_segment(self, table_physical: str, segment: ImmutableSegment) -> List[str]:
        """Store the segment durably and drive its replicas ONLINE.  Under a
        storage quota the file is written to a staging directory first and
        its real size checked before it enters the store."""
        config = self.resources.table_configs.get(table_physical)
        if config is None or config.quota.storage_bytes() is None:
            return self._assign(table_physical, segment.metadata, self.store.save(table_physical, segment))
        with tempfile.TemporaryDirectory() as td:
            with open(write_segment(segment, td), "rb") as f:
                data = f.read()
        self._check_storage_quota(table_physical, segment.segment_name, len(data))
        return self._assign(table_physical, segment.metadata,
                            self.store.save_bytes(table_physical, segment.segment_name, data))

    def upload_segment_bytes(self, table_physical: str, data: bytes,
                             servers: Optional[List[str]] = None) -> List[str]:
        """The HTTP upload path: segment-file bytes -> store + assign.  The
        controller reads the file's header only; each server decodes and
        CRC-verifies its own copy when it loads it.  The payload is the
        file's exact size, which the storage quota is checked against."""
        if table_physical not in self.resources.table_configs:
            raise KeyError(f"no table {table_physical!r}")
        meta = read_segment_metadata(data)
        self._check_storage_quota(table_physical, meta.segment_name, len(data))
        stored = self.store.save_bytes(table_physical, meta.segment_name, data)
        return self._assign(table_physical, meta, stored, servers)

    def delete_segment(self, table_physical: str, segment_name: str) -> None:
        self.resources.delete_segment(table_physical, segment_name)
        self.store.delete(table_physical, segment_name)

    def delete_table(self, table_physical: str) -> None:
        for seg in self.resources.segments_of(table_physical):
            self.store.delete(table_physical, seg)
        self.resources.delete_table(table_physical)

    # -- observability --------------------------------------------------
    def _refresh_gauges(self) -> None:
        insts = self.resources.instances_snapshot()
        self.metrics.gauge("aliveServers").set(sum(1 for i in insts if i.role == "server" and i.alive))
        self.metrics.gauge("aliveBrokers").set(sum(1 for i in insts if i.role == "broker" and i.alive))
        self.metrics.gauge("deadInstances").set(sum(1 for i in insts if not i.alive))
        self.metrics.gauge("tables").set(len(self.resources.tables()))

    def metrics_snapshot(self) -> Dict[str, Any]:
        """The controller's registries as JSON (``/debug/metrics``): the
        control-plane traffic and each manager's per-table gauges."""
        self._refresh_gauges()
        return {
            "controller": self.metrics.snapshot(),
            "validation": self.validation_manager.metrics.snapshot(),
            "segmentStatus": self.status_checker.metrics.snapshot(),
            "stabilizer": self.stabilizer.metrics.snapshot(),
            "retention": self.retention_manager.metrics.snapshot(),
            "deepstore": self.deepstore_scrubber.metrics.snapshot(),
            "durability": self.property_store.metrics.snapshot(),
        }

    def metrics_text(self) -> str:
        """Prometheus exposition of every controller registry."""
        self._refresh_gauges()
        return prometheus_text([self.metrics, self.validation_manager.metrics, self.status_checker.metrics,
                                self.stabilizer.metrics, self.retention_manager.metrics,
                                self.deepstore_scrubber.metrics, self.property_store.metrics])

    def _history_tick(self, now: float) -> None:
        """The flight recorder's trigger on the history cadence: servers
        declared dead or stabilizer repairs since the last sample."""
        total = (
            self.metrics.meter("instancesMarkedDead").count
            + self.stabilizer.metrics.meter("stabilizer.replicasAdded").count
            + self.stabilizer.metrics.meter("stabilizer.consumingReassigned").count
        )
        delta = total - self._last_notable
        self._last_notable = total
        if delta > 0:
            self.flightrec.maybe_dump("serverDeathOrHeal", {"notableEventsThisTick": delta})

    def stop(self) -> None:
        """Stop the history thread, every manager and the stabilizer, and
        release the property store's lock."""
        self.history.stop()
        for mgr in self._managers():
            mgr.stop()
        self.property_store.close()


def cost_rates_from_capacity(capacity: Dict[str, Any]) -> Dict[str, float]:
    """Per-table docsScanned one-minute rates out of a ``/debug/capacity``
    roll-up: the cost axis of the rebalance planner's placement weight."""
    out: Dict[str, float] = {}
    for table, entry in (capacity.get("tables") or {}).items():
        try:
            out[table] = float(entry.get("docsScannedRate1m") or 0.0)
        except (TypeError, ValueError):
            continue
    return out


def tier_pressure_from_capacity(capacity: Dict[str, Any]) -> Dict[str, float]:
    """Per-server residency pressure (hot bytes over the HBM cap, 0..1)
    out of a ``/debug/capacity`` roll-up: the planner's memory axis.  A
    server without a residency section, or at no pressure, is left out."""
    out: Dict[str, float] = {}
    for name, entry in (capacity.get("servers") or {}).items():
        res = entry.get("residency") or {}
        try:
            p = float(res.get("pressure") or 0.0)
        except (TypeError, ValueError):
            continue
        if p > 0:
            out[name] = p
    return out


def busy_from_utilization(util: Dict[str, Any]) -> Dict[str, float]:
    """Per-server device busy fractions out of a ``/debug/utilization``
    roll-up: the planner's destination tiebreak (the idlest cold server)."""
    out: Dict[str, float] = {}
    for name, entry in (util.get("servers") or {}).items():
        occ = (entry.get("device") or {}).get("occupancy") or {}
        try:
            out[name] = float(occ.get("busyFraction") or 0.0)
        except (TypeError, ValueError):
            continue
    return out


class _SkewProbe:
    """TTL-cached skew inputs of the stabilizer's rebalance planner.  The
    planner runs every round (2 s) and each roll-up is one HTTP fan-out,
    so the probe refreshes at most every ``ttl_s`` and serves cached maps
    between; a failure leaves the last maps (empty at first: docs-only
    weighting), so a dead server never stalls the convergence loop."""

    def __init__(self, ctrl: "Controller", ttl_s: float = 30.0) -> None:
        self.ctrl = ctrl
        self.ttl_s = ttl_s
        self._lock = threading.Lock()
        self._at = 0.0
        self._rates: Dict[str, float] = {}
        self._busy: Dict[str, float] = {}
        self._pressure: Dict[str, float] = {}

    def _refresh(self) -> None:
        with self._lock:
            now = time.monotonic()
            if now - self._at < self.ttl_s:
                return
            self._at = now
        try:
            capacity = collect_capacity(self.ctrl, timeout_s=1.5)
            self._rates = cost_rates_from_capacity(capacity)
            self._pressure = tier_pressure_from_capacity(capacity)
            self._busy = busy_from_utilization(collect_utilization(self.ctrl, timeout_s=1.5))
        except Exception:
            logger.warning("skew-probe roll-up failed", exc_info=True)

    def cost_rates(self) -> Dict[str, float]:
        self._refresh()
        return self._rates

    def busy(self) -> Dict[str, float]:
        self._refresh()
        return self._busy

    def pressure(self) -> Dict[str, float]:
        self._refresh()
        return self._pressure


def _fetch_json(url: str, timeout_s: float) -> Dict[str, Any]:
    with urllib.request.urlopen(url, timeout=timeout_s) as r:
        return json.loads(r.read())


def collect_cluster_metrics(ctrl: "Controller", timeout_s: float = 3.0) -> Dict[str, Any]:
    """Cluster-wide metrics: the controller's registries and
    ``/debug/metrics`` of every alive instance with an HTTP surface (a
    broker's query port, a server's admin port), fetched concurrently so
    a few unreachable instances cost one timeout.  An unreachable
    instance is an ``error`` entry."""

    def fetch(inst) -> Dict[str, Any]:
        entry: Dict[str, Any] = {"role": inst.role, "url": inst.url}
        try:
            entry["metrics"] = _fetch_json(inst.url.rstrip("/") + "/debug/metrics", timeout_s)
        except (urllib.error.URLError, OSError, ValueError) as e:
            entry["error"] = str(e)
        return entry

    out: Dict[str, Any] = {"controller": ctrl.metrics_snapshot(), "instances": {}}
    targets = [i for i in ctrl.resources.instances_snapshot() if i.alive and i.url]
    if targets:
        with concurrent.futures.ThreadPoolExecutor(max_workers=min(16, len(targets))) as pool:
            for inst, entry in zip(targets, pool.map(fetch, targets)):
                out["instances"][inst.name] = entry
    return out


_HBM_KEYS = ("stagedBytes", "highWatermarkBytes", "stagedTables", "evictions", "evictedBytes",
             "qinputCacheBytes", "byTable")
_RESIDENCY_KEYS = ("pressure", "hbmCapBytes", "hotBytes", "warmBytes", "coldBytes", "hotTables",
                   "warmTables", "coldTables")


def collect_capacity(ctrl: "Controller", timeout_s: float = 3.0) -> Dict[str, Any]:
    """Cluster-wide capacity and cost roll-up (``/debug/capacity``): every
    alive server's staging ledger, residency tiers and ingest lag beside
    every broker's per-table cost rates.  Sources: a server's
    ``/debug/metrics`` (``ServerInstance.status()``: ``hbm``,
    ``residency``, the ``ingest.lag.*`` gauges) and a broker's
    ``/debug/metrics`` (the ``table.*.docsScanned`` / ``bytesScanned``
    meters).  Every unreachable instance is listed, since a dead broker
    makes the per-table attribution partial.  A server's residency
    ``pressure`` is its hot-tier bytes over its HBM cap, on the card the
    real bytes it holds there."""
    cm = collect_cluster_metrics(ctrl, timeout_s=timeout_s)
    servers: Dict[str, Any] = {}
    tables: Dict[str, Dict[str, Any]] = {}
    unreachable: Dict[str, Any] = {}
    total_staged = 0
    total_lag = 0
    for name, entry in sorted((cm.get("instances") or {}).items()):
        role = entry.get("role")
        if entry.get("error"):
            unreachable[name] = {"role": role, "error": entry["error"]}
            if role == "server":
                servers[name] = {"error": entry["error"]}
            continue
        payload = entry.get("metrics") or {}
        if role == "server":
            hbm = payload.get("hbm") or {}
            snap = payload.get("metrics") or {}
            gauges = snap.get("gauges") or {}
            meters = snap.get("meters") or {}
            lag = {k[len("ingest.lag."):]: v for k, v in gauges.items()
                   if k.startswith("ingest.lag.") and isinstance(v, (int, float))}
            servers[name] = {
                "hbm": {k: hbm.get(k) for k in _HBM_KEYS},
                "ingestLag": lag,
                "ingestRows": meters.get("ingest.rowsConsumed") or {},
                "costDocsScanned": meters.get("cost.docsScanned") or {},
                "costBytesScanned": meters.get("cost.bytesScanned") or {},
            }
            res = payload.get("residency") or {}
            if res:
                servers[name]["residency"] = {k: res.get(k) for k in _RESIDENCY_KEYS}
            total_staged += int(hbm.get("stagedBytes") or 0)
            total_lag += int(sum(lag.values()))
        elif role == "broker":
            for mname, m in (payload.get("meters") or {}).items():
                if not mname.startswith("table.") or "." not in mname[len("table."):]:
                    continue
                tname, metric = mname[len("table."):].rsplit(".", 1)
                if metric not in ("docsScanned", "bytesScanned"):
                    continue
                t = tables.setdefault(tname, {})
                t[metric] = t.get(metric, 0) + int(m.get("count") or 0)
                t[f"{metric}Rate1m"] = round(t.get(f"{metric}Rate1m", 0.0) + float(m.get("rate1m") or 0.0), 3)
    return {
        "totals": {"stagedBytes": total_staged, "ingestLagRows": total_lag, "servers": len(servers),
                   "tables": len(tables)},
        "servers": servers,
        "tables": tables,
        "unreachable": unreachable,
    }


def collect_workload(
    ctrl: "Controller",
    timeout_s: float = 3.0,
    n: int = 20,
    tables=None,
) -> Dict[str, Any]:
    """Cluster-wide workload roll-up (``/debug/workload``): every alive
    broker's per-plan-digest registry merged by digest — counts and
    cost sums add, summaries/tables/exemplars are first-writer — then
    re-ranked by frequency and by cost.  The fleet-level answer to
    "which plan shapes dominate, and which should batched serving
    target first?" — and, with ``tables``, the prewarm feed a restarted
    server pulls for the tables it hosts (``?n=&tables=``).
    Unreachable brokers degrade to an ``unreachable`` entry."""
    wanted = (
        None if tables is None else {_raw_table(t) for t in tables}
    )
    merged: Dict[str, Dict[str, Any]] = {}
    unreachable: Dict[str, str] = {}
    brokers = [
        i
        for i in ctrl.resources.instances_snapshot()
        if i.role == "broker" and i.alive and i.url
    ]

    def fetch(inst):
        try:
            # top=1024 (above the registry capacity) returns the FULL
            # per-broker registry: merging truncated top-20 slices
            # would undercount any digest outside one broker's head
            with urllib.request.urlopen(
                inst.url.rstrip("/") + "/debug/workload?top=1024",
                timeout=timeout_s,
            ) as r:
                return json.loads(r.read())
        except (urllib.error.URLError, OSError, ValueError) as e:
            return {"_error": str(e)}

    results = []
    if brokers:
        with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(8, len(brokers))
        ) as pool:
            results = list(pool.map(fetch, brokers))
    total_recorded = 0
    for inst, snap in zip(brokers, results):
        if "_error" in snap:
            unreachable[inst.name] = snap["_error"]
            continue
        total_recorded += int(snap.get("totalRecorded") or 0)
        seen: set = set()
        for plan in (snap.get("topByCount") or []) + (snap.get("topByCost") or []):
            digest = plan.get("digest")
            if not digest or digest in seen:
                continue  # a digest appears in both rankings: merge once
            seen.add(digest)
            if wanted is not None and _raw_table(plan.get("table", "")) not in wanted:
                continue
            m = merged.get(digest)
            if m is None:
                m = merged[digest] = {
                    "digest": digest,
                    "summary": plan.get("summary", ""),
                    "table": plan.get("table", ""),
                    # literals-erased exemplar (first broker wins): what
                    # a prewarming server re-parses to rebuild the shape
                    "exemplarPql": plan.get("exemplarPql", ""),
                    "count": 0,
                    "shedCount": 0,
                    "failedCount": 0,
                    "docsScanned": 0,
                    "cost": {},
                    "brokers": [],
                }
            elif not m.get("exemplarPql") and plan.get("exemplarPql"):
                m["exemplarPql"] = plan["exemplarPql"]
            m["count"] += int(plan.get("count") or 0)
            m["shedCount"] += int(plan.get("shedCount") or 0)
            m["failedCount"] += int(plan.get("failedCount") or 0)
            m["docsScanned"] += int(plan.get("docsScanned") or 0)
            for k, v in (plan.get("cost") or {}).items():
                m["cost"][k] = m["cost"].get(k, 0) + v
            m["brokers"].append(inst.name)

    # the ONE cost-ranking formula, shared with the broker's registry
    cost_key = PlanStatsStore._cost_key

    plans = list(merged.values())
    k = max(1, int(n))
    return {
        "brokers": len(brokers),
        "digests": len(plans),
        "totalRecorded": total_recorded,
        "topByCount": sorted(plans, key=lambda d: -d["count"])[:k],
        "topByCost": sorted(plans, key=cost_key, reverse=True)[:k],
        "unreachable": unreachable,
    }


def collect_slo(ctrl: "Controller", timeout_s: float = 3.0) -> Dict[str, Any]:
    """Fleet SLO roll-up (the controller's ``/debug/slo``): every alive
    broker's ``/debug/slo`` merged a table.  Each broker measures burn over
    its own traffic, so the fleet keeps the worst burn of each table and
    the per-broker entries beneath it; a table burns if any broker says
    so.  An unreachable broker is listed under ``unreachable``."""
    brokers = [i for i in ctrl.resources.instances_snapshot() if i.role == "broker" and i.alive and i.url]

    def fetch(inst):
        try:
            return _fetch_json(inst.url.rstrip("/") + "/debug/slo", timeout_s)
        except (urllib.error.URLError, OSError, ValueError) as e:
            return {"_error": str(e)}

    results = []
    if brokers:
        with concurrent.futures.ThreadPoolExecutor(max_workers=min(8, len(brokers))) as pool:
            results = list(pool.map(fetch, brokers))
    tables: Dict[str, Dict[str, Any]] = {}
    unreachable: Dict[str, str] = {}
    config: Dict[str, Any] = {}
    for inst, snap in zip(brokers, results):
        if "_error" in snap:
            unreachable[inst.name] = snap["_error"]
            continue
        config = config or (snap.get("config") or {})
        for table, entry in (snap.get("tables") or {}).items():
            t = tables.get(table)
            if t is None:
                t = tables[table] = {"burnRate5m": 0.0, "burnRate1h": 0.0, "burning": False,
                                     "objective": entry.get("objective"), "byBroker": {}}
            t["burnRate5m"] = max(t["burnRate5m"], float(entry.get("burnRate5m") or 0.0))
            t["burnRate1h"] = max(t["burnRate1h"], float(entry.get("burnRate1h") or 0.0))
            t["burning"] = t["burning"] or bool(entry.get("burning"))
            t["byBroker"][inst.name] = {k: entry.get(k) for k in ("burnRate5m", "burnRate1h", "burning", "windows")}
    burning = sorted(t for t, e in tables.items() if e["burning"])
    ranked = sorted(tables.items(), key=lambda kv: -max(kv[1]["burnRate5m"], kv[1]["burnRate1h"]))
    return {
        "brokers": len(brokers),
        "config": config,
        "tables": tables,
        "burningTables": burning,
        "worstBurning": [t for t, _ in ranked[:10]],
        "unreachable": unreachable,
    }


def collect_utilization(
    ctrl: "Controller", timeout_s: float = 3.0, top_k: int = 10
) -> Dict[str, Any]:
    """Fleet device-utilization roll-up (``/debug/utilization``): every
    alive server's ``/debug/device`` snapshot included VERBATIM under
    ``servers.<name>.device`` — the totals below are computed from
    exactly those snapshots, so the roll-up always equals what it
    fetched — plus fleet aggregates (summed transfers, combined achieved
    rates over the recent windows, occupancy spread) and the top-K
    UNDERutilized executed plan shapes across every server's
    ``/debug/plans`` registry: a shape with heavy device time and a low
    roofline fraction is the first to speed up.  Unreachable servers
    degrade to an ``unreachable`` entry (partial roll-ups say so)."""
    targets = [
        i
        for i in ctrl.resources.instances_snapshot()
        if i.role == "server" and i.alive and i.url
    ]

    def fetch(inst):
        # the two GETs degrade independently: a server whose plans
        # registry times out still contributes its device snapshot
        # (only a failed DEVICE fetch marks it unreachable)
        out: Dict[str, Any] = {}
        base = inst.url.rstrip("/")
        try:
            with urllib.request.urlopen(
                base + "/debug/device", timeout=timeout_s
            ) as r:
                out["device"] = json.loads(r.read())
        except (urllib.error.URLError, OSError, ValueError) as e:
            out["_error"] = str(e)
            return out
        # full registry head ranked by cost: the underutilized-shape
        # scan wants the expensive shapes, not the frequent ones
        try:
            with urllib.request.urlopen(
                base + "/debug/plans?by=cost&top=1024", timeout=timeout_s
            ) as r:
                out["plans"] = json.loads(r.read())
        except (urllib.error.URLError, OSError, ValueError) as e:
            out["plansError"] = str(e)
        return out

    results = []
    if targets:
        with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(16, len(targets))
        ) as pool:
            results = list(pool.map(fetch, targets))

    servers: Dict[str, Any] = {}
    unreachable: Dict[str, str] = {}
    totals = {
        "h2dBytes": 0,
        "d2hBytes": 0,
        "deviceMs": 0.0,
        "deviceBytes": 0,
        "queries": 0,
    }
    busy: List[float] = []
    fractions: List[float] = []
    profiles_active = 0
    shapes: List[Dict[str, Any]] = []
    # transfer counters are per-PROCESS (like the staging cache they
    # instrument): servers sharing one process all report the same
    # cumulative numbers, so the fleet total counts each processToken
    # once instead of multiplying by co-resident servers
    seen_transfer_tokens: set = set()
    for inst, snap in zip(targets, results):
        if "_error" in snap:
            unreachable[inst.name] = snap["_error"]
            continue
        dev = snap.get("device") or {}
        servers[inst.name] = {"device": dev}
        if "plansError" in snap:
            servers[inst.name]["plansError"] = snap["plansError"]
        occ = dev.get("occupancy") or {}
        if occ:
            busy.append(float(occ.get("busyFraction") or 0.0))
        tr = dev.get("transfers") or {}
        token = tr.get("processToken") or f"_anon-{inst.name}"
        if token not in seen_transfer_tokens:
            seen_transfer_tokens.add(token)
            totals["h2dBytes"] += int(tr.get("h2dBytes") or 0)
            totals["d2hBytes"] += int(tr.get("d2hBytes") or 0)
        recent = dev.get("recent") or {}
        totals["deviceMs"] = round(
            totals["deviceMs"] + float(recent.get("deviceMs") or 0.0), 3
        )
        totals["deviceBytes"] += int(recent.get("deviceBytes") or 0)
        totals["queries"] += int(recent.get("queries") or 0)
        if recent.get("rooflineFraction") is not None:
            fractions.append(float(recent["rooflineFraction"]))
        if (dev.get("profiler") or {}).get("active"):
            profiles_active += 1
        for plan in (snap.get("plans") or {}).get("plans") or []:
            roof = plan.get("roofline")
            if not roof:
                continue  # never ran on device: nothing to rank
            shapes.append(
                {
                    "server": inst.name,
                    "digest": plan.get("digest"),
                    "summary": plan.get("summary", ""),
                    "table": plan.get("table", ""),
                    "count": plan.get("count", 0),
                    "deviceMs": roof.get("deviceMs", 0),
                    "deviceBytes": roof.get("deviceBytes", 0),
                    "achievedBytesPerSec": roof.get("achievedBytesPerSec", 0),
                    "rooflineFraction": roof.get("rooflineFraction"),
                }
            )

    # least-utilized first: shapes with a declared-peak fraction rank
    # before unknown-peak shapes (ranked by raw achieved bytes/s) —
    # ties broken toward the shapes burning the most device time,
    # which are the ones worth fixing first
    def _under_key(s: Dict[str, Any]):
        f = s.get("rooflineFraction")
        if f is not None:
            return (0, f, -float(s.get("deviceMs") or 0))
        return (1, float(s.get("achievedBytesPerSec") or 0),
                -float(s.get("deviceMs") or 0))

    ms = totals["deviceMs"]
    return {
        "servers": servers,
        "totals": dict(
            totals,
            achievedBytesPerSec=(
                round(totals["deviceBytes"] * 1000.0 / ms, 3) if ms > 0 else 0.0
            ),
        ),
        "occupancy": {
            "servers": len(busy),
            "meanBusyFraction": (
                round(sum(busy) / len(busy), 6) if busy else 0.0
            ),
            "maxBusyFraction": round(max(busy), 6) if busy else 0.0,
        },
        "rooflineFraction": round(max(fractions), 6) if fractions else None,
        "profilesActive": profiles_active,
        "underutilizedPlans": sorted(shapes, key=_under_key)[:top_k],
        "unreachable": unreachable,
    }


def _split_path(path: str) -> Optional[List[str]]:
    """URL-decoded path segments, or None for segments that would
    traverse the filesystem when joined into store paths."""
    parts = [unquote(p) for p in path.split("/") if p]
    for p in parts:
        if "/" in p or "\\" in p or p in (".", ".."):
            return None
    return parts


def _alive_broker_urls(resources: ClusterResourceManager) -> List[str]:
    return [i.url for i in resources.instances_snapshot() if i.role == "broker" and i.alive and i.url]


def _proxy_pql(ctrl: Controller, pql: str, trace: bool = False) -> Dict[str, Any]:
    """Forward a PQL query to an alive broker and return its JSON answer
    (``PqlQueryResource.java``, the dashboard's query console).  Brokers
    are tried in random order with failover."""
    brokers = _alive_broker_urls(ctrl.resources)
    if not brokers:
        return {"error": "no alive broker registered"}
    random.shuffle(brokers)
    last_err: Optional[Exception] = None
    for url in brokers:
        req = urllib.request.Request(
            url.rstrip("/") + "/query",
            data=json.dumps({"pql": pql, "trace": trace}).encode("utf-8"),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.loads(r.read())
        except (urllib.error.URLError, OSError, ValueError) as e:
            # ValueError: a non-broker process answering on a stale
            # registration's port
            last_err = e
    return {"error": f"all brokers failed: {last_err}"}


class ControllerHttpServer:
    """The REST front (module docstring).  ``start`` also starts the
    gateway's liveness monitor."""

    def __init__(self, controller: Controller, host: str = "127.0.0.1", port: int = 0):
        ctrl = controller

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, body: bytes, ctype: str, status: int = 200) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _respond(self, payload: Any, status: int = 200) -> None:
                self._send(json.dumps(payload).encode("utf-8"), "application/json", status)

            def _read_json(self) -> Dict[str, Any]:
                n = int(self.headers.get("Content-Length", "0"))
                return json.loads(self.rfile.read(n) or b"{}")

            def _respond_stale(self, e: StaleEpochError) -> None:
                # a typed fencing rejection (409): nothing was changed
                return self._respond({"error": str(e), "errorType": "StaleEpochError",
                                      "staleEpoch": e.stale, "currentEpoch": e.current}, 409)

            def _commit(self, segment: str, server: str, epoch) -> None:
                """segmentCommit: fenced before the body is parsed (a
                fenced-off committer retrying must not cost a segment's
                bytes a rejection; the body is still drained so the client
                reads the verdict)."""
                n = int(self.headers.get("Content-Length", "0"))
                completion = ctrl.realtime_manager.completion
                try:
                    fenced = completion.commit_fence_check(segment, server, epoch=epoch)
                except StaleEpochError:
                    self.rfile.read(n)
                    raise
                if fenced is not None:
                    self.rfile.read(n)
                    return self._respond({"response": fenced})
                data = self.rfile.read(n)
                with tempfile.TemporaryDirectory() as td:
                    with open(os.path.join(td, SEGMENT_FILE_NAME), "wb") as f:
                        f.write(data)
                    committed = read_segment(td)
                return self._respond({"response": completion.segment_commit(segment, server, committed, epoch=epoch)})

            def _respond_html(self, html: str) -> None:
                self._send(html.encode("utf-8"), "text/html; charset=utf-8")

            def do_GET(self):
                url = urlparse(self.path)
                parts = _split_path(url.path)
                if parts is None:
                    return self._respond({"error": "bad path"}, 400)
                try:
                    if not parts or parts == ["dashboard"]:
                        return self._respond_html(dashboard.render_home(ctrl))
                    if parts == ["dashboard", "query"]:
                        return self._respond_html(dashboard.render_query_console())
                    if len(parts) == 3 and parts[:2] == ["dashboard", "table"]:
                        if parts[2] not in ctrl.resources.tables():
                            return self._respond({"error": "table not found"}, 404)
                        return self._respond_html(dashboard.render_table(ctrl, parts[2]))
                    if parts == ["dashboard", "metrics"]:
                        return self._respond_html(dashboard.render_metrics(ctrl, collect_cluster_metrics(ctrl)))
                    if parts == ["dashboard", "capacity"]:
                        return self._respond_html(dashboard.render_capacity(ctrl, collect_capacity(ctrl)))
                    if parts == ["dashboard", "workload"]:
                        return self._respond_html(dashboard.render_workload(ctrl, collect_workload(ctrl)))
                    if parts == ["dashboard", "utilization"]:
                        return self._respond_html(dashboard.render_utilization(ctrl, collect_utilization(ctrl)))
                    if parts == ["dashboard", "slo"]:
                        return self._respond_html(dashboard.render_slo(ctrl, collect_slo(ctrl)))
                    if parts == ["pql"]:
                        qs = parse_qs(url.query)
                        trace = (qs.get("trace") or ["false"])[0].lower() == "true"
                        return self._respond(_proxy_pql(ctrl, (qs.get("pql") or [""])[0], trace))
                    if parts == ["debug", "clustermetrics"]:
                        return self._respond(collect_cluster_metrics(ctrl))
                    if parts == ["debug", "capacity"]:
                        return self._respond(collect_capacity(ctrl))
                    if parts == ["debug", "slo"]:
                        return self._respond(collect_slo(ctrl))
                    if parts == ["debug", "history"]:
                        return self._respond(ctrl.history.query_from_qs(url.query))
                    if parts == ["debug", "flightrec"]:
                        return self._respond(ctrl.flightrec.snapshot())
                    if parts == ["debug", "audit"]:
                        return self._respond(ctrl.crc_audit.snapshot())
                    if parts == ["debug", "deepstore"]:
                        return self._respond(ctrl.deepstore_scrubber.snapshot())
                    if parts == ["debug", "stabilizer"]:
                        return self._respond(ctrl.stabilizer.debug_snapshot())
                    if len(parts) == 3 and parts[0] == "instances" and parts[2] == "drain":
                        # the rolling restart's poll
                        try:
                            return self._respond(ctrl.drain_status(parts[1]))
                        except KeyError as e:
                            return self._respond({"error": str(e)}, 404)
                    if parts == ["tenants"]:
                        return self._respond({"tenants": ctrl.resources.list_tenants()})
                    if len(parts) == 2 and parts[0] == "tenants":
                        return self._respond({
                            "tenant": parts[1],
                            "ServerInstances": ctrl.resources.tenant_instances(parts[1], "server"),
                            "BrokerInstances": ctrl.resources.tenant_instances(parts[1], "broker"),
                        })
                    if len(parts) == 3 and parts[0] == "tables" and parts[2] == "size":
                        return self._respond({"table": parts[1],
                                              "reportedSizeInBytes": ctrl.store.table_size_bytes(parts[1])})
                    if parts == ["health"]:
                        return self._respond({"status": "ok"})
                    if parts == ["metrics"]:
                        return self._send(ctrl.metrics_text().encode("utf-8"), "text/plain; version=0.0.4")
                    if parts == ["debug", "metrics"]:
                        return self._respond(ctrl.metrics_snapshot())
                    if parts == ["clusterstate"]:
                        qs = parse_qs(url.query)
                        if_newer = int((qs.get("ifNewer") or ["-1"])[0])
                        epoch = (qs.get("epoch") or [""])[0]
                        if epoch == ctrl.gateway.epoch and ctrl.resources.version <= if_newer:
                            return self._respond({"version": ctrl.resources.version,
                                                  "epoch": ctrl.gateway.epoch, "unchanged": True})
                        return self._respond(ctrl.gateway.cluster_state())
                    if len(parts) == 3 and parts[0] == "instances" and parts[2] == "messages":
                        return self._respond({"messages": ctrl.gateway.messages(parts[1])})
                    if len(parts) == 4 and parts[0] == "segments" and parts[3] == "file":
                        path = ctrl.store.segment_file_path(parts[1], parts[2])
                        if not os.path.exists(path):
                            return self._respond({"error": "not found"}, 404)
                        with open(path, "rb") as f:
                            return self._send(f.read(), "application/octet-stream")
                    if parts == ["brokers"]:
                        return self._respond({"brokers": _alive_broker_urls(ctrl.resources)})
                    if parts == ["debug", "workload"]:
                        # ?n= caps the top-K rankings; ?tables=a,b narrows
                        # them (the prewarm feed of a restarted server)
                        qs = parse_qs(url.query)
                        try:
                            n = int((qs.get("n") or qs.get("top") or ["20"])[0])
                        except ValueError:
                            n = 20
                        tables = [t.strip() for t in (qs.get("tables") or [""])[0].split(",") if t.strip()]
                        return self._respond(collect_workload(ctrl, n=n, tables=tables or None))
                    if parts == ["debug", "utilization"]:
                        return self._respond(collect_utilization(ctrl))
                    if parts == ["tables"]:
                        return self._respond({"tables": ctrl.resources.tables()})
                    if len(parts) == 2 and parts[0] == "schemas":
                        schema = ctrl.resources.get_schema(parts[1])
                        if schema is None:
                            return self._respond({"error": "not found"}, 404)
                        return self._respond(schema.to_json())
                    if len(parts) == 3 and parts[0] == "tables":
                        if parts[2] == "segments":
                            return self._respond({"segments": ctrl.resources.segments_of(parts[1])})
                        if parts[2] == "idealstate":
                            return self._respond(ctrl.resources.get_ideal_state(parts[1]))
                        if parts[2] == "externalview":
                            return self._respond(ctrl.resources.get_external_view(parts[1]))
                    return self._respond({"error": "not found"}, 404)
                except Exception as e:
                    return self._respond({"error": str(e)}, 500)

            def do_POST(self):
                url = urlparse(self.path)
                parts = _split_path(url.path)
                if parts is None:
                    return self._respond({"error": "bad path"}, 400)
                try:
                    if parts == ["pql"]:
                        body = self._read_json()
                        return self._respond(_proxy_pql(ctrl, body.get("pql", ""), bool(body.get("trace"))))
                    if parts == ["instances"]:
                        return self._respond(ctrl.gateway.register(self._read_json()))
                    if parts == ["deepstore", "suspect"]:
                        # a server's download failed CRC against the store copy
                        body = self._read_json()
                        ctrl.deepstore_scrubber.report_suspect(
                            str(body.get("table", "")), str(body.get("segment", "")), str(body.get("source", "")))
                        return self._respond({"status": "reported"})
                    if len(parts) == 3 and parts[0] == "instances" and parts[2] in ("drain", "undrain"):
                        fn = ctrl.drain_instance if parts[2] == "drain" else ctrl.undrain_instance
                        try:
                            return self._respond(fn(parts[1]))
                        except KeyError as e:
                            return self._respond({"error": str(e)}, 404)
                    if parts == ["tenants"]:
                        body = self._read_json()
                        tagged = ctrl.resources.create_tenant(
                            body["name"], body.get("role", "server"), int(body.get("count", 1)))
                        return self._respond({"status": "ok", "instances": tagged})
                    if len(parts) == 3 and parts[0] == "tables" and parts[2] == "rebalance":
                        dry = (parse_qs(url.query).get("dryRun") or ["false"])[0].lower() == "true"
                        return self._respond(ctrl.rebalance_table(parts[1], dry_run=dry))
                    if len(parts) == 3 and parts[0] == "instances" and parts[2] == "heartbeat":
                        return self._respond(ctrl.gateway.heartbeat(parts[1], self._read_json()))
                    if len(parts) == 3 and parts[0] == "instances" and parts[2] == "ack":
                        return self._respond(ctrl.gateway.ack(parts[1], self._read_json()))
                    if parts == ["schemas"]:
                        schema = Schema.from_json(self._read_json())
                        ctrl.add_schema(schema)
                        return self._respond({"status": "ok", "schema": schema.schema_name})
                    if parts == ["tables"]:
                        config = TableConfig.from_json(self._read_json())
                        if config.table_type == "REALTIME":
                            if config.stream is None:
                                return self._respond({"error": "REALTIME table needs streamConfigs"}, 400)
                            physical = ctrl.add_realtime_table(config, stream_provider_from_config(config.stream))
                        else:
                            physical = ctrl.add_table(config)
                        return self._respond({"status": "ok", "table": physical})
                    if len(parts) == 3 and parts[0] == "tables" and parts[2] == "quota":
                        # live query-rate quota update or removal
                        # ({"maxQueriesPerSecond": null}); the cluster-state
                        # version moves, so networked brokers converge
                        body = self._read_json()
                        try:
                            ctrl.resources.update_table_quota(
                                parts[1], body.get("maxQueriesPerSecond"), body.get("burstQueries"))
                        except KeyError as e:
                            return self._respond({"error": str(e)}, 404)
                        return self._respond({"status": "ok", "table": parts[1]})
                    if parts == ["realtime", "consumed"]:
                        # segmentConsumed; the caller's lease epoch rides the
                        # body and is fence-checked (409 on a mismatch)
                        body = self._read_json()
                        resp, target = ctrl.realtime_manager.completion.segment_consumed(
                            body["segment"], body["server"], int(body["offset"]), epoch=body.get("epoch"))
                        return self._respond({"response": resp, "targetOffset": target})
                    if len(parts) == 4 and parts[:2] == ["realtime", "commit"]:
                        epoch = (parse_qs(url.query).get("epoch") or [None])[0]
                        return self._commit(parts[2], parts[3], epoch)
                    if len(parts) == 2 and parts[0] == "segments":
                        # ?server= pins the assignment (an HLC segment stays
                        # on the server that consumed it)
                        n = int(self.headers.get("Content-Length", "0"))
                        body = self.rfile.read(n)
                        pin = parse_qs(url.query).get("server")
                        servers = ctrl.upload_segment_bytes(parts[1], body, servers=pin)
                        return self._respond({"status": "ok", "servers": servers})
                    if parts == ["realtime", "hlc", "roll"]:
                        # a server sealed its HLC segment and consumes on at
                        # the next sequence: record that CONSUMING segment
                        body = self._read_json()
                        seg = ctrl.realtime_manager.register_hlc_roll(
                            body["table"], body["server"], int(body["idx"]), int(body["seq"]))
                        return self._respond({"status": "ok", "segment": seg})
                    return self._respond({"error": "not found"}, 404)
                except StaleEpochError as e:
                    return self._respond_stale(e)
                except Exception as e:
                    logger.warning("REST handler error", exc_info=True)
                    return self._respond({"error": str(e)}, 400)

            def do_DELETE(self):
                parts = _split_path(urlparse(self.path).path)
                if parts is None:
                    return self._respond({"error": "bad path"}, 400)
                try:
                    if len(parts) == 2 and parts[0] == "tables":
                        ctrl.delete_table(parts[1])
                        return self._respond({"status": "ok"})
                    if len(parts) == 4 and parts[0] == "tables" and parts[2] == "segments":
                        ctrl.delete_segment(parts[1], parts[3])
                        return self._respond({"status": "ok"})
                    return self._respond({"error": "not found"}, 404)
                except StaleEpochError as e:
                    # a zombie controller's deletes hit the fenced store too
                    return self._respond_stale(e)
                except Exception as e:
                    logger.warning("REST handler error", exc_info=True)
                    return self._respond({"error": str(e)}, 400)

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._controller = controller
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> None:
        self._controller.gateway.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._controller.gateway.stop()
        self._httpd.shutdown()
        self._httpd.server_close()
