"""Controller: cluster CRUD facade and REST API (port of
``pinot_tpu.controller.controller``, trimmed).

``Controller`` keeps schemas, table configs and the ideal state
(``ClusterResourceManager``), the durable segment copies
(``SegmentStore``), the remote-instance control plane
(``ParticipantGateway``) and the LLC realtime manager
(``realtime/llc.py RealtimeSegmentManager``: REALTIME tables, their
CONSUMING segments and the completion protocol).  ``ControllerHttpServer`` serves the routes the
server and broker starters and the admin CLI call, with the reference's
paths and JSON:

  GET    /health  /metrics  /debug/metrics  /clusterstate?ifNewer=&epoch=
         /instances/<name>/messages  /segments/<table>/<segment>/file
         /tables  /tables/<table>/segments|idealstate|externalview
         /schemas/<name>  /brokers
         /debug/workload?n=&tables=   (collect_workload: every broker's
                              plan statistics merged by digest)
         /debug/utilization   (collect_utilization: every server's
                              /debug/device and its costliest plans)
  POST   /instances  /instances/<name>/heartbeat|ack  /schemas
         /tables   (a REALTIME config's streamConfigs name its stream)
         /tables/<table>/quota   ({"maxQueriesPerSecond", "burstQueries"};
                              null removes the query-rate quota)
         /segments/<table>   (the segment file's bytes; refused past the
                              table's storage quota)
         /realtime/consumed   (segmentConsumed: {segment, server, offset, epoch})
         /realtime/commit/<segment>/<server>?epoch=   (segmentCommit: the
                              committed segment file's bytes)
  DELETE /tables/<table>  /tables/<table>/segments/<segment>

Left out, ROADMAP queue 1 item 30: the property store, journal and
recovery (a restarted controller does not resume a table's consumption
from its checkpointed offsets), the stabilizer, the retention /
validation / status-checker managers (``realtime_manager.
ensure_consuming_segments`` is the validation repair, called directly),
the dashboard pages (of the utilization and workload roll-ups too),
creating tenants, rebalance and drain, and the other ``collect_*``
planes.  A table on a tenant without live members is refused, and the
storage quota is checked before an upload touches the store.
"""
from __future__ import annotations

import concurrent.futures
import json
import logging
import os
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
from pinot_tpu_torch.controller.network import ParticipantGateway
from pinot_tpu_torch.controller.resource_manager import ClusterResourceManager
from pinot_tpu_torch.controller.store import SegmentStore
from pinot_tpu_torch.engine.plandigest import _raw_table
from pinot_tpu_torch.realtime.llc import RealtimeSegmentManager
from pinot_tpu_torch.realtime.stream import stream_provider_from_config
from pinot_tpu_torch.segment.format import SEGMENT_FILE_NAME, read_segment, read_segment_metadata, write_segment
from pinot_tpu_torch.segment.immutable import ImmutableSegment, SegmentMetadata
from pinot_tpu_torch.utils.metrics import ControllerMetrics, prometheus_text
from pinot_tpu_torch.utils.planstats import PlanStatsStore

logger = logging.getLogger(__name__)


class Controller:
    """``data_dir`` holds the segment store; ``heartbeat_timeout_s`` is the
    remote instances' liveness window."""

    def __init__(self, data_dir: str, heartbeat_timeout_s: float = 6.0, lease_s: Optional[float] = None) -> None:
        # the incarnation number (no property store persists one): a
        # restarted controller's epoch is larger
        self.epoch = int(time.time() * 1000)
        self.resources = ClusterResourceManager()
        self.store = SegmentStore(os.path.join(data_dir, "segments"))
        self.metrics = ControllerMetrics("controller")
        for m in ("instanceRegistrations", "heartbeats", "instancesMarkedDead", "transitionAcks",
                  "clusterStatePolls", "segmentUploads", "lease.granted", "fence.staleEpochRejections",
                  "fence.leaseRejections", "fence.committerReElections"):
            self.metrics.meter(m)
        self.metrics.gauge("fence.epoch").set(self.epoch)
        self.realtime_manager = RealtimeSegmentManager(self.resources, self.store, metrics=self.metrics)
        # arms the commit plane's epoch fence: segmentConsumed and
        # segmentCommit carry the caller's lease epoch
        self.realtime_manager.epoch = self.epoch
        self.gateway = ParticipantGateway(
            self.resources, heartbeat_timeout_s=heartbeat_timeout_s, metrics=self.metrics,
            epoch=self.epoch, lease_s=lease_s,
        )
        # a committer whose lease expired mid-protocol is re-electable
        self.realtime_manager.completion.lease_checker = self.gateway.server_lease_valid

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

    def _refresh_gauges(self) -> None:
        insts = self.resources.instances_snapshot()
        self.metrics.gauge("aliveServers").set(sum(1 for i in insts if i.role == "server" and i.alive))
        self.metrics.gauge("aliveBrokers").set(sum(1 for i in insts if i.role == "broker" and i.alive))
        self.metrics.gauge("deadInstances").set(sum(1 for i in insts if not i.alive))
        self.metrics.gauge("tables").set(len(self.resources.tables()))

    def metrics_snapshot(self) -> Dict[str, Any]:
        self._refresh_gauges()
        return {"controller": self.metrics.snapshot()}

    def metrics_text(self) -> str:
        self._refresh_gauges()
        return prometheus_text(self.metrics)


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

            def do_GET(self):
                url = urlparse(self.path)
                parts = _split_path(url.path)
                if parts is None:
                    return self._respond({"error": "bad path"}, 400)
                try:
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
                    if parts == ["instances"]:
                        return self._respond(ctrl.gateway.register(self._read_json()))
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
                        n = int(self.headers.get("Content-Length", "0"))
                        body = self.rfile.read(n)
                        pin = parse_qs(url.query).get("server")
                        servers = ctrl.upload_segment_bytes(parts[1], body, servers=pin)
                        return self._respond({"status": "ok", "servers": servers})
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
