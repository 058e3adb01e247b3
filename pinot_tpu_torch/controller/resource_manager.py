"""Cluster resource manager: ideal state and external view (port of
``pinot_tpu.controller.resource_manager``, trimmed).

- **ideal state** per table: ``{segment -> {server -> target_state}}``,
  what the controller wants (N replicas a segment, round-robin over the
  live servers of the table's tenant);
- **external view** per table: ``{segment -> {server -> actual_state}}``,
  what the servers report after running their transitions;
- **participants**: server callbacks running OFFLINE->ONLINE,
  ->CONSUMING (a realtime segment's consumer starts), CONSUMING->ONLINE
  (the committed copy replaces it), ONLINE->OFFLINE and ->DROPPED (a
  remote participant answers "pending" and reports the state later,
  ``report_state``).

Every change of a view or an instance bumps ``version``; remote brokers
poll the cluster state when it moves, and an in-process broker's view
listener (``add_view_listener``) is called with the table's view.

Tables on a tenant with no live members are refused
(``validate_tenants``); a table's query-rate quota updates live
(``update_table_quota``); servers report whether they are warming.

Left out, ROADMAP queue 1 item 30: the property store and recovery,
creating tenants beyond the default tag, drain, rebalance, per-replica
surgery for the stabilizer, instance listeners.
"""
from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.tableconfig import QuotaConfig, TableConfig
from pinot_tpu_torch.segment.immutable import SegmentMetadata

logger = logging.getLogger(__name__)

ONLINE = "ONLINE"
CONSUMING = "CONSUMING"
OFFLINE = "OFFLINE"
DROPPED = "DROPPED"
ERROR = "ERROR"


@dataclass
class InstanceState:
    name: str
    role: str  # "server" | "broker"
    alive: bool = True
    tags: Set[str] = field(default_factory=lambda: {"DefaultTenant"})
    url: Optional[str] = None  # broker query URL, server admin URL
    addr: Optional[Tuple[str, int]] = None  # server query TCP endpoint
    # serving-lease expiry (the gateway's monotonic clock); None = never
    # leased (an in-process participant)
    lease_until: Optional[float] = None
    # heartbeat-reported: the server is still prewarming its hot plan
    # shapes (``server/prewarm.py``).  A warming server serves; brokers
    # only deprioritize it
    warming: bool = False


class Participant:
    """Server-side transition executor: ``on_transition(table, segment,
    target, info)`` returns True (done), False (failed -> ERROR) or None
    (pending: the state arrives later through ``report_state``)."""

    def __init__(self, name: str, on_transition: Callable[[str, str, str, Dict[str, Any]], Optional[bool]]) -> None:
        self.name = name
        self.on_transition = on_transition


class ClusterResourceManager:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self.schemas: Dict[str, Schema] = {}
        self.table_configs: Dict[str, TableConfig] = {}
        self.segment_metadata: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.ideal_states: Dict[str, Dict[str, Dict[str, str]]] = {}
        self.external_views: Dict[str, Dict[str, Dict[str, str]]] = {}
        self.instances: Dict[str, InstanceState] = {}
        self._participants: Dict[str, Participant] = {}
        self._assign_rr = 0
        # bumped on every view or instance change; remote brokers poll it
        self.version = 0
        # fn(table, {segment: {server: state}}) on every view change
        self._view_listeners: List[Callable[[str, Dict[str, Dict[str, str]]], None]] = []
        # fn(segment) after a segment is deleted (the realtime manager
        # stops its consumers)
        self.segment_deleted_listeners: List[Callable[[str], None]] = []

    def bump_version(self) -> int:
        with self._lock:
            self.version += 1
            return self.version

    # -- instances ----------------------------------------------------
    def instances_snapshot(self) -> List[InstanceState]:
        with self._lock:
            return [replace(i, tags=set(i.tags)) for i in self.instances.values()]

    def register_instance(self, state: InstanceState, participant: Optional[Participant] = None) -> None:
        with self._lock:
            self.instances[state.name] = state
            if participant is not None:
                self._participants[state.name] = participant
        self.bump_version()

    def set_instance_alive(self, name: str, alive: bool) -> None:
        """A liveness flip: a dead server's replicas turn OFFLINE in every
        external view; a revived one replays its ideal-state transitions."""
        with self._lock:
            inst = self.instances.get(name)
            if inst is None or inst.alive == alive:
                return
            inst.alive = alive
            if not alive:
                for view in self.external_views.values():
                    for replicas in view.values():
                        if name in replicas:
                            replicas[name] = OFFLINE
        self.bump_version()
        if alive:
            self.reconcile_instance(name)

    def reconcile_instance(self, name: str) -> None:
        """Replay this instance's ONLINE and CONSUMING ideal-state
        transitions (a server joining or rejoining)."""
        with self._lock:
            tables = list(self.ideal_states.keys())
        for table in tables:
            with self._lock:
                ideal = dict(self.ideal_states.get(table, {}))
            for seg, replicas in ideal.items():
                if replicas.get(name) in (ONLINE, CONSUMING):
                    self._execute_transition(table, seg, name, replicas[name])
            self._notify_view(table)

    # -- listeners ----------------------------------------------------
    def add_view_listener(self, fn: Callable[[str, Dict[str, Dict[str, str]]], None]) -> None:
        with self._lock:
            self._view_listeners.append(fn)

    def _notify_view(self, table: str) -> None:
        """Bump the version and hand the table's view of live servers to
        every view listener."""
        self.bump_version()
        with self._lock:
            view = {
                seg: {srv: st for srv, st in replicas.items()
                      if self.instances.get(srv) is not None and self.instances[srv].alive}
                for seg, replicas in self.external_views.get(table, {}).items()
            }
            listeners = list(self._view_listeners)
        for fn in listeners:
            try:
                fn(table, view)
            except Exception:
                logger.exception("view listener failed for %s", table)

    def set_instance_warming(self, name: str, warming: bool) -> None:
        """Warm-start readiness flip (heartbeat-reported).  Routing covers
        are untouched (a warming server serves), but the version bump
        makes remote brokers refetch the cluster state, whose
        ``warmingServers`` list feeds their deprioritization."""
        with self._lock:
            inst = self.instances.get(name)
            if inst is None or inst.warming == warming:
                return
            inst.warming = warming
        self.bump_version()

    def is_instance_warming(self, name: str) -> bool:
        with self._lock:
            inst = self.instances.get(name)
            return inst is not None and inst.warming

    def _live_tenant_members(self, tag: str, role: str) -> List[str]:
        with self._lock:
            return sorted(
                i.name for i in self.instances.values() if tag in i.tags and i.role == role and i.alive
            )

    def validate_tenants(self, config: TableConfig) -> None:
        """Refuse a table whose non-default tenant has no live members
        (the reference validates tenants before writing the table
        config)."""
        if config.server_tenant != "DefaultTenant" and not self._live_tenant_members(
            config.server_tenant, "server"
        ):
            raise ValueError(f"server tenant {config.server_tenant!r} has no live servers")
        if config.broker_tenant != "DefaultTenant" and not self._live_tenant_members(
            config.broker_tenant, "broker"
        ):
            raise ValueError(f"broker tenant {config.broker_tenant!r} has no live brokers")

    def update_table_quota(self, physical: str, max_queries_per_second, burst_queries=None) -> None:
        """Live query-rate quota update or removal (None) for a running
        table: the view re-notify re-applies it in in-process brokers at
        once, and the version bump reaches networked brokers on their next
        cluster-state poll."""
        with self._lock:
            config = self.table_configs.get(physical)
            if config is None:
                raise KeyError(f"no such table {physical}")
            config.quota = QuotaConfig(
                storage=config.quota.storage,
                max_queries_per_second=max_queries_per_second,
                burst_queries=burst_queries,
            )
        self._notify_view(physical)

    # -- schema / table CRUD ------------------------------------------
    def add_schema(self, schema: Schema) -> None:
        with self._lock:
            self.schemas[schema.schema_name] = schema

    def get_schema(self, name: str) -> Optional[Schema]:
        with self._lock:
            return self.schemas.get(name)

    def add_table(self, config: TableConfig) -> str:
        if not config.table_name.replace("_", "").replace("-", "").isalnum():
            # table names become store paths: refuse anything that could
            # traverse the filesystem
            raise ValueError(f"invalid table name {config.table_name!r}")
        with self._lock:
            physical = config.physical_name
            self.table_configs[physical] = config
            self.ideal_states.setdefault(physical, {})
            self.external_views.setdefault(physical, {})
        self.bump_version()
        return physical

    def delete_table(self, physical: str) -> None:
        with self._lock:
            segs = list(self.ideal_states.get(physical, {}).keys())
        for seg in segs:
            self.delete_segment(physical, seg)
        with self._lock:
            self.table_configs.pop(physical, None)
            self.ideal_states.pop(physical, None)
            self.external_views.pop(physical, None)
        self._notify_view(physical)

    def tables(self) -> List[str]:
        with self._lock:
            return list(self.table_configs.keys())

    # -- segment assignment -------------------------------------------
    def _pick_servers(self, config: TableConfig) -> List[str]:
        with self._lock:
            servers = sorted(
                n for n, inst in self.instances.items()
                if inst.role == "server" and inst.alive and config.server_tenant in inst.tags
            )
        if not servers:
            raise RuntimeError("no live servers to assign segment")
        n = min(config.replication, len(servers))
        # balanced round-robin over the sorted server list
        picked = [servers[(self._assign_rr + i) % len(servers)] for i in range(n)]
        self._assign_rr += 1
        return picked

    def add_segment(
        self,
        physical_table: str,
        metadata: SegmentMetadata,
        download_info: Dict[str, Any],
        target_state: str = ONLINE,
        servers: Optional[Sequence[str]] = None,
    ) -> List[str]:
        """Assign a segment to replicas and drive them to ``target_state``
        (the upload path: store, ideal state, ONLINE messages)."""
        with self._lock:
            config = self.table_configs[physical_table]
            chosen = list(servers) if servers else self._pick_servers(config)
            self.ideal_states[physical_table][metadata.segment_name] = {s: target_state for s in chosen}
            self.segment_metadata[(physical_table, metadata.segment_name)] = {
                "metadata": metadata, **download_info,
            }
        for server in chosen:
            self._execute_transition(physical_table, metadata.segment_name, server, target_state)
        self._notify_view(physical_table)
        return chosen

    def _execute_transition(self, table: str, segment: str, server: str, target: str) -> None:
        with self._lock:
            participant = self._participants.get(server)
            info = dict(self.segment_metadata.get((table, segment), {}))
            if target == ONLINE:
                cfg = self.table_configs.get(table)
                cols = cfg.indexing.inverted_index_columns if cfg else []
                if cols:
                    info["invertedIndexColumns"] = list(cols)
                schema = self.schemas.get(cfg.raw_name) if cfg else None
                if schema is not None:
                    info["schema"] = schema
            view = self.external_views.setdefault(table, {}).setdefault(segment, {})
        ok: Optional[bool] = False
        if participant is not None:
            try:
                ok = participant.on_transition(table, segment, target, info)
            except Exception:
                logger.exception("transition %s/%s -> %s on %s failed", table, segment, target, server)
                ok = False
        with self._lock:
            if ok is None:
                view.setdefault(server, OFFLINE)  # pending: report_state follows
            else:
                view[server] = target if ok else ERROR

    def reload_table(self, physical: str) -> None:
        """Run every ONLINE transition of a table's ideal state again (the
        reference's segment reload).  The servers' CRC skip makes it cheap
        on metadata; it is how schema evolution reaches segments loaded
        before the schema grew."""
        with self._lock:
            ideal = dict(self.ideal_states.get(physical, {}))
        for seg, replicas in ideal.items():
            for server, state in replicas.items():
                if state == ONLINE:
                    self._execute_transition(physical, seg, server, ONLINE)
        self._notify_view(physical)

    def tables_of_schema(self, raw_name: str) -> List[str]:
        with self._lock:
            return [phys for phys, cfg in self.table_configs.items() if cfg.raw_name == raw_name]

    def delete_segment(self, physical_table: str, segment: str) -> None:
        with self._lock:
            replicas = self.ideal_states.get(physical_table, {}).pop(segment, {})
            self.segment_metadata.pop((physical_table, segment), None)
        for server in replicas:
            self._execute_transition(physical_table, segment, server, DROPPED)
        with self._lock:
            self.external_views.get(physical_table, {}).pop(segment, None)
        for fn in list(self.segment_deleted_listeners):
            fn(segment)
        self._notify_view(physical_table)

    def report_state(self, server: str, table: str, segment: str, state: str) -> None:
        """A remote participant's state after it ran a queued transition
        (the Helix CurrentState write)."""
        with self._lock:
            tbl_view = self.external_views.setdefault(table, {})
            if segment not in self.ideal_states.get(table, {}):
                tbl_view.pop(segment, None)  # deleted while the message was in flight
                return
            if state == DROPPED:
                tbl_view.get(segment, {}).pop(server, None)
            else:
                tbl_view.setdefault(segment, {})[server] = state
        self._notify_view(table)

    # -- views --------------------------------------------------------
    def get_ideal_state(self, table: str) -> Dict[str, Dict[str, str]]:
        with self._lock:
            return {s: dict(r) for s, r in self.ideal_states.get(table, {}).items()}

    def get_external_view(self, table: str) -> Dict[str, Dict[str, str]]:
        with self._lock:
            return {s: dict(r) for s, r in self.external_views.get(table, {}).items()}

    def segments_of(self, table: str) -> List[str]:
        with self._lock:
            return list(self.ideal_states.get(table, {}).keys())

    def get_segment_metadata(self, table: str, segment: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self.segment_metadata.get((table, segment))
