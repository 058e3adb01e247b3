"""Cluster resource manager: ideal state and external view (port of
``pinot_tpu.controller.resource_manager``).

- **ideal state** per table: ``{segment -> {server -> target_state}}``,
  what the controller wants (N replicas a segment, round-robin over the
  live, not draining servers of the table's tenant);
- **external view** per table: ``{segment -> {server -> actual_state}}``,
  what the servers report after running their transitions;
- **participants**: server callbacks running OFFLINE->ONLINE,
  ->CONSUMING (a realtime segment's consumer starts), CONSUMING->ONLINE
  (the committed copy replaces it), ONLINE->OFFLINE and ->DROPPED (a
  remote participant answers "pending" and reports the state later,
  ``report_state``);
- **listeners**: view listeners (a broker's routing) and instance
  listeners (a broker's health tracker) called on every change.

With a ``property_store`` the schemas, table configs, ideal states,
segment records (the LLC offset checkpoints among them) and the drain
flags are written through to it, so a restarted controller recovers
them (``Controller._recover``).  Tenants (``create_tenant``), drain
(``set_instance_draining``), ``rebalance_table`` and the per-replica
surgery the stabilizer runs (``add_segment_replica`` ...) are the
reference's.  Every change of a view or an instance bumps ``version``;
remote brokers poll the cluster state when it moves.
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
OFFLINE = "OFFLINE"
CONSUMING = "CONSUMING"
DROPPED = "DROPPED"
ERROR = "ERROR"


@dataclass
class InstanceState:
    name: str
    role: str  # "server" | "broker"
    alive: bool = True
    tags: Set[str] = field(default_factory=lambda: {"DefaultTenant"})
    url: Optional[str] = None  # broker HTTP url (client discovery)
    addr: Optional[Tuple[str, int]] = None  # server query-TCP endpoint
    # drain/decommission: a draining server keeps serving in-flight
    # queries but is hidden from NEW routing covers and excluded from
    # segment placement; the SelfStabilizer migrates its replicas off
    # so a rolling restart is drain -> restart -> rejoin (undrain)
    draining: bool = False
    # warm-start readiness (heartbeat-reported): True while the server
    # is still prewarming its compile working set.  A warming server
    # serves normally — brokers merely deprioritize it and the
    # stabilizer defers trimming the replica it is replacing.
    warming: bool = False
    # serving-lease expiry (monotonic deadline, ParticipantGateway
    # clock): None = never leased (in-process participant — implicit
    # authority, and the stabilizer applies only its grace window).
    # While ``now < lease_until`` a heartbeat-missing server may STILL
    # be alive-but-partitioned and serving from its last snapshot, so
    # the stabilizer must not move its replicas yet (lease fence).
    lease_until: Optional[float] = None


class Participant:
    """Server-side transition executor registered with the controller.

    ``on_transition`` returns True (done), False (failed -> ERROR), or
    None (pending — a remote participant queued the work and will report
    the resulting state later via ``report_state``, the Helix
    message+current-state split)."""

    def __init__(
        self,
        name: str,
        on_transition: Callable[[str, str, str, Dict[str, Any]], Optional[bool]],
    ) -> None:
        self.name = name
        # on_transition(table, segment, target_state, metadata) -> ok|None
        self.on_transition = on_transition


class ClusterResourceManager:
    def __init__(self, property_store=None) -> None:
        """``property_store`` (controller.property_store.PropertyStore)
        makes schemas, table configs, ideal states, and segment
        metadata — incl. LLC offset checkpoints — durable across
        controller restarts (the ZK property-store role,
        ``PinotHelixResourceManager.java:103``).  None keeps everything
        in memory (embedded/test deployments)."""
        self.property_store = property_store
        self._lock = threading.RLock()
        self.schemas: Dict[str, Schema] = {}
        self.table_configs: Dict[str, TableConfig] = {}
        self.segment_metadata: Dict[Tuple[str, str], Dict[str, Any]] = {}  # (table, seg) -> zk-like record
        self.ideal_states: Dict[str, Dict[str, Dict[str, str]]] = {}
        self.external_views: Dict[str, Dict[str, Dict[str, str]]] = {}
        self.instances: Dict[str, InstanceState] = {}
        self._participants: Dict[str, Participant] = {}
        # drain flags survive BOTH instance re-registration and
        # controller restarts: kept by name (not on the InstanceState,
        # which registration replaces) and persisted to the property
        # store so a recovered controller resumes an in-flight drain
        self._draining_flags: Set[str] = set()
        if property_store is not None:
            for name in property_store.list_keys("instances"):
                rec = property_store.get("instances", name)
                if rec and rec.get("draining"):
                    self._draining_flags.add(name)
        self._view_listeners: List[Callable[[str, Dict[str, Dict[str, str]]], None]] = []
        self._instance_listeners: List[Callable[[str, bool], None]] = []
        # deep-store suspect intake: the controller points this at its
        # DeepStoreScrubber.report_suspect so in-process servers can
        # flag a store copy whose bytes failed CRC on fetch
        # (table, segment, source_uri) -> None; None = no scrubber
        self.report_store_suspect: Optional[Callable[[str, str, str], None]] = None
        # fn(segment) after a segment is deleted (the realtime manager
        # stops its in-process consumers)
        self.segment_deleted_listeners: List[Callable[[str], None]] = []
        # (table, segment) -> the old replicas a rebalance drops once the
        # new ones report their ideal state (_settle_deferred_drops)
        self._deferred_drops: Dict[Tuple[str, str], Set[str]] = {}
        self._assign_rr = 0
        # monotonically bumped on every view/instance change; remote
        # brokers poll it to decide when to rebuild routing
        self.version = 0

    def bump_version(self) -> int:
        with self._lock:
            self.version += 1
            return self.version

    # -- instances ----------------------------------------------------
    def instances_snapshot(self) -> List[InstanceState]:
        """Point-in-time instance copies for lock-free iteration by
        readers (dashboard pages, broker discovery). Tags are copied too
        so create_tenant can't mutate a set mid-iteration."""
        with self._lock:
            return [replace(i, tags=set(i.tags)) for i in self.instances.values()]

    def register_instance(self, state: InstanceState, participant: Optional[Participant] = None) -> None:
        with self._lock:
            # a drain is an operator intent keyed by NAME: registration
            # (fresh process or re-register after a controller restart)
            # must not silently re-admit a draining instance — only an
            # explicit undrain does
            state.draining = state.name in self._draining_flags
            self.instances[state.name] = state
            if participant is not None:
                self._participants[state.name] = participant
        self.bump_version()

    def set_instance_draining(self, name: str, draining: bool) -> None:
        """Mark an instance draining (decommission intent): it keeps
        answering in-flight queries but drops out of NEW routing covers
        and of segment placement; the SelfStabilizer migrates its
        replicas off.  The flag is durable (property store) and survives
        re-registration — cleared only by an explicit undrain."""
        with self._lock:
            inst = self.instances.get(name)
            if inst is None and name not in self._draining_flags:
                if not draining:
                    return
                raise KeyError(f"unknown instance {name!r}")
            if draining:
                self._draining_flags.add(name)
            else:
                self._draining_flags.discard(name)
            if inst is not None:
                if inst.draining == draining:
                    return
                inst.draining = draining
            tables = list(self.external_views.keys())
        if self.property_store is not None:
            if draining:
                self.property_store.put("instances", name, {"draining": True})
            else:
                self.property_store.delete("instances", name)
        # routing covers rebuild from the filtered views (draining
        # servers hidden), on the same version bump remote brokers poll
        for table in tables:
            self._notify_view(table)
        self.bump_version()

    def set_instance_warming(self, name: str, warming: bool) -> None:
        """Warm-start readiness flip (heartbeat-reported).  Routing
        covers are untouched — a warming server serves — but the
        version bump makes remote brokers refetch the cluster state
        (its ``warmingServers`` list feeds their deprioritization)."""
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

    def segments_on(self, name: str) -> Dict[str, List[str]]:
        """Ideal-state replicas still placed on ``name`` per table (the
        drain endpoint's drained-vs-remaining accounting)."""
        with self._lock:
            return {
                table: segs
                for table, ideal in self.ideal_states.items()
                if (segs := sorted(s for s, r in ideal.items() if name in r))
            }

    def set_instance_alive(self, name: str, alive: bool) -> None:
        """Liveness flip (the ZK-session-loss analog): a dead server's
        partitions drop out of every external view and routing rebuilds."""
        tables: List[str]
        with self._lock:
            inst = self.instances.get(name)
            if inst is None or inst.alive == alive:
                return
            inst.alive = alive
            tables = list(self.external_views.keys())
        for table in tables:
            changed = False
            with self._lock:
                view = self.external_views.get(table, {})
                for seg, replicas in view.items():
                    if name in replicas:
                        replicas[name] = OFFLINE if not alive else replicas[name]
                        changed = True
            if changed or alive:
                self._notify_view(table)
        # the SAME liveness flip that rebuilt routing also reaches
        # broker health trackers (heartbeat-miss -> penalty box, and
        # recovery -> circuit closed) — one code path, no separate poll
        self._notify_instance(name, alive)
        if alive:
            self._reconcile_instance(name)

    def reconcile_instance(self, name: str) -> None:
        """Replay this instance's ideal-state transitions (used on
        participant re-registration, where the fresh InstanceState is
        already alive so set_instance_alive would no-op)."""
        self._reconcile_instance(name)

    def _reconcile_instance(self, name: str) -> None:
        """On instance (re)start: replay its ideal-state transitions."""
        with self._lock:
            tables = list(self.ideal_states.keys())
        for table in tables:
            with self._lock:
                ideal = dict(self.ideal_states.get(table, {}))
            for seg, replicas in ideal.items():
                if replicas.get(name) in (ONLINE, CONSUMING):
                    self._execute_transition(table, seg, name, replicas[name])
            self._notify_view(table)

    def reload_table(self, physical: str) -> None:
        """Re-execute every ONLINE transition for a table's current
        ideal state (the reference's segment-reload API,
        PinotSegmentRestletResource reload).  CRC-skip on the servers
        makes this metadata-cheap; it is how schema evolution reaches
        segments loaded before the schema grew."""
        with self._lock:
            ideal = dict(self.ideal_states.get(physical, {}))
        for seg, replicas in ideal.items():
            for server, state in replicas.items():
                if state == ONLINE:
                    self._execute_transition(physical, seg, server, ONLINE)
        self._notify_view(physical)

    def tables_of_schema(self, raw_name: str) -> List[str]:
        with self._lock:
            return [
                phys
                for phys, cfg in self.table_configs.items()
                if cfg.raw_name == raw_name
            ]

    # -- listeners ----------------------------------------------------
    def add_view_listener(self, fn: Callable[[str, Dict[str, Dict[str, str]]], None]) -> None:
        with self._lock:
            self._view_listeners.append(fn)

    def add_instance_listener(self, fn: Callable[[str, bool], None]) -> None:
        """Subscribe to instance-liveness flips (``(name, alive)``); the
        broker health tracker consumes these so a controller-declared
        dead server enters the penalty box immediately."""
        with self._lock:
            self._instance_listeners.append(fn)

    def _notify_instance(self, name: str, alive: bool) -> None:
        with self._lock:
            listeners = list(self._instance_listeners)
        for fn in listeners:
            try:
                fn(name, alive)
            except Exception:
                logger.exception("instance listener failed for %s", name)

    def _routable(self, srv: str) -> bool:
        """Server visible to brokers for NEW queries: registered, alive,
        and not draining (a draining server still answers in-flight
        work; it just stops receiving fresh covers)."""
        inst = self.instances.get(srv)
        return inst is not None and inst.alive and not inst.draining

    def routing_view(self, table: str, instances: Optional[Dict[str, InstanceState]] = None
                     ) -> Dict[str, Dict[str, str]]:
        """The external view brokers route on: each segment's replicas on
        routable servers.  A draining server's replica stays in while the
        segment has no routable ONLINE / CONSUMING replica elsewhere (the
        last copy of a segment is served until its new home is up: the
        reference hides it at once and, at replication 1, answers over
        fewer segments while the stabilizer copies it).  Caller holds
        ``_lock`` or passes an ``instances`` snapshot."""
        instances = self.instances if instances is None else instances

        def routable(srv: str) -> bool:
            inst = instances.get(srv)
            return inst is not None and inst.alive and not inst.draining

        out: Dict[str, Dict[str, str]] = {}
        for seg, replicas in self.external_views.get(table, {}).items():
            view = {srv: st for srv, st in replicas.items() if routable(srv)}
            if not any(st in (ONLINE, CONSUMING) for st in view.values()):
                view.update({srv: st for srv, st in replicas.items()
                             if st in (ONLINE, CONSUMING) and instances.get(srv) is not None
                             and instances[srv].alive and instances[srv].draining})
            out[seg] = view
        return out

    def _notify_view(self, table: str) -> None:
        self.bump_version()
        with self._lock:
            view = self.routing_view(table)
            listeners = list(self._view_listeners)
        for fn in listeners:
            try:
                fn(table, view)
            except Exception:
                logger.exception("view listener failed for %s", table)

    # -- tenants ------------------------------------------------------
    def create_tenant(self, name: str, role: str, count: int) -> List[str]:
        """Tag ``count`` live, not-yet-dedicated instances of ``role``
        with the tenant tag (the PinotTenantRestletResource /
        tag-instances flow of the reference).  Returns tagged names."""
        with self._lock:
            free = sorted(
                i.name
                for i in self.instances.values()
                if i.role == role and i.alive and not (i.tags - {"DefaultTenant"})
            )
            if len(free) < count:
                raise RuntimeError(
                    f"tenant {name!r}: need {count} untagged {role}s, have {len(free)}"
                )
            tagged = free[:count]
            for n in tagged:
                # dedication: the tenant tag replaces DefaultTenant (the
                # reference untags the default when an instance joins a
                # tenant), so default-tenant tables stop landing here
                self.instances[n].tags.add(name)
                self.instances[n].tags.discard("DefaultTenant")
        self.bump_version()
        return tagged

    def list_tenants(self) -> Dict[str, List[str]]:
        """All tenant tags -> member instance names."""
        with self._lock:
            out: Dict[str, List[str]] = {}
            for inst in self.instances.values():
                for tag in inst.tags:
                    out.setdefault(tag, []).append(inst.name)
            return {t: sorted(ns) for t, ns in sorted(out.items())}

    def tenant_instances(self, name: str, role: Optional[str] = None) -> List[str]:
        with self._lock:
            return sorted(
                i.name
                for i in self.instances.values()
                if name in i.tags and (role is None or i.role == role)
            )

    def _live_tenant_members(self, tag: str, role: str) -> List[str]:
        with self._lock:
            return sorted(
                i.name
                for i in self.instances.values()
                if tag in i.tags and i.role == role and i.alive
            )

    def validate_tenants(self, config: TableConfig) -> None:
        """Reject table creation when a non-default tenant has no live
        members (the reference validates tenants before writing the
        table config; SURVEY §3.5)."""
        if config.server_tenant != "DefaultTenant" and not self._live_tenant_members(
            config.server_tenant, "server"
        ):
            raise ValueError(f"server tenant {config.server_tenant!r} has no live servers")
        if config.broker_tenant != "DefaultTenant" and not self._live_tenant_members(
            config.broker_tenant, "broker"
        ):
            raise ValueError(f"broker tenant {config.broker_tenant!r} has no live brokers")

    # -- rebalance -----------------------------------------------------
    def rebalance_table(
        self, physical_table: str, dry_run: bool = False
    ) -> Dict[str, Any]:
        """Recompute a balanced segment->server assignment over the
        current live tenant servers and (unless ``dry_run``) apply the
        diff: new replicas driven ONLINE, removed replicas DROPPED.

        The RebalanceTableCommand / Helix auto-rebalance analog: load
        per server is capped at ceil(total_replica_slots / num_servers)
        and existing placements are kept whenever the cap allows, so
        movement is minimal.  Segments with a CONSUMING replica are
        skipped (moving a live consumer is the LLC manager's job)."""
        with self._lock:
            config = self.table_configs.get(physical_table)
            if config is None:
                raise KeyError(f"no table {physical_table!r}")
            eligible = sorted(
                n
                for n, inst in self.instances.items()
                if inst.role == "server"
                and inst.alive
                and not inst.draining
                and config.server_tenant in inst.tags
            )
            if not eligible:
                raise RuntimeError("no live servers to rebalance onto")
            ideal = {
                s: dict(r) for s, r in self.ideal_states.get(physical_table, {}).items()
            }
        n_rep = min(config.replication, len(eligible))
        movable = sorted(s for s, r in ideal.items() if CONSUMING not in r.values())
        total_slots = n_rep * len(movable)
        cap = -(-total_slots // len(eligible)) if movable else 0  # ceil
        load = {s: 0 for s in eligible}
        target: Dict[str, List[str]] = {}
        # pass 1: keep existing eligible replicas while under the cap
        for seg in movable:
            kept = []
            for srv in sorted(ideal[seg]):
                if srv in load and load[srv] < cap and len(kept) < n_rep:
                    kept.append(srv)
                    load[srv] += 1
            target[seg] = kept
        # pass 2: fill open slots with the least-loaded servers
        for seg in movable:
            while len(target[seg]) < n_rep:
                srv = min(
                    (s for s in eligible if s not in target[seg]),
                    key=lambda s: (load[s], s),
                )
                target[seg].append(srv)
                load[srv] += 1
        added: Dict[str, List[str]] = {}
        removed: Dict[str, List[str]] = {}
        for seg in movable:
            state = next(iter(ideal[seg].values()), ONLINE)
            adds = [s for s in target[seg] if s not in ideal[seg]]
            drops = [s for s in ideal[seg] if s not in target[seg]]
            if adds:
                added[seg] = adds
            if drops:
                removed[seg] = drops
            if dry_run or (not adds and not drops):
                continue
            with self._lock:
                tbl = self.ideal_states.get(physical_table)
                if tbl is None or seg not in tbl:
                    # table/segment deleted since the snapshot was taken:
                    # don't resurrect it, drop it from the plan
                    added.pop(seg, None)
                    removed.pop(seg, None)
                    continue
                tbl[seg] = {s: state for s in target[seg]}
            for srv in adds:
                self._execute_transition(physical_table, seg, srv, state)
            with self._lock:
                view = self.external_views.get(physical_table, {}).get(seg, {})
                pending = any(view.get(srv) != state for srv in adds)
                if pending and drops:
                    # make before break: a remote server loads the new
                    # replica later, and the old ones serve until it reports
                    # it up (``report_state``); the ideal state is the
                    # target already.  In process the load is done here
                    self._deferred_drops.setdefault((physical_table, seg), set()).update(drops)
                    continue
            self._drop_replicas(physical_table, seg, drops)
        if not dry_run and (added or removed):
            self.persist_ideal_state(physical_table)
            self._notify_view(physical_table)
        return {
            "dryRun": dry_run,
            "segmentsMoved": len(set(added) | set(removed)),
            "added": added,
            "removed": removed,
            "target": {s: sorted(r) for s, r in target.items()},
        }

    def _drop_replicas(self, table: str, segment: str, servers) -> None:
        for srv in servers:
            self._execute_transition(table, segment, srv, DROPPED)
            with self._lock:
                self.external_views.get(table, {}).get(segment, {}).pop(srv, None)

    def _settle_deferred_drops(self, table: str, segment: str) -> None:
        """A rebalanced segment's new replicas reported: once every one of
        them is at its ideal state the old replicas are dropped; a new
        replica in ERROR puts the old ones back in the ideal state (the
        move is abandoned and the segment keeps its serving copies)."""
        with self._lock:
            held = self._deferred_drops.get((table, segment))
            ideal = self.ideal_states.get(table, {}).get(segment)
            if held is None:
                return
            if ideal is None:
                self._deferred_drops.pop((table, segment), None)
                return
            view = self.external_views.get(table, {}).get(segment, {})
            if any(view.get(srv) == ERROR for srv in ideal):
                self._deferred_drops.pop((table, segment), None)
                state = next(iter(ideal.values()), ONLINE)
                for srv in held:
                    ideal.setdefault(srv, state)
                restore = True
            elif all(view.get(srv) == st for srv, st in ideal.items()):
                self._deferred_drops.pop((table, segment), None)
                restore = False
            else:
                return
        if restore:
            self.persist_ideal_state(table)
        else:
            self._drop_replicas(table, segment, held)

    # -- durability ---------------------------------------------------
    def persist_ideal_state(self, physical: str) -> None:
        if self.property_store is None:
            return
        # snapshot AND write under the lock: two concurrent mutators
        # must not be able to persist their snapshots out of order, or
        # the durable file could lose the newer update (writes are
        # small JSON records, so holding the lock is cheap)
        with self._lock:
            ideal = self.ideal_states.get(physical)
            if ideal is None:
                self.property_store.delete("idealstates", physical)
            else:
                self.property_store.put(
                    "idealstates", physical, {s: dict(r) for s, r in ideal.items()}
                )

    def persist_segment_record(self, physical: str, segment: str) -> None:
        """Write the JSON-serializable part of a segment's metadata
        record (the ZK segment-metadata analog: LLC offsets live in
        metadata.custom; ``dir`` is the controller-store download
        path).  Callables and in-memory segment objects are runtime
        wiring and are reattached on recovery."""
        if self.property_store is None:
            return
        import json as _json

        with self._lock:  # see persist_ideal_state on ordering
            info = self.segment_metadata.get((physical, segment))
            if info is None:
                self.property_store.delete(f"segments/{physical}", segment)
                return
            rec: Dict[str, Any] = {}
            meta = info.get("metadata")
            if meta is not None:
                rec["metadata"] = meta.to_json()
            for k, v in info.items():
                if k == "metadata" or callable(v):
                    continue
                try:
                    _json.dumps(v)
                except TypeError:
                    continue  # runtime wiring (segment objects, etc.)
                rec[k] = v
            self.property_store.put(f"segments/{physical}", segment, rec)

    # -- schema / table CRUD ------------------------------------------
    def add_schema(self, schema: Schema) -> None:
        with self._lock:
            self.schemas[schema.schema_name] = schema
        if self.property_store is not None:
            self.property_store.put("schemas", schema.schema_name, schema.to_json())

    def get_schema(self, name: str) -> Optional[Schema]:
        with self._lock:
            return self.schemas.get(name)

    def add_table(self, config: TableConfig) -> str:
        if not config.table_name.replace("_", "").replace("-", "").isalnum():
            # table names become store paths (segment store dirs,
            # property-store namespaces): refuse anything that could
            # traverse the filesystem
            raise ValueError(f"invalid table name {config.table_name!r}")
        with self._lock:
            physical = config.physical_name
            self.table_configs[physical] = config
            self.ideal_states.setdefault(physical, {})
            self.external_views.setdefault(physical, {})
        if self.property_store is not None:
            self.property_store.put("tables", physical, config.to_json())
        self.persist_ideal_state(physical)
        self._notify_view(physical)
        return physical

    def update_table_quota(
        self,
        physical: str,
        max_queries_per_second,
        burst_queries=None,
    ) -> None:
        """Live quota update/removal for a running table.  Persists the
        changed config, bumps the cluster-state version (so networked
        brokers pick it up on their next poll), and re-notifies the view
        (so in-process brokers re-apply the quota immediately).  Passing
        None removes the quota — brokers must CLEAR the bucket, not keep
        enforcing a stale one."""
        with self._lock:
            config = self.table_configs.get(physical)
            if config is None:
                raise KeyError(f"no such table {physical}")
            config.quota = QuotaConfig(
                storage=config.quota.storage,
                max_queries_per_second=max_queries_per_second,
                burst_queries=burst_queries,
            )
        if self.property_store is not None:
            self.property_store.put("tables", physical, config.to_json())
        # _notify_view bumps the version, re-sends routing AND re-applies
        # quota via BrokerStarter.on_view_change in-process; networked
        # brokers see the bumped version on their next clusterstate poll
        self._notify_view(physical)

    def update_table_slo(self, physical: str, slo) -> None:
        """Live SLO-objective update/removal for a running table
        (``SloConfig`` or None to fall back to env defaults).  Same
        propagation contract as ``update_table_quota``: persist the
        changed config, bump the cluster-state version (networked
        brokers re-apply on their next poll), re-notify the view
        (in-process brokers re-apply immediately)."""
        with self._lock:
            config = self.table_configs.get(physical)
            if config is None:
                raise KeyError(f"no such table {physical}")
            config.slo = slo
        if self.property_store is not None:
            self.property_store.put("tables", physical, config.to_json())
        self._notify_view(physical)

    def delete_table(self, physical: str) -> None:
        with self._lock:
            segs = list(self.ideal_states.get(physical, {}).keys())
        for seg in segs:
            self.delete_segment(physical, seg)
        with self._lock:
            self.table_configs.pop(physical, None)
            self.ideal_states.pop(physical, None)
            self.external_views.pop(physical, None)
        if self.property_store is not None:
            self.property_store.delete("tables", physical)
            self.property_store.delete("idealstates", physical)
            self.property_store.delete("streams", physical)
            self.property_store.delete_namespace(f"segments/{physical}")
        self._notify_view(physical)

    def tables(self) -> List[str]:
        with self._lock:
            return list(self.table_configs.keys())

    # -- segment assignment (ideal-state writes) ----------------------
    def _pick_servers(self, config: TableConfig) -> List[str]:
        with self._lock:
            servers = sorted(
                n
                for n, inst in self.instances.items()
                if inst.role == "server"
                and inst.alive
                and not inst.draining
                and config.server_tenant in inst.tags
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
        """Assign a segment to replicas and drive them to target_state
        (the upload path: PinotSegmentUploadRestletResource ->
        addNewOfflineSegment -> ideal state -> Helix ONLINE messages)."""
        with self._lock:
            config = self.table_configs[physical_table]
            chosen = list(servers) if servers else self._pick_servers(config)
            self.ideal_states[physical_table][metadata.segment_name] = {
                s: target_state for s in chosen
            }
            self.segment_metadata[(physical_table, metadata.segment_name)] = {
                "metadata": metadata,
                **download_info,
            }
        self.persist_ideal_state(physical_table)
        self.persist_segment_record(physical_table, metadata.segment_name)
        for server in chosen:
            self._execute_transition(
                physical_table, metadata.segment_name, server, target_state
            )
        self._notify_view(physical_table)
        return chosen

    def _execute_transition(
        self, table: str, segment: str, server: str, target: str
    ) -> None:
        with self._lock:
            participant = self._participants.get(server)
            info = dict(self.segment_metadata.get((table, segment), {}))
            if target == ONLINE:
                # configured inverted-index columns resolve from the
                # CURRENT table config at transition time (covers every
                # metadata writer incl. realtime commits, and config
                # edits apply on the next reload): servers pre-build
                # postings at load so the first needle query is warm
                cfg = self.table_configs.get(table)
                cols = cfg.indexing.inverted_index_columns if cfg else []
                if cols:
                    info["invertedIndexColumns"] = list(cols)
                # current schema rides along so the server can patch
                # schema-evolved segments with default columns at load
                # (SegmentPreProcessor -> BaseDefaultColumnHandler)
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
                # pending: remote participant will report_state later
                view.setdefault(server, OFFLINE)
            else:
                view[server] = target if ok else ERROR

    def delete_segment(self, physical_table: str, segment: str) -> None:
        with self._lock:
            replicas = self.ideal_states.get(physical_table, {}).pop(segment, {})
            self.segment_metadata.pop((physical_table, segment), None)
        self.persist_ideal_state(physical_table)
        self.persist_segment_record(physical_table, segment)
        for server in replicas:
            self._execute_transition(physical_table, segment, server, DROPPED)
        with self._lock:
            self.external_views.get(physical_table, {}).pop(segment, None)
        for fn in list(self.segment_deleted_listeners):
            fn(segment)
        self._notify_view(physical_table)

    def report_state(self, server: str, table: str, segment: str, state: str) -> None:
        """Async current-state report from a remote participant (the
        Helix CurrentState write a server makes after executing a
        queued transition message)."""
        with self._lock:
            tbl_view = self.external_views.setdefault(table, {})
            if segment not in self.ideal_states.get(table, {}):
                # segment deleted while the message was in flight; drop
                # any residual view entry instead of resurrecting it
                tbl_view.pop(segment, None)
                return
            if state == DROPPED:
                # the Helix analog deletes the current-state entry on
                # DROPPED — keeping it would leave a phantom replica
                # after a rebalance moved the segment off this server
                tbl_view.get(segment, {}).pop(server, None)
            else:
                tbl_view.setdefault(segment, {})[server] = state
        self._settle_deferred_drops(table, segment)
        self._notify_view(table)

    # -- per-replica surgery (SelfStabilizer) --------------------------
    def add_segment_replica(self, table: str, segment: str, server: str) -> bool:
        """Add ``server`` to a segment's ideal replica set and drive it
        to the set's existing target state (the re-replication step: the
        new replica fetches from the controller's durable copy via the
        segment record's downloadUri/dir).  Idempotent."""
        with self._lock:
            replicas = self.ideal_states.get(table, {}).get(segment)
            if replicas is None or server in replicas:
                return False
            state = next(iter(replicas.values()), ONLINE)
            replicas[server] = state
        self.persist_ideal_state(table)
        self._execute_transition(table, segment, server, state)
        self._notify_view(table)
        return True

    def remove_segment_replica(self, table: str, segment: str, server: str) -> bool:
        """Remove one replica from a segment's ideal state.  A live
        holder gets a DROPPED transition (unload); a dead one gets no
        message — its queue was cleared on death, and re-registration
        reconciles against the ideal state that no longer names it."""
        with self._lock:
            replicas = self.ideal_states.get(table, {}).get(segment)
            if replicas is None or server not in replicas:
                return False
            del replicas[server]
            inst = self.instances.get(server)
            send_drop = inst is not None and inst.alive
        self.persist_ideal_state(table)
        if send_drop:
            self._execute_transition(table, segment, server, DROPPED)
        with self._lock:
            self.external_views.get(table, {}).get(segment, {}).pop(server, None)
        self._notify_view(table)
        return True

    def retire_segment(self, table: str, segment: str) -> List[str]:
        """Drop a segment from ideal state + metadata, transitioning
        only LIVE holders to DROPPED (unlike ``delete_segment``, which
        messages every replica).  Used by the stabilizer to retire a
        CONSUMING segment whose holders are all dead/draining so the
        realtime manager can re-create it on a live server at the last
        committed offset.  Returns the replica servers it held."""
        with self._lock:
            replicas = self.ideal_states.get(table, {}).pop(segment, {})
            self.segment_metadata.pop((table, segment), None)
            live = [
                s
                for s in replicas
                if (inst := self.instances.get(s)) is not None and inst.alive
            ]
        self.persist_ideal_state(table)
        self.persist_segment_record(table, segment)
        for server in live:
            self._execute_transition(table, segment, server, DROPPED)
        with self._lock:
            self.external_views.get(table, {}).pop(segment, None)
        self._notify_view(table)
        return sorted(replicas)

    def reset_segment(self, physical_table: str, segment: str, server: str) -> None:
        """ERROR -> OFFLINE -> retarget (the Helix error-reset analog)."""
        with self._lock:
            target = self.ideal_states.get(physical_table, {}).get(segment, {}).get(server)
        if target:
            self._execute_transition(physical_table, segment, server, target)
            self._notify_view(physical_table)

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
