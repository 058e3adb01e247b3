"""Broker starter: the broker's routing and time boundary follow the
controller's external views (port of ``pinot_tpu.broker.starter``).

The reference's ``HelixBrokerStarter.java:57`` registers ExternalView
listeners; ``ClusterChangeMediator`` debounces them into routing rebuilds
and time-boundary refreshes.  Here the controller calls the listener
directly on every view change.
"""
from __future__ import annotations

from typing import Dict, Optional

from pinot_tpu_torch.broker.broker import OFFLINE_SUFFIX, BrokerRequestHandler
from pinot_tpu_torch.controller.resource_manager import ClusterResourceManager, InstanceState


class BrokerStarter:
    def __init__(self, broker: BrokerRequestHandler, resources: ClusterResourceManager,
                 url: Optional[str] = None) -> None:
        self.broker = broker
        self.resources = resources
        self.url = url

    def start(self) -> None:
        """Register the broker and follow the views: the routing of every
        table the controller already has is seeded now."""
        self.resources.register_instance(InstanceState(self.broker.name, role="broker", url=self.url))
        self.resources.add_view_listener(self.on_view_change)
        # a liveness flip (a missed heartbeat, a re-registration) reaches the
        # broker's health tracker on the same event that rebuilds its routing
        self.resources.add_instance_listener(self.on_instance_change)
        for table in self.resources.tables():
            self.on_view_change(table, self.resources.get_external_view(table))

    def on_instance_change(self, name: str, alive: bool) -> None:
        if alive:
            self.broker.health.mark_alive(name)
        else:
            self.broker.health.mark_dead(name)

    def on_view_change(self, table: str, view: Dict[str, Dict[str, str]]) -> None:
        """The broker's routing, quota, SLO objectives, declared
        partitioning and time boundary follow each view change."""
        resources = self.resources
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
