"""In-process cluster harness: a controller, N servers and a broker in one
process (port of ``pinot_tpu.tools.cluster_harness``, trimmed to
``InProcessCluster`` and ``single_server_broker``).

The reference's ``PerfBenchmarkDriver.java:61`` and the integration
tests' ``ClusterTest`` start the whole cluster in one process the same
way.  The servers join the controller as participants
(``server/starter.py``) and the broker's routing and hybrid time
boundaries follow the controller's external views through a view
listener (the reference's ``broker/starter.py``).  A REALTIME table's
consumers are stepped by the caller (``consume_step`` / ``try_commit`` of
``controller.realtime_manager.consumers_of(segment)``) unless an
``IngestConsumerPool`` is set as ``controller.realtime_manager.ingest_pool``.

Left out, ROADMAP queue 1 item 30: the chaos scenarios, the networked
cluster, the load generators.
"""
from __future__ import annotations

import tempfile
from typing import Dict, List, Optional, Union

import torch

from pinot_tpu_torch.broker.broker import OFFLINE_SUFFIX, BrokerHttpServer, BrokerRequestHandler
from pinot_tpu_torch.broker.routing import RoutingTableProvider
from pinot_tpu_torch.common.conf import BrokerConf, ServerConf
from pinot_tpu_torch.common.response import BrokerResponse
from pinot_tpu_torch.common.schema import Schema
from pinot_tpu_torch.common.tableconfig import StreamConfig, TableConfig
from pinot_tpu_torch.controller.controller import Controller
from pinot_tpu_torch.controller.resource_manager import InstanceState
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
        broker_url = None
        if http:
            self.http = BrokerHttpServer(self.broker)
            self.http.start()
            broker_url = f"http://{self.http.host}:{self.http.port}"
        resources = self.controller.resources
        resources.register_instance(InstanceState(self.broker.name, role="broker", url=broker_url))
        resources.add_view_listener(self._on_view_change)
        for _ in range(num_servers):
            self.add_server()

    def _on_view_change(self, table: str, view: Dict[str, Dict[str, str]]) -> None:
        """The broker's routing, quota, SLO objectives, declared
        partitioning and time boundary follow each view change."""
        resources = self.controller.resources
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
        consumer, the broker and the servers (their scheduler workers and
        device lanes)."""
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
