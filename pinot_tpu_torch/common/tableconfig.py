"""Table configuration (copy of ``pinot_tpu.common.tableconfig``,
trimmed).

The reference's JSON table config: table type (OFFLINE or REALTIME),
replication, retention, indexing, quota and tenants, the declared key
partitioning (``PartitionConfig``) the broker's join planner reads, and a
REALTIME table's stream (``StreamConfig``, ``streamConfigs`` in the JSON).
A table's ``slo`` block (``SloConfig``) sets the broker's SLO objectives
for it (``utils/slo.py``).  Realtime tables consume from a network, Kafka,
file or memory stream through the low-level consumers or through a
high-level consumer group (``realtime/llc.py``).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class RetentionConfig:
    retention_time_unit: str = "DAYS"
    retention_time_value: int = 0  # 0 = keep forever

    def to_json(self) -> Dict[str, Any]:
        return {
            "retentionTimeUnit": self.retention_time_unit,
            "retentionTimeValue": self.retention_time_value,
        }


@dataclass
class IndexingConfig:
    inverted_index_columns: List[str] = field(default_factory=list)
    sorted_column: Optional[str] = None
    startree_enabled: bool = False
    startree_dimensions_split_order: List[str] = field(default_factory=list)
    startree_max_leaf_records: int = 10_000

    def to_json(self) -> Dict[str, Any]:
        return {
            "invertedIndexColumns": list(self.inverted_index_columns),
            "sortedColumn": self.sorted_column,
            "starTreeEnabled": self.startree_enabled,
            "starTreeDimensionsSplitOrder": list(self.startree_dimensions_split_order),
            "starTreeMaxLeafRecords": self.startree_max_leaf_records,
        }


@dataclass
class PartitionConfig:
    """Declared key partitioning: segments of the table carry their
    partition id in the segment name (``..._pN``), and the broker's join
    planner picks the COLOCATED strategy when both join sides declare
    partitioning on their join keys with equal partition counts and the
    covers align (``broker/joinplan.py``)."""

    column: Optional[str] = None
    num_partitions: Optional[int] = None

    def to_json(self) -> Dict[str, Any]:
        return {"column": self.column, "numPartitions": self.num_partitions}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "PartitionConfig":
        return cls(column=d.get("column"), num_partitions=d.get("numPartitions"))


@dataclass
class StreamConfig:
    """Realtime ingestion config (the kafka.* stream properties analog).

    ``stream_type`` selects the provider: ``network`` (the TCP stream
    broker, ``realtime/netstream.py``; properties host, port), ``kafka``
    (the Kafka v0 wire protocol, ``realtime/kafka.py``; properties host,
    port), ``file`` (JSONL a partition; properties paths) or ``memory``
    (in process; properties partitions).  ``rows_per_segment`` is the
    flush threshold of a consuming segment.

    ``consumer_type`` "lowlevel" is one controller-coordinated consumer a
    stream partition, with committer election and exact offset checkpoints
    (LLC).  "highlevel" is one consumer a server in a consumer group the
    stream broker coordinates: partitions rebalance across the servers as
    members come and go, and the group's offsets are checkpointed in the
    stream broker (HLC, ``HLRealtimeSegmentDataManager.java:54``).  It
    needs a network or Kafka stream, where consumer groups live."""

    stream_type: str = "file"  # network | kafka | file | memory
    topic: str = ""
    decoder: str = "json"
    rows_per_segment: int = 100_000
    consumer_type: str = "lowlevel"  # lowlevel | highlevel
    properties: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SloConfig:
    """Per-table service-level objectives, which the broker evaluates as
    multi-window burn rates (``utils/slo.py``).  An unset field falls back
    to the env default (``PINOT_TPU_SLO_*``)."""

    latency_ms: Optional[float] = None  # queries must answer under this
    latency_target: Optional[float] = None  # the fraction that must (0.99)
    availability_target: Optional[float] = None  # the non-failed fraction

    def to_json(self) -> Dict[str, Any]:
        return {
            "latencyMs": self.latency_ms,
            "latencyTarget": self.latency_target,
            "availabilityTarget": self.availability_target,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "SloConfig":
        return cls(
            latency_ms=d.get("latencyMs"),
            latency_target=d.get("latencyTarget"),
            availability_target=d.get("availabilityTarget"),
        )


@dataclass
class QuotaConfig:
    storage: Optional[str] = None
    max_queries_per_second: Optional[float] = None
    burst_queries: Optional[float] = None

    _UNITS = {"": 1, "K": 2**10, "M": 2**20, "G": 2**30, "T": 2**40}

    def storage_bytes(self) -> Optional[int]:
        """The storage quota ("128M", "2.5G", "1024") in bytes; None when
        unset."""
        if not self.storage:
            return None
        m = re.fullmatch(r"(\d+(?:\.\d+)?)\s*([kKmMgGtT]?)[bB]?", self.storage.strip())
        if m is None:
            raise ValueError(f"bad storage quota {self.storage!r}")
        return int(float(m.group(1)) * self._UNITS[m.group(2).upper()])

    def to_json(self) -> Dict[str, Any]:
        d = {"storage": self.storage, "maxQueriesPerSecond": self.max_queries_per_second}
        if self.burst_queries is not None:
            d["burstQueries"] = self.burst_queries
        return d


@dataclass
class TableConfig:
    table_name: str
    table_type: str = "OFFLINE"  # OFFLINE | REALTIME
    replication: int = 1
    retention: RetentionConfig = field(default_factory=RetentionConfig)
    indexing: IndexingConfig = field(default_factory=IndexingConfig)
    quota: QuotaConfig = field(default_factory=QuotaConfig)
    slo: Optional["SloConfig"] = None
    partitioning: Optional[PartitionConfig] = None
    stream: Optional[StreamConfig] = None
    broker_tenant: str = "DefaultTenant"
    server_tenant: str = "DefaultTenant"

    @property
    def physical_name(self) -> str:
        suffix = "_OFFLINE" if self.table_type == "OFFLINE" else "_REALTIME"
        if self.table_name.endswith(("_OFFLINE", "_REALTIME")):
            return self.table_name
        return self.table_name + suffix

    @property
    def raw_name(self) -> str:
        for sfx in ("_OFFLINE", "_REALTIME"):
            if self.table_name.endswith(sfx):
                return self.table_name[: -len(sfx)]
        return self.table_name

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "tableName": self.table_name,
            "tableType": self.table_type,
            "segmentsConfig": {"replication": self.replication, **self.retention.to_json()},
            "tableIndexConfig": self.indexing.to_json(),
            "tenants": {"broker": self.broker_tenant, "server": self.server_tenant},
            "quota": self.quota.to_json(),
        }
        if self.slo is not None:
            d["slo"] = self.slo.to_json()
        if self.partitioning is not None:
            d["partitioning"] = self.partitioning.to_json()
        if self.stream is not None:
            d["streamConfigs"] = {
                "streamType": self.stream.stream_type,
                "topic": self.stream.topic,
                "decoder": self.stream.decoder,
                "rowsPerSegment": self.stream.rows_per_segment,
                "consumerType": self.stream.consumer_type,
                "properties": self.stream.properties,
            }
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "TableConfig":
        stream = None
        if "streamConfigs" in d:
            sc = d["streamConfigs"]
            stream = StreamConfig(
                stream_type=sc.get("streamType", "file"),
                topic=sc.get("topic", ""),
                decoder=sc.get("decoder", "json"),
                rows_per_segment=sc.get("rowsPerSegment", 100_000),
                consumer_type=sc.get("consumerType", "lowlevel"),
                properties=sc.get("properties", {}),
            )
        seg = d.get("segmentsConfig", {})
        idx = d.get("tableIndexConfig", {})
        tenants = d.get("tenants", {})
        quota = d.get("quota", {})
        return cls(
            table_name=d["tableName"],
            table_type=d.get("tableType", "OFFLINE"),
            replication=seg.get("replication", 1),
            broker_tenant=tenants.get("broker", "DefaultTenant"),
            server_tenant=tenants.get("server", "DefaultTenant"),
            quota=QuotaConfig(
                storage=quota.get("storage"),
                max_queries_per_second=quota.get("maxQueriesPerSecond"),
                burst_queries=quota.get("burstQueries"),
            ),
            retention=RetentionConfig(
                retention_time_unit=seg.get("retentionTimeUnit", "DAYS"),
                retention_time_value=seg.get("retentionTimeValue", 0),
            ),
            indexing=IndexingConfig(
                inverted_index_columns=idx.get("invertedIndexColumns", []),
                sorted_column=idx.get("sortedColumn"),
                startree_enabled=idx.get("starTreeEnabled", False),
                startree_dimensions_split_order=idx.get("starTreeDimensionsSplitOrder", []),
                startree_max_leaf_records=idx.get("starTreeMaxLeafRecords", 10_000),
            ),
            slo=SloConfig.from_json(d["slo"]) if d.get("slo") else None,
            partitioning=(
                PartitionConfig.from_json(d["partitioning"]) if d.get("partitioning") else None
            ),
            stream=stream,
        )
