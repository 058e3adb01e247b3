"""Table configuration (copy of ``pinot_tpu.common.tableconfig``,
trimmed to offline tables).

The reference's JSON table config: table type, replication, retention,
indexing, quota and tenants.  A table's ``slo`` and ``partitioning``
blocks ride along as the JSON they are; a REALTIME table's
``streamConfigs`` is refused (realtime ingestion is a later item of the
port, ROADMAP queue 1 item 29).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

REALTIME_ITEM = "realtime tables are item 29 of the port (ROADMAP queue 1)"


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
class QuotaConfig:
    storage: Optional[str] = None
    max_queries_per_second: Optional[float] = None
    burst_queries: Optional[float] = None

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
    slo: Optional[Dict[str, Any]] = None
    partitioning: Optional[Dict[str, Any]] = None
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
            d["slo"] = dict(self.slo)
        if self.partitioning is not None:
            d["partitioning"] = dict(self.partitioning)
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "TableConfig":
        if "streamConfigs" in d or d.get("tableType", "OFFLINE") != "OFFLINE":
            raise NotImplementedError(REALTIME_ITEM)
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
            slo=d.get("slo") or None,
            partitioning=d.get("partitioning") or None,
        )
