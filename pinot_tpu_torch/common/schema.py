"""Schema / field model (copy of ``pinot_tpu.common.schema``, trimmed to
what the query slice uses).

Semantics mirror the reference data model (pinot-common
``common/data/FieldSpec.java`` and ``common/data/Schema.java``): a schema
is a set of DIMENSION / METRIC / TIME columns over five stored types
(INT, LONG, FLOAT, DOUBLE, STRING) plus their multi-value variants.
Missing input values become per-type default null values
(``FieldSpec.java:37-47``): dimensions get min-int / min-long / -inf /
``"null"``; metrics get 0 / 0.0 / ``"null"``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional

import numpy as np


class DataType(str, Enum):
    INT = "INT"
    LONG = "LONG"
    FLOAT = "FLOAT"
    DOUBLE = "DOUBLE"
    STRING = "STRING"
    BOOLEAN = "BOOLEAN"  # stored as STRING (FieldSpec.java:210)
    INT_ARRAY = "INT_ARRAY"
    LONG_ARRAY = "LONG_ARRAY"
    FLOAT_ARRAY = "FLOAT_ARRAY"
    DOUBLE_ARRAY = "DOUBLE_ARRAY"
    STRING_ARRAY = "STRING_ARRAY"

    @property
    def is_single_value(self) -> bool:
        return not self.name.endswith("_ARRAY")

    @property
    def element_type(self) -> "DataType":
        """The scalar type of this (possibly multi-value) type."""
        return self if self.is_single_value else DataType(self.name[: -len("_ARRAY")])

    @property
    def stored_type(self) -> "DataType":
        """BOOLEAN is stored as STRING (FieldSpec.java:210)."""
        elem = self.element_type
        return DataType.STRING if elem == DataType.BOOLEAN else elem

    @property
    def is_numeric(self) -> bool:
        return self.stored_type in (DataType.INT, DataType.LONG, DataType.FLOAT, DataType.DOUBLE)

    def to_numpy(self) -> np.dtype:
        return {
            DataType.INT: np.dtype(np.int32),
            DataType.LONG: np.dtype(np.int64),
            DataType.FLOAT: np.dtype(np.float32),
            DataType.DOUBLE: np.dtype(np.float64),
            DataType.STRING: np.dtype(object),
        }[self.stored_type]

    def convert(self, value: Any) -> Any:
        """Coerce a literal to this type's python representation.  FLOAT
        round-trips through float32 (the reference stores Java ``float``)."""
        t = self.stored_type
        if t == DataType.STRING:
            if isinstance(value, bool):
                return "true" if value else "false"
            return str(value)
        if t in (DataType.INT, DataType.LONG):
            try:
                return int(value)
            except ValueError:
                return int(float(value))
        v = float(value)
        if t == DataType.FLOAT:
            return float(np.float32(v))
        return v


class FieldType(str, Enum):
    DIMENSION = "DIMENSION"
    METRIC = "METRIC"
    TIME = "TIME"


# Default null values, FieldSpec.java:37-47.
_DIM_NULL = {
    DataType.INT: -(2**31),
    DataType.LONG: -(2**63),
    DataType.FLOAT: float("-inf"),
    DataType.DOUBLE: float("-inf"),
    DataType.STRING: "null",
}
_METRIC_NULL = {
    DataType.INT: 0,
    DataType.LONG: 0,
    DataType.FLOAT: 0.0,
    DataType.DOUBLE: 0.0,
    DataType.STRING: "null",
}


@dataclass
class FieldSpec:
    name: str
    data_type: DataType
    field_type: FieldType = FieldType.DIMENSION
    single_value: bool = True
    default_null_value: Optional[Any] = None

    def __post_init__(self) -> None:
        self.data_type = DataType(self.data_type)
        self.field_type = FieldType(self.field_type)
        if not self.data_type.is_single_value:
            self.single_value = False

    @property
    def stored_type(self) -> DataType:
        return self.data_type.stored_type

    def get_default_null_value(self) -> Any:
        if self.default_null_value is not None:
            return self.stored_type.convert(self.default_null_value)
        table = _METRIC_NULL if self.field_type == FieldType.METRIC else _DIM_NULL
        return table[self.stored_type]

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "dataType": self.data_type.value,
            "fieldType": self.field_type.value,
            "singleValueField": self.single_value,
        }
        if self.default_null_value is not None:
            d["defaultNullValue"] = self.default_null_value
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any], field_type: Optional[FieldType] = None) -> "FieldSpec":
        ft = field_type or FieldType(d.get("fieldType", "DIMENSION"))
        return cls(
            name=d["name"],
            data_type=DataType(d["dataType"]),
            field_type=ft,
            single_value=d.get("singleValueField", True),
            default_null_value=d.get("defaultNullValue"),
        )


@dataclass
class TimeFieldSpec(FieldSpec):
    """TIME column with a granularity unit (Schema.java timeFieldSpec)."""

    time_unit: str = "DAYS"  # DAYS | HOURS | MINUTES | SECONDS | MILLISECONDS

    def __post_init__(self) -> None:
        super().__post_init__()
        self.field_type = FieldType.TIME

    def to_json(self) -> Dict[str, Any]:
        d = super().to_json()
        d["timeUnit"] = self.time_unit
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any], field_type: Optional[FieldType] = None) -> "TimeFieldSpec":
        # the flat form this package writes, or the reference's nested
        # TimeGranularitySpec form (``incomingGranularitySpec``)
        g = d.get("incomingGranularitySpec")
        if g is not None:
            return cls(
                name=g["name"],
                data_type=DataType(g["dataType"]),
                single_value=g.get("singleValueField", True),
                default_null_value=d.get("defaultNullValue"),
                time_unit=g.get("timeType", d.get("timeUnit", "DAYS")),
            )
        return cls(
            name=d["name"],
            data_type=DataType(d["dataType"]),
            single_value=d.get("singleValueField", True),
            default_null_value=d.get("defaultNullValue"),
            time_unit=d.get("timeUnit", "DAYS"),
        )


@dataclass
class Schema:
    """Column schema: dimensions + metrics + optional time column."""

    schema_name: str
    dimensions: List[FieldSpec] = field(default_factory=list)
    metrics: List[FieldSpec] = field(default_factory=list)
    time_field: Optional[TimeFieldSpec] = None

    def __post_init__(self) -> None:
        self._by_name: Dict[str, FieldSpec] = {}
        for spec in self.all_fields():
            if spec.name in self._by_name:
                raise ValueError(f"duplicate column {spec.name!r} in schema {self.schema_name!r}")
            self._by_name[spec.name] = spec

    def all_fields(self) -> List[FieldSpec]:
        out: List[FieldSpec] = list(self.dimensions) + list(self.metrics)
        if self.time_field is not None:
            out.append(self.time_field)
        return out

    @property
    def column_names(self) -> List[str]:
        return [s.name for s in self.all_fields()]

    def field(self, name: str) -> FieldSpec:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(f"unknown column {name!r} in schema {self.schema_name!r}") from None

    def has_column(self, name: str) -> bool:
        return name in self._by_name

    @property
    def time_column_name(self) -> Optional[str]:
        return self.time_field.name if self.time_field is not None else None

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "schemaName": self.schema_name,
            "dimensionFieldSpecs": [s.to_json() for s in self.dimensions],
            "metricFieldSpecs": [s.to_json() for s in self.metrics],
        }
        if self.time_field is not None:
            d["timeFieldSpec"] = self.time_field.to_json()
        return d

    def to_json_str(self) -> str:
        return json.dumps(self.to_json(), indent=2)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Schema":
        dims = [FieldSpec.from_json(x, FieldType.DIMENSION) for x in d.get("dimensionFieldSpecs", [])]
        mets = [FieldSpec.from_json(x, FieldType.METRIC) for x in d.get("metricFieldSpecs", [])]
        tf = d.get("timeFieldSpec")
        return cls(
            schema_name=d.get("schemaName", d.get("name", "unknown")),
            dimensions=dims,
            metrics=mets,
            time_field=TimeFieldSpec.from_json(tf) if tf else None,
        )
