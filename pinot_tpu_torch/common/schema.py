"""Schema / field model (copy of ``pinot_tpu.common.schema``, trimmed to
what the query slice uses).

Semantics mirror the reference data model (pinot-common
``common/data/FieldSpec.java`` and ``common/data/Schema.java``): a schema
is a set of DIMENSION / METRIC / TIME columns over five stored types
(INT, LONG, FLOAT, DOUBLE, STRING) plus their multi-value variants.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List

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


@dataclass
class FieldSpec:
    name: str
    data_type: DataType
    field_type: FieldType = FieldType.DIMENSION
    single_value: bool = True

    def __post_init__(self) -> None:
        self.data_type = DataType(self.data_type)
        self.field_type = FieldType(self.field_type)
        if not self.data_type.is_single_value:
            self.single_value = False

    @property
    def stored_type(self) -> DataType:
        return self.data_type.stored_type


@dataclass
class Schema:
    """Column schema: dimensions + metrics."""

    schema_name: str
    dimensions: List[FieldSpec] = field(default_factory=list)
    metrics: List[FieldSpec] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._by_name: Dict[str, FieldSpec] = {}
        for spec in self.all_fields():
            if spec.name in self._by_name:
                raise ValueError(f"duplicate column {spec.name!r} in schema {self.schema_name!r}")
            self._by_name[spec.name] = spec

    def all_fields(self) -> List[FieldSpec]:
        return list(self.dimensions) + list(self.metrics)

    @property
    def column_names(self) -> List[str]:
        return [s.name for s in self.all_fields()]

    def field(self, name: str) -> FieldSpec:
        try:
            return self._by_name[name]
        except KeyError:
            raise KeyError(f"unknown column {name!r} in schema {self.schema_name!r}") from None
