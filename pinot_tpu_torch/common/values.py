"""Shared value rendering: dictIds / raw values -> result strings.

Group-by keys and selection cells are rendered identically by the scan
oracle and the TPU engine so differential tests compare exactly (the
reference renders via ``Dictionary.getStringValue`` at result build).
"""
from __future__ import annotations

from typing import Any

from pinot_tpu_torch.common.schema import DataType


def render_value(stored_type: DataType, v: Any) -> str:
    if stored_type in (DataType.INT, DataType.LONG):
        return str(int(v))
    if stored_type in (DataType.FLOAT, DataType.DOUBLE):
        return repr(float(v))
    return str(v)
