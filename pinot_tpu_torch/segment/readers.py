"""Record readers: CSV / JSON-lines -> rows for the segment builder
(copy of ``pinot_tpu.segment.readers``).

Reference: pinot-core ``data/readers/`` (CSV/JSON record readers).  Avro
containers are item 31 of the port: ``read_for_path`` raises for them.

Multi-value CSV cells use ';' as the value separator (the reference's
CSVRecordReaderConfig default multi-value delimiter).
"""
from __future__ import annotations

import csv
import json
from typing import Any, Dict, List

from pinot_tpu_torch.common.schema import Schema

Row = Dict[str, Any]

MV_DELIMITER = ";"


def _convert_cell(schema: Schema, name: str, raw: str) -> Any:
    spec = schema.field(name)
    if raw == "" or raw is None:
        return spec.get_default_null_value()
    if spec.single_value:
        return spec.stored_type.convert(raw)
    parts = [p for p in str(raw).split(MV_DELIMITER)]
    return [spec.stored_type.convert(p) for p in parts if p != ""] or [
        spec.get_default_null_value()
    ]


def read_csv(path: str, schema: Schema, delimiter: str = ",") -> List[Row]:
    rows: List[Row] = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f, delimiter=delimiter)
        for rec in reader:
            row: Row = {}
            for spec in schema.all_fields():
                raw = rec.get(spec.name)
                row[spec.name] = (
                    _convert_cell(schema, spec.name, raw)
                    if raw is not None
                    else spec.get_default_null_value()
                )
            rows.append(row)
    return rows


def read_for_path(path: str, schema: Schema) -> List[Row]:
    """Pick the reader by file extension (csv, else jsonl)."""
    lower = path.lower()
    if lower.endswith(".csv"):
        return read_csv(path, schema)
    if lower.endswith((".avro", ".avro.gz")):
        raise NotImplementedError(f"{path}: avro input is item 31 of the port (ROADMAP queue 1)")
    return read_jsonl(path, schema)


def read_jsonl(path: str, schema: Schema) -> List[Row]:
    rows: List[Row] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            row: Row = {}
            for spec in schema.all_fields():
                v = rec.get(spec.name)
                if v is None:
                    row[spec.name] = (
                        spec.get_default_null_value()
                        if spec.single_value
                        else [spec.get_default_null_value()]
                    )
                elif spec.single_value:
                    row[spec.name] = spec.stored_type.convert(v)
                else:
                    vs = v if isinstance(v, list) else [v]
                    row[spec.name] = [spec.stored_type.convert(x) for x in vs] or [
                        spec.get_default_null_value()
                    ]
            rows.append(row)
    return rows
