"""Pure-Python Avro Object Container File reader/writer (copy of
``pinot_tpu.segment.avro``).

The reference ingests Avro as its primary interchange format
(``core/data/readers/AvroRecordReader.java:46``, reading a
``DataFileStream<GenericRecord>``; schema mapping via
``AvroUtils``), and its sample/test datasets are Avro containers.  No
Avro library is baked into this image, so this module implements the
container format directly — it needs nothing beyond the stdlib:

  header:  magic "Obj\\x01" | file-metadata map (avro.schema JSON,
           avro.codec) | 16-byte sync marker
  blocks:  long record-count | long byte-size | block data | sync
  codecs:  null, deflate (raw DEFLATE, RFC 1951 — zlib wbits=-15)
  values:  zigzag-varint ints/longs, little-endian IEEE float/double,
           length-prefixed bytes/string, records/arrays/maps/unions/
           enums/fixed per the writer schema

Supports ``.gz``-wrapped containers like the reference reader
(``AvroRecordReader.java:75-78``).
"""
from __future__ import annotations

import gzip
import io
import json
import os
import struct
import zlib
from typing import Any, BinaryIO, Dict, Iterator, List, Optional, Sequence, Tuple

from pinot_tpu_torch.common.schema import DataType, FieldSpec, FieldType, Schema, TimeFieldSpec

MAGIC = b"Obj\x01"

Row = Dict[str, Any]


# ---------------------------------------------------------------------------
# primitive codecs
# ---------------------------------------------------------------------------


def _read_long(buf: io.BytesIO) -> int:
    """Zigzag varint (Avro int and long share the encoding)."""
    shift = 0
    acc = 0
    while True:
        b = buf.read(1)
        if not b:
            raise EOFError("truncated varint")
        byte = b[0]
        acc |= (byte & 0x7F) << shift
        if not byte & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1)


def _write_long(out: io.BytesIO, value: int) -> None:
    acc = (value << 1) ^ (value >> 63)
    acc &= (1 << 64) - 1
    while True:
        byte = acc & 0x7F
        acc >>= 7
        if acc:
            out.write(bytes([byte | 0x80]))
        else:
            out.write(bytes([byte]))
            break


def _read_bytes(buf: io.BytesIO) -> bytes:
    n = _read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise EOFError("truncated bytes")
    return data


def _write_bytes(out: io.BytesIO, data: bytes) -> None:
    _write_long(out, len(data))
    out.write(data)


# ---------------------------------------------------------------------------
# schema-driven value codec
# ---------------------------------------------------------------------------


def _resolve(schema: Any, named: Dict[str, Any]) -> Any:
    """Expand a named-type reference to its definition."""
    if isinstance(schema, str) and schema in named:
        return named[schema]
    return schema


def _register_named(schema: Any, named: Dict[str, Any]) -> None:
    if isinstance(schema, dict):
        t = schema.get("type")
        if t in ("record", "enum", "fixed") and "name" in schema:
            named[schema["name"]] = schema
        if t == "record":
            for f in schema.get("fields", []):
                _register_named(f.get("type"), named)
        elif t == "array":
            _register_named(schema.get("items"), named)
        elif t == "map":
            _register_named(schema.get("values"), named)
    elif isinstance(schema, list):
        for s in schema:
            _register_named(s, named)


def _decode(schema: Any, buf: io.BytesIO, named: Dict[str, Any]) -> Any:
    schema = _resolve(schema, named)
    if isinstance(schema, list):  # union: index then value
        idx = _read_long(buf)
        return _decode(schema[idx], buf, named)
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            return {
                f["name"]: _decode(f["type"], buf, named)
                for f in schema["fields"]
            }
        if t == "array":
            out: List[Any] = []
            while True:
                n = _read_long(buf)
                if n == 0:
                    break
                if n < 0:  # block with byte-size prefix
                    n = -n
                    _read_long(buf)
                for _ in range(n):
                    out.append(_decode(schema["items"], buf, named))
            return out
        if t == "map":
            m: Dict[str, Any] = {}
            while True:
                n = _read_long(buf)
                if n == 0:
                    break
                if n < 0:
                    n = -n
                    _read_long(buf)
                for _ in range(n):
                    key = _read_bytes(buf).decode("utf-8")
                    m[key] = _decode(schema["values"], buf, named)
            return m
        if t == "enum":
            return schema["symbols"][_read_long(buf)]
        if t == "fixed":
            return buf.read(schema["size"])
        schema = t  # {"type": "string"} style wrapper

    if schema == "null":
        return None
    if schema == "boolean":
        b = buf.read(1)
        return b != b"\x00"
    if schema in ("int", "long"):
        return _read_long(buf)
    if schema == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if schema == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if schema == "bytes":
        return _read_bytes(buf)
    if schema == "string":
        return _read_bytes(buf).decode("utf-8")
    raise ValueError(f"unsupported avro type {schema!r}")


def _encode(schema: Any, value: Any, out: io.BytesIO, named: Dict[str, Any]) -> None:
    schema = _resolve(schema, named)
    if isinstance(schema, list):  # union: pick first matching branch
        for idx, branch in enumerate(schema):
            if _matches(branch, value, named):
                _write_long(out, idx)
                _encode(branch, value, out, named)
                return
        raise ValueError(f"value {value!r} matches no union branch {schema!r}")
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            for f in schema["fields"]:
                _encode(f["type"], value[f["name"]], out, named)
            return
        if t == "array":
            items = list(value)
            if items:
                _write_long(out, len(items))
                for v in items:
                    _encode(schema["items"], v, out, named)
            _write_long(out, 0)
            return
        if t == "map":
            if value:
                _write_long(out, len(value))
                for k, v in value.items():
                    _write_bytes(out, str(k).encode("utf-8"))
                    _encode(schema["values"], v, out, named)
            _write_long(out, 0)
            return
        if t == "enum":
            _write_long(out, schema["symbols"].index(value))
            return
        if t == "fixed":
            out.write(bytes(value))
            return
        schema = t

    if schema == "null":
        return
    if schema == "boolean":
        out.write(b"\x01" if value else b"\x00")
    elif schema in ("int", "long"):
        _write_long(out, int(value))
    elif schema == "float":
        out.write(struct.pack("<f", float(value)))
    elif schema == "double":
        out.write(struct.pack("<d", float(value)))
    elif schema == "bytes":
        _write_bytes(out, bytes(value))
    elif schema == "string":
        _write_bytes(out, str(value).encode("utf-8"))
    else:
        raise ValueError(f"unsupported avro type {schema!r}")


def _matches(schema: Any, value: Any, named: Dict[str, Any]) -> bool:
    schema = _resolve(schema, named)
    name = schema["type"] if isinstance(schema, dict) else schema
    if name == "null":
        return value is None
    if value is None:
        return False
    if name == "boolean":
        return isinstance(value, bool)
    if name in ("int", "long"):
        return isinstance(value, int) and not isinstance(value, bool)
    if name in ("float", "double"):
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if name in ("string", "enum"):
        return isinstance(value, str)
    if name in ("bytes", "fixed"):
        return isinstance(value, (bytes, bytearray))
    if name == "record":
        return isinstance(value, dict)
    if name == "array":
        return isinstance(value, (list, tuple))
    if name == "map":
        return isinstance(value, dict)
    return False


# ---------------------------------------------------------------------------
# container file
# ---------------------------------------------------------------------------


class AvroContainerReader:
    """Streams records out of an Avro Object Container File."""

    def __init__(self, path: str) -> None:
        self.path = path
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            self._data = f.read()
        buf = io.BytesIO(self._data)
        if buf.read(4) != MAGIC:
            raise ValueError(f"{path}: not an Avro object container file")
        self.metadata: Dict[str, bytes] = {}
        while True:
            n = _read_long(buf)
            if n == 0:
                break
            if n < 0:
                n = -n
                _read_long(buf)
            for _ in range(n):
                key = _read_bytes(buf).decode("utf-8")
                self.metadata[key] = _read_bytes(buf)
        self.sync = buf.read(16)
        self.schema = json.loads(self.metadata["avro.schema"].decode("utf-8"))
        self.codec = self.metadata.get("avro.codec", b"null").decode("utf-8")
        if self.codec not in ("null", "deflate"):
            raise ValueError(f"unsupported avro codec {self.codec!r}")
        self._named: Dict[str, Any] = {}
        _register_named(self.schema, self._named)
        self._body_offset = buf.tell()

    def __iter__(self) -> Iterator[Any]:
        # each iteration walks its own cursor from the first block, so
        # the reader is safely re-iterable
        buf = io.BytesIO(self._data)
        buf.seek(self._body_offset)
        while True:
            head = buf.read(1)
            if not head:
                return
            buf.seek(-1, io.SEEK_CUR)
            count = _read_long(buf)
            size = _read_long(buf)
            block = buf.read(size)
            if len(block) != size:
                raise EOFError("truncated avro block")
            if self.codec == "deflate":
                block = zlib.decompress(block, -15)
            bbuf = io.BytesIO(block)
            for _ in range(count):
                yield _decode(self.schema, bbuf, self._named)
            marker = buf.read(16)
            if marker != self.sync:
                raise ValueError("avro sync marker mismatch")


def write_avro(
    path: str,
    avro_schema: Dict[str, Any],
    records: Sequence[Dict[str, Any]],
    codec: str = "null",
    records_per_block: int = 4096,
) -> None:
    """Write records as an Avro Object Container File."""
    if codec not in ("null", "deflate"):
        raise ValueError(f"unsupported avro codec {codec!r}")
    named: Dict[str, Any] = {}
    _register_named(avro_schema, named)
    sync = os.urandom(16)
    with open(path, "wb") as f:
        f.write(MAGIC)
        head = io.BytesIO()
        meta = {
            "avro.schema": json.dumps(avro_schema).encode("utf-8"),
            "avro.codec": codec.encode("utf-8"),
        }
        _write_long(head, len(meta))
        for k, v in meta.items():
            _write_bytes(head, k.encode("utf-8"))
            _write_bytes(head, v)
        _write_long(head, 0)
        f.write(head.getvalue())
        f.write(sync)
        for start in range(0, len(records), records_per_block):
            chunk = records[start : start + records_per_block]
            body = io.BytesIO()
            for rec in chunk:
                _encode(avro_schema, rec, body, named)
            data = body.getvalue()
            if codec == "deflate":
                compressor = zlib.compressobj(9, zlib.DEFLATED, -15)
                data = compressor.compress(data) + compressor.flush()
            block = io.BytesIO()
            _write_long(block, len(chunk))
            _write_long(block, len(data))
            f.write(block.getvalue())
            f.write(data)
            f.write(sync)


# ---------------------------------------------------------------------------
# pinot-side adapters (AvroRecordReader / AvroUtils analogs)
# ---------------------------------------------------------------------------


def read_avro(path: str, schema: Schema) -> List[Row]:
    """Avro container -> rows typed per the Pinot schema (the
    ``AvroRecordReader`` role: extract schema fields from each
    GenericRecord, null-defaulting and MV flattening)."""
    def conv(spec: FieldSpec, v: Any) -> Any:
        # Avro bytes/fixed arrive as Python bytes; decode before the
        # STRING conversion so the stored value is the content, not repr
        if isinstance(v, (bytes, bytearray)):
            v = bytes(v).decode("utf-8", "replace")
        return spec.stored_type.convert(v)

    rows: List[Row] = []
    for rec in AvroContainerReader(path):
        row: Row = {}
        for spec in schema.all_fields():
            v = rec.get(spec.name)
            if spec.single_value:
                row[spec.name] = (
                    spec.get_default_null_value() if v is None else conv(spec, v)
                )
            else:
                vs = v if isinstance(v, list) else ([] if v is None else [v])
                row[spec.name] = [conv(spec, x) for x in vs if x is not None] or [
                    spec.get_default_null_value()
                ]
        rows.append(row)
    return rows


_AVRO_TO_DATATYPE = {
    "boolean": DataType.STRING,
    "int": DataType.INT,
    "long": DataType.LONG,
    "float": DataType.FLOAT,
    "double": DataType.DOUBLE,
    "string": DataType.STRING,
    "bytes": DataType.STRING,
    "enum": DataType.STRING,
    "fixed": DataType.STRING,
}

_SV_TO_MV = {
    DataType.INT: DataType.INT_ARRAY,
    DataType.LONG: DataType.LONG_ARRAY,
    DataType.FLOAT: DataType.FLOAT_ARRAY,
    DataType.DOUBLE: DataType.DOUBLE_ARRAY,
    DataType.STRING: DataType.STRING_ARRAY,
}


def _field_datatype(ftype: Any, named: Dict[str, Any]) -> Tuple[DataType, bool]:
    """(stored type, single_value) for an Avro field type; unions of
    [null, T] unwrap to T (AvroUtils union handling)."""
    ftype = _resolve(ftype, named)
    if isinstance(ftype, list):
        non_null = [t for t in ftype if t != "null"]
        if not non_null:
            return DataType.STRING, True
        return _field_datatype(non_null[0], named)
    if isinstance(ftype, dict):
        t = ftype["type"]
        if t == "array":
            inner, _sv = _field_datatype(ftype["items"], named)
            return inner, False
        if t in _AVRO_TO_DATATYPE:
            return _AVRO_TO_DATATYPE[t], True
        return DataType.STRING, True
    return _AVRO_TO_DATATYPE.get(ftype, DataType.STRING), True


def avro_to_pinot_schema(
    path: str,
    table_name: Optional[str] = None,
    metrics: Sequence[str] = (),
    time_field: Optional[str] = None,
    time_unit: str = "DAYS",
) -> Schema:
    """Derive a Pinot schema from an Avro container's writer schema —
    the ``AvroUtils.getPinotSchemaFromAvroSchema`` role.  Fields default
    to dimensions; pass ``metrics``/``time_field`` to classify."""
    reader = AvroContainerReader(path)
    avro_schema = reader.schema
    if avro_schema.get("type") != "record":
        raise ValueError("top-level avro schema must be a record")
    named: Dict[str, Any] = {}
    _register_named(avro_schema, named)

    dims: List[FieldSpec] = []
    mets: List[FieldSpec] = []
    tf: Optional[TimeFieldSpec] = None
    for f in avro_schema["fields"]:
        name = f["name"]
        dt, sv = _field_datatype(f["type"], named)
        data_type = dt if sv else _SV_TO_MV.get(dt, DataType.STRING_ARRAY)
        if name == time_field:
            tf = TimeFieldSpec(name, dt, time_unit=time_unit)
        elif name in metrics:
            mets.append(FieldSpec(name, data_type, FieldType.METRIC, single_value=sv))
        else:
            dims.append(FieldSpec(name, data_type, FieldType.DIMENSION, single_value=sv))
    return Schema(
        table_name or avro_schema.get("name", "avroTable"),
        dimensions=dims,
        metrics=mets,
        time_field=tf,
    )


def pinot_to_avro_schema(schema: Schema) -> Dict[str, Any]:
    """Pinot schema -> Avro record schema (segment->Avro converter
    support, pinot-tools segment converters)."""
    type_map = {
        DataType.INT: "int",
        DataType.LONG: "long",
        DataType.FLOAT: "float",
        DataType.DOUBLE: "double",
        DataType.STRING: "string",
    }
    fields = []
    for spec in schema.all_fields():
        st = spec.stored_type
        base = type_map.get(st, "string")
        ftype: Any = base if spec.single_value else {"type": "array", "items": base}
        fields.append({"name": spec.name, "type": ["null", ftype]})
    return {"type": "record", "name": schema.schema_name, "fields": fields}
