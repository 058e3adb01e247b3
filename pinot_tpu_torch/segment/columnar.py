"""Columnar segment build path (copy of ``pinot_tpu.segment.columnar``):
typed arrays in, segment out, no per-row Python objects.

The row-wise ``SegmentBuilder`` mirrors the reference's two passes over
records (``SegmentIndexCreationDriverImpl.java:71``). This module is the
vectorized equivalent: ``np.unique(return_inverse=True)`` produces the
sorted dictionary and the dictId forward index in one pass, so stats
collection, dictionary build, and fwd-index write collapse into array
ops. Output segments are bit-identical to the row path (same
dictionaries, fwd indexes, metadata, CRC), which the differential tests
assert.

``build_segment_from_csv`` feeds this from the native one-pass CSV
parser (``csrc/csvread.cpp``, built by ``segment/native.py``; a failed
build raises).  Files that need the csv module's semantics (quoted cells,
a lone CR, unparseable numerics, ragged-wide rows) take the row path,
as in the reference (reader layer: ``data/readers/CSVRecordReader.java``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from pinot_tpu_torch.common.schema import DataType, FieldSpec, Schema
from pinot_tpu_torch.segment import native
from pinot_tpu_torch.segment.builder import (
    SegmentGeneratorConfig,
    build_segment,
    finalize_segment,
)
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.immutable import ColumnData, ColumnMetadata, ImmutableSegment

# SV columns: a typed numpy array (object dtype for strings), length
# num_docs. MV columns: (flat_values, offsets) CSR — offsets[i]:offsets[i+1]
# spans doc i's values.
ColumnInput = Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]


def build_segment_from_columns(
    schema: Schema,
    columns_in: Dict[str, ColumnInput],
    num_docs: int,
    table_name: str,
    segment_name: Optional[str] = None,
    **kwargs: Any,
) -> ImmutableSegment:
    config = SegmentGeneratorConfig(
        table_name=table_name, segment_name=segment_name, **kwargs
    )
    columns: Dict[str, ColumnData] = {}
    for spec in schema.all_fields():
        columns[spec.name] = _build_column(spec, columns_in[spec.name], num_docs)
    return finalize_segment(schema, config, num_docs, columns)


def _build_column(spec: FieldSpec, data: ColumnInput, num_docs: int) -> ColumnData:
    st = spec.stored_type
    if spec.single_value:
        arr = data
        uniq, inv = np.unique(arr, return_inverse=True)
        d = Dictionary(st, uniq.tolist() if st == DataType.STRING else uniq)
        fwd = inv.astype(np.int32)
        is_sorted = bool(num_docs < 2 or np.all(arr[1:] >= arr[:-1]))
        meta = _column_metadata(spec, d, num_docs, is_sorted, 0, num_docs)
        return ColumnData(metadata=meta, dictionary=d, fwd=fwd)

    flat, offsets = data
    uniq, inv = np.unique(flat, return_inverse=True)
    d = Dictionary(st, uniq.tolist() if st == DataType.STRING else uniq)
    mv_values = inv.astype(np.int32)
    lengths = np.diff(offsets)
    max_mv = int(lengths.max()) if len(lengths) else 0
    meta = _column_metadata(spec, d, num_docs, False, max_mv, int(len(flat)))
    return ColumnData(
        metadata=meta,
        dictionary=d,
        mv_values=mv_values,
        mv_offsets=np.asarray(offsets, dtype=np.int32),
    )


def _column_metadata(
    spec: FieldSpec,
    d: Dictionary,
    num_docs: int,
    is_sorted: bool,
    max_mv: int,
    total_entries: int,
) -> ColumnMetadata:
    return ColumnMetadata(
        name=spec.name,
        data_type=spec.data_type,
        field_type=spec.field_type,
        single_value=spec.single_value,
        cardinality=d.cardinality,
        total_docs=num_docs,
        is_sorted=is_sorted,
        max_num_multi_values=max_mv,
        total_number_of_entries=total_entries,
        min_value=d.min_value,
        max_value=d.max_value,
    )


# ---------------------------------------------------------------------------
# CSV -> columnar arrays (native fast path + Python fallback)
# ---------------------------------------------------------------------------

from pinot_tpu_torch.segment.readers import MV_DELIMITER, read_csv


def build_segment_from_csv(
    schema: Schema,
    path: str,
    table_name: str,
    segment_name: Optional[str] = None,
    delimiter: str = ",",
    **kwargs: Any,
) -> ImmutableSegment:
    """CSV file -> segment via the columnar path when possible."""
    cols, num_docs = read_csv_columnar(path, schema, delimiter)
    if cols is not None:
        return build_segment_from_columns(
            schema, cols, num_docs, table_name, segment_name, **kwargs
        )
    rows = read_csv(path, schema, delimiter)
    return build_segment(schema, rows, table_name, segment_name, **kwargs)


def read_csv_columnar(
    path: str, schema: Schema, delimiter: str = ","
) -> Tuple[Optional[Dict[str, ColumnInput]], int]:
    """Parse a CSV into per-column arrays using the native parser.

    Returns ``(None, 0)`` when the file needs the csv module's semantics
    (quoted cells, a lone CR, unparseable numerics): the caller takes the
    row-wise reader.  The parser is built first; a failed build raises.
    """
    import mmap

    native.load()
    with open(path, "rb") as f:
        try:
            data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # empty file
            return None, 0
    # mmap instead of read(): the scans below and the native parse run
    # against page-cache-backed memory, so peak RSS stays O(columns)
    # instead of 2x the file
    if data.find(b'"') >= 0:
        return None, 0  # quoted CSV: python csv module semantics needed
    i = data.find(b"\r")
    while i != -1:
        # a lone \r is a row separator for python's csv module but cell
        # data for the native parser — keep both paths identical
        if i + 1 >= len(data) or data[i + 1] != 0x0A:
            return None, 0
        i = data.find(b"\r", i + 2)
    nl = data.find(b"\n")
    if nl < 0:
        return None, 0
    header_line = data[:nl].rstrip(b"\r").decode("utf-8")
    # exact header names, like csv.DictReader in the fallback path (a
    # space-padded header mismatches the schema on both paths alike)
    header = header_line.split(delimiter)

    # per-header-column parse type; columns absent from the schema are
    # tokenized but record nothing (type 3)
    types: List[int] = []
    i64_def: List[int] = []
    f64_def: List[float] = []
    specs: List[Optional[FieldSpec]] = []
    for name in header:
        spec = schema.field(name) if schema.has_column(name) else None
        specs.append(spec)
        if spec is None:
            types.append(3)
            i64_def.append(0)
            f64_def.append(0.0)
        elif spec.single_value and spec.stored_type in (
            DataType.INT,
            DataType.LONG,
        ):
            types.append(0)
            i64_def.append(int(spec.get_default_null_value()))
            f64_def.append(0.0)
        elif spec.single_value and spec.stored_type in (
            DataType.FLOAT,
            DataType.DOUBLE,
        ):
            types.append(1)
            i64_def.append(0)
            f64_def.append(float(spec.get_default_null_value()))
        else:
            types.append(2)
            i64_def.append(0)
            f64_def.append(0.0)

    parsed = native.csv_parse(data, nl + 1, delimiter, types, i64_def, f64_def)
    if parsed is None:
        return None, 0
    num_docs, i64_cols, f64_cols, str_offs = parsed

    out: Dict[str, ColumnInput] = {}
    for c, spec in enumerate(specs):
        if spec is None:
            continue
        if types[c] == 0:
            arr = i64_cols[c]
            dtype = spec.stored_type.to_numpy()
            if dtype == np.int32 and arr.size:
                info = np.iinfo(np.int32)
                if arr.min() < info.min or arr.max() > info.max:
                    # same loud failure as the row-wise np.asarray(int32)
                    raise OverflowError(
                        f"value out of INT range in column {spec.name!r}"
                    )
            out[spec.name] = arr.astype(dtype, copy=False)
        elif types[c] == 1:
            arr = f64_cols[c]
            # the row-wise builder maps NaN cells to the default null
            nan = np.isnan(arr)
            if nan.any():
                arr = np.where(nan, float(spec.get_default_null_value()), arr)
            if spec.stored_type == DataType.FLOAT:
                # round-trip through float32 like DataType.convert
                arr = arr.astype(np.float32)
            out[spec.name] = arr.astype(spec.stored_type.to_numpy(), copy=False)
        else:
            out[spec.name] = _materialize_cells(data, str_offs[c], num_docs, spec)

    # schema columns missing from the header get default null values
    for spec in schema.all_fields():
        if spec.name in out:
            continue
        default = spec.get_default_null_value()
        if spec.single_value:
            out[spec.name] = np.full(
                num_docs,
                default,
                dtype=spec.stored_type.to_numpy(),
            )
        else:
            flat = np.full(num_docs, default, dtype=spec.stored_type.to_numpy())
            out[spec.name] = (flat, np.arange(num_docs + 1, dtype=np.int64))
    return out, num_docs


def _materialize_cells(
    body: bytes, offs: np.ndarray, num_docs: int, spec: FieldSpec
) -> ColumnInput:
    """Decode raw (offset,length) cell slices for string / MV columns,
    applying the same empty-cell and MV-split semantics as the row-wise
    reader (MV delimiter ';', CSVRecordReaderConfig default)."""
    starts = offs[0::2]
    lens = offs[1::2]
    default = spec.get_default_null_value()
    if spec.single_value:
        vals = np.empty(num_docs, dtype=object)
        for i in range(num_docs):
            if lens[i] == 0:
                vals[i] = default
            else:
                s = int(starts[i])
                vals[i] = body[s : s + int(lens[i])].decode("utf-8")
        return vals

    st = spec.stored_type
    flat: List[Any] = []
    offsets = np.zeros(num_docs + 1, dtype=np.int64)
    for i in range(num_docs):
        if lens[i] == 0:
            parts: List[Any] = [default]
        else:
            s = int(starts[i])
            cell = body[s : s + int(lens[i])].decode("utf-8")
            parts = [st.convert(p) for p in cell.split(MV_DELIMITER) if p != ""] or [
                default
            ]
        flat.extend(parts)
        offsets[i + 1] = len(flat)
    if st == DataType.STRING:
        return np.asarray(flat, dtype=object), offsets
    return np.asarray(flat, dtype=st.to_numpy()), offsets
